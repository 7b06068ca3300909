"""Training steps of two trees of the repo, in turns on one card.

Runs phase 21 (c) of chip_smoke.py (main.py train and eval at synthetic-llama-1b's full
width and depth: full fine-tune, LoRA with saves, a resume, QLoRA; each printing its step
times, tokens/s and peak memory) in a fresh process from OTHER, then from this tree
twice, then from OTHER again, so that the two are compared within one call:

    python3 scripts/train_ab_probe.py OTHER

OTHER is another commit's tree unpacked inside the checkout (`git archive`), in a
directory that .gitignore lists.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = """
import torch, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
cs.set_peaks(torch.cuda.get_device_name(0))
cs.drive_training(torch, cs.smi_line())
"""


def main() -> None:
  other = os.path.abspath(sys.argv[1])
  for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True, text=True)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("[training]") and "step ms" in l]
    for line in lines:
      print(f"[ab] {label} ({tree}): {line}", flush=True)
    if proc.returncode != 0:
      print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
      raise SystemExit(f"{label}: exited {proc.returncode}")


if __name__ == "__main__":
  main()
