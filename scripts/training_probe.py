"""Phase 21 of chip_smoke.py (training: K1b against its plain version, the two-layer
cut's gradients against the CPU, main.py train and eval at synthetic-llama-1b's full
width and depth, ring training over TCP) alone, on the card, after the kernel build
(`-Xptxas -v` printed): `python3 scripts/training_probe.py`."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
  t0 = time.perf_counter()
  card = cs.smi_line()
  print(card, flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cs.set_peaks(torch.cuda.get_device_name(0))
  from xotorch_tpu_torch.ops import _build
  print(f"build: {_build.load_all(verbose=True):.1f} s", flush=True)
  results: dict = {}
  print(cs.check_training(torch, card, results), flush=True)
  print(results, flush=True)
  print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
