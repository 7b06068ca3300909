"""Phase 24 of chip_smoke.py (training over meshes whose positions repeat the one card)
alone, on the card: `python3 scripts/mesh_training_probe.py` (the build, phase 20 (b)'s
adapter server for its single-card @ad1 stream, phase 21 (c)'s single-card train and
eval runs for their losses, then phase 24). `--cuts` runs phase 24 (b) and (c) alone."""
import os
import shutil
import sys
import tempfile
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
  print(f"build: {_build.load_all(verbose=False):.1f} s", flush=True)
  if "--cuts" in sys.argv:
    cs.mesh_train_cut(torch, card)
    cs.mesh_ring_cut(torch, card)
    print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return
  streams: dict = {}
  root = tempfile.mkdtemp(prefix="xot-probe-adapters-")
  try:
    paths = cs.write_adapters(torch, root, "synthetic-llama-1b")
    with cs.phase_env(**cs.ADAPTER_ENV):
      cs.drive_adapters(torch, card, paths, streams=streams)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  trained = cs.drive_training(torch, card)
  print(cs.check_mesh_training(torch, card, trained, streams), flush=True)
  print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
