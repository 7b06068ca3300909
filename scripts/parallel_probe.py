"""Phase 23 of chip_smoke.py (tensor, sequence and expert parallelism over meshes whose
positions repeat the one card, and the multihost seam) alone, on the card, after phase 5
(the single-card main path it compares its streams and launches with):
`python3 scripts/parallel_probe.py` (the build, phase 5 with its prefix cache and
co-scheduled prefill off, as in the smoke, then phase 23)."""
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
  print(f"build: {_build.load_all(verbose=False):.1f} s", flush=True)
  with cs.phase_env(XOT_PREFIX_CACHE="0", XOT_PREFILL_COSCHED="0"):
    main_run = cs.drive_main_path(torch, card)
  print(cs.check_parallel(torch, card, main_run), flush=True)
  print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
