"""Phase 10 of chip_smoke.py (the token ring in one process: (a) over TCP, then (c) the
fused in-process ring of two and three Nodes, its concurrent streams and ring
speculation) alone, on the card, after the main path it is held against:
`python3 scripts/fused_ring_probe.py` (the build, phase 5, then the ring)."""
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
    main_run = cs.drive_main_path(torch, card, focus="flash_cached_")
    per_token = cs.drive_ring_inprocess(torch, card, main_run)
    cs.drive_ring_fused(torch, card, main_run, per_token)
  print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
