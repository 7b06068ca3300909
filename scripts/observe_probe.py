"""Phases 5, 8 (the int4 K5 and int8 K6 servers), 10 and 15 of chip_smoke.py alone, on
the card: `python3 scripts/observe_probe.py` (about 3 minutes with the build)."""
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
  cs.set_peaks(torch.cuda.get_device_name(0))
  from xotorch_tpu_torch.ops import _build
  print(f"build: {_build.load_all(verbose=False):.1f} s", flush=True)
  main_run = cs.drive_main_path(torch, card, focus="flash_cached_")
  phases = cs.quant_phases()
  for fmt, env, kernel, focus in (phases[0], phases[2]):
    cs.drive_quantized(torch, card, fmt, env, kernel, focus)
  cs.drive_ring_inprocess(torch, card, main_run)
  print(cs.check_observability(torch, card), flush=True)
  print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
