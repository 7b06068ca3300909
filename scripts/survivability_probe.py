"""Phases 5, 10 and 17 of chip_smoke.py on the card, alone: the build, the main path (its
tokens are what phase 17 holds the ring to), the one-process ring with the survivability
taps' cost (knobs on and off in turns), then the two-process ring under injected faults
and a SIGKILL. `python3 scripts/survivability_probe.py [--rounds N]` runs phase 17 N
times (default 1) after the others, to see how each round's eviction came about."""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
  parser = argparse.ArgumentParser()
  parser.add_argument("--rounds", type=int, default=1, help="times to run phase 17")
  rounds = parser.parse_args().rounds
  t0 = time.perf_counter()
  card = cs.smi_line()
  print(card, flush=True)
  cs.set_peaks(torch.cuda.get_device_name(0))
  from xotorch_tpu_torch.ops import _build
  print(f"build: {_build.load_all(verbose=False):.1f} s", flush=True)
  with cs.phase_env(XOT_PREFIX_CACHE="0", XOT_PREFILL_COSCHED="0"):  # as phases 4-15 run
    main_run = cs.drive_main_path(torch, card, focus="flash_cached_")
    cs.drive_ring_inprocess(torch, card, main_run)
  for r in range(rounds):
    print(f"phase 17, round {r + 1} of {rounds}: {cs.check_survivability(torch, card, main_run)}",
          flush=True)
  print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
