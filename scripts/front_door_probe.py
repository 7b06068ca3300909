"""Phase 22 of chip_smoke.py on the card, alone: the kernels' build, then the front door
(the router over three replica processes and two references: affinity, the KV fabric's
fetch, the prefill/decode chain, failover and the fleet's respawn).
`python3 scripts/front_door_probe.py`."""
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
  print(f"phase 22: {cs.check_front_door(torch, card)}", flush=True)
  print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
