"""Phase 26 of chip_smoke.py (llama-3.2-1b downloaded from a loopback HF endpoint and
served by main.py, and the native sidecar) alone, on the card: `python3
scripts/last_modules_probe.py` (the build, phase 5's main path for its timings, then
the phase)."""
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
  cs.set_peaks(torch.cuda.get_device_name(0))
  os.environ.setdefault("HF_ENDPOINT", "http://127.0.0.1:9")
  from xotorch_tpu_torch.ops import _build
  print(f"build: {_build.load_all(verbose=False):.1f} s", flush=True)
  with cs.phase_env(XOT_PREFIX_CACHE="0", XOT_PREFILL_COSCHED="0"):
    main_run = cs.drive_main_path(torch, card, focus="flash_cached_")
  print(cs.check_last_modules(torch, card, main_run), flush=True)
  print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
