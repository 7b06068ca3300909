"""Run chip_smoke.py's phase 14 (the sampling extras) alone on the card: build the
kernels, run `check_sampling_extras`, print its launches and numbers; with `--gemma`,
phase 12 too (gemma-2-2b, with its extras request).

  python3 scripts/extras_probe.py [--gemma]
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch
import chip_smoke
from xotorch_tpu_torch.ops import _build
card = chip_smoke.smi_line()
print(card, torch.__version__, torch.version.cuda, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
print(f"build {_build.load_all(verbose=False):.1f} s", flush=True)
out = chip_smoke.check_sampling_extras(torch, card)
print({k: v for k, v in out.items() if k not in ("seed7", "penalty_tokens")}, flush=True)
print(f"phase 14 done at {time.perf_counter() - t0:.1f} s", flush=True)
if "--gemma" in sys.argv:
  print(chip_smoke.drive_gemma(torch, card), flush=True)
print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
