"""Phase 19 of chip_smoke.py (the MoE and vision families: Qwen3-30B-A3B cut to 4 layers
and LLaVA-1.5-7B from seeded checkpoints) alone, on the card, after the kernel cases at
their attention widths: `python3 scripts/families_probe.py` (the build, the cases, then
the phase); `--kernels-only` stops after the cases."""
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
  cs.check_family_kernels(torch)
  if "--kernels-only" not in sys.argv:
    print(cs.check_families(torch, card), flush=True)
  print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
