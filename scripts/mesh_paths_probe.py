"""Phase 25 of chip_smoke.py (the serving mesh's last paths: a paged cut of Llama-3.1-405B
at 16 groups and page 8, vision, the fused ring and the KV fabric over tp 2) alone, on
the card: `python3 scripts/mesh_paths_probe.py` (the build, phase 5 and phase 10 (a) with
the prefix cache and co-scheduled prefill off, as in the smoke, then phase 19's LLaVA
checkpoint written and served by drive_llava, kept for (b), then phase 25). `--only a`
(or b, c, d; comma-separated) runs those parts alone, b after its LLaVA checkpoint,
c after phases 5 and 10 (a)."""
import argparse
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--only", default="a,b,c,d", help="the parts of phase 25 to run")
  parts = set(parser.parse_args().only.split(","))
  t0 = time.perf_counter()
  card = cs.smi_line()
  print(card, flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cs.set_peaks(torch.cuda.get_device_name(0))
  from xotorch_tpu_torch.ops import _build
  print(f"build: {_build.load_all(verbose=False):.1f} s", flush=True)
  launches: dict = {}
  if "a" in parts:
    launches.update(cs.mesh_paged_cut(torch, card))
  if "b" in parts:
    llava: dict = {}
    try:
      cs.drive_llava(torch, card, keep=llava)
      launches.update(cs.mesh_vision(torch, card, llava))
    finally:
      shutil.rmtree(llava.get("tmp", "/nonexistent"), ignore_errors=True)
  if "c" in parts:
    with cs.phase_env(XOT_PREFIX_CACHE="0", XOT_PREFILL_COSCHED="0"):
      main_run = cs.drive_main_path(torch, card)
      per_token = cs.drive_ring_inprocess(torch, card, main_run)
      fused = cs.drive_ring_fused(torch, card, main_run, per_token, tp=cs.MESH_TP,
                                  node_counts=(2,))
    launches.update({f"(c) {k}": v for f in fused.values() for k, v in f["launches"].items()})
  if "d" in parts:
    launches.update({f"(d) {k}": v for k, v in cs.mesh_fabric(torch, card).items()})
  print(launches, flush=True)
  print(f"probe ok in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
