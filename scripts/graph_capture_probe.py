"""Probe what can break a decode graph's capture on the card, and hold the graph cache
(xotorch_tpu_torch/models/graphs.py) against it:

1. a graph cache left dead in a reference cycle inside the capture of an int4 (K5) B=8
   contiguous decode step of synthetic-llama-1b at full width, with the collector's
   threshold at 1 and objects allocated after it: `capture_guard` keeps the collector
   off, so the capture must hold;
2. `--loops P N`: P captures of fresh graph caches, each after a profiled eager chunk,
   then N more back to back (every capture a new pool and slab: the guard releases the
   dead ones' memory first); each must hold;
3. last, the hazard itself in plain PyTorch, with no code of the port inside the
   capture: a capture of one matmul during which a dead CUDA graph is left in a cycle
   and the collector (threshold 1) runs on its own. It is expected to fail ("operation
   failed due to a previous error during capture"); the process's generator is unusable
   after it, so it runs last.

    python3 scripts/graph_capture_probe.py [--loops 50 150]

Needs one NVIDIA GPU; it builds the kernels first, as chip_smoke.py does. Prints one
line a probe and exits 1 if a capture through the graph cache failed."""
import argparse
import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch

import chip_smoke as cs
from xotorch_tpu_torch.models import graphs
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.ops import _build


class Cycle:
  """An object that only the garbage collector frees."""

  def __init__(self, victim):
    self.me = self
    self.victim = victim


def leave_dead(holder: list) -> None:
  """Move the last object of `holder` into a reference cycle (its only reference) and
  allocate: with the collector on and its threshold at 1, a collection runs here and
  destroys it."""
  Cycle(holder.pop())
  [[i] for i in range(1000)]


def why(e: BaseException) -> str:
  out = []
  while e is not None:
    out.append(f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
    e = e.__cause__ or e.__context__
  return " <- ".join(out)


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--loops", type=int, nargs=2, default=(50, 150), metavar=("P", "N"))
  args = parser.parse_args()
  card = cs.smi_line()
  print(card, flush=True)
  _build.load_all()
  cfg = get_model_card("synthetic-llama-1b")["synthetic_config"]
  m = cs.fused_model(torch, "int4 K5", {"XOT_QUANTIZE": "int4"}, cfg, cfg["num_hidden_layers"])
  state, toks, pos = cs.fused_batch(torch, m, 8, False)
  temps = torch.zeros(8, device="cuda")

  def chunk(gcache):
    out, _ = cs.fused_chunk(m, cs._clone_state(state, False), toks, pos, 2, temps, 0, False,
                            gc=gcache)
    torch.cuda.synchronize()
    return out

  def capture() -> str:
    """One fresh graph cache's capture and replay: '' when it held, else why not."""
    try:
      chunk(graphs.GraphCache("cuda"))
      return ""
    except Exception as e:
      return why(e)

  failed = 0
  want = chunk(None)
  spare = [graphs.GraphCache("cuda")]
  if not torch.equal(chunk(spare[0]), want):
    raise AssertionError("graph tokens differ from the eager body's")
  step, thresholds = graphs.decode_step, gc.get_threshold()

  def step_leaving_a_dead_graph(*a, **kw):
    if torch.cuda.is_current_stream_capturing() and spare:
      gc.set_threshold(1)
      leave_dead(spare)
    return step(*a, **kw)

  graphs.decode_step = step_leaving_a_dead_graph
  try:
    err = capture()
  finally:
    graphs.decode_step = step
    gc.set_threshold(*thresholds)
  failed += bool(err) or bool(spare)
  print(f"[probe] graph cache, a graph cache left dead in a cycle inside the capture, "
        f"collector threshold 1: {'held' if not err else 'FAILED: ' + err} ({card})", flush=True)

  for label, n, profiled in (("after a profiled eager chunk", args.loops[0], True),
                             ("back to back", args.loops[1], False)):
    errs, t0 = [], time.perf_counter()
    for _ in range(n):
      if profiled:
        cs._profile_chunk(torch, lambda: chunk(None))
      err = capture()
      if err:
        errs.append(err)
        break
    failed += bool(errs)
    print(f"[probe] graph cache, fresh caches captured {label}: {len(errs)} failed of "
          f"{n} ({time.perf_counter() - t0:.1f} s; peak reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB) {errs[:1]} ({card})", flush=True)

  # The hazard in plain PyTorch: no guard, no code of the port inside the capture.
  a = torch.randn(1024, 1024, device="cuda")
  old = torch.cuda.CUDAGraph()
  s = torch.cuda.Stream()
  s.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(s):
    a @ a
    old.capture_begin()
    a @ a
    old.capture_end()
    graph = torch.cuda.CUDAGraph()
    gc.enable()
    try:
      graph.capture_begin(capture_error_mode="thread_local")
      try:
        holder = [old]
        del old
        gc.set_threshold(1)
        leave_dead(holder)
        a @ a
      finally:
        gc.set_threshold(*thresholds)
        graph.capture_end()
      err = ""
    except Exception as e:
      err = why(e)
  print(f"[probe] plain PyTorch, a CUDA graph left dead in a cycle inside a capture, "
        f"collector on, threshold 1: {'held' if not err else 'failed (expected): ' + err} "
        f"({card})", flush=True)
  return 1 if failed else 0


if __name__ == "__main__":
  sys.exit(main())
