"""The fused device programs on the card: a decode step, a prefill scan group and a
draft verification, each captured once as a CUDA graph and replayed.

JAX runs a decode chunk as one XLA program (`lax.scan` over K steps under `jax.jit`)
and a long prompt's equal segments as one program for each power-of-two group
(`prefill_scan`); `jit` keeps one executable for each set of statics. `GraphCache` is
the port's counterpart of that executable cache: one `torch.cuda.CUDAGraph` for each
key, with the static buffers it was captured on.

- A decode graph is ONE step (models/generate.decode_step) over static buffers:
  tokens [Bb, 1], positions [Bb], temperatures [Bb], a [OUT_ROWS, Bb] token record
  with its step counter, the page table (paged), injected noise (when given), and a
  request's sampling extras (SamplerExtras): the logit bias [Bb, V] fp32, the penalty
  counts [Bb, V] int32 with presence and frequency [Bb] fp32, min-p [Bb] fp32, and the
  logprob record [OUT_ROWS, Bb] and [OUT_ROWS, Bb, K]. A chunk of K tokens is K
  replays, so the chunk ladder's sizes add no key and a step's host cost is one
  replay. Keys: route (contiguous or paged), the bucketed batch Bb, the cache length S
  or the page-table width, the cache's leaves, and the sampler's statics (top_k, the
  snapped top_p, whether noise is injected, the generator, whether there is a bias,
  whether there are counts, top_lp, whether min-p is on). The extras' values are
  written to their buffers before a chunk (the counts read back after it), so a
  request's bias, penalties or min-p capture no graph of their own.
- A prefill graph is `prefill_scan` over one group of g segments of `chunk` tokens;
  keys (g, chunk, S or the table width, is_first).
- A verify graph is draft verification's forward + argmax (`forward_argmax`) over
  [prev_token] + draft padded to a power-of-two bucket T_pad: over the slab at one row
  (contiguous; keys T_pad and the cache's leaves, K2 at T > 1) or through a static
  [1, width] page table over the arena (keys T_pad, the width and the arena, K4). It
  returns the [1, T_pad] argmax on the device, as JAX jits the verify forward once a
  bucket.
- A ring graph is one step of a co-located ring (`decode_step_ring`: every segment's
  decode step through K2, then the sampler), replayed a token (`decode_ring`, the
  batched form at every B), and the ring's verify (`verify_ring`). It reads several
  contexts' parameters and caches, so it lives in a cache of its own (the driving
  engine's, one a chain of contexts) that each segment's cache lists in `dependents`:
  whatever drops a segment's graphs (a checkpoint load, the context's eviction, OOM
  recovery) drops the ring's with them. The slab: the ring cache has its own, holding
  every segment's stacked caches side by side (leaves '<segment>.<leaf>'), sized to the
  largest ring seen; no segment's own slab is shared or resized by it, so a solo
  graph of a segment's context never drops because a ring grew, and growing the ring's
  slab (a longer cache, a wider batch) drops only the ring's programs over it.
- Static addresses. A replay reads and writes the addresses it was captured on. The
  page arena is static by construction; contiguous caches are per request and are
  reallocated when they grow, so the requests of a contiguous chunk are copied into
  one slab for each context (rows of a [L, Bb, S, ...] view over its prefix, pad rows
  zeroed, as JAX's stack of zero caches) and copied back out after it: the stack and
  split of `decode_chunk_batched`, as copies. The slab is sized to the largest
  stacked cache yet seen; growing it drops the graphs captured over it.
- First use of a key runs the body eagerly (the warm-up: every kernel is loaded and
  every plan cached before the capture) as the real first run, then captures it; the
  capture runs nothing on the device. So the first use leaves the cache, tokens,
  launch counters and generator state as a replay would.
- A capture starts as `torch.cuda.graph`'s does (`capture_guard`): the card's queued
  work finished and the allocator's cached blocks and dead graphs' pools released, and
  Python's garbage collector stays off until it ends. A dead graph that the collector
  destroys inside a capture (one of a dropped engine's, say) invalidates it ("operation
  failed due to a previous error during capture"), and inside a capture the allocator
  cannot release cached memory to make room: it runs out instead. (No collection runs
  before the capture, as `torch.cuda.graph` skips it too: a full one costs hundreds of
  milliseconds in a serving process, and the collector off is enough.)
- A serving mesh (parallel/mesh.py): a program over sharded params runs every
  position's kernels, copies and sums in the one graph; its key carries the mesh
  (`_mesh_key`), and the slab holds every cache piece as a leaf of its own. The slab
  and the pool are on the cache's one device, and work on another card's stream may
  not be recorded at all: a program whose mesh spans distinct devices is unrun, so its
  capture is refused before its first run, naming its key.
- Launch counters. The kernel wrappers count on the host when called, which under
  capture is once. A graph records the counters' change during its capture (which is
  then undone) and adds it at every replay.
- All graphs share one memory pool and run on the cache's one stream; the cache holds
  at most `capacity` graphs (least recently used dropped) and is dropped with its
  context. Noise comes from the engine's generator, registered with each graph that
  samples, so a replay draws fresh noise; a seeded request's from a second generator,
  registered with the seeded graphs and re-seeded before each chunk (the engine's
  `_sample_generator`), so every seed shares one graph for each key.

There is no eager fallback: a capture or replay that fails raises, naming its key.
The eager body stays reachable as models/generate's functions, which the CPU runs.
"""
from __future__ import annotations

import contextlib
import gc as python_gc
import math
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from xotorch_tpu_torch.models.config import ModelConfig
from xotorch_tpu_torch.models.generate import (decode_step, decode_step_ring, forward_argmax,
                                               forward_argmax_ring, prefill_scan, scan_groups)
from xotorch_tpu_torch.models.transformer import QuantRoute
from xotorch_tpu_torch.ops import flash_attention, flash_decode, int4_matmul, int8_matmul, paged_attention
from xotorch_tpu_torch.parallel.mesh import MeshParams

OUT_ROWS = 64  # decode steps a graph's token record holds before the host reads it
SLAB_ALIGN = 256  # bytes between the slab's leaves
CAPACITY = 48  # graphs a cache holds

Cache = Dict[str, torch.Tensor]


def counted_wrappers() -> Tuple[Callable, ...]:
  """Every kernel wrapper with a launch counter."""
  return (flash_attention.flash_attention, flash_decode.flash_cached_attention,
          flash_decode.flash_cached_attention_int8, paged_attention.paged_decode_attention,
          paged_attention.paged_decode_attention_int8, paged_attention.paged_prefill_attention,
          paged_attention.paged_prefill_attention_int8, int4_matmul.int4_w4a16_matmul,
          int4_matmul.int4_w4a8_matmul, int8_matmul.int8_rowquant_matmul)


def _counters() -> Dict[Tuple[Callable, str], int]:
  return {(fn, attr): getattr(fn, attr) for fn in counted_wrappers()
          for attr in ("launches", "windowed_launches") if hasattr(fn, attr)}


# Held by every capture, and by a device trace's profiler while it starts or stops
# (orchestration/tracing.py): a profiler session that starts inside a capture breaks it.
CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def capture_guard(device: torch.device):
  """Around a capture: finish the card's queued work and release the allocator's cached
  memory first, then keep the garbage collector off until the capture ends (see the
  module docstring), with CAPTURE_LOCK held throughout."""
  with CAPTURE_LOCK:
    if device.type == "cuda":
      torch.cuda.synchronize(device)
      torch.cuda.empty_cache()
    enabled = python_gc.isenabled()
    python_gc.disable()
    try:
      yield
    finally:
      if enabled:
        python_gc.enable()


def _mesh_key(params) -> tuple:
  """The mesh a sharded param tree lies on (parallel/mesh.MeshParams): every key of a
  program over it carries ("mesh", axes, devices); () on one device."""
  return (("mesh",) + params.mesh.key(),) if isinstance(params, MeshParams) else ()


def _mesh_devices(key: tuple) -> set:
  """The distinct devices of the meshes in a program's key (`_mesh_key`)."""
  return {d for part in key if isinstance(part, tuple) and part[:1] == ("mesh",)
          for d in part[2]}


def _bucket(n: int) -> int:
  return 1 << max(0, n - 1).bit_length()


@dataclass
class SamplerExtras:
  """A request's sampling extras, one row per request, as the engine keeps them and
  both a graph chunk and an eager one take them (the graph key takes only which are
  present, and top_lp): `counts` is advanced in place by every chunk."""
  bias: Optional[torch.Tensor] = None  # [B, V] fp32 OpenAI logit_bias
  counts: Optional[torch.Tensor] = None  # [B, V] int32 counts of the sampled tokens
  presence: Optional[torch.Tensor] = None  # [B] fp32, with counts
  frequency: Optional[torch.Tensor] = None  # [B] fp32, with counts
  min_p: Optional[torch.Tensor] = None  # [B] fp32; None = off
  top_lp: int = -1  # -1 = no logprob report; 0..20 alternatives
  seed: Optional[int] = None  # the request's seed: picks the generator, no buffer or key

  def key(self) -> tuple:
    return (self.bias is not None, self.counts is not None, int(self.top_lp),
            self.min_p is not None)

  def sampler_kwargs(self) -> dict:
    """The keywords of models/generate's sampling functions (forward_sample,
    decode_chunk_batched, decode_chunk_paged)."""
    zero = lambda x: 0.0 if x is None else x  # noqa: E731
    return dict(bias=self.bias, counts=self.counts, presence=zero(self.presence),
                frequency=zero(self.frequency), min_p=self.min_p, top_lp=self.top_lp)

  def absorb(self, rest: Sequence) -> Optional[tuple]:
    """After an eager chunk, its results past the tokens and the caches (the counts,
    then the logprob triple, as decode_chunk returns them): the counts copied into
    `counts`; returns the logprob triple or None, as a graph chunk does."""
    rest = list(rest)
    if self.counts is not None:
      self.counts.copy_(rest.pop(0))
    return rest.pop(0) if self.top_lp >= 0 else None


PLAIN = SamplerExtras()


@dataclass
class Program:
  """One key's static buffers, its body over them and, once captured, its graph."""
  key: tuple
  statics: Dict[str, torch.Tensor]
  body: Callable[[], Any]
  generator: Optional[torch.Generator] = None
  uses_slab: bool = False
  graph: Any = None
  output: Any = None  # what the captured body returned: static tensors a replay rewrites
  deltas: Dict[Tuple[Callable, str], int] = field(default_factory=dict)


class GraphCache:
  """The captured programs of one model context on one card (see the module
  docstring). `captures`, `capture_seconds` and `replays` count its work, `pool_bytes`
  what the captures added to the card's reserved memory (the shared pool's growth)."""

  def __init__(self, device, capacity: int = CAPACITY):
    self.device = torch.device(device)
    self.capacity = capacity
    self.programs: "OrderedDict[tuple, Program]" = OrderedDict()
    self.slab: Optional[torch.Tensor] = None
    self._pool = None
    self._stream = None
    self.captures = 0
    self.capture_seconds = 0.0
    self.replays = 0
    self.pool_bytes = 0
    # Caches whose programs read this cache's context too (a fused ring's): cleared
    # with this one.
    self.dependents: "weakref.WeakSet[GraphCache]" = weakref.WeakSet()

  # --------------------------------------------------------------- buffers

  @contextlib.contextmanager
  def on_stream(self):
    """Run the enclosed copies, warm-ups, captures and replays on the cache's stream,
    ordered after the caller's stream's work and before its next."""
    if self._stream is None:
      self._stream = torch.cuda.Stream(self.device)
    caller = torch.cuda.current_stream(self.device)
    self._stream.wait_stream(caller)
    try:
      with torch.cuda.stream(self._stream):
        yield
    finally:  # a failed capture or replay too: the caller's next work waits for it
      caller.wait_stream(self._stream)

  def slab_views(self, leaves: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]) -> Cache:
    """Contiguous views over the slab's prefix, one for each leaf (shape, dtype). A
    slab too small for them is replaced by one that fits, and every graph captured
    over the old one is dropped."""
    offsets, total = {}, 0
    for name, (shape, dtype) in leaves.items():
      offsets[name] = total
      nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
      total += -(-nbytes // SLAB_ALIGN) * SLAB_ALIGN
    if self.slab is None or self.slab.numel() < total:
      for key in [k for k, p in self.programs.items() if p.uses_slab]:
        self._drop(key)
      self.slab = None
      self.slab = torch.empty(total, dtype=torch.uint8, device=self.device)
    views = {}
    for name, (shape, dtype) in leaves.items():
      n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
      views[name] = self.slab[offsets[name]:offsets[name] + n].view(dtype).view(shape)
    return views

  @property
  def slab_bytes(self) -> int:
    return 0 if self.slab is None else self.slab.numel()

  # --------------------------------------------------------------- programs

  def program(self, key: tuple, make_statics: Callable[[], Dict[str, torch.Tensor]],
              make_body: Callable[[Dict[str, torch.Tensor]], Callable[[], Any]],
              generator: Optional[torch.Generator] = None, uses_slab: bool = False) -> Program:
    """The program of `key`, made (not yet captured) on first use."""
    prog = self.programs.get(key)
    if prog is None:
      statics = make_statics()
      prog = Program(key, statics, make_body(statics), generator, uses_slab)
      self.programs[key] = prog
      while len(self.programs) > self.capacity:
        self._drop(next(iter(self.programs)))
    self.programs.move_to_end(key)
    return prog

  def run(self, prog: Program) -> Any:
    """One run of `prog`: a replay; on first use the body eagerly (the warm-up and the
    real run), then the capture. Returns the body's output."""
    if prog.graph is not None:
      self._replay(prog)
      return prog.output
    devices = _mesh_devices(prog.key)
    if len(devices) > 1:
      raise RuntimeError(f"CUDA graph capture of {prog.key} refused: its mesh spans "
                         f"{len(devices)} devices, a capture across cards is unrun")
    out = prog.body()
    self._capture(prog)
    return out

  def _capture(self, prog: Program) -> None:
    t0 = time.perf_counter()
    if self._pool is None:
      self._pool = torch.cuda.graph_pool_handle()
    before = _counters()
    graph = torch.cuda.CUDAGraph()
    try:
      with capture_guard(self.device):
        reserved = torch.cuda.memory_reserved(self.device)
        if prog.generator is not None:
          graph.register_generator_state(prog.generator)
        graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
        try:
          output = prog.body()
        except BaseException:
          with contextlib.suppress(Exception):
            graph.capture_end()
          raise
        graph.capture_end()
    except Exception as e:
      raise RuntimeError(f"CUDA graph capture of {prog.key} failed: {e}") from e
    finally:
      after = _counters()
      for (fn, attr), n in before.items():
        setattr(fn, attr, n)
    prog.graph, prog.output = graph, output
    prog.deltas = {k: after[k] - n for k, n in before.items() if after[k] != n}
    self.captures += 1
    self.capture_seconds += time.perf_counter() - t0
    self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved

  def _replay(self, prog: Program) -> None:
    try:
      prog.graph.replay()
    except Exception as e:
      raise RuntimeError(f"CUDA graph replay of {prog.key} failed: {e}") from e
    for (fn, attr), n in prog.deltas.items():
      setattr(fn, attr, getattr(fn, attr) + n)
    self.replays += 1

  def clear(self) -> None:
    """Drop every program with its graph and the slab (the engine's OOM recovery: the
    port's counterpart of `jax.clear_caches()`), and every dependent cache's. Their
    memory goes back to the allocator; the next use of a key captures it again, into a
    new pool."""
    for key in list(self.programs):
      self._drop(key)
    self.slab = None
    self._pool = None
    for dep in list(self.dependents):
      dep.clear()

  def _drop(self, key: tuple) -> None:
    prog = self.programs.pop(key)
    if prog.graph is not None:
      prog.graph.reset()
      if not any(p.graph is not None for p in self.programs.values()):
        # PyTorch frees a pool that no graph uses, and a capture into its handle then
        # fails: the next capture takes a new pool.
        self._pool = None


# ------------------------------------------------------------------ the slab copies

def slab_leaves(cache: Cache, rows: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
  """The (shape, dtype) of each leaf of `rows` stacked caches shaped like `cache`."""
  return {name: ((t.shape[0], rows) + tuple(t.shape[2:]), t.dtype) for name, t in cache.items()}


def stack_into(slab: Cache, caches: Sequence[Cache]) -> None:
  """Copy each member's [L, 1, S, ...] leaves (an int8 cache's scales too) into its row
  of the slab's [L, Bb, S, ...] views; rows past the members are zeroed."""
  for name, buf in slab.items():
    for i, c in enumerate(caches):
      buf[:, i:i + 1].copy_(c[name])
    if buf.shape[1] > len(caches):
      buf[:, len(caches):].zero_()


def split_from(slab: Cache, caches: Sequence[Cache]) -> None:
  """Copy each member's row of the slab back into its own cache, in place."""
  for name, buf in slab.items():
    for i, c in enumerate(caches):
      c[name].copy_(buf[:, i:i + 1])


# ------------------------------------------------------------------ decode

def _decode_program(gc: GraphCache, key: tuple, params, cache: Cache, cfg: ModelConfig, Bb: int,
                    top_k: int, top_p: float, route: Optional[QuantRoute],
                    generator: Optional[torch.Generator], noise: bool,
                    table_width: int = 0, uses_slab: bool = False,
                    extras: SamplerExtras = PLAIN) -> Program:
  device = gc.device
  V = cfg.vocab_size

  def make_statics():
    f32 = dict(dtype=torch.float32, device=device)
    st = {"tok": torch.zeros((Bb, 1), dtype=torch.int64, device=device),
          "pos": torch.zeros((Bb,), dtype=torch.int32, device=device),
          "temps": torch.zeros((Bb,), **f32),
          "out": torch.zeros((OUT_ROWS, Bb), dtype=torch.int64, device=device),
          "step": torch.zeros((1,), dtype=torch.int64, device=device)}
    if table_width:
      st["table"] = torch.zeros((Bb, table_width), dtype=torch.int32, device=device)
    if noise:
      st["gumbel"] = torch.zeros((OUT_ROWS, Bb, V), **f32)
    if extras.bias is not None:
      st["bias"] = torch.zeros((Bb, V), **f32)
    if extras.counts is not None:
      st["counts"] = torch.zeros((Bb, V), dtype=torch.int32, device=device)
      st["presence"] = torch.zeros((Bb,), **f32)
      st["frequency"] = torch.zeros((Bb,), **f32)
    if extras.min_p is not None:
      st["min_p"] = torch.zeros((Bb,), **f32)
    if extras.top_lp >= 0:
      K = extras.top_lp
      st["lp"] = torch.zeros((OUT_ROWS, Bb), **f32)
      st["top_ids"] = torch.zeros((OUT_ROWS, Bb, K), dtype=torch.int64, device=device)
      st["top_lps"] = torch.zeros((OUT_ROWS, Bb, K), **f32)
    return st

  def make_body(st):
    lp_out = (st["lp"], st["top_ids"], st["top_lps"]) if extras.top_lp >= 0 else None

    def body():
      return decode_step(params, st["tok"], cache, st["pos"], cfg, st["temps"], top_k, top_p,
                         use_flash_decode=True, generator=None if noise else generator,
                         gumbel=st.get("gumbel"), page_table=st.get("table"), route=route,
                         out=st["out"], step=st["step"], bias=st.get("bias"),
                         counts=st.get("counts"), presence=st.get("presence", 0.0),
                         frequency=st.get("frequency", 0.0), min_p=st.get("min_p"),
                         top_lp=extras.top_lp, lp_out=lp_out)[0]
    return body

  return gc.program(key, make_statics, make_body, generator=None if noise else generator,
                    uses_slab=uses_slab)


def _fill_rows(dst: torch.Tensor, src: torch.Tensor, pad: Optional[torch.Tensor]) -> None:
  """dst[:n] = src; the rows past it = `pad` (one row), or zeros."""
  n = src.shape[0]
  dst[:n].copy_(src)
  if dst.shape[0] > n:
    if pad is None:
      dst[n:].zero_()
    else:
      dst[n:].copy_(pad.expand_as(dst[n:]))


EXTRAS_BUFFERS = ("bias", "counts", "presence", "frequency", "min_p")


def _fill_extras(st: Dict[str, torch.Tensor], extras: SamplerExtras) -> None:
  """The extras' rows into their static buffers; pad rows zeroed."""
  for name in EXTRAS_BUFFERS:
    if name in st:
      _fill_rows(st[name], getattr(extras, name).to(st[name].dtype), None)


RECORDS = ("out", "lp", "top_ids", "top_lps")


def _run_steps(gc: GraphCache, prog: Program, num_tokens: int,
               gumbel: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
  """`num_tokens` runs of a decode program; returns its records, batch first: the
  tokens "out" [Bb, num_tokens] and, with logprobs, "lp" [Bb, num_tokens] and
  "top_ids" / "top_lps" [Bb, num_tokens, K]. The records are read every OUT_ROWS
  steps, and injected noise loaded as many rows at a time."""
  st = prog.statics
  names = [n for n in RECORDS if n in st]
  rows: Dict[str, List[torch.Tensor]] = {n: [] for n in names}
  for i in range(num_tokens):
    if i % OUT_ROWS == 0:
      if i:
        for name in names:
          rows[name].append(st[name].clone())
      st["step"].zero_()
      if gumbel is not None:
        n = min(OUT_ROWS, num_tokens - i)
        st["gumbel"][:n].copy_(gumbel[i:i + n])
    gc.run(prog)
  tail = num_tokens - OUT_ROWS * len(rows["out"])
  return {name: torch.cat(rows[name] + [st[name][:tail].clone()]).transpose(0, 1)
          for name in names}


def _sampler_key(top_k: int, top_p: float, gumbel: Optional[torch.Tensor],
                 generator: Optional[torch.Generator], route: Optional[QuantRoute],
                 extras: SamplerExtras = PLAIN) -> tuple:
  return (int(top_k), float(top_p or 0.0), gumbel is not None,
          None if gumbel is not None else generator, route) + extras.key()


def _finish(prog: Program, records: Dict[str, torch.Tensor], B: int, extras: SamplerExtras):
  """(The chunk's tokens [B, n], the logprob triple or None), the counts read back into
  extras.counts."""
  if extras.counts is not None:
    extras.counts.copy_(prog.statics["counts"][:B])
  report = None
  if extras.top_lp >= 0:
    report = tuple(records[n][:B] for n in ("lp", "top_ids", "top_lps"))
  return records["out"][:B], report


def decode_contiguous(gc: GraphCache, params, caches: Sequence[Cache], toks: torch.Tensor,
                      pos_vec: torch.Tensor, cfg: ModelConfig, num_tokens: int,
                      temps: torch.Tensor, top_k: int, top_p: float = 0.0,
                      route: Optional[QuantRoute] = None,
                      generator: Optional[torch.Generator] = None,
                      gumbel: Optional[torch.Tensor] = None,
                      extras: SamplerExtras = PLAIN):
  """`decode_chunk_batched` as graph replays: B requests' contiguous caches (one
  shape) stacked into the slab (pad rows to a power of two: zero caches with row 0's
  token, position and temperature), `num_tokens` replays of the step, the caches
  copied back into each request's own buffers. `gumbel` [num_tokens, Bb, V] injects
  noise. Returns ([B, num_tokens] tokens on the device, the logprob triple [B, n],
  [B, n, K], [B, n, K] when extras.top_lp >= 0, else None), extras.counts advanced."""
  B = len(caches)
  Bb = _bucket(B)
  leaves = slab_leaves(caches[0], Bb)
  key = (("decode", "contiguous", Bb, tuple((n, s, d) for n, (s, d) in leaves.items()))
         + _sampler_key(top_k, top_p, gumbel, generator, route, extras) + _mesh_key(params))
  with gc.on_stream():
    slab = gc.slab_views(leaves)
    stack_into(slab, caches)
    prog = _decode_program(gc, key, params, slab, cfg, Bb, top_k, top_p, route, generator,
                           gumbel is not None, uses_slab=True, extras=extras)
    st = prog.statics
    _fill_rows(st["tok"], toks.to(torch.int64), toks[:1].to(torch.int64))
    _fill_rows(st["pos"], pos_vec.to(torch.int32), pos_vec[:1].to(torch.int32))
    _fill_rows(st["temps"], temps.to(torch.float32), temps[:1].to(torch.float32))
    _fill_extras(st, extras)
    records = _run_steps(gc, prog, num_tokens, gumbel)
    split_from(slab, caches)
    return _finish(prog, records, B, extras)


def decode_paged(gc: GraphCache, params, arena: Cache, page_table: torch.Tensor,
                 toks: torch.Tensor, pos_vec: torch.Tensor, cfg: ModelConfig, num_tokens: int,
                 temps: torch.Tensor, top_k: int, top_p: float = 0.0,
                 route: Optional[QuantRoute] = None, generator: Optional[torch.Generator] = None,
                 gumbel: Optional[torch.Tensor] = None, extras: SamplerExtras = PLAIN):
  """`decode_chunk_paged` as graph replays over the context's page arena: the page
  table, tokens, positions and temperatures copied into the static buffers (pad rows:
  an all-zero table and position 0, row 0's token and temperature), `num_tokens`
  replays. Returns (tokens, logprob triple or None), as decode_contiguous."""
  B, width = page_table.shape
  Bb = _bucket(B)
  key = (("decode", "paged", Bb, width, arena["k"].data_ptr(),
          tuple((n, tuple(t.shape), t.dtype) for n, t in arena.items()))
         + _sampler_key(top_k, top_p, gumbel, generator, route, extras) + _mesh_key(params))
  with gc.on_stream():
    prog = _decode_program(gc, key, params, arena, cfg, Bb, top_k, top_p, route, generator,
                           gumbel is not None, table_width=width, extras=extras)
    st = prog.statics
    _fill_rows(st["table"], page_table.to(torch.int32), None)
    _fill_rows(st["tok"], toks.to(torch.int64), toks[:1].to(torch.int64))
    _fill_rows(st["pos"], pos_vec.to(torch.int32), None)
    _fill_rows(st["temps"], temps.to(torch.float32), temps[:1].to(torch.float32))
    _fill_extras(st, extras)
    records = _run_steps(gc, prog, num_tokens, gumbel)
    return _finish(prog, records, B, extras)


def host_copy(gc: GraphCache, t: torch.Tensor) -> Tuple[torch.Tensor, Any]:
  """A decode chunk's tokens on their way to the host without waiting for what the
  stream runs after them: copied into pinned host memory on the cache's stream, with
  an event recorded behind the copy. Returns (the host tensor, the event); the host
  tensor holds the tokens once `event.synchronize()` returns. (`t.cpu()` would wait
  for the whole stream, a chunk enqueued after `t` too.)"""
  with gc.on_stream():
    host = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
  return host, event


# ------------------------------------------------------------------ verify

def _verify_program(gc: GraphCache, key: tuple, params, target: Cache, cfg: ModelConfig,
                    T_pad: int, start_layer: int, route: Optional[QuantRoute],
                    table_width: int = 0) -> Program:
  device = gc.device

  def make_statics():
    st = {"x": torch.zeros((1, T_pad), dtype=torch.int64, device=device),
          "pos": torch.zeros((1,), dtype=torch.int32, device=device)}
    if table_width:
      st["table"] = torch.zeros((1, table_width), dtype=torch.int32, device=device)
    return st

  def make_body(st):
    return lambda: forward_argmax(params, st["x"], target, st["pos"], cfg,
                                  page_table=st.get("table"), start_layer=start_layer,
                                  route=route)[0]

  return gc.program(key, make_statics, make_body, uses_slab=not table_width)


def verify_contiguous(gc: GraphCache, params, x: torch.Tensor, cache: Cache, start_pos: int,
                      cfg: ModelConfig, start_layer: int = 0,
                      route: Optional[QuantRoute] = None) -> torch.Tensor:
  """`forward_argmax` of draft verification as one graph replay: the request's
  contiguous cache copied into the slab at one row, [prev_token] + draft ([1, T_pad],
  zero-padded to a power-of-two bucket) forwarded from `start_pos` through K2 (K2q),
  the cache copied back. Keys: the bucket and the cache's leaves. Returns the [1, T_pad]
  argmax on the device, the program's output buffer: read it before the next replay."""
  T_pad = x.shape[1]
  leaves = slab_leaves(cache, 1)
  key = ("verify", "contiguous", T_pad, tuple((n, s, d) for n, (s, d) in leaves.items()),
         start_layer, route) + _mesh_key(params)
  with gc.on_stream():
    slab = gc.slab_views(leaves)
    stack_into(slab, [cache])
    prog = _verify_program(gc, key, params, slab, cfg, T_pad, start_layer, route)
    prog.statics["x"].copy_(x)
    prog.statics["pos"].fill_(start_pos)
    preds = gc.run(prog)
    split_from(slab, [cache])
    return preds


def verify_paged(gc: GraphCache, params, x: torch.Tensor, arena: Cache, page_table: torch.Tensor,
                 start_pos: int, cfg: ModelConfig, start_layer: int = 0,
                 route: Optional[QuantRoute] = None) -> torch.Tensor:
  """`forward_argmax_paged` as one graph replay over the page arena: the request's
  [1, width] page table (already extended over the bucket; the width a power of two) in
  a static buffer, [prev_token] + draft read as a ragged query through K4 (K4q). Keys:
  the bucket, the table width and the arena. Returns the [1, T_pad] argmax on the
  device, the program's output buffer."""
  T_pad, width = x.shape[1], page_table.shape[1]
  key = ("verify", "paged", T_pad, width, arena["k"].data_ptr(),
         tuple((n, tuple(t.shape), t.dtype) for n, t in arena.items()), start_layer,
         route) + _mesh_key(params)
  with gc.on_stream():
    prog = _verify_program(gc, key, params, arena, cfg, T_pad, start_layer, route,
                           table_width=width)
    prog.statics["x"].copy_(x)
    prog.statics["pos"].fill_(start_pos)
    prog.statics["table"].copy_(page_table)
    return gc.run(prog)


# ------------------------------------------------------------------ the fused ring

def _ring_slab(gc: GraphCache, seg_caches: Sequence[Sequence[Cache]], rows: int):
  """Views over the ring cache's slab for every segment's `rows` stacked caches (leaves
  named '<segment>.<leaf>' in one slab). Returns (the per-segment views, the key of
  their shapes)."""
  leaves = {f"{i}.{name}": spec for i, caches in enumerate(seg_caches)
            for name, spec in slab_leaves(caches[0], rows).items()}
  views = gc.slab_views(leaves)
  slabs = [{name: views[f"{i}.{name}"] for name in caches[0]} for i, caches in enumerate(seg_caches)]
  return slabs, tuple((n, s, d) for n, (s, d) in leaves.items())


def decode_ring(gc: GraphCache, params_segs: Sequence, seg_caches: Sequence[Sequence[Cache]],
                toks: torch.Tensor, pos_vec: torch.Tensor, cfg: ModelConfig, num_tokens: int,
                temps: torch.Tensor, top_k: int, top_p: float = 0.0,
                start_layers: Sequence[int] = (0,), route: Optional[QuantRoute] = None,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
  """`decode_chunk_ring_batched` (and, at B=1, `decode_chunk_ring`) as replays of one
  captured composite step (`decode_step_ring`: every segment's K2 step, then the
  sampler). `seg_caches` holds, for each segment in ring order, the B requests'
  contiguous caches (one shape a segment); they are stacked into the ring cache's slab
  (pad rows to a power of two: zero caches with row 0's token, position and
  temperature), `num_tokens` replays run, and every cache is copied back. Keys: the
  bucketed batch, every segment's leaves (a mesh segment's cache pieces among them),
  the segments' first layers, the sampler's statics and each mesh segment's mesh
  (`_mesh_key`: segments may differ, some on a mesh, some not). Returns the
  [B, num_tokens] tokens on the device."""
  B = len(seg_caches[0])
  Bb = _bucket(B)
  noise = gumbel is not None
  with gc.on_stream():
    slabs, leaves_key = _ring_slab(gc, seg_caches, Bb)
    for slab, caches in zip(slabs, seg_caches):
      stack_into(slab, caches)
    key = (("decode", "ring", Bb, leaves_key, tuple(start_layers))
           + _sampler_key(top_k, top_p, gumbel, generator, route)
           + tuple(part for p in params_segs for part in _mesh_key(p)))

    def make_statics():
      st = {"tok": torch.zeros((Bb, 1), dtype=torch.int64, device=gc.device),
            "pos": torch.zeros((Bb,), dtype=torch.int32, device=gc.device),
            "temps": torch.zeros((Bb,), dtype=torch.float32, device=gc.device),
            "out": torch.zeros((OUT_ROWS, Bb), dtype=torch.int64, device=gc.device),
            "step": torch.zeros((1,), dtype=torch.int64, device=gc.device)}
      if noise:
        st["gumbel"] = torch.zeros((OUT_ROWS, Bb, cfg.vocab_size), dtype=torch.float32,
                                   device=gc.device)
      return st

    def make_body(st):
      return lambda: decode_step_ring(params_segs, st["tok"], slabs, st["pos"], cfg, st["temps"],
                                      top_k, top_p, start_layers, route,
                                      generator=None if noise else generator,
                                      gumbel=st.get("gumbel"), out=st["out"], step=st["step"])

    prog = gc.program(key, make_statics, make_body, generator=None if noise else generator,
                      uses_slab=True)
    st = prog.statics
    _fill_rows(st["tok"], toks.to(torch.int64), toks[:1].to(torch.int64))
    _fill_rows(st["pos"], pos_vec.to(torch.int32), pos_vec[:1].to(torch.int32))
    _fill_rows(st["temps"], temps.to(torch.float32), temps[:1].to(torch.float32))
    records = _run_steps(gc, prog, num_tokens, gumbel)
    for slab, caches in zip(slabs, seg_caches):
      split_from(slab, caches)
    return records["out"][:B]


def verify_ring(gc: GraphCache, params_segs: Sequence, x: torch.Tensor, caches: Sequence[Cache],
                start_pos: int, cfg: ModelConfig, start_layers: Sequence[int] = (0,),
                route: Optional[QuantRoute] = None) -> torch.Tensor:
  """`forward_argmax_ring` as one graph replay: every segment's cache copied into the
  ring cache's slab at one row, [prev_token] + draft ([1, T_pad]) through every segment
  (K2 at T > 1) from `start_pos`, the caches copied back. Keys: the bucket, every
  segment's leaves and first layers, each mesh segment's mesh. Returns the [1, T_pad] argmax on the device, the
  program's output buffer: read it before the next replay."""
  T_pad = x.shape[1]
  with gc.on_stream():
    slabs, leaves_key = _ring_slab(gc, [[c] for c in caches], 1)
    for slab, c in zip(slabs, caches):
      stack_into(slab, [c])
    key = (("verify", "ring", T_pad, leaves_key, tuple(start_layers), route)
           + tuple(part for p in params_segs for part in _mesh_key(p)))

    def make_statics():
      return {"x": torch.zeros((1, T_pad), dtype=torch.int64, device=gc.device),
              "pos": torch.zeros((1,), dtype=torch.int32, device=gc.device)}

    def make_body(st):
      return lambda: forward_argmax_ring(params_segs, st["x"], slabs, st["pos"], cfg,
                                         start_layers, route)[0]

    prog = gc.program(key, make_statics, make_body, uses_slab=True)
    prog.statics["x"].copy_(x)
    prog.statics["pos"].fill_(start_pos)
    preds = gc.run(prog)
    for slab, c in zip(slabs, caches):
      split_from(slab, [c])
    return preds


# ------------------------------------------------------------------ prefill

def prefill(gc: GraphCache, params, x: torch.Tensor, cache: Cache, start_pos: int,
            cfg: ModelConfig, chunk: int, is_first: bool = True, start_layer: int = 0,
            page_table: Optional[torch.Tensor] = None, route: Optional[QuantRoute] = None,
            want_hidden: bool = False) -> Optional[torch.Tensor]:
  """`prefill_scan` over x's whole segments of `chunk` tokens ([1, T] tokens or
  [1, T, H] hidden, T a multiple of `chunk`) from `start_pos`, one graph replay for
  each power-of-two group (`scan_groups`). A contiguous `cache` (the request's own) is
  copied into the slab and back; with `page_table` [1, width], `cache` is the page
  arena. Returns the [1, T, H] last-layer hidden states when `want_hidden`."""
  n_segs = x.shape[1] // chunk
  hidden = tuple(x.shape[2:])
  with gc.on_stream():
    if page_table is None:
      leaves = slab_leaves(cache, 1)
      target = gc.slab_views(leaves)
      stack_into(target, [cache])
      where = ("contiguous", tuple((n, s, d) for n, (s, d) in leaves.items()))
    else:
      target = cache
      where = ("paged", page_table.shape[1], cache["k"].data_ptr(),
               tuple((n, tuple(t.shape), t.dtype) for n, t in cache.items()))
    hs, pos = [], start_pos
    for off, g in scan_groups(n_segs):
      key = (("prefill",) + where + (g, chunk, is_first, x.dtype, hidden, start_layer, route)
             + _mesh_key(params))

      def make_statics(g=g):
        st = {"x": torch.zeros((1, g * chunk) + hidden, dtype=x.dtype, device=gc.device),
              "pos": torch.zeros((1,), dtype=torch.int32, device=gc.device)}
        if page_table is not None:
          st["table"] = torch.zeros(tuple(page_table.shape), dtype=torch.int32, device=gc.device)
        return st

      def make_body(st, g=g):
        return lambda: prefill_scan(params, st["x"], target, st["pos"], cfg, g, is_first=is_first,
                                    start_layer=start_layer, page_table=st.get("table"),
                                    route=route)[0]

      prog = gc.program(key, make_statics, make_body, uses_slab=page_table is None)
      st = prog.statics
      st["x"].copy_(x[:, off * chunk:(off + g) * chunk])
      st["pos"].fill_(pos)
      if page_table is not None:
        st["table"].copy_(page_table)
      h = gc.run(prog)
      if want_hidden:
        hs.append(h.clone())
      pos += g * chunk
    if page_table is None:
      split_from(target, [cache])
  if not want_hidden:
    return None
  return hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)
