"""Analytic cost model + live roofline attribution.

PERF.md's whole argument is a roofline ledger — every serving feature is
justified as "bytes per token" or "dispatches per token" — but until now the
numbers were hand-derived in markdown after a manual TPU harvest. This module
makes the ledger executable:

- `CostModel` computes, from the ModelConfig and the engine's serving
  configuration, the HBM bytes a dispatch must move (weight bytes by dtype
  including the int8 per-channel and int4 group-packed layouts of
  models/quantize.py, KV read bytes at the current depth for contiguous vs
  paged layouts) and the FLOPs it must execute. The weight math mirrors
  `models/transformer.init_random_params` + `models/quantize.quantize_params`
  shape for shape and is cross-checked in tests against
  `models/quantize.quantized_bytes` on real pytrees — if the layouts drift,
  the ground-truth test fails, not the dashboard.
- `PerfAttribution` turns those predictions plus the wall times the engine's
  drain loop ALREADY observes (timestamps at batcher boundaries — no new
  host syncs, no `block_until_ready`) into EWMA throughput/utilization
  gauges (`xot_decode_tok_s`, `xot_hbm_util_pct`, `xot_mfu_pct`) and a
  cumulative per-executable time/bytes table, served at `/v1/perf`.

Every input is host metadata (config ints, dtype byte widths, positions) and
every output a python int/float — computing a prediction can never add a
device sync. The quantized layout constants are imported from
models/quantize itself so there is exactly one source of truth for them.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from xotorch_tpu_torch.models.config import ModelConfig
from xotorch_tpu_torch.models.quantize import (
  _INT4_LAYER_SLOTS, LAYER_SLOTS, _group_size,
)

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def dtype_width(name: str) -> int:
  """Byte width of a compute dtype name (engine XOT_DTYPE vocabulary)."""
  return _DTYPE_BYTES.get(name, 2)


@dataclass(frozen=True)
class CostModel:
  """Analytic HBM-byte / FLOP model for one served shard.

  `dtype_bytes` is the compute dtype width (weights, norms, scales — the
  engine quantizes with scale_dtype = compute dtype); `quantize` is the
  weight format (None | "int8" | "int4"); `kv_quant` the KV-cache format
  (None | "int8"). Covers the text stack; vision towers and LoRA adapter
  leaves are O(rank·hidden) noise against the matmuls and are not counted.

  `tp` is the serving mesh's tensor-parallel width (engine._serving_mesh):
  the per-device byte methods divide exactly the axes
  parallel/mesh.spec_for_param shards, so a mesh run's roofline is the
  bytes ONE device must stream, not the fiction of the whole model on one
  chip. tp=1 makes every per-device method equal its global twin.
  """
  cfg: ModelConfig
  n_layers: int
  is_first: bool
  is_last: bool
  quantize: Optional[str] = None
  dtype_bytes: int = 2
  kv_quant: Optional[str] = None
  tp: int = 1
  # Absolute index of this shard's first layer: the paged KV read math is
  # per-LAYER when windows alternate (gemma2), and cfg.layer_window takes
  # absolute indices. 0 keeps every single-shard construction unchanged.
  start_layer: int = 0

  # ------------------------------------------------------------ weight bytes

  def _layer_slot_shapes(self) -> Dict[str, Tuple[int, ...]]:
    """Per-layer tensor shapes, mirroring init_random_params layer_params
    (the stacked [L, ...] axis is applied by the caller)."""
    cfg = self.cfg
    H, D = cfg.hidden_size, cfg.head_dim
    I = cfg.intermediate_size
    E, MI = cfg.num_experts, cfg.moe_intermediate_size or I
    shapes: Dict[str, Tuple[int, ...]] = {
      "attn_norm": (H,), "mlp_norm": (H,),
      "wq": (H, cfg.num_heads * D),
      "wk": (H, cfg.num_kv_heads * D),
      "wv": (H, cfg.num_kv_heads * D),
      "wo": (cfg.num_heads * D, H),
    }
    if cfg.sandwich_norms:
      shapes["post_attn_norm"] = (H,)
      shapes["post_mlp_norm"] = (H,)
    if cfg.attention_bias:
      shapes["bq"] = (cfg.num_heads * D,)
      shapes["bk"] = (cfg.num_kv_heads * D,)
      shapes["bv"] = (cfg.num_kv_heads * D,)
    if cfg.qk_norm:
      shapes["q_norm"] = (D,)
      shapes["k_norm"] = (D,)
    if cfg.is_moe:
      shapes["router"] = (H, E)
      shapes["we_gate"] = (E, H, MI)
      shapes["we_up"] = (E, H, MI)
      shapes["we_down"] = (E, MI, H)
    else:
      shapes["w_gate"] = (H, I)
      shapes["w_up"] = (H, I)
      shapes["w_down"] = (I, H)
    return shapes

  def n_params(self) -> int:
    """Total element count of the unquantized shard pytree (the bench's
    `sum(x.size)` over init_random_params leaves)."""
    cfg = self.cfg
    total = self.n_layers * sum(math.prod(s) for s in self._layer_slot_shapes().values())
    if self.is_first or cfg.tie_word_embeddings:
      total += cfg.vocab_size * cfg.hidden_size
    if self.is_last:
      total += cfg.hidden_size  # final_norm
      if not cfg.tie_word_embeddings:
        total += cfg.hidden_size * cfg.vocab_size
    return total

  def _quantized_slot_bytes(self, slot: str, shape: Tuple[int, ...], fmt: str) -> int:
    """Resident bytes of one stacked matmul slot [L, ...shape] under weight
    quantization — the exact layouts quantize_params produces."""
    L = self.n_layers
    elements = L * math.prod(shape)
    d_in = shape[-2]
    if (fmt == "int4" and slot in _INT4_LAYER_SLOTS
        and _group_size(d_in) % 2 == 0):
      # Packed uint8 nibbles (two values/byte) + one scale per (group, out).
      gs = _group_size(d_in)
      groups = d_in // gs
      return elements // 2 + L * groups * shape[-1] * self.dtype_bytes
    # int8 per-channel (also int4's fallback for MoE experts): 1 byte per
    # element + a scale vector with the contraction axis squeezed out.
    scale_elements = L * math.prod(shape) // d_in
    return elements + scale_elements * self.dtype_bytes

  def weight_bytes(self, fmt: Optional[str] = "__default__") -> int:
    """Predicted resident weight bytes for this shard. `fmt` defaults to the
    model's own quantization; pass None / "int8" / "int4" explicitly for the
    roofline-ceiling table. Matches models/quantize.quantized_bytes on the
    real pytree (ground-truth-tested)."""
    if fmt == "__default__":
      fmt = self.quantize
    cfg = self.cfg
    total = 0
    for slot, shape in self._layer_slot_shapes().items():
      if fmt in ("int8", "int4") and slot in LAYER_SLOTS:
        total += self._quantized_slot_bytes(slot, shape, fmt)
      else:
        total += self.n_layers * math.prod(shape) * self.dtype_bytes
    if self.is_first or cfg.tie_word_embeddings:
      n = cfg.vocab_size * cfg.hidden_size
      if fmt in ("int8", "int4"):  # embedding is int8 in BOTH quant formats
        total += n + cfg.vocab_size * self.dtype_bytes
      else:
        total += n * self.dtype_bytes
    if self.is_last:
      total += cfg.hidden_size * self.dtype_bytes  # final_norm
      if not cfg.tie_word_embeddings:
        n = cfg.hidden_size * cfg.vocab_size
        if fmt in ("int8", "int4"):
          total += n + cfg.vocab_size * self.dtype_bytes
        else:
          total += n * self.dtype_bytes
    return total

  # ------------------------------------------------------ mesh-aware (tp) math

  # Megatron layout (parallel/mesh.spec_for_param): column-parallel slots
  # shard their OUT axis over tp, row-parallel their contraction axis.
  _TP_COL_SLOTS = ("wq", "wk", "wv", "w_gate", "w_up", "we_gate", "we_up")
  _TP_ROW_SLOTS = ("wo", "w_down", "we_down")

  def _tp_width(self) -> int:
    return max(int(self.tp), 1)

  def weight_bytes_per_device(self, fmt: Optional[str] = "__default__") -> int:
    """Per-DEVICE resident weight bytes under the tp serving mesh — the
    mesh-aware twin of weight_bytes, mirroring parallel/mesh.spec_for_param
    placement for placement (ground-truth-tested against per-leaf
    `sharding.shard_shape` sizes on a sharded pytree): column slots divide
    their out axis, row slots their contraction axis, qkv biases follow
    their out axis, int8 scales follow their base slot's OUT axis (so row
    slots' scales replicate), the int4 grouped layout shards out on column
    slots and the GROUP axis on row slots (replicating when groups don't
    divide — the _int4_shape_guard fallback), and norms/router replicate.
    The engine only builds a mesh whose tp divides every dense dimension
    (engine._serving_mesh feasibility loop), so the dense divisions here
    are exact, never floor."""
    if fmt == "__default__":
      fmt = self.quantize
    tp = self._tp_width()
    if tp == 1:
      return self.weight_bytes(fmt)
    cfg = self.cfg
    L = self.n_layers
    total = 0
    for slot, shape in self._layer_slot_shapes().items():
      d_in = shape[-2] if len(shape) >= 2 else 1
      d_out = shape[-1]
      if not (fmt in ("int8", "int4") and slot in LAYER_SLOTS):
        n = L * math.prod(shape) * self.dtype_bytes
        if slot in self._TP_COL_SLOTS + ("bq", "bk", "bv") or slot in self._TP_ROW_SLOTS:
          n //= tp
        total += n
        continue
      gs = _group_size(d_in)
      if fmt == "int4" and slot in _INT4_LAYER_SLOTS and gs % 2 == 0:
        groups = d_in // gs
        payload = L * math.prod(shape) // 2
        gscale = L * groups * d_out * self.dtype_bytes
        if slot in self._TP_COL_SLOTS or groups % tp == 0:
          payload //= tp
          gscale //= tp
        total += payload + gscale
        continue
      payload = L * math.prod(shape)
      scale = L * math.prod(shape) // d_in * self.dtype_bytes
      if slot in self._TP_COL_SLOTS:
        payload //= tp
        scale //= tp
      elif slot in self._TP_ROW_SLOTS:
        payload //= tp  # per-out scale stays replicated on row slots
      total += payload + scale
    if self.is_first or cfg.tie_word_embeddings:
      # embedding [V, H] shards hidden; its per-row scale [V] replicates.
      n = cfg.vocab_size * cfg.hidden_size // tp
      if fmt in ("int8", "int4"):
        total += n + cfg.vocab_size * self.dtype_bytes
      else:
        total += n * self.dtype_bytes
    if self.is_last:
      total += cfg.hidden_size * self.dtype_bytes  # final_norm replicated
      if not cfg.tie_word_embeddings:
        # lm_head [H, V] shards vocab; its scale [V] shards with it.
        n = cfg.hidden_size * cfg.vocab_size // tp
        if fmt in ("int8", "int4"):
          total += n + cfg.vocab_size * self.dtype_bytes // tp
        else:
          total += n * self.dtype_bytes
    return total

  def _kv_tp(self) -> int:
    """KV divisor: cache_spec shards Hkv over tp, so per-device KV bytes
    divide by tp exactly when the head count does (always true on an
    engine-built mesh — num_kv_heads is in the feasibility dims)."""
    tp = self._tp_width()
    return tp if self.cfg.num_kv_heads % tp == 0 else 1

  def collective_bytes_per_token(self) -> int:
    """Per-device ICI bytes ONE decoded token moves under tp: two
    row-parallel psums per layer (the wo and w_down matmul outputs), each a
    ring all-reduce shipping 2·(tp-1)/tp of the hidden activation per
    device. 0 off-mesh — the term exists so mesh speedup claims subtract
    the collective tax instead of pretending ICI is free."""
    tp = self._tp_width()
    if tp == 1:
      return 0
    per_psum = 2 * (tp - 1) * self.cfg.hidden_size * self.dtype_bytes // tp
    return self.n_layers * 2 * per_psum

  # ---------------------------------------------------------------- KV bytes

  def _kv_token_bytes_one_layer(self, per_position_scale: bool = True) -> int:
    """HBM bytes of ONE cached token position in ONE layer (K + V rows,
    scale entries included under int8 KV — the arena pairs each int8 page
    with a per-(position, head) scale page from the same allocator)."""
    cfg = self.cfg
    per_pos = 2 * cfg.num_kv_heads  # K and V rows
    if self.kv_quant == "int8":
      b = per_pos * cfg.head_dim  # int8 payload
      if per_position_scale:
        b += per_pos * self.dtype_bytes  # one scale per (position, head)
      return b
    return per_pos * cfg.head_dim * self.dtype_bytes

  def _kv_token_bytes(self, per_position_scale: bool = True) -> int:
    """HBM bytes of ONE cached token position (K + V across this shard's
    layers, scales included under int8 KV)."""
    return self.n_layers * self._kv_token_bytes_one_layer(per_position_scale)

  def _paged_pages_read(self, depth: int, layer_idx: int, page: int) -> int:
    """Pages one decode step DMAs for one layer at `depth` resident tokens:
    the windowed kernels clamp their page walk to ceil over the layer's own
    window ([lo, hi] inclusive, lo = max(depth - w, 0) // page), and the
    engine's window release means the clamped-out pages aren't even
    resident. Global layers walk every occupied page. Ground-truth-tested
    against the arena's actual layout (tests/test_costmodel)."""
    d = max(int(depth), 1)
    hi = (d - 1) // page
    w = self.cfg.layer_window(layer_idx) if self.cfg.uses_sliding_window else 0
    lo = max(d - w, 0) // page if w > 0 else 0
    return hi - lo + 1

  def kv_resident_bytes(self, alloc_tokens: int, batch: int = 1) -> int:
    """Resident bytes of a contiguous cache allocation
    (transformer.init_kv_cache shape math)."""
    return batch * alloc_tokens * self._kv_token_bytes()

  def kv_read_bytes_per_token(self, depth: int, alloc_tokens: Optional[int] = None,
                              paged: bool = False, page: int = 128) -> int:
    """KV bytes one decode step must stream for one request at `depth`
    resident tokens. Contiguous XLA attention reads the whole ALLOCATED
    buffer (`alloc_tokens`); the paged kernel DMAs only the request's
    occupied pages (rounded up to page granularity, bounded per LAYER by
    that layer's sliding window — gemma2-style alternation reads full depth
    on global layers and ~window on sliding ones); flash-decode/occupancy
    paths read ~`depth` (pass alloc_tokens=None, paged=False)."""
    if paged:
      per_layer = self._kv_token_bytes_one_layer()
      return sum(self._paged_pages_read(depth, self.start_layer + i, page)
                 for i in range(self.n_layers)) * page * per_layer
    if alloc_tokens:
      tokens_read = alloc_tokens
    else:
      tokens_read = max(depth, 1)
    return tokens_read * self._kv_token_bytes()

  def kv_write_bytes_per_token(self) -> int:
    return self._kv_token_bytes()

  def kv_read_bytes_per_token_per_device(self, depth: int,
                                         alloc_tokens: Optional[int] = None,
                                         paged: bool = False, page: int = 128) -> int:
    """Per-device twin of kv_read_bytes_per_token: the cache/arena shards
    its Hkv axis over tp (parallel/mesh.cache_spec), so one chip streams
    1/tp of every position's K/V rows."""
    return self.kv_read_bytes_per_token(
      depth, alloc_tokens=alloc_tokens, paged=paged, page=page) // self._kv_tp()

  # ------------------------------------------------------------------- FLOPs

  def _attn_flops_per_pair(self) -> int:
    """QK^T and AV each cost 2·(num_heads·head_dim) FLOPs per (query,
    visible-key) pair, per layer."""
    return 4 * self.cfg.num_heads * self.cfg.head_dim

  def decode_flops_per_token(self, depth: int = 0) -> int:
    """2 MACs per resident matmul param plus attention over the visible
    context. MoE models route: only top-k experts' FLOPs count."""
    return (2 * self._active_matmul_params()
            + self.n_layers * depth * self._attn_flops_per_pair())

  def prefill_flops(self, tokens: int, start: int = 0) -> int:
    """Dense matmul FLOPs + causal attention: each of `tokens` new queries
    sees the `start` already-resident positions plus ~half of its own slice
    (T·start + T²/2 visible pairs). start=0 is the bench's from-zero
    prefill-MFU formula, now derived from one place."""
    pairs = tokens * start + tokens * tokens // 2
    return (2 * self._active_matmul_params() * tokens
            + self.n_layers * pairs * self._attn_flops_per_pair())

  def _active_matmul_params(self) -> int:
    """Params each token's forward actually multiplies through: for MoE,
    the shared projections + top-k experts (the routed gather reads only
    the chosen experts' weights); embedding lookup is a gather, not a
    matmul, but the tied/untied lm_head IS a matmul on the last shard."""
    cfg = self.cfg
    shapes = self._layer_slot_shapes()
    total = 0
    for slot, shape in shapes.items():
      if slot.startswith("we_") and cfg.num_experts_per_tok:
        total += math.prod(shape) // cfg.num_experts * cfg.num_experts_per_tok
      else:
        total += math.prod(shape)
    total *= self.n_layers
    if self.is_last:
      total += cfg.hidden_size * cfg.vocab_size  # unembed matmul (tied or not)
    return total

  # ------------------------------------------------------- dispatch roll-ups

  def decode_dispatch_cost(self, tokens: int,
                           rows: Sequence[Tuple[int, bool, Optional[int]]],
                           page: int = 128) -> Tuple[int, int]:
    """(hbm_bytes, flops) one fused/batched decode dispatch must move: the
    weight stream repeats once per scan step (each of `tokens` steps reads
    every resident weight byte), each row adds its per-step KV read at its
    own (depth, paged, alloc) and the per-step KV write. Under a tp mesh
    both terms are PER-DEVICE (sharded weight/KV streams) and so are the
    FLOPs — /v1/perf's HBM%/MFU gauges compare against ONE chip's peak."""
    wb = self.weight_bytes_per_device()
    kv_read = sum(
      self.kv_read_bytes_per_token(depth, alloc_tokens=alloc, paged=paged, page=page)
      for depth, paged, alloc in rows) // self._kv_tp()
    kv_write = len(rows) * self.kv_write_bytes_per_token() // self._kv_tp()
    bytes_total = tokens * (wb + kv_read + kv_write)
    flops = tokens * sum(self.decode_flops_per_token(depth)
                         for depth, _, _ in rows) // self._tp_width()
    return bytes_total, flops

  def prefill_dispatch_cost(self, tokens: int, chunk: int = 4096,
                            start: int = 0) -> Tuple[int, int]:
    """(hbm_bytes, flops) for prefilling `tokens` positions in `chunk`-sized
    segments on top of `start` already-resident ones (a chunked or
    co-scheduled prefill's later slices pass their offset so the attention
    over — and KV stream of — the positions earlier slices wrote is
    counted, not just the slice itself): one weight stream per segment,
    each segment's attention re-reads every prior position's KV, plus this
    slice's own KV writes."""
    c = max(chunk, 1)
    n_seg = max(1, math.ceil(tokens / c))
    kv_read_tokens = sum(start + min(i * c, tokens) for i in range(n_seg))
    bytes_total = (n_seg * self.weight_bytes_per_device()
                   + (kv_read_tokens * self._kv_token_bytes()
                      + tokens * self.kv_write_bytes_per_token()) // self._kv_tp())
    return bytes_total, self.prefill_flops(tokens, start) // self._tp_width()

  def verify_dispatch_cost(self, tokens: int, depth: int, paged: bool = False,
                           alloc_tokens: Optional[int] = None,
                           page: int = 128) -> Tuple[int, int]:
    """(hbm_bytes, flops) one K-token draft-VERIFY forward must move: ONE
    weight stream regardless of K (the entire speculation win — K accepted
    tokens ride a single pass of the resident weights), the KV read at the
    layout the request is actually served from (a paged verify streams only
    the request's occupied pages; contiguous reads its whole allocation),
    the K fresh positions' KV writes, and prefill-shaped causal attention +
    per-position unembed FLOPs (the verify argmaxes every position, not
    just the last). This is what keeps /v1/perf's MFU honest when
    speculation multiplies accepted tok/s past the plain-decode roofline."""
    kv_read = self.kv_read_bytes_per_token(
      depth + tokens, alloc_tokens=alloc_tokens, paged=paged, page=page)
    bytes_total = (self.weight_bytes_per_device()
                   + (kv_read + tokens * self.kv_write_bytes_per_token())
                   // self._kv_tp())
    return bytes_total, self.prefill_flops(tokens, depth) // self._tp_width()

  # ---------------------------------------------------------------- ceilings

  def ceilings(self, hbm_gbps: Optional[float]) -> Dict[str, Any]:
    """Batch-1 decode tok/s ceilings (peak HBM bandwidth ÷ resident weight
    bytes) for each weight format this model could serve in — the PERF.md
    roofline table, computed instead of hand-derived. On a tp mesh the
    tok/s ceiling uses the PER-DEVICE weight stream (the bytes one chip
    actually moves per step) and the per-device bytes appear alongside the
    global ones; the collective term is reported so the ceiling can be
    read as bandwidth-bound-minus-ICI-tax, not naive bytes/tp."""
    tp = self._tp_width()
    out: Dict[str, Any] = {"hbm_gbps": hbm_gbps, "tp": tp}
    for label, fmt in (("bf16", None), ("int8", "int8"), ("int4", "int4")):
      wb = self.weight_bytes(fmt)
      wbd = self.weight_bytes_per_device(fmt)
      out[f"{label}_weight_bytes"] = wb
      if tp > 1:
        out[f"{label}_weight_bytes_per_device"] = wbd
      out[f"{label}_tok_s"] = (round(hbm_gbps * 1e9 / wbd, 1)
                               if hbm_gbps and wbd else None)
    if tp > 1:
      out["collective_bytes_per_token"] = self.collective_bytes_per_token()
    return out


# ------------------------------------------------------------- attribution


class _Ewma:
  """Irregular-interval EWMA of a rate: each observation contributes
  `amount` over the wall interval since the previous one, blended with
  time-constant `tau` — so the gauge decays toward current behavior instead
  of averaging over the process lifetime."""

  __slots__ = ("tau", "rate", "_last_t")

  def __init__(self, tau: float):
    self.tau = max(float(tau), 1e-3)
    self.rate: float = 0.0
    self._last_t: Optional[float] = None

  def observe(self, amount: float, secs: float, now: float) -> None:
    if self._last_t is None:
      self.rate = amount / max(secs, 1e-9)
      self._last_t = now
      return
    dt = max(now - self._last_t, secs, 1e-9)
    alpha = 1.0 - math.exp(-dt / self.tau)
    self.rate = (1.0 - alpha) * self.rate + alpha * (amount / dt)
    self._last_t = now

  def peek(self, now: float) -> float:
    """Rate decayed for the silence since the last observation — an idle
    server's gauge must fall toward 0, not freeze at the last burst."""
    if self._last_t is None:
      return 0.0
    return self.rate * math.exp(-max(now - self._last_t, 0.0) / self.tau)


class PerfAttribution:
  """Cumulative + EWMA attribution of engine dispatch wall time.

  Fed exclusively from `_observe_dispatch` boundaries (timestamps the
  batcher already takes around its executor calls), so per-lane dispatch
  counts equal the jit first/cached counters by construction and the hot
  path gains ZERO device syncs. Thread-safe: the engine executor thread
  writes, /metrics and /v1/perf read."""

  def __init__(self, ewma_s: float = 30.0):
    self._lock = threading.Lock()
    self._execs: Dict[Any, Dict[str, Any]] = {}
    self._lanes: Dict[str, Dict[str, float]] = {}
    self._ewma_tok: Dict[str, _Ewma] = {}
    self._ewma_bytes = _Ewma(ewma_s)
    self._ewma_flops = _Ewma(ewma_s)
    self._ewma_s = ewma_s

  def observe(self, key: Any, lane: str, secs: float, tokens: int = 0,
              batch: int = 1, hbm_bytes: int = 0, flops: int = 0,
              now: Optional[float] = None) -> None:
    now = time.monotonic() if now is None else now
    with self._lock:
      row = self._execs.get(key)
      if row is None:
        row = self._execs[key] = {
          "lane": lane, "dispatches": 0, "secs": 0.0, "tokens": 0,
          "hbm_bytes": 0, "flops": 0, "batch_max": 0,
        }
      row["dispatches"] += 1
      row["secs"] += secs
      row["tokens"] += tokens
      row["hbm_bytes"] += hbm_bytes
      row["flops"] += flops
      row["batch_max"] = max(row["batch_max"], batch)
      lane_row = self._lanes.setdefault(lane, {
        "dispatches": 0, "secs": 0.0, "tokens": 0, "hbm_bytes": 0, "flops": 0,
      })
      lane_row["dispatches"] += 1
      lane_row["secs"] += secs
      lane_row["tokens"] += tokens
      lane_row["hbm_bytes"] += hbm_bytes
      lane_row["flops"] += flops
      ewma = self._ewma_tok.get(lane)
      if ewma is None:
        ewma = self._ewma_tok[lane] = _Ewma(self._ewma_s)
      ewma.observe(float(tokens), secs, now)
      if hbm_bytes:
        self._ewma_bytes.observe(float(hbm_bytes), secs, now)
      if flops:
        self._ewma_flops.observe(float(flops), secs, now)

  # -------------------------------------------------------------------- read

  def gauges(self, peak_gbps: Optional[float] = None,
             peak_tflops: Optional[float] = None) -> Dict[str, float]:
    """The /metrics gauge values, decayed for the silence since the last
    dispatch (an idle node reads ~0, not its last burst). Utilization
    gauges report 0.0 when the chip peak is unknown (CPU) — exporting
    nothing would make dashboards conditional on the backend."""
    now = time.monotonic()
    with self._lock:
      decode = self._ewma_tok.get("decode")
      prefill = self._ewma_tok.get("prefill")
      decode_rate = decode.peek(now) if decode else 0.0
      prefill_rate = prefill.peek(now) if prefill else 0.0
      bytes_s = self._ewma_bytes.peek(now)
      flops_s = self._ewma_flops.peek(now)
    return {
      "decode_tok_s": round(decode_rate, 3),
      "prefill_tok_s": round(prefill_rate, 3),
      "hbm_util_pct": (round(100.0 * bytes_s / (peak_gbps * 1e9), 3)
                       if peak_gbps else 0.0),
      "mfu_pct": (round(100.0 * flops_s / (peak_tflops * 1e12), 3)
                  if peak_tflops else 0.0),
    }

  def lanes(self) -> Dict[str, Dict[str, float]]:
    with self._lock:
      return {lane: dict(row) for lane, row in self._lanes.items()}

  def executables(self, top: int = 12) -> List[Dict[str, Any]]:
    """Cumulative per-executable rows, heaviest wall time first. The key is
    the engine's executable-identity tuple (batch width bucket, chunk size,
    sampling constants) rendered as a string."""
    with self._lock:
      rows = [{"key": repr(k), **v} for k, v in self._execs.items()]
    rows.sort(key=lambda r: r["secs"], reverse=True)
    for r in rows:
      r["secs"] = round(r["secs"], 6)
    return rows[:top]

  def compact(self) -> Dict[str, Any]:
    """Small JSON-safe summary for the status-bus rollup (one per topology
    tick — keep it a handful of scalars)."""
    g = self.gauges()
    lanes = self.lanes()
    return {
      "decode_tok_s": g["decode_tok_s"],
      "prefill_tok_s": g["prefill_tok_s"],
      "dispatches": int(sum(r["dispatches"] for r in lanes.values())),
      "tokens": int(sum(r["tokens"] for r in lanes.values())),
      "hbm_bytes": int(sum(r["hbm_bytes"] for r in lanes.values())),
      "secs": round(sum(r["secs"] for r in lanes.values()), 6),
    }
