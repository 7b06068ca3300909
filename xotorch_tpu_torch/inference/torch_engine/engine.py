"""TorchShardInferenceEngine: the port's compute backend for one NVIDIA GPU.

The port of the single-shard subset of xotorch_tpu/inference/jax_engine/engine.py:

- `ensure_shard` loads a shard: a card's HF safetensors checkpoint (dense, MoE, or
  llava with its vision tower and projector on the first shard) from the directory
  its downloader gives (models/weights.load_shard_params, straight to the device),
  with the tokenizer of that directory, or the DummyTokenizer and the config's eos
  where none can be built; a synthetic card's random weights from a seed. Weights are quantized on the device under `quantize=` / XOT_QUANTIZE (int8 or
  int4): decode projections then run the quantized GEMV kernels K5, K5v4 and K6
  (models/transformer._linear);
- `infer_sample_tensor` prefills in XOT_PREFILL_CHUNK segments and samples the first
  token on the device. A prompt's leading whole segments (all but the segment that
  holds its last token) fill the cache through `prefill_scan`, one program for each
  power-of-two group of segments (`_scan_prefill`, `_paged_fill_sync`), on a
  contiguous cache when there are at least two of them and XOT_SCAN_PREFILL is on
  (JAX's rule), on the page arena always; every segment of the scan goes through the
  cached kernel (K2, or K4 on the arena), the from-zero one too. Otherwise, and for the
  last segment (padded to a power-of-two bucket), a fresh request's first segment on
  a contiguous cache goes to the prefill kernel (K1) and later ones to K2; on the page
  arena every segment goes to K4;
- `generate_chunk` decodes K tokens per call with sampling on the device, with the
  same CacheExhausted semantics at XOT_MAX_CACHE_LEN. With XOT_DECODE_BATCH > 1 the
  call goes through the continuous batcher (`_DecodeBatcher`), which coalesces
  concurrent requests' chunks into one batched dispatch: over stacked contiguous
  caches through K2 (XOT_PAGED_KV=0, the default), or over the shared page arena
  through K3 (XOT_PAGED_KV=1);
- on the card every decode chunk and every scan-prefill group runs as CUDA-graph
  replays (models/graphs.py: one captured decode step replayed K times, one captured
  group of segments; contiguous caches copied through the context's slab). No eager
  path runs instead: a failed capture raises, naming its key. The CPU runs the same
  step and scan eagerly (models/generate.py);
- `infer_tensor` / `sample` keep the per-token contract of the ring: a partition's
  hidden state leaves in the model's dtype (bf16 on the card) for the next peer;
- `infer_prompt(images=)` is the multimodal prefill (JAX's): the images through the
  vision tower and projector, spliced in at the prompt's `<image>` placeholders, the
  merged sequence through the text stack from position 0 (K1 on the card); its logits
  come back to the host, where `sample` takes the first token with the request's
  extras and `attach_sampling` binds them to the decode state;
- OpenAI's sampling extras (`sampling=` of infer_sample_tensor: seed, logit_bias,
  presence/frequency penalties, min_p, logprobs) become the request's extras state
  (`_build_extras`) on the peer that samples: a dense [1, V] bias, [1, V] counts of the
  sampled tokens (the prompt carries no penalty), the values the sampler reads, and a
  seed whose stream derives from (seed, the sampled token's absolute position, the
  choice index of an `n` sibling `rid#i`). An extras request decodes in a chunk of its
  own, never in the batcher, contiguous or paged; on the card its chunk replays the
  decode graph keyed by which extras it has, with their values in static buffers.
  Logprob records wait in a bounded LRU for `pop_logprobs`.

Per-request state is either a contiguous [L, 1, S, Hkv, D] KV cache that grows by
powers of two, or (XOT_PAGED_KV=1) a VirtualKV handle of pages in the context's
PagePool, plus a position. With `kv_quant="int8"` / XOT_KV_QUANT=int8 both hold int8
K/V with a scale per (position, head), and attention takes the kernels' int8
variants (K2q, K3q, K4q). Every device computation runs on one executor thread (`_run`,
which counts the calls in flight for `dispatch_inflight`, the Node stall watchdog's
sign of active local work: a first request's CUDA-graph captures defer a stall abort
as XLA compiles do in the JAX package); an asyncio lock serialises shard loads. The engine reads its knobs when it is built.
It runs on `cuda` unless the caller passes device="cpu" (the tests do), and raises
when no GPU is present rather than falling back to the CPU.

Observability (the JAX engine's hooks): the owning Node installs its `metrics`,
`flight`, `tracer` and `trace_ctx`; `perf` is the engine's PerfAttribution
(XOT_PERF_ATTR). Each dispatch (one executor call that ends in the readback the path
already does: a prefill with its scan groups, a mid-ring segment, a decode chunk of
1..B rows, a per-token ring step) is observed once (`_observe_dispatch`): its wall
time from host timestamps taken at its start and after that readback, and the cost
model's bytes and FLOPs for what it ran (inference/torch_engine/costmodel.py, bound to
the context at load). A dispatch that captured a CUDA graph, or that ran an eager key
for the first time, counts as a first dispatch (`xot_jit_first_dispatch_total`) and
records an `engine.compile` flight event. Nothing here adds a device sync.

KV reuse and prefill scheduling (the JAX engine's defaults):

- the prefix cache (XOT_PREFIX_CACHE entries a context, LRU; XOT_PREFIX_CACHE_MIN
  tokens at least): a finished prefill's KV is kept, keyed by its prompt, and a fresh
  prompt sharing a long head with an entry seeds its state from it and prefills only
  the rest (`_prefix_reuse`, `_prefix_store`). A contiguous entry is a clone of the
  cache's first T positions; a paged entry holds references to the prompt's whole
  pages, which a warm paged request takes in place as the head of its page table
  (shared pages are never written: reuse rounds down to whole pages and writes land
  at pos // page). Under pool pressure entries yield to live requests
  (`_pool_alloc`);
- the host KV tier (XOT_KV_HOST_BYTES, kv_offload.HostKVStore): an evicted entry is
  copied to host RAM first, and a prompt that the device cache misses but the host
  tier covers is restored into fresh pages or a fresh snapshot (`_host_promote`)
  before it prefills; `prefetch_host_prefix` does that for a queued prompt. A
  restore that fails degrades to a cold prefill (counted in
  `_host_restore_fallbacks`);
- the KV fabric (fabric/, XOT_FABRIC_*): a prompt the device cache and the local host
  tier miss imports a sibling replica's host entry over HTTP, its digest verified, and
  restores it as a local spill (`_fabric_consult` inside `_host_promote`); offers
  (`fabric_offer`, `prefetch_fabric_offer`) and a prefill replica's handle
  (`prefill_export`) let the router split prefill from decode. Every fabric failure is
  counted (`_fabric_errors`) and prefills cold;
- co-scheduled prefill (XOT_PREFILL_COSCHED, XOT_PREFILL_CHUNK_BUDGET): while other
  requests are active, a prompt longer than one segment prefills through the
  batcher's prefill lane in slices of XOT_PREFILL_CHUNK_BUDGET segments, one slice a
  drain cycle after the cycle's decode dispatches (`_prefill_and_sample`);
- OOM recovery: a device out-of-memory error in a serving call spills and drops
  every prefix entry, drops every request state (their next touch raises
  RequestStateLost), the page pool, the captured CUDA graphs and the slab, and is
  answered as CacheExhausted (`_run`, `_free_device_memory`).

Resident models (XOT_MAX_RESIDENT_MODELS, the JAX engine's LRU of contexts): each
model keeps its weights, request states, page pool, prefix cache, captured graphs and
slab in a context of its own, so a second model leaves the first one's in-flight
requests as they were. Past the bound the least recently used context goes, one with
no request states first; its graphs are reset and its slab dropped on the executor,
outside any capture, never left to the garbage collector (`_evict_context`). Every
call resolves the context of its own shard; `_active` is the one loaded or touched
last.

Overlapped decode chunks (XOT_OVERLAP_CHUNKS, on; XOT_OVERLAP_BATCH for batches, off):
a solo greedy or sampled chunk on a contiguous cache dispatches the caller's next
chunk (`next_size`) from its own last token on the device before it reads its tokens
back, so the card runs chunk N+1 while the host takes chunk N. The next call takes that
result when its request matches the record (`_spec_next`, `ctx.batch_spec`) and rolls
the position back when it does not; every other touch of the request discards the
record first (`_discard_spec`), and capacity is judged by the committed position
(`_committed_pos`). The paged path runs no chunk ahead, as in JAX.

Speculative decoding (the Node's XOT_SPECULATE, XOT_DRAFT_MODEL): `verify_draft` runs
[prev_token] + draft through the model once, takes the longest prefix of the draft
that the model's own argmax agrees with and the model's next token after it, and
rolls the position back over the rest: on a contiguous cache through K2 at T > 1, on
the page arena natively through K4 (`_verify_draft_paged_sync`, XOT_PAGED_SPEC), on the
card as one captured graph a bucket (models/graphs.verify_contiguous / verify_paged).
`draft_tokens` proposes k tokens from a second resident context (the draft model),
greedy, through its own decode graphs.

Multi-LoRA serving (XOT_ADAPTERS, the JAX engine's): a `base@name` shard is a context
of its own whose base tensors alias a resident context over the same base and layers
(the same storage: one base on the card, whatever the number of adapters), with the
registered adapter merged over them (train/lora.py); models/transformer adds each
adapted slot's delta. With no donor resident the base loads for it as for a plain id.
Its requests, batcher, page pool, prefix cache, host-tier entries and graphs are its
own, so no KV computed under another adapter or the base is ever reused. Evicting a
donor frees nothing that an adapter context still holds: the tensors go with their
last reference. `load_checkpoint` / `save_checkpoint` move adapter-only files, shard
saves and full checkpoints (the JAX engine's, without the optimizer's moments).

Training (the JAX engine's): `train_example`, `evaluate_example`, `save_session` and the
moments file serve every family, as in JAX: qwen3-moe through its router and experts
(the dense combine at B*T > 8, the routed gather at or under it; int8 experts frozen
under QLoRA, never an adapter site) and llava on its text path (the tower stays in
`ctx.vision`, outside the params).

Co-located partitions (the JAX engine's `supports_device_io` and
`supports_ring_fusion`): `infer_prompt` / `infer_tensor` with `keep_on_device` hand the
output to a next partition in this process as the device tensor (counted in
`device_hops`; a hop to the host counts its bytes in `host_hop_bytes`).
`generate_chunk_ring`, driven from the last partition's engine, decodes a chain of
partitions in this process in fused chunks: on the card replays of one captured
composite step over every segment (models/graphs.decode_ring, a graph cache of its own
that every segment's cache drops with it), with the solo overlap (`_ring_spec`), a
batcher a chain (`_ring_batch_sync`) and the ring's verify (`verify_draft_ring`). It
declines (`_ring_declines`), and the Node takes the per-token ring, only where JAX's
does: a request with sampling extras, a chain that does not cover the layers
contiguously, positions out of lockstep (and, batched, a member without room).

Serving over a local mesh (the JAX engine's `_serving_mesh`): XOT_TP (over
XOT_SERVE_TP; CLI --serve-tp), XOT_SERVE_SP and XOT_SERVE_EP build a mesh over
parallel/mesh.local_devices() for each shard at its load, with JAX's clamps; unset, tp
stays one position where JAX takes every local card (a mesh over distinct cards is
unrun: the graph cache refuses to capture one). The weights are split per mesh position
(parallel/mesh.shard_params), caches and the page arena over tp along the kv heads, and
every forward runs the transformer's mesh path: each position's kernels on its own
heads and slices, the collectives written out (models/transformer._forward_mesh). A
whole-model shard under sp prefills its from-zero segment by ring attention
(`_ring_prefill`, counted in `sp_ring_prefills`). LoRA serves and trains over the mesh
as in JAX: the adapters (XOT_LORA_RANK, XOT_ADAPTERS, a `base@name` context aliasing
its donor's pieces) are whole leaves replicated to every position, attached after the
base is split. `train_example` and `evaluate_example` run the training forward over the
mesh (each tp position's K1 and K1b on its heads), the optimizer is a
parallel/zero.MeshAdamW over the pieces, and `load_checkpoint` / `save_checkpoint`
read and write the single device's files (whole leaves, gathered from the pieces; the
moments file in JAX's layout). Every path JAX serves under its mesh serves here too:
vision (the tower and projector once on the engine's device, unsharded; the merged
sequence a replicated hidden input, by ring attention under sp), the fused in-process
ring (segments on meshes or not, each program keyed by every segment's mesh) and the
KV fabric (the host tier holds whole leaves, JAX's layout: kv_offload.join_pieces on
spill, split_pieces on restore, so a tp replica and a single-card one, of either
package, import each other's entries). An engine inside a process group (XOT_COORDINATOR,
XOT_MULTIHOST; main.py joins it) serves its own local mesh as its own peer, as every
rank of JAX's main.py does.

Paged attention always reads the pages in place through K3/K4 (K3q/K4q): XOT_PAGED_KERNEL
unset or `1` is that, and `0`, the JAX package's XLA gather, is refused when the engine
is built, as XOT_RAGGED_PREFILL=0 is.
"""
from __future__ import annotations

import asyncio
import contextlib
import hashlib
import threading
import time
import weakref
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from functools import partial
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from xotorch_tpu_torch.inference.engine import CacheExhausted, InferenceEngine, RequestStateLost
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer, tokenizer_for_dir
from xotorch_tpu_torch.inference.torch_engine import vkv
from xotorch_tpu_torch.inference.torch_engine.costmodel import CostModel, PerfAttribution, _Ewma, dtype_width
from xotorch_tpu_torch.inference.torch_engine.kv_offload import (HostKVStore, common_prefix_len,
                                                                join_pieces, split_pieces)
from xotorch_tpu_torch.inference.torch_engine.paged_cache import (PagePool, commit_pages, from_host,
                                                                  gather_pages, migrate_pages,
                                                                  scatter_pages, to_host)
from xotorch_tpu_torch.inference.torch_engine.vkv import VirtualKV
from xotorch_tpu_torch.models.config import ModelConfig, config_from_hf_dict, load_model_config
from xotorch_tpu_torch.models import graphs
from xotorch_tpu_torch.models.generate import (decode_chunk_batched, decode_chunk_paged,
                                               decode_chunk_ring, decode_chunk_ring_batched,
                                               forward_argmax, forward_argmax_paged,
                                               forward_argmax_ring, forward_sample, prefill_scan,
                                               scan_groups)
from xotorch_tpu_torch.models.quantize import (QUANT_DTYPES, dequantize_params, is_quantized,
                                               quantize_params, quantized_bytes)
from xotorch_tpu_torch.models.registry import (adapter_path, build_full_shard, get_model_card,
                                               split_adapter)
from xotorch_tpu_torch.models.transformer import (embed, forward_shard, init_kv_cache,
                                                  init_random_params, quant_route)
from xotorch_tpu_torch.models.vision import (encode_images, merge_image_features, preprocess_images,
                                             project_features)
from xotorch_tpu_torch.models.weights import load_shard_params, load_vision_tower, save_shard_params
from xotorch_tpu_torch.ops import flash_attention, flash_decode, paged_attention
from xotorch_tpu_torch.ops.sampling import (DEFAULT_TEMP, DEFAULT_TOP_K, sample_logits,
                                            sample_logits_logprobs)
from xotorch_tpu_torch.parallel.mesh import (Mesh, MeshParams, cache_device, device_bytes,
                                             gather_params, local_devices, make_mesh,
                                             shard_params, with_layers)
from xotorch_tpu_torch.topology.device_capabilities import cuda_chip_peaks
from xotorch_tpu_torch.train import lora, optstate
from xotorch_tpu_torch.train import step as train_step
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG, spawn_detached

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}

# The grad mode each executor call runs in (`_run`): serving never records autograd
# state; loads make ordinary tensors (an inference tensor cannot be saved for backward);
# training records it.
GRAD_MODES = {"serve": torch.inference_mode, "load": torch.no_grad, "train": torch.enable_grad}


def _is_device_oom(e: BaseException) -> bool:
  """torch's OutOfMemoryError, or a RuntimeError whose text says the device is out of
  memory (a CUDA error, or a graph capture that failed on one)."""
  return (isinstance(e, torch.OutOfMemoryError)
          or (isinstance(e, RuntimeError) and "out of memory" in str(e).lower()))


def _bucket(n: int, minimum: int = 16) -> int:
  b = minimum
  while b < n:
    b *= 2
  return b


def resolve_device(device: Optional[str]) -> torch.device:
  """`cuda` unless the caller asks for the CPU; no GPU and no CPU request raises."""
  dev = torch.device(device or "cuda")
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device: xotorch_tpu_torch runs on an NVIDIA GPU; "
                       "pass device='cpu' (--device cpu) to run on the CPU")
  if dev.type not in ("cuda", "cpu"):
    raise ValueError(f"unsupported device {dev}")
  return dev


@dataclass
class _RequestState:
  cache: Optional[Dict[str, torch.Tensor]]  # {"k", "v"[, "k_scale", "v_scale"]}: [L, 1, S, ...]; None when paged
  pos: int  # tokens already resident in the cache
  last_used: float
  pages: Optional[VirtualKV] = None  # the request's pool pages (XOT_PAGED_KV=1)
  # Shared prefix pages a contiguous prefill seeded from (XOT_PAGED_PREFILL=0), held
  # until the commit puts them at the head of the page table.
  paged_seed: Optional[list] = None
  # OpenAI sampling extras (_build_extras): one row of bias, counts, penalties, min-p,
  # logprobs and the seed. None = a plain request, which the batcher may group.
  extras: Optional[graphs.SamplerExtras] = None


@dataclass
class _ShardContext:
  shard: Shard
  cfg: ModelConfig
  params: Any
  cache_len: int
  max_cache_len: int
  tokenizer: Any
  states: "OrderedDict[str, _RequestState]"
  batcher: Optional["_DecodeBatcher"] = None
  page_pool: Optional[PagePool] = None
  model_dir: Optional[Path] = None  # the checkpoint's directory; None for synthetic cards
  graphs: Optional[graphs.GraphCache] = None  # the captured programs, on the card
  costmodel: Optional[CostModel] = None  # the shard's analytic bytes and FLOPs
  # The prefix cache: prompt hash -> (prompt tokens, entry), least recently used first.
  # An entry is a contiguous snapshot {leaf: [L, 1, T, ...]} or, under XOT_PAGED_KV,
  # {"pages": the prompt's whole pages (one reference each), "len": tokens covered}.
  prefix_cache: "OrderedDict[int, Tuple[np.ndarray, dict]]" = field(default_factory=OrderedDict)
  # The batched chunk dispatched ahead (XOT_OVERLAP_BATCH), or None.
  batch_spec: Optional[dict] = None
  # A multimodal first shard's (vision tower, projector) params on the device, or None.
  vision: Optional[Tuple[Dict[str, Any], Dict[str, Any]]] = None
  # Training: the AdamW over `opt_leaves` (the trainable tensors in JAX's flatten
  # order), made at the first step; a load resets it.
  optimizer: Optional[torch.optim.Optimizer] = None
  opt_leaves: Optional[List[torch.Tensor]] = None
  # The serving mesh (`_serving_mesh`) the params are placed on, or None; the weights'
  # bytes over every position (one replica), counted before the split.
  mesh: Optional[Mesh] = None
  weight_bytes: int = 0


class _Pending(NamedTuple):
  """One request's decode chunk waiting for a dispatch."""
  request_id: str
  state: _RequestState
  prev_token: int
  num_tokens: int
  temp: float
  top_k: int
  top_p: float
  future: Optional[asyncio.Future]
  enqueued: float = 0.0  # monotonic time of the submit (the batcher's queue wait)
  next_size: Optional[int] = None  # the caller's next chunk: dispatched ahead when it may be


class _DecodeBatcher:
  """Continuous batching at chunk granularity (the port of the JAX engine's
  _DecodeBatcher).

  Concurrent requests each drive their own decode loop; this collector coalesces
  their generate_chunk calls into ONE batched dispatch per drain cycle. Coalescing
  comes from the drain loop, not a timer: while one batch computes on the engine's
  executor, every request that becomes ready queues into `pending`, and the next
  cycle takes them all, so the batch width follows the load. Rows are grouped by
  (top_k, top_p); temperature is per row. A group runs at its smallest requested
  size (bigger requesters loop again) and is cut at XOT_DECODE_BATCH rows. When the
  queue drains, the idle slot goes to one bounded page-pool defrag pass.

  The drain cycle also co-schedules prefill: `pending_prefill` holds bounded prompt
  slices (the engine's _prefill_and_sample cuts a long prompt into calls of
  XOT_PREFILL_CHUNK_BUDGET segments) and each cycle runs its decode dispatches first,
  then ONE slice, so the streams already decoding stall at most one slice a cycle,
  never a whole prompt.

  A fused ring's batcher (`generate_chunk_ring`, one a chain) has no context of its
  own: `dispatch` is the engine's `_ring_batch_sync`, and a submitted item's `state`
  slot carries the request's ring segments."""

  def __init__(self, engine: "TorchShardInferenceEngine", ctx: Optional[_ShardContext],
               dispatch=None):
    self.engine = engine
    self.ctx = ctx
    # (items, num_tokens, top_k, top_p) -> one result a row (None: the row declined).
    self.dispatch = dispatch or partial(engine._decode_batch_sync, ctx)
    self.pending: List[_Pending] = []
    # (call, future, enqueue time, tokens, dispatch key, start position) a slice
    self.pending_prefill: list = []
    self._draining = False
    self._drain_task = None  # strong ref: the loop only weakly holds tasks
    # Dispatches run, rows over all of them (mean width = rows / dispatches), and
    # decode steps over all of them.
    self.dispatches = 0
    self.rows = 0
    self.steps = 0
    self.slices = 0  # prefill slices run

  def _start(self) -> None:
    if not self._draining:
      self._draining = True
      self._drain_task = spawn_detached(self._drain())

  async def submit_prefill(self, fn, tokens: int = 0, key: Optional[tuple] = None,
                           start: int = 0) -> Any:
    """Run `fn` (a call for the executor) as one prefill slice of the drain cycle; its
    result or exception. FIFO across requests; a request's slices stay in order because
    its prefill coroutine awaits each before it submits the next. `tokens`, `key` and
    `start` are the slice's attribution (positions run, dispatch key, positions already
    resident); key None (the prologue, a host-tier restore) is not observed."""
    fut = asyncio.get_running_loop().create_future()
    self.pending_prefill.append((fn, fut, time.monotonic(), tokens, key, start))
    self._start()
    return await fut

  async def submit(self, request_id: str, state: _RequestState, prev_token: int,
                   num_tokens: int, temp: float, top_k: int, top_p: float,
                   next_size: Optional[int] = None) -> np.ndarray:
    fut = asyncio.get_running_loop().create_future()
    self.pending.append(_Pending(request_id, state, prev_token, num_tokens, temp, top_k, top_p,
                                 fut, time.monotonic(), next_size))
    self._start()
    return await fut

  async def _run_slice(self) -> None:
    """The oldest prefill slice, observed as one prefill dispatch; its outcome goes to
    its own future (a slice's failure fails only its request)."""
    fn, fut, enqueued, tokens, key, start = self.pending_prefill.pop(0)
    eng = self.engine
    if eng.metrics is not None:
      eng.metrics.queue_wait_prefill.observe(time.monotonic() - enqueued)
    try:
      t0, captures = time.monotonic(), eng._captures(self.ctx)
      res = await eng._run(fn)
      secs = time.monotonic() - t0
      if eng.flight is not None:
        eng.flight.record("batcher.prefill_slice", None, secs=round(secs, 6))
      if key is not None:
        eng._observe_dispatch("prefill", key, secs, tokens=tokens, ctx=self.ctx, start=start,
                              captured=max(0, eng._captures(self.ctx) - captures))
      self.slices += 1
      if not fut.done():
        fut.set_result(res)
    except Exception as e:
      if not fut.done():
        fut.set_exception(e)

  async def _drain(self) -> None:
    batch: List[_Pending] = []
    try:
      # One wait before the first take (an event-loop tick at XOT_BATCH_WINDOW_MS=0):
      # loops woken in the same pass coalesce at once.
      await asyncio.sleep(self.engine.batch_window_s)
      while self.pending or self.pending_prefill:
        batch, self.pending = self.pending, []
        m = self.engine.metrics
        if m is not None and batch:
          take_t = time.monotonic()
          for it in batch:
            m.queue_wait_decode.observe(take_t - it.enqueued)
        groups: Dict[Tuple[int, float], List[_Pending]] = {}
        for item in batch:
          groups.setdefault((item.top_k, item.top_p), []).append(item)
        cap = max(1, self.engine.decode_batch)
        for (top_k, top_p), items in groups.items():
          items.sort(key=lambda it: it.request_id)
          num_tokens = min(it.num_tokens for it in items)
          for off in range(0, len(items), cap):
            chunk = items[off:off + cap]
            try:
              t0 = time.monotonic()
              results = await self.engine._run(self.dispatch, chunk, num_tokens, top_k, top_p)
              steps = max((len(r) for r in results if r is not None), default=0)
              fl = self.engine.flight
              if fl is not None:
                fl.record("batcher.dispatch", None, lead=chunk[0].request_id, batch=len(chunk),
                          tokens=steps, secs=round(time.monotonic() - t0, 6))
              self.dispatches += 1
              self.rows += sum(r is not None for r in results)
              self.steps += steps
              for it, toks in zip(chunk, results):
                if not it.future.done():
                  it.future.set_result(toks)
            except Exception as e:  # fails this dispatch's requests, not the loop
              for it in chunk:
                if not it.future.done():
                  it.future.set_exception(e)
        # Decode went first; now one prefill slice.
        if self.pending_prefill:
          await self._run_slice()
        # Let the resolved requests' loops take their tokens and submit again before
        # the next take, so steady-state batches stay wide.
        await asyncio.sleep(0)
      pool = self.ctx.page_pool if self.ctx is not None else None
      if pool is not None and self.engine.defrag and pool.fragmentation() > 0:
        try:
          await self.engine._run(self.engine._defrag_sync, self.ctx)
        except Exception as e:  # an idle pass: a failure must not fail a request
          if DEBUG >= 1:
            print(f"idle defrag pass failed (ignored): {e!r}")
    except Exception as e:
      # A failure outside a dispatch must fail every waiting submitter: a future
      # nobody resolves would hang its request forever.
      failed, self.pending = self.pending, []
      failed_prefill, self.pending_prefill = self.pending_prefill, []
      futures = [it.future for it in batch + failed] + [item[1] for item in failed_prefill]
      for fut in futures:
        if not fut.done():
          fut.set_exception(e)
    finally:
      self._draining = False
      if self.pending or self.pending_prefill:
        # A submit slipped in after the last take and saw _draining set.
        self._start()


class TorchShardInferenceEngine(InferenceEngine):
  def __init__(self, shard_downloader=None, dtype: Optional[str] = None,
               device: Optional[str] = None, seed: Optional[int] = None,
               quantize: Optional[str] = None, kv_quant: Optional[str] = None):
    self.device = resolve_device(device)
    self.shard_downloader = shard_downloader
    self.dtype = DTYPES[dtype or knobs.get_str("XOT_DTYPE")]
    # Weight-only quantization (models/quantize.py), applied on the device right after
    # the weights are made: `quantize=` or XOT_QUANTIZE (CLI --quantize).
    self.quantize = (quantize or knobs.get_str("XOT_QUANTIZE", "")).lower() or None
    if self.quantize is not None and self.quantize not in QUANT_DTYPES:
      raise ValueError(f"Unsupported quantization {self.quantize!r}; have {sorted(QUANT_DTYPES)}")
    # Which kernels the quantized decode projections take, decided here once.
    self.quant_route = quant_route(self.device.type == "cuda")
    # int8 KV cache (models/transformer.init_kv_cache kv_quant): half the cache bytes
    # per resident token. `kv_quant=` or XOT_KV_QUANT (CLI --kv-quantize).
    self.kv_quant = (kv_quant or knobs.get_str("XOT_KV_QUANT", "")).lower() or None
    if self.kv_quant not in (None, "int8"):
      raise ValueError(f"Unsupported KV quantization {self.kv_quant!r}; have ['int8']")
    if knobs.get_bool("XOT_PAGED_KERNEL", None) is False:
      raise ValueError("XOT_PAGED_KERNEL=0 (the gathered paged view) is not ported: paged "
                       "attention reads the pages in place through K3/K4 (K3q/K4q)")
    if not knobs.get_bool("XOT_RAGGED_PREFILL"):
      raise ValueError("XOT_RAGGED_PREFILL=0 (the gathered paged view) is not ported: paged "
                       "segments read the pages in place through K4/K4q")
    # The kernels' tile knobs and page sizes are refused here, on the CPU as on the card,
    # rather than at a launch in the middle of a request (the CPU never launches one).
    flash_attention.flash_blocks()
    flash_decode.decode_blocks()
    self.executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torch-engine")
    self.session: Dict[str, Any] = {}
    self._dispatches_inflight = 0  # executor calls queued or running (_run)
    # Resident model contexts, least recently used first (XOT_MAX_RESIDENT_MODELS), and
    # the one loaded or touched last.
    self._contexts: "OrderedDict[Shard, _ShardContext]" = OrderedDict()
    self._active: Optional[_ShardContext] = None
    self.max_models = max(1, knobs.get_int("XOT_MAX_RESIDENT_MODELS"))
    self._shard_lock = asyncio.Lock()
    self._configured_cache_len = knobs.get_int("XOT_CACHE_LEN")
    self._configured_max_cache_len = knobs.get_int("XOT_MAX_CACHE_LEN")
    self.max_resident = knobs.get_int("XOT_MAX_RESIDENT_REQUESTS")
    self.decode_batch = knobs.get_int("XOT_DECODE_BATCH")
    self.batch_window_s = knobs.get_float("XOT_BATCH_WINDOW_MS") / 1000.0
    self.paged = knobs.get_bool("XOT_PAGED_KV")
    self.kv_page = knobs.get_int("XOT_KV_PAGE")
    if self.paged and self.kv_page < 1:
      raise ValueError(f"XOT_KV_PAGE={self.kv_page} with XOT_PAGED_KV=1: a page holds one "
                       f"or more positions (the paged kernels K3/K4 take any such page)")
    self.paged_prefill = knobs.get_bool("XOT_PAGED_PREFILL")
    self.defrag = knobs.get_bool("XOT_KV_DEFRAG")
    self.defrag_moves = 0
    # KV reuse and prefill scheduling (see the module docstring).
    self._prefix_cache_max = knobs.get_int("XOT_PREFIX_CACHE")
    self._prefix_cache_min = knobs.get_int("XOT_PREFIX_CACHE_MIN")
    self._host_kv_max_bytes = knobs.get_int("XOT_KV_HOST_BYTES")
    self.cosched = knobs.get_bool("XOT_PREFILL_COSCHED")
    self._prefill_chunk_budget = max(1, knobs.get_int("XOT_PREFILL_CHUNK_BUDGET"))
    # Prefix hits, the prompt tokens they spared, entries evicted (LRU bound, pool
    # pressure, OOM recovery); the host tier (built at its first spill), its hits, bytes
    # copied out and back, and restores that fell back to a cold prefill.
    self._prefix_hits = 0
    self._prefix_tokens_saved = 0
    self._prefix_evictions = 0
    self._host_kv: Optional[HostKVStore] = None
    self._host_kv_hits = 0
    self._host_spill_bytes = 0
    self._host_fetch_bytes = 0
    self._host_restore_fallbacks = 0
    # Host hits by the entry's origin ("local" spill or "fabric" import), served as
    # labelled xot_kv_host_hits_total series beside the bare total.
    self._host_hits_by_source: Dict[str, int] = {}
    # The fleet-wide KV fabric (fabric/, XOT_FABRIC_PEERS): a prefix that misses the
    # device cache and the local host tier consults sibling replicas and imports the
    # longest covering entry into the host tier, whence _host_promote restores it. The
    # client is built at its first use (`_fabric_client`).
    self._fabric_peers = [p.strip() for p in knobs.get_str("XOT_FABRIC_PEERS").split(",")
                          if p.strip()]
    self._fabric_timeout_s = knobs.get_float("XOT_FABRIC_TIMEOUT_S")
    self._fabric_offer_ttl_s = knobs.get_float("XOT_FABRIC_OFFER_TTL_S")
    self._fabric = None
    self._fabric_hits = 0
    self._fabric_misses = 0
    self._fabric_errors = 0
    self._fabric_bytes = 0
    # OOM recoveries, and the requests whose state one dropped (bounded): their next
    # touch raises RequestStateLost instead of starting over from an empty cache.
    self._oom_count = 0
    self._states_lost_to_oom: "OrderedDict[str, None]" = OrderedDict()
    # Live roofline attribution (XOT_PERF_ATTR) and the dispatch classification.
    self._dtype_name = next(k for k, v in DTYPES.items() if v == self.dtype)
    self.perf = (PerfAttribution(knobs.get_float("XOT_PERF_EWMA_S"))
                 if knobs.get_bool("XOT_PERF_ATTR") else None)
    self._exec_seen: set = set()
    self._jit_first_dispatches = 0
    self._jit_cached_dispatches = 0
    self._chip_peaks: Optional[Tuple[Optional[float], Optional[float]]] = None
    self._grow_copies = 0
    self._commit_copy_bytes = 0
    # The engine-global sampling stream: `seed=`, else XOT_SEED, else the clock.
    self._seed = int(seed) if seed is not None else knobs.get_int("XOT_SEED", int(time.time()))
    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(self._seed)
    # A seeded request's stream: re-seeded before each sampling call or chunk from
    # (seed, position, choice); the seeded decode graphs are captured with it.
    self._sample_generator = torch.Generator(device=self.device)
    self._logprob_store: "OrderedDict[str, list]" = OrderedDict()
    self._logprob_lock = threading.Lock()
    # Overlapped chunks: the knobs, the solo chunks dispatched ahead (request -> record)
    # and how the next calls resolved them.
    self.overlap = knobs.get_bool("XOT_OVERLAP_CHUNKS")
    self.overlap_batch = knobs.get_bool("XOT_OVERLAP_BATCH")
    self._spec_next: Dict[str, dict] = {}
    self._overlap_hits = self._overlap_misses = 0
    self._overlap_batch_hits = self._overlap_batch_misses = 0
    # Speculative decoding: draft tokens verified and accepted, their EWMAs (made at the
    # first verify), paged-to-contiguous gathers (XOT_PAGED_SPEC=0 only), and the draft
    # model with its retry cooldown after a failed load. The draft's greedy chunks draw
    # from a generator of their own: a chunk draws noise at every step whatever its
    # temperature, and the draft must not move the sampled streams of the engine's one.
    self.paged_spec = knobs.get_bool("XOT_PAGED_SPEC")
    self._spec_proposed = self._spec_accepted = 0
    self._spec_ewma: Optional[Tuple[Any, Any]] = None
    self._unpage_calls = 0
    self.draft_model = knobs.get_str("XOT_DRAFT_MODEL", "") or ""
    self._draft_retry_s = knobs.get_float("XOT_DRAFT_RETRY_S")
    self._draft_retry_at = 0.0
    self._draft_generator = torch.Generator(device=self.device)
    self._draft_generator.manual_seed(0)
    # The fused in-process ring, driven from the last partition's engine: the ring chunk
    # dispatched ahead of each request, the batcher of each chain, the graph cache of
    # each chain of contexts (on the card), chunks and batched dispatches run, and the
    # chunks that declined to the per-token ring, by reason.
    self._ring_spec: Dict[str, dict] = {}
    self._ring_batchers: Dict[tuple, _DecodeBatcher] = {}
    self._ring_graphs: Dict[tuple, Tuple[list, graphs.GraphCache]] = {}
    self._ring_chunks = self._ring_batch_dispatches = self._ring_batch_rows = 0
    self._ring_declines: Dict[str, int] = {}
    # Device-resident hops: outputs handed to a co-located next partition on the
    # device, and the bytes of hidden states copied to the host for a hop.
    self.device_hops = 0
    self.host_hop_bytes = 0
    # The serving mesh's knobs (`_serving_mesh` builds it per shard at its load), the
    # devices it may span, and the from-zero segments prefilled by ring attention.
    tp_env = knobs.raw("XOT_TP")
    self._tp_env = tp_env if tp_env is not None else knobs.raw("XOT_SERVE_TP")
    self._sp_env = knobs.get_int("XOT_SERVE_SP")
    self._ep_env = knobs.get_int("XOT_SERVE_EP")
    self._local_devices = local_devices(self.device)
    self.sp_ring_prefills = 0

  # ------------------------------------------------------------- serving mesh

  def _serving_mesh(self, cfg: ModelConfig, shard: Optional[Shard] = None) -> Optional[Mesh]:
    """The shard's serving mesh over the local devices (JAX's `_serving_mesh`), or None.

    Axes: 'tp' (XOT_TP, falling back to XOT_SERVE_TP: 0 = off, N = force, unset = off,
    where JAX takes every local card), 'sp' (XOT_SERVE_SP: the from-zero
    segment's positions over sp, ring attention; a power of two, and only for a
    whole-model shard) and 'ep' (XOT_SERVE_EP, MoE only: the experts over ep, dividing
    their count). Requested sizes reduce to the largest feasible divisors: tp divides
    every dense dimension, so each split is even."""
    sp_env, ep_env = self._sp_env, self._ep_env
    if not cfg.is_moe:
      ep_env = 0
    # The ring prefill needs a whole-model shard (token input, from-zero context): a
    # mid-shard must not reserve sp devices it can never use.
    if shard is not None and not (shard.is_first_layer and shard.is_last_layer):
      sp_env = 0
    n_local = len(self._local_devices)
    # Unset is one position: JAX's auto-tp over every local card waits for a run over
    # distinct cards (ROADMAP), so a multi-card host serves as it did before the mesh.
    t = min(max(int(self._tp_env), 1), n_local) if self._tp_env is not None else 1
    dims = [cfg.num_kv_heads, cfg.num_heads, cfg.hidden_size,
            cfg.num_heads * cfg.head_dim, cfg.intermediate_size, cfg.vocab_size]
    if cfg.is_moe and cfg.moe_intermediate_size:
      dims.append(cfg.moe_intermediate_size)
    while t > 1 and any(d % t for d in dims):
      t -= 1
    ep = min(ep_env, n_local // t) if ep_env > 1 else 1
    while ep > 1 and cfg.num_experts % ep:
      ep -= 1
    sp = min(sp_env, n_local // (t * ep)) if sp_env > 1 else 1
    # Prefill segments are padded to power-of-two buckets: a sp that is not a power of
    # two would never divide them.
    while sp > 1 and sp & (sp - 1):
      sp -= 1
    if t <= 1 and sp <= 1 and ep <= 1:
      return None
    axes = {}
    if ep > 1:
      axes["ep"] = ep
    if sp > 1:
      axes["sp"] = sp
    axes["tp"] = t
    return make_mesh(axes, self._local_devices)

  # ------------------------------------------------------------- accessors

  @property
  def _ctx(self) -> Optional[_ShardContext]:
    """The context loaded or touched last."""
    return self._active

  @property
  def shard(self) -> Optional[Shard]:
    return self._active.shard if self._active else None

  @property
  def cfg(self) -> Optional[ModelConfig]:
    return self._active.cfg if self._active else None

  @property
  def tokenizer(self):
    return self._active.tokenizer if self._active else None

  async def _run(self, fn, *args, oom_as_cache_exhausted: bool = True, grad: str = "serve"):
    """Every device computation funnels through the single-worker executor. Device
    memory exhaustion is caught here: the engine frees what it can
    (_free_device_memory, on the executor, after the failed call) so that later
    requests find a healthy engine. A serving call surfaces it as CacheExhausted (the
    request's length error); a load passes oom_as_cache_exhausted=False and gets a
    RuntimeError (a model that does not fit is no fault of a prompt). The in-flight
    count brackets the call, so the stall watchdog tells a device call in progress (a
    first request's graph captures included) from a silent distributed stall. `grad`
    names the call's grad mode (GRAD_MODES)."""
    mode = GRAD_MODES[grad]

    def call(f, *a):
      with mode():
        return f(*a)
    loop = asyncio.get_running_loop()
    self._dispatches_inflight += 1
    try:
      return await loop.run_in_executor(self.executor, call, fn, *args)
    except Exception as e:
      if not _is_device_oom(e):
        raise
      try:
        freed = await loop.run_in_executor(self.executor, call, self._free_device_memory)
      except Exception as free_err:  # recovery must never mask the OOM
        freed = f"recovery itself failed: {free_err!r}"
      msg = f"device memory exhausted (recovery #{self._oom_count}: freed {freed}); original: {e}"
      if oom_as_cache_exhausted:
        raise CacheExhausted(msg) from e
      raise RuntimeError(msg) from e
    finally:
      self._dispatches_inflight -= 1

  def dispatch_inflight(self) -> bool:
    """True while an executor call (a forward, a prefill slice, a decode chunk, a graph
    capture or replay) is queued or running: active local work, which the Node's stall
    watchdog does not abort as a stall."""
    return self._dispatches_inflight > 0

  def _free_device_memory(self) -> str:
    """OOM recovery (the JAX engine's, with the port's counterpart of
    `jax.clear_caches()`): drop the chunks dispatched ahead, then every context's
    captured CUDA graphs and slab, so the spills below find room; spill every prefix
    entry to the host tier, then drop it; drop every request state (remembered, bounded,
    so that its next touch raises RequestStateLost) and the page pools; drop every
    context but the active one; return the allocator's cached blocks to the card.
    Records `engine.oom_recovery` and freezes the flight recorder. Runs on the
    executor, so no device work interleaves with it."""
    self._oom_count += 1
    n_snap = n_state = n_spill = n_ctx = 0
    # A record must never resolve against a state made again after the recovery.
    self._spec_next.clear()
    self._ring_spec.clear()
    for ctx in self._contexts.values():
      ctx.batch_spec = None
      if ctx.graphs is not None:
        ctx.graphs.clear()
    if self.device.type == "cuda":
      torch.cuda.empty_cache()
    for ctx in self._contexts.values():
      for toks, entry in ctx.prefix_cache.values():
        if self._spill_prefix_entry(ctx, toks, entry):
          n_spill += 1
      n_snap += len(ctx.prefix_cache)
      self._prefix_evictions += len(ctx.prefix_cache)
      ctx.prefix_cache.clear()
      for rid in ctx.states:
        self._states_lost_to_oom[rid] = None
      n_state += len(ctx.states)
      ctx.states.clear()
      # Every state and entry that referenced the arena is gone: the next paged
      # request builds a fresh pool.
      ctx.page_pool = None
    while len(self._states_lost_to_oom) > 512:
      self._states_lost_to_oom.popitem(last=False)
    for shard in [s for s, c in self._contexts.items() if c is not self._active]:
      self._contexts.pop(shard)
      n_ctx += 1
    if self.device.type == "cuda":
      torch.cuda.empty_cache()
    # Every graph is captured again: count those as first dispatches.
    self._exec_seen.clear()
    freed = (f"{n_snap} prefix snapshots ({n_spill} spilled to host tier), "
             f"{n_state} request states, {n_ctx} model contexts")
    if self.flight is not None:
      self.flight.record("engine.oom_recovery", None, recovery=self._oom_count, freed=freed)
      self.flight.freeze(None, reason=f"oom_recovery:{self._oom_count}")
    return freed

  # ---------------------------------------------------------- observability

  def _engine_span(self, name: str, request_id: Optional[str], attributes: Optional[dict] = None):
    """A child span of the request's trace for an engine-depth phase, or a no-op
    context when tracing is off or the request has no trace context (an orphan engine
    span would pollute the buffer with single-span traces)."""
    tr = self.tracer
    if tr is None or not tr.enabled or self.trace_ctx is None or not request_id:
      return contextlib.nullcontext()
    ctx = self.trace_ctx(request_id)
    if ctx is None:
      return contextlib.nullcontext()
    return tr.start_span(name, parent=ctx,
                         attributes={"request.id": request_id, **(attributes or {})})

  @staticmethod
  def _captures(ctx: _ShardContext) -> int:
    return ctx.graphs.captures if ctx.graphs is not None else 0

  def _start_of(self, ctx: _ShardContext, request_id: str, input_data) -> Tuple[int, bool]:
    """(positions the request already holds, whether its segments run on the arena),
    read before a forward."""
    state = ctx.states.get(request_id)
    return (self._committed_pos(ctx, request_id, state) if state is not None else 0,
            self._paged_segment(ctx, request_id, input_data))

  def _observe_forward(self, ctx: _ShardContext, key: tuple, true_t: int, start: int, paged: bool,
                       t0: float, captures: int) -> None:
    """A forward that just read back: a prefill of `true_t` tokens from `start`, or at
    T = 1 a one-token step of the per-token ring (a decode row at depth `start`)."""
    secs = time.monotonic() - t0
    captured = self._captures(ctx) - captures
    if true_t > 1:
      self._observe_dispatch("prefill", key, secs, tokens=true_t, ctx=ctx, start=start,
                             captured=captured)
    else:
      self._observe_dispatch("decode", key, secs, tokens=1, ctx=ctx, rows=[(start, paged, None)],
                             captured=captured)

  def _observe_dispatch(self, kind: str, key: tuple, seconds: float, batch: int = 1,
                        tokens: int = 0, ctx: Optional[_ShardContext] = None,
                        rows: Optional[list] = None, start: int = 0, captured: int = 0,
                        emitted: Optional[int] = None) -> None:
    """Classify one dispatch as a first dispatch (it captured a CUDA graph, or ran an
    eager key not seen before: what pays a compile here) or a cached one, recording a
    first one's wall time as an `engine.compile` flight event; then feed the roofline
    attribution: `seconds` is the wall interval the caller measured, and the cost
    model turns the dispatch's static facts (token count, each decode row's depth and
    layout) into its HBM bytes and FLOPs. A draft verify ("verify") books one weight
    stream for its `tokens` positions at the depth and layout of its one row, and the
    tokens it `emitted` (accepted and bonus) as the lane's tokens. Host metadata only,
    no device sync."""
    first = captured > 0 or key not in self._exec_seen
    self._exec_seen.add(key)
    if first:
      self._jit_first_dispatches += 1
      if self.flight is not None:
        self.flight.record("engine.compile", None, kind=kind, batch=batch, tokens=tokens,
                           secs=round(seconds, 4), captures=captured)
    else:
      self._jit_cached_dispatches += 1
    perf = self.perf
    if perf is None:
      return
    cm = ctx.costmodel if ctx is not None else None
    hbm_bytes = flops = 0
    total_tokens = tokens
    if kind == "decode":
      rows = rows or [(0, False, None)] * max(batch, 1)
      total_tokens = tokens * len(rows)
      if cm is not None:
        hbm_bytes, flops = cm.decode_dispatch_cost(tokens, rows, page=self.kv_page)
    elif kind == "verify":
      if cm is not None:
        depth, paged, alloc = (rows or [(0, False, None)])[0]
        hbm_bytes, flops = cm.verify_dispatch_cost(tokens, depth, paged=paged, alloc_tokens=alloc,
                                                   page=self.kv_page)
    elif cm is not None:
      hbm_bytes, flops = cm.prefill_dispatch_cost(tokens, self._prefill_chunk(), start=start)
    if emitted is not None:
      total_tokens = emitted
    perf.observe(key, kind, seconds, tokens=total_tokens, batch=batch, hbm_bytes=hbm_bytes,
                 flops=flops)

  def _chip_peak_specs(self) -> Tuple[Optional[float], Optional[float]]:
    """(peak bf16 TFLOP/s, peak HBM GB/s) of the engine's card, or (None, None) on the
    CPU or a card without a row: the denominators of the utilization gauges."""
    if self._chip_peaks is None:
      self._chip_peaks = ((None, None) if self.device.type != "cuda"
                          else cuda_chip_peaks(torch.cuda.get_device_name(self.device)))
    return self._chip_peaks

  def perf_stats(self) -> Optional[Dict[str, float]]:
    """EWMA gauge values for /metrics (xot_decode_tok_s and friends), or None when
    attribution is off (XOT_PERF_ATTR=0)."""
    if self.perf is None:
      return None
    peak_tflops, peak_gbps = self._chip_peak_specs()
    return self.perf.gauges(peak_gbps, peak_tflops)

  def perf_compact(self) -> Optional[Dict[str, Any]]:
    """Small perf summary for the status-bus rollup (rides node_metrics on the topology
    cadence, so /v1/perf on any node shows the whole ring)."""
    if self.perf is None:
      return None
    out = self.perf.compact()
    gauges = self.perf_stats() or {}
    out["hbm_util_pct"] = gauges.get("hbm_util_pct", 0.0)
    out["mfu_pct"] = gauges.get("mfu_pct", 0.0)
    return out

  def history_gauges(self) -> Optional[Dict[str, Any]]:
    """Host-side gauge snapshot for the metrics-history sampler: the live EWMA gauges
    plus the cumulative counters it differences per tick. None when attribution is
    off."""
    if self.perf is None:
      return None
    out: Dict[str, Any] = dict(self.perf_stats() or {})
    spec = self.spec_stats()
    if spec is not None:
      out["spec_accept_rate"] = spec["accept_rate"]
    out["jit_first_dispatches"] = self._jit_first_dispatches
    out["jit_cached_dispatches"] = self._jit_cached_dispatches
    out["host_fetch_bytes"] = self._host_fetch_bytes
    return out

  def _observe_spec(self, proposed: int, accepted: int) -> None:
    """One verify round into the paired EWMAs of proposed and accepted draft tokens
    (every verify path calls it after bumping the cumulative counters)."""
    if self._spec_ewma is None:
      tau = knobs.get_float("XOT_SPEC_EWMA_S")
      self._spec_ewma = (_Ewma(tau), _Ewma(tau))
    now = time.monotonic()
    self._spec_ewma[0].observe(float(proposed), 1e-3, now)
    self._spec_ewma[1].observe(float(accepted), 1e-3, now)

  def spec_stats(self) -> Optional[Dict[str, float]]:
    """The xot_spec_accept_rate gauge: the EWMA of accepted draft tokens over the EWMA
    of proposed ones; None until a draft has been verified."""
    if self._spec_ewma is None:
      return None
    now = time.monotonic()
    prop = self._spec_ewma[0].peek(now)
    acc = self._spec_ewma[1].peek(now)
    return {"accept_rate": round(acc / prop, 4) if prop > 1e-12 else 0.0}

  def context_stats(self) -> List[Dict[str, Any]]:
    """Each resident model context, least recently used first: its model and layers,
    request states, captured graphs, the bytes its graphs' memory pool and its slab hold
    on the card (0 on the CPU), and whether it is the active one."""
    out = []
    for shard, ctx in list(self._contexts.items()):
      gc = ctx.graphs
      out.append({"model_id": shard.model_id, "layers": [shard.start_layer, shard.end_layer],
                  "states": len(ctx.states), "graphs": len(gc.programs) if gc else 0,
                  "graph_pool_bytes": gc.pool_bytes if gc else 0,
                  "slab_bytes": gc.slab_bytes if gc else 0, "active": ctx is self._active})
    return out

  def perf_report(self) -> Optional[Dict[str, Any]]:
    """The /v1/perf report (the JAX engine's keys): the loaded model's analytic
    ceilings (bf16/int8/int4), predicted against actual resident weight bytes, the
    EWMA gauges, per-lane totals, the heaviest dispatch keys, the dispatch
    classification, the page pools' and host tier's byte flows, and speculation's
    proposed and accepted tokens; and, the port's own, every resident context with its
    graph and slab bytes (`contexts`). Host metadata only."""
    if self.perf is None:
      return None
    peak_tflops, peak_gbps = self._chip_peak_specs()
    report: Dict[str, Any] = {
      "gauges": self.perf.gauges(peak_gbps, peak_tflops),
      "lanes": self.perf.lanes(),
      "executables": self.perf.executables(),
      "dispatch": {"jit_first_dispatches": self._jit_first_dispatches,
                   "jit_cached_dispatches": self._jit_cached_dispatches},
      "byte_flows": {"host_spill_bytes": self._host_spill_bytes,
                     "host_fetch_bytes": self._host_fetch_bytes,
                     "commit_copy_bytes": self._commit_copy_bytes,
                     "unpage_gathers": self._unpage_calls,
                     "pool": self.page_pool_stats(), "host_tier": self.host_kv_stats()},
      "speculation": {"proposed": self._spec_proposed, "accepted": self._spec_accepted,
                      "accept_rate_ewma": (self.spec_stats() or {}).get("accept_rate")},
      "model": None,
      "ceilings": None,
      "contexts": self.context_stats(),
    }
    ctx = self._active
    if ctx is not None and ctx.costmodel is not None:
      cm = ctx.costmodel
      actual = ctx.weight_bytes  # numel x element size, counted at load: metadata only
      report["model"] = {
        "model_id": ctx.shard.model_id,
        "layers": [ctx.shard.start_layer, ctx.shard.end_layer],
        "dtype": self._dtype_name,
        "quantize": self.quantize,
        "kv_quant": self.kv_quant,
        "tp": cm.tp,
        "n_params": cm.n_params(),
        "weight_bytes_predicted": cm.weight_bytes(),
        "weight_bytes_actual": actual,
        "weight_bytes_per_device_predicted": cm.weight_bytes_per_device(),
        "weight_bytes_per_device_actual": device_bytes(ctx.params),
        "kv_write_bytes_per_token": cm.kv_write_bytes_per_token(),
        "kv_read_bytes_per_token_at_cache_len": cm.kv_read_bytes_per_token(
          ctx.cache_len, alloc_tokens=ctx.cache_len),
        "kv_read_bytes_per_token_at_cache_len_per_device": cm.kv_read_bytes_per_token_per_device(
          ctx.cache_len, alloc_tokens=ctx.cache_len),
        "collective_bytes_per_token": cm.collective_bytes_per_token(),
      }
      report["ceilings"] = cm.ceilings(peak_gbps)
    return report

  # ------------------------------------------------------------- shard setup

  async def ensure_shard(self, shard: Shard) -> None:
    await self._ensure_ctx(shard)

  async def _ensure_ctx(self, shard: Shard) -> _ShardContext:
    """The context of `shard`, loaded if it is not resident (the JAX engine's LRU of
    XOT_MAX_RESIDENT_MODELS contexts): a second model leaves the first one's requests
    as they were. Past the bound the least recently used context with no request states
    goes, or, when every other one is busy, the least recently used of them (its
    requests then fail loudly with RequestStateLost)."""
    ctx = self._contexts.get(shard)
    if ctx is not None:
      self._contexts.move_to_end(shard)
      self._active = ctx
      return ctx
    async with self._shard_lock:
      ctx = self._contexts.get(shard)  # another task loaded it while this one waited
      if ctx is not None:
        self._contexts.move_to_end(shard)
        self._active = ctx
        return ctx
      card = get_model_card(shard.model_id) or {}
      base_id, adapter_name = split_adapter(shard.model_id)
      adapter_ckpt = self._adapter_checkpoint(adapter_name) if adapter_name is not None else None
      donor = self._donor_ctx(shard, base_id) if adapter_name is not None else None
      model_dir = None
      if donor is not None:
        # The base's directory: the adapter context's tokenizer is the base's.
        model_dir = donor.model_dir
      elif card.get("synthetic_config") is None:
        if self.shard_downloader is None:
          raise ValueError(f"{shard.model_id}: a checkpoint needs a shard downloader")
        model_dir = Path(await self.shard_downloader.ensure_shard(shard, type(self).__name__))
      ctx = await self._run(self._load_shard, shard, model_dir, donor, adapter_ckpt,
                            oom_as_cache_exhausted=False, grad="load")
      if donor is not None:
        ctx.tokenizer = donor.tokenizer
      elif model_dir is not None:
        ctx.tokenizer = await tokenizer_for_dir(model_dir)
      self._contexts[shard] = ctx
      self._active = ctx
      while len(self._contexts) > self.max_models:
        victim = next((s for s, c in self._contexts.items() if s != shard and not c.states),
                      next(s for s in self._contexts if s != shard))
        evicted = self._contexts.pop(victim)
        await self._run(self._evict_context, evicted, oom_as_cache_exhausted=False)
      return ctx

  def _evict_context(self, ctx: _ShardContext) -> None:
    """Tear down an evicted model context on the executor, between device calls and so
    outside any capture: its chunks dispatched ahead, request states (their pages) and
    prefix entries go, its captured graphs are reset and its slab dropped explicitly
    (a dead graph that the garbage collector destroys inside another context's capture
    kills that capture: models/graphs.capture_guard), then the allocator's cached blocks
    go back to the card. Its weights go with the last reference to the context."""
    for rid in list(ctx.states):
      self._spec_next.pop(rid, None)
    ctx.batch_spec = None
    n_states = len(ctx.states)
    for rid in list(ctx.states):
      self._drop_state(ctx, rid)
    self._clear_prefix_cache(ctx)
    ctx.page_pool = None
    if ctx.graphs is not None:
      ctx.graphs.clear()
    if self.device.type == "cuda":
      torch.cuda.empty_cache()
    if DEBUG >= 1:
      print(f"Evicted model context {ctx.shard} ({n_states} resident request states)", flush=True)

  def _adapter_checkpoint(self, name: str):
    """A registered adapter's checkpoint (a file, or a directory's latest shard saves),
    or raise with the JAX engine's messages: not registered, no such path, no files."""
    ap = adapter_path(name)
    if ap is None:
      raise ValueError(
        f"adapter {name!r} is not registered — set XOT_ADAPTERS="
        f"'{name}=/path/to/adapter'")
    p = Path(ap)
    if not p.exists():
      raise FileNotFoundError(f"adapter {name!r} path does not exist: {ap}")
    ckpt = self._latest_shard_saves(p) if p.is_dir() else p
    if not ckpt:
      raise FileNotFoundError(f"no adapter checkpoint files under {ap}")
    return ckpt

  def _donor_ctx(self, shard: Shard, base_id: str) -> Optional[_ShardContext]:
    """A resident context over the same base and layer range (the base's, or another
    adapter's) whose weights an adapter context can alias."""
    for s, c in self._contexts.items():
      if (split_adapter(s.model_id)[0] == base_id
          and (s.start_layer, s.end_layer) == (shard.start_layer, shard.end_layer)):
        return c
    return None

  def _lora_generator(self) -> torch.Generator:
    """The draws of fresh adapters (XOT_LORA_RANK): seeded from the engine's seed, as
    JAX keys them, so every context and reload of one engine draws the same A."""
    g = torch.Generator(device=self.device)
    g.manual_seed(self._seed)
    return g

  def _load_shard(self, shard: Shard, model_dir: Optional[Path],
                  donor: Optional[_ShardContext] = None, adapter_ckpt=None) -> _ShardContext:
    """The shard's config and weights on the device: from the checkpoint in
    `model_dir`, or a synthetic card's random weights when it is None.

    Multi-LoRA (a `base@name` shard): with a `donor` context over the same base and
    layers, its tensors are aliased (the same storage, every `lora_*` leaf dropped),
    quantization included, with its vision tower; else the base loads as for a plain
    id. `adapter_ckpt` (a file or a list of shard saves) is merged over it. Fresh
    adapters (XOT_LORA_RANK, XOT_LORA_TARGETS=all for the MLP slots) attach only where
    no adapter checkpoint does: they would overwrite its trained leaves."""
    t0 = time.perf_counter()
    mesh = None
    if donor is not None:
      cfg, mesh = donor.cfg, donor.mesh
      if mesh is not None:
        params = with_layers(donor.params, {}, drop=[k for k in donor.params.tree["layers"]
                                                     if k.startswith("lora_")])
      else:
        params = {**donor.params, "layers": {k: v for k, v in donor.params["layers"].items()
                                             if not k.startswith("lora_")}}
      vision = donor.vision
    else:
      if model_dir is None:
        cfg = config_from_hf_dict(get_model_card(shard.model_id)["synthetic_config"])
      else:
        cfg = load_model_config(model_dir)
      mesh = self._serving_mesh(cfg, shard)
      self._check_kernel_shapes(shard.model_id, cfg, mesh)
      if model_dir is None:
        params = init_random_params(cfg, shard.get_layer_count(), shard.is_first_layer,
                                    shard.is_last_layer, seed=0, dtype=self.dtype,
                                    device=self.device, start_layer=shard.start_layer)
      else:
        params = load_shard_params(model_dir, cfg, shard, dtype=self.dtype, device=self.device)
      if self.quantize:
        params = quantize_params(params, self.quantize, scale_dtype=self.dtype, inplace=True)
      vision = None
      if cfg.is_multimodal and shard.is_first_layer and model_dir is not None:
        # The tower and projector stay in the compute dtype whatever `quantize` says, as
        # in JAX: only the text stack's slots are quantized.
        vision = load_vision_tower(model_dir, cfg, dtype=self.dtype, device=self.device)
    weight_bytes = donor.weight_bytes if isinstance(params, MeshParams) else quantized_bytes(params)
    if mesh is not None and not isinstance(params, MeshParams):
      # Each position's slices of the weights (parallel/mesh.spec_for_param); the
      # quantized ones keep the port's kernels, run on each position's slice.
      params = shard_params(params, mesh)
      if DEBUG >= 1:
        print(f"Serving {shard} over the mesh {mesh}", flush=True)
    if adapter_ckpt is not None:
      params = lora.load_lora_checkpoint(params, shard, adapter_ckpt)
      if DEBUG >= 1:
        print(f"LoRA adapter {split_adapter(shard.model_id)[1]!r} attached over "
              f"{split_adapter(shard.model_id)[0]}" + (" (aliased base)" if donor else ""))
    lora_rank = knobs.get_int("XOT_LORA_RANK")
    if lora_rank > 0 and adapter_ckpt is None:
      targets = lora.ATTN_SLOTS + (lora.MLP_SLOTS if knobs.get_str("XOT_LORA_TARGETS", "") == "all"
                                   else ())
      params = lora.add_lora_params(params, lora_rank, self._lora_generator(), targets)
      if DEBUG >= 1:
        print(f"LoRA adapters attached: rank={lora_rank}, targets={targets}")
    cache_len = min(self._configured_cache_len, cfg.max_seq_len)
    max_cache_len = max(cache_len, min(self._configured_max_cache_len, cfg.max_seq_len))
    tokenizer = DummyTokenizer()  # a checkpoint's own replaces it (_ensure_ctx)
    if cfg.eos_token_ids:
      tokenizer.eos_token_id = cfg.eos_token_ids[0]
    if DEBUG >= 1:
      print(f"torch engine ready for {shard} on {self.device} from {model_dir or 'a seed'} "
            f"(dtype={self.dtype}, quantize={self.quantize}, kv_quant={self.kv_quant}, "
            f"cache_len={cache_len}, paged={self.paged}) in {time.perf_counter() - t0:.3f} s",
            flush=True)
    costmodel = CostModel(cfg, shard.get_layer_count(), shard.is_first_layer, shard.is_last_layer,
                          quantize=self.quantize, dtype_bytes=dtype_width(self._dtype_name),
                          kv_quant=self.kv_quant, start_layer=shard.start_layer,
                          tp=mesh.axis_size("tp") if mesh is not None else 1)
    return _ShardContext(shard=shard, cfg=cfg, params=params, cache_len=cache_len,
                         max_cache_len=max_cache_len, tokenizer=tokenizer,
                         states=OrderedDict(), model_dir=model_dir,
                         graphs=graphs.GraphCache(self.device) if self.device.type == "cuda" else None,
                         costmodel=costmodel, vision=vision, mesh=mesh, weight_bytes=weight_bytes)

  def _check_kernel_shapes(self, model_id: str, cfg: ModelConfig,
                           mesh: Optional[Mesh] = None) -> None:
    """Refuse, when a shard is loaded, a model whose attention shapes the kernels are not
    built for: under XOT_PAGED_KV=1 head_dim or groups outside K3's and K4's builds (K2's
    64 q heads per kv head, any page), then head_dim outside K1's and K2's or more q
    heads per kv head than K2 takes. Under a mesh each tp position's shard is checked:
    Hq/tp q heads over Hkv/tp kv heads keep the group size, so the same rule holds for
    each."""
    tp = mesh.axis_size("tp") if mesh is not None else 1
    groups = (cfg.num_heads // tp) // (cfg.num_kv_heads // tp)
    dims = paged_attention.HEAD_DIMS
    if self.paged and (cfg.head_dim not in dims or groups > paged_attention.MAX_GROUPS):
      raise ValueError(f"{model_id}: head_dim {cfg.head_dim} with {groups} q heads per kv head "
                       f"under XOT_PAGED_KV=1; the paged kernels K3/K4 are built for head_dim "
                       f"{dims} and at most {paged_attention.MAX_GROUPS} q heads per kv head")
    dims = flash_decode.HEAD_DIMS
    if cfg.head_dim not in dims or groups > flash_decode.MAX_GROUPS:
      raise ValueError(f"{model_id}: head_dim {cfg.head_dim} with {groups} q heads per kv head; "
                       f"the attention kernels K1/K2 are built for head_dim {dims} and at most "
                       f"{flash_decode.MAX_GROUPS} q heads per kv head")

  def eos_token_ids_for(self, shard: Shard) -> Tuple[int, ...]:
    """The EOS ids of `shard`'s own model, whichever context is active."""
    ctx = self._contexts.get(shard)
    if ctx is None:
      return ()
    eos = getattr(ctx.tokenizer, "eos_token_id", None)
    return tuple(((eos,) if eos is not None else ()) + tuple(ctx.cfg.eos_token_ids or ()))

  # ------------------------------------------------------------ checkpoints

  def _checkpoint_file_for(self, path: Path, shard: Shard) -> Optional[Path]:
    """A concrete safetensors file for this shard: a file path as it is; a directory's
    own `{start}-{end}-*` saves of this shard (latest iteration), else any safetensors
    there that is neither another shard's save nor an optimizer-moments file."""
    if path.is_file():
      return path
    if not path.is_dir():
      return None
    sid = f"{shard.start_layer}-{shard.end_layer}"
    mine = sorted(
      (p for p in path.glob(f"{sid}-*.safetensors") if not p.stem.endswith("-opt")),
      key=lambda p: int(p.stem.rsplit("-", 1)[-1]) if p.stem.rsplit("-", 1)[-1].isdigit() else -1,
    )
    if mine:
      return mine[-1]
    rest = sorted(p for p in path.glob("*.safetensors")
                  if not lora.SHARD_SAVE_RE.fullmatch(p.stem) and not p.stem.endswith("-opt"))
    return rest[0] if rest else None

  @staticmethod
  def _latest_shard_saves(path: Path) -> list:
    """All `{start}-{end}-{iter}` saves in a directory, the latest iteration per layer
    range (train/lora.adapter_checkpoint_files: the API's listing resolves directories
    by the same rule)."""
    return lora.adapter_checkpoint_files(path)

  async def load_checkpoint(self, shard: Shard, path: str) -> None:
    """Load `path` into the shard's context (the JAX engine's resolution):

    - an adapter-only file (this shard's own save in a directory, or a file) merges
      over the loaded base;
    - a directory whose shard saves are all adapter-only merges their union (a ring
      re-partitioned since they were written), even with base files beside them;
    - otherwise full weights: an explicit file or a shard save beats an HF index in the
      same directory, then the index, then any other safetensors file. A quantized
      engine requantizes them, and a context that had adapters gets fresh ones of the
      same rank and slots.

    Then the context's prefix cache and host-tier entries go (computed under the old
    weights), its chunks dispatched ahead roll back, and its captured CUDA graphs and
    slab are dropped: a replay reads the parameters at the addresses of its capture,
    and the new tensors have other addresses. The next use of each key captures again.

    The optimizer resets with the weights. Where the load took one trained save as it is
    (an adapter file, an explicit file or a shard save) and XOT_SAVE_OPT_STATE is on,
    the moments saved beside it (`_opt_state_file`) are restored in the same executor
    call; a file that does not fit leaves the optimizer cold, with a message, and never
    blocks the weights."""
    ctx = await self._ensure_ctx(shard)
    # The moments a resume may restore: set only where one save loads as it is (a
    # re-partitioned merge or a base reload lands at another parameter point).
    resume = {"opt": None}

    def _load():
      p = Path(path)
      ckpt = self._checkpoint_file_for(p, ctx.shard)
      if ckpt is not None and lora.is_lora_checkpoint(ckpt):
        resume["opt"] = self._opt_state_file(ckpt, ctx.shard)
        return lora.load_lora_checkpoint(ctx.params, ctx.shard, ckpt)
      if p.is_dir():
        # Checked whatever _checkpoint_file_for fell back to: a base model.safetensors
        # in the same directory must not shadow the adapter saves.
        pieces = self._latest_shard_saves(p)
        if pieces and all(lora.is_lora_checkpoint(f) for f in pieces):
          return lora.load_lora_checkpoint(ctx.params, ctx.shard, pieces)
      model_dir = p if p.is_dir() else p.parent
      explicit = ckpt is not None and (p.is_file() or lora.SHARD_SAVE_RE.fullmatch(ckpt.stem))
      if explicit:
        params = load_shard_params(model_dir, ctx.cfg, ctx.shard, dtype=self.dtype,
                                   device=self.device, checkpoint_file=ckpt)
        resume["opt"] = self._opt_state_file(ckpt, ctx.shard)
      elif ((model_dir / "model.safetensors.index.json").exists()
            or (model_dir / "model.safetensors").exists()):
        params = load_shard_params(model_dir, ctx.cfg, ctx.shard, dtype=self.dtype,
                                   device=self.device)
      elif ckpt is not None:
        params = load_shard_params(model_dir, ctx.cfg, ctx.shard, dtype=self.dtype,
                                   device=self.device, checkpoint_file=ckpt)
      else:
        raise FileNotFoundError(f"no checkpoint for shard {ctx.shard} at {path}")
      if self.quantize:
        # Checkpoints are stored in the compute dtype (save_checkpoint dequantizes).
        params = quantize_params(params, self.quantize, scale_dtype=self.dtype, inplace=True)
      if ctx.mesh is not None:
        params = shard_params(params, ctx.mesh)
      old_layers = (ctx.params.tree if ctx.mesh is not None else ctx.params)["layers"]
      lora_a_keys = sorted(k for k in old_layers if k.startswith("lora_") and k.endswith("_a"))
      if lora_a_keys:
        rank = int(old_layers[lora_a_keys[0]].shape[-1])
        targets = tuple(k[len("lora_"):-len("_a")] for k in lora_a_keys)
        params = lora.add_lora_params(params, rank, self._lora_generator(), targets)
        resume["opt"] = None  # fresh adapters: no saved moments belong to them
      return params

    def _load_and_swap():
      params = _load()
      for rid, st in ctx.states.items():
        self._discard_spec(rid, st)
      self._discard_batch_spec(ctx)
      if ctx.graphs is not None:
        ctx.graphs.clear()
      ctx.params = params
      ctx.optimizer = ctx.opt_leaves = None  # moments of other weights never apply
      self._clear_prefix_cache(ctx)
      if self.device.type == "cuda":
        torch.cuda.empty_cache()
      opt_file = resume["opt"]
      if opt_file is not None and opt_file.exists() and knobs.get_bool("XOT_SAVE_OPT_STATE"):
        self._ensure_optimizer(ctx)
        try:
          optstate.load_opt_state(ctx.optimizer, ctx.opt_leaves, opt_file)
        except Exception as e:
          print(f"optimizer state not restored ({e!r}); training resumes cold")
          ctx.optimizer = ctx.opt_leaves = None

    await self._run(_load_and_swap, oom_as_cache_exhausted=False, grad="load")

  async def save_checkpoint(self, shard: Shard, path: str) -> None:
    """Write the shard's context to `path`: its adapters alone when it has any
    (`lora.layers.{i}.*`, MBs, not the base), else its weights in HF layout and the
    compute dtype (a quantized context dequantized). The optimizer's moments go beside
    it when the context has an optimizer and XOT_SAVE_OPT_STATE is on; otherwise a
    stale moments file beside it is removed (it would pair other moments with these
    weights on the next resume)."""
    ctx = await self._ensure_ctx(shard)

    def _save():
      if lora.has_lora(ctx.params):
        lora.save_lora_checkpoint(ctx.params, ctx.shard, Path(path))
        return
      # Over a mesh the whole leaves, gathered from the pieces: the single device's files.
      params = gather_params(ctx.params) if ctx.mesh is not None else ctx.params
      if is_quantized(params):
        params = dequantize_params(params, self.dtype)
      save_shard_params(params, ctx.cfg, ctx.shard, Path(path))

    await self._run(_save, oom_as_cache_exhausted=False)
    opt_file = self._opt_state_file(Path(path), ctx.shard)

    def _save_opt():
      if ctx.optimizer is not None and knobs.get_bool("XOT_SAVE_OPT_STATE"):
        optstate.save_opt_state(ctx.optimizer, ctx.opt_leaves, opt_file)
      elif opt_file.exists():
        opt_file.unlink()

    await self._run(_save_opt, oom_as_cache_exhausted=False)

  @staticmethod
  def _opt_state_file(path: Path, shard: Shard) -> Path:
    """The moments file of one checkpoint file, beside it ('0-3-4.safetensors' ->
    '0-3-4-opt.safetensors'): a rollback to an earlier save never restores a later
    save's moments."""
    if path.suffix != ".safetensors":
      raise ValueError(f"checkpoint path must be a .safetensors file, got {path}")
    return path.with_name(path.stem + "-opt.safetensors")

  # --------------------------------------------------------------- training

  def _ensure_optimizer(self, ctx: _ShardContext) -> torch.optim.Optimizer:
    """The context's AdamW (lr XOT_LR, optax.adamw's other defaults) over its
    trainable leaves: the adapters alone when it has any (the base frozen), else every
    float leaf; over a mesh a parallel/zero.MeshAdamW over those leaves' pieces (its
    `leaves` are what the gradients are taken of). Made at the first step; loads reset
    it."""
    if ctx.optimizer is None:
      ctx.optimizer = lora.optimizer_for(ctx.params, knobs.get_float("XOT_LR"))
      ctx.opt_leaves = train_step.optimizer_leaves(ctx.optimizer)
    return ctx.optimizer

  def _check_example(self, ctx: _ShardContext, train: bool) -> None:
    """Refuse, before any step, what the training forward does not serve. Every family
    trains, as in JAX: qwen3-moe through its router and experts (the dense combine at
    B*T > 8, the routed gather at or under it; int8 experts stay frozen), llava on its
    text path (the tower lives in `ctx.vision`, outside the params)."""
    model = ctx.shard.model_id
    if not train:
      return
    if self.device.type == "cuda":
      flash_attention.check_bwd_head_dim(ctx.cfg.head_dim, f"{model}: training")
    tree = ctx.params.tree if isinstance(ctx.params, MeshParams) else ctx.params
    if is_quantized(tree) and not lora.has_lora(tree):
      raise ValueError(
        "Full-parameter training on an int8-quantized base is not supported; "
        "attach adapters (--lora-rank / XOT_LORA_RANK) for QLoRA fine-tuning"
      )

  def _example_tensor(self, example) -> torch.Tensor:
    """An example on the device: token ids [B, T] as int64, a hidden state [B, T, H] in
    the compute dtype (numpy, or a CPU tensor off the wire)."""
    t = example if torch.is_tensor(example) else torch.from_numpy(np.array(example))
    if t.dim() == 2:
      return t.to(device=self.device, dtype=torch.int64)
    return t.to(device=self.device, dtype=self.dtype)

  def _ints(self, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64), device=self.device)

  @staticmethod
  def _to_host(t: torch.Tensor):
    """A hidden state or its gradient off the device for the next hop: bf16 stays a
    bf16 CPU tensor (the codec's bf16 frames), any other dtype becomes numpy."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()

  def _update(self, ctx: _ShardContext, grads: List[torch.Tensor]) -> None:
    """One AdamW step on the context's leaves, in place; the prefix cache and the host
    tier's entries of the context go (computed under the old weights)."""
    train_step.apply_grads(ctx.optimizer, ctx.opt_leaves, grads)
    self._clear_prefix_cache(ctx)

  async def train_example(self, request_id: str, shard: Shard, example, target, lengths,
                          forward_fn=None):
    """Pipelined training over the ring (the JAX engine's): the last shard computes the
    loss, its gradients and its input's gradient at once; another shard runs its slice
    keeping the autograd graph, chains the activations downstream through
    `forward_fn(activations, target, lengths, train=True) -> (loss, grad)`, pulls the
    returned gradient back through its slice, steps its optimizer and returns (loss,
    the gradient of its input; zeros for a first shard: tokens have none)."""
    ctx = await self._ensure_ctx(shard)
    if not shard.is_last_layer and forward_fn is None:
      raise ValueError("Non-last shard requires forward_fn to chain the ring")
    self._check_example(ctx, train=True)
    first = shard.is_first_layer

    if shard.is_last_layer:
      def _last():
        self._ensure_optimizer(ctx)
        loss, x_grad, grads = train_step.leaf_loss_and_grads(
          ctx.params, ctx.cfg, self._example_tensor(example), self._ints(target),
          self._ints(np.asarray(lengths).reshape(-1)), first, ctx.opt_leaves,
          start_layer=shard.start_layer)
        with torch.no_grad():
          self._update(ctx, grads)
        x_grad = x_grad.cpu().numpy() if first else self._to_host(x_grad.to(self.dtype))
        return float(loss), x_grad
      return await self._run(_last, oom_as_cache_exhausted=False, grad="train")

    # Another shard: the forward keeps its graph across the downstream hop.
    held = {}

    def _fwd():
      self._ensure_optimizer(ctx)
      x = self._example_tensor(example)
      if not first:
        x = x.detach().clone()
      wrt = list(ctx.opt_leaves) + ([] if first else [x])
      held["wrt"] = wrt
      for t in wrt:
        t.requires_grad_(True)
      held["out"] = train_step.training_forward(ctx.params, x, ctx.cfg, first, False,
                                                shard.start_layer)
      return self._to_host(held["out"])

    def _release():
      for t in held.get("wrt", ()):
        t.requires_grad_(False)
      held.clear()

    try:
      activations = await self._run(_fwd, oom_as_cache_exhausted=False, grad="train")
      loss, down_grad = await forward_fn(activations, np.asarray(target), np.asarray(lengths), True)
      if down_grad is None:
        raise RuntimeError(f"Downstream shard returned no gradient for {request_id}")

      def _bwd():
        out, wrt = held["out"], held["wrt"]
        down = self._example_tensor(down_grad).to(out.dtype)
        grads = torch.autograd.grad(out, wrt, grad_outputs=down, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(wrt, grads)]
        _release()
        with torch.no_grad():
          self._update(ctx, grads[:len(ctx.opt_leaves)])
        return np.zeros((1,), np.float32) if first else self._to_host(grads[-1].to(self.dtype))

      x_grad = await self._run(_bwd, oom_as_cache_exhausted=False, grad="train")
    finally:
      if held:
        await self._run(_release, oom_as_cache_exhausted=False, grad="load")
    return float(loss), x_grad

  async def evaluate_example(self, request_id: str, shard: Shard, example, target, lengths,
                             forward_fn=None) -> float:
    """The loss of an example through the training forward, with no gradient: the last
    shard's masked cross-entropy, chained through `forward_fn` from another shard."""
    ctx = await self._ensure_ctx(shard)
    if not shard.is_last_layer and forward_fn is None:
      raise ValueError("Non-last shard requires forward_fn to chain the ring")
    self._check_example(ctx, train=False)

    def _fwd():
      out = train_step.training_forward(ctx.params, self._example_tensor(example), ctx.cfg,
                                        shard.is_first_layer, shard.is_last_layer,
                                        shard.start_layer)
      if shard.is_last_layer:
        return float(train_step.masked_ce_loss(out, self._ints(target),
                                               self._ints(np.asarray(lengths).reshape(-1))))
      return self._to_host(out)

    out = await self._run(_fwd, oom_as_cache_exhausted=False)
    if shard.is_last_layer:
      return out
    loss, _ = await forward_fn(out, np.asarray(target), np.asarray(lengths), False)
    return loss

  # ---------------------------------------------------------------- tokens

  async def encode(self, shard: Shard, prompt: str) -> np.ndarray:
    ctx = await self._ensure_ctx(shard)
    return np.asarray(ctx.tokenizer.encode(prompt), dtype=np.int64)

  async def decode(self, shard: Shard, tokens: np.ndarray) -> str:
    ctx = await self._ensure_ctx(shard)
    return ctx.tokenizer.decode(np.asarray(tokens).reshape(-1).tolist())

  async def sample(self, x: np.ndarray, temp: float = DEFAULT_TEMP, top_k: int = DEFAULT_TOP_K,
                   top_p: float = 0.0, request_id: Optional[str] = None,
                   sampling: Optional[dict] = None) -> np.ndarray:
    """Host-path sampling of the last position's logits: the first token of a
    multimodal prefill, whose logits come back from infer_prompt. A request's extras
    apply as the device sampler applies them at its first token (JAX's `sample`): its
    seed, logit_bias and min_p, and a logprob entry recorded under `request_id`. The
    penalties count sampled tokens, so they do nothing at the first; attach_sampling
    then counts this token for the decode chunks. A seeded request draws from (seed,
    the sampled token's position, choice) like the device path, so its stream does
    not depend on other traffic."""
    def _sample() -> np.ndarray:
      host = np.asarray(x)
      if host.ndim == 3:
        host = host[:, -1, :]  # only the last position crosses to the device
      elif host.ndim == 1:
        host = host[None, :]
      logits = torch.as_tensor(np.ascontiguousarray(host), device=self.device)
      if not sampling:
        tok = sample_logits(logits, temp=temp, top_k=top_k, top_p=top_p, generator=self.generator)
        return tok.cpu().numpy().astype(np.int64)
      ctx = next((c for c in self._contexts.values() if request_id in c.states), self._active)
      ex = self._build_extras(ctx, sampling)
      state = ctx.states.get(request_id) if request_id is not None else None
      generator = self._generator_for(ex, request_id or "", state.pos - 1 if state else 0)
      if ex.top_lp >= 0 and request_id is not None:
        tok, lp, top_ids, top_lps = sample_logits_logprobs(
          logits, temp=temp, top_k=top_k, top_p=top_p, bias=ex.bias, min_p=ex.min_p,
          top_lp=ex.top_lp, generator=generator)
        self._record_logprobs(request_id, lp, top_ids, top_lps)
      else:
        tok = sample_logits(logits, temp=temp, top_k=top_k, top_p=top_p, bias=ex.bias,
                            min_p=ex.min_p, generator=generator)
      return tok.cpu().numpy().astype(np.int64)
    return await self._run(_sample)

  async def attach_sampling(self, shard: Shard, request_id: str, sampling: dict,
                            sampled_tokens=()) -> None:
    """Bind a request's sampling extras to its decode state where the prefill could not:
    a multimodal prefill samples its first token on the host (`sample`), so no extras
    state was built, and the decode chunks would run without bias, penalties or logprob
    records. `sampled_tokens` (the host-sampled first token) seed the penalty counts,
    as the text path counts its prefill-sampled token. A no-op when the state is
    unknown or already has extras (JAX's `attach_sampling`)."""
    ctx = self._contexts.get(shard)
    state = ctx.states.get(request_id) if ctx is not None else None
    if state is None or state.extras is not None:
      return

    def _attach() -> None:
      if state.extras is not None:
        return
      ex = self._build_extras(ctx, sampling)
      if ex.counts is not None:
        for t in sampled_tokens:
          ex.counts[0, int(t) % ctx.cfg.vocab_size] += 1
      state.extras = ex

    await self._run(_attach)

  # ----------------------------------------------------------- device path

  def _to_device_input(self, input_data) -> torch.Tensor:
    """Token ids [B, T] or a hidden state [B, T, H] on the engine's device: numpy, or a
    CPU torch tensor (a bf16 hop as the wire codec decodes it)."""
    if not isinstance(input_data, torch.Tensor):
      input_data = np.asarray(input_data)
      if not input_data.flags.writeable:  # the codec's arrays view the received frame
        input_data = input_data.copy()
      input_data = torch.from_numpy(input_data)
    if input_data.ndim == 2:
      return input_data.to(device=self.device, dtype=torch.int64)
    if input_data.ndim == 3:
      return input_data.to(device=self.device, dtype=self.dtype)
    raise ValueError(f"expected 2-D tokens or 3-D hidden state, got ndim={input_data.ndim}")

  def _prefill_chunk(self) -> int:
    return knobs.get_int("XOT_PREFILL_CHUNK")

  def _paged_segment(self, ctx: _ShardContext, request_id: str, x: torch.Tensor) -> bool:
    """A segment runs on the page arena when its request already lives there, or
    when it starts a request under XOT_PAGED_KV with paged-native prefill: token
    input for one request on a shard that spans the whole model."""
    state = ctx.states.get(request_id)
    if state is not None:
      return state.pages is not None
    return (self.paged and self.paged_prefill and ctx.shard.is_first_layer
            and ctx.shard.is_last_layer and x.ndim == 2 and x.shape[0] == 1)

  def _segment_setup(self, ctx: _ShardContext, request_id: str, input_data: np.ndarray):
    """Device transfer, bucket padding, state and capacity, and the attention path.
    Returns (x, true length, state, the cache or arena, forward keywords): a page
    table on the arena (K4 or K3); on a contiguous cache a fresh request's multi-token
    segment goes to K1, everything else to K2 (K2q, K3q, K4q for an int8 cache)."""
    x = self._to_device_input(input_data)
    true_t = x.shape[1]
    bucket = 1 if true_t == 1 else _bucket(true_t)
    if self._paged_segment(ctx, request_id, x):
      state = self._prep_state_paged(ctx, request_id, bucket)
      cache, kw = ctx.page_pool.arena, {"page_table": self._paged_table_for(ctx, state),
                                        "route": self.quant_route}
    else:
      state = self._prep_state(ctx, request_id, bucket)
      use_flash = true_t > 1 and state.pos == 0
      cache, kw = state.cache, {"use_flash": use_flash, "use_flash_decode": not use_flash,
                                "route": self.quant_route}
    if bucket != true_t:
      pad = torch.zeros((x.shape[0], bucket - true_t) + tuple(x.shape[2:]), dtype=x.dtype,
                        device=x.device)
      x = torch.cat([x, pad], dim=1)
    return x, true_t, state, cache, kw

  def _advance(self, ctx: _ShardContext, state: _RequestState, n: int) -> None:
    """Move a request past `n` tokens it just wrote. A paged request gives back the
    pages that only its bucket padding reached (they hold garbage and are its own),
    then whatever its window slid past."""
    state.pos += n
    state.last_used = time.monotonic()
    if state.pages is not None:
      pool = ctx.page_pool
      freed = state.pages.trim_to(pool.pages_for(state.pos))
      if freed:
        pool.decref(freed)
      self._vkv_window_release(ctx, state)

  def _forward_segment(self, ctx: _ShardContext, request_id: str, input_data: np.ndarray,
                       fill: bool = False):
    """One segment's forward; returns (device output, true length). `fill` skips the
    unembedding (cache-fill segments whose logits nobody reads)."""
    x, true_t, state, cache, kw = self._segment_setup(ctx, request_id, input_data)
    ring = "page_table" not in kw and true_t > 1 and self._ring_prefill(ctx, state.pos, x)
    out, _ = forward_shard(ctx.params, x, cache, state.pos, ctx.cfg, is_first=x.ndim == 2,
                           is_last=ctx.shard.is_last_layer and not fill,
                           start_layer=ctx.shard.start_layer, ring=ring, **kw)
    self.sp_ring_prefills += ring
    self._advance(ctx, state, true_t)
    return out, true_t

  @staticmethod
  def _ring_prefill(ctx: _ShardContext, pos: int, x) -> bool:
    """Whether a contiguous segment of `x` at `pos` prefills by ring attention over the
    mesh's sp axis (JAX's "ring"/"ring_full" executables): a first-layer shard's segment
    from position 0 whose (padded) length sp divides, for a family with no window,
    softcap or query_pre_attn_scalar: its tokens, or the merged sequence of a
    multimodal prompt (a hidden input). Later segments attend the cache."""
    mesh, cfg = ctx.mesh, ctx.cfg
    return (mesh is not None and mesh.axis_size("sp") > 1 and ctx.shard.is_first_layer
            and pos == 0 and x.shape[1] % mesh.axis_size("sp") == 0
            and not (cfg.uses_sliding_window or cfg.attn_logit_softcap
                     or cfg.query_pre_attn_scalar))

  def _prefill_groups(self, ctx: _ShardContext, state: _RequestState, x: torch.Tensor, cache,
                      chunk: int, want_hidden: bool,
                      page_table: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """x's whole segments of `chunk` tokens from state.pos through `prefill_scan`, one
    program for each power-of-two group: a CUDA-graph replay on the card
    (models/graphs.prefill), the same scan eagerly on the CPU. Returns the last-layer
    hidden states when `want_hidden`."""
    is_first = x.ndim == 2
    if ctx.graphs is not None:
      return graphs.prefill(ctx.graphs, ctx.params, x, cache, state.pos, ctx.cfg, chunk,
                            is_first=is_first, start_layer=ctx.shard.start_layer,
                            page_table=page_table, route=self.quant_route, want_hidden=want_hidden)
    hs, pos = [], state.pos
    for off, g in scan_groups(x.shape[1] // chunk):
      h, _ = prefill_scan(ctx.params, x[:, off * chunk:(off + g) * chunk], cache, pos, ctx.cfg, g,
                          is_first=is_first, start_layer=ctx.shard.start_layer,
                          page_table=page_table, route=self.quant_route)
      hs.append(h)
      pos += g * chunk
    if not want_hidden:
      return None
    return hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)

  def _scan_prefill(self, ctx: _ShardContext, request_id: str, input_data, chunk: int,
                    want_hidden: bool = False):
    """A long prompt's leading whole segments on a contiguous cache through the scan
    prefill (`_prefill_groups`): one program for each power-of-two group of segments
    instead of one dispatch a segment. Returns the [B, total, H] last-layer hidden
    states when `want_hidden` (a mid-ring shard), else True; None when the path does
    not apply (XOT_SCAN_PREFILL=0, a length that is not whole segments, or fewer than
    two: the per-segment loop then pays one dispatch anyway and keeps K1 for a
    from-zero segment), and the caller loops over the segments."""
    total = input_data.shape[1]
    if not knobs.get_bool("XOT_SCAN_PREFILL") or total % chunk or total < 2 * chunk:
      return None
    # A from-zero prompt on a sp mesh rings its first segment: it outranks the scan.
    st = ctx.states.get(request_id)
    if self._ring_prefill(ctx, st.pos if st is not None else 0, input_data):
      return None
    state = self._prep_state(ctx, request_id, total)
    x = self._to_device_input(input_data)
    h = self._prefill_groups(ctx, state, x, state.cache, chunk, want_hidden)
    state.pos += total
    state.last_used = time.monotonic()
    return h if want_hidden else True

  def _prefill_fill_sync(self, ctx: _ShardContext, request_id: str, input_data,
                         paged_native: bool, expected_pos: Optional[int] = None,
                         reserve: Optional[int] = None) -> None:
    """Cache-fill forward of a prompt's whole segments, outputs dropped on the device:
    the scan prefill where it applies, else segment by segment. The unit of work the
    co-scheduling lane admits between decode dispatches. `expected_pos` (a later
    slice) is where the previous slice left the request; `reserve` (a co-scheduled
    contiguous prompt's first slice) sizes its cache for the whole rest of the prompt
    at once, as the one-call path's first fill does, so later slices never grow it."""
    self._check_prefill_continuity(ctx, request_id, expected_pos)
    if paged_native:
      self._paged_fill_sync(ctx, request_id, input_data)
      return
    if reserve and reserve > input_data.shape[1]:
      self._prep_state(ctx, request_id, reserve)
    chunk = self._prefill_chunk()
    if not self._scan_prefill(ctx, request_id, input_data, chunk):
      for off in range(0, input_data.shape[1], chunk):
        self._forward_segment(ctx, request_id, input_data[:, off:off + chunk], fill=True)

  def _check_prefill_continuity(self, ctx: _ShardContext, request_id: str,
                                expected_pos: Optional[int]) -> None:
    """Between co-scheduled slices the engine serves other requests, and a burst of new
    states can evict a request mid-prefill. A later slice must not recreate it at pos 0:
    it raises RequestStateLost (the node aborts the request). `expected_pos` is None
    for the slice allowed to create the state (the first, with no prefix reuse)."""
    if expected_pos is None:
      return
    st = ctx.states.get(request_id)
    if st is None or st.pos != expected_pos:
      raise RequestStateLost(
        f"request {request_id}: prefill state evicted mid-co-scheduled prefill "
        f"(expected pos {expected_pos}, found {st.pos if st else 'no state'})")

  def _prefill_begin_sync(self, ctx: _ShardContext, request_id: str, input_data,
                          paged_native: bool) -> Tuple[Optional[np.ndarray], int]:
    """The prefill's prologue: prefix reuse for a fresh batch-1 token prompt on a shard
    that holds layer 0 (a mid-ring shard sees hidden states, which key no prefix).
    Returns (the full prompt, for the store after the prefill, or None; the positions
    reuse took off the prompt)."""
    is_prefill = (getattr(input_data, "ndim", 0) == 2 and input_data.shape[1] > 1
                  and input_data.shape[0] == 1 and ctx.shard.is_first_layer
                  and request_id not in ctx.states)
    if not is_prefill:
      return None, 0
    full_prompt = np.asarray(input_data)
    return full_prompt, self._prefix_reuse(ctx, request_id, full_prompt, paged_native=paged_native)

  def _abort_paged_prefill(self, ctx: _ShardContext, request_id: str) -> None:
    """Release a fresh request whose prefill died on exhaustion: it can never produce a
    token, so what it holds (its pool pages above all, which co-resident streams need,
    or a contiguous buffer) goes back at once."""
    self._drop_state(ctx, request_id)

  def _infer_sync(self, ctx: _ShardContext, request_id: str, input_data,
                  keep_on_device: bool = False):
    """The shard's output on the host: fp32 logits from the last shard as numpy; a
    hidden state in the model's dtype, so a hop carries what the next shard computes
    in. numpy has no bfloat16, so a bf16 hidden state stays a CPU torch tensor, which
    the wire codec sends as raw bf16. With `keep_on_device` (the next partition shares
    this process) the output stays the device tensor: no host copy."""
    t0, captures = time.monotonic(), self._captures(ctx)
    start, paged = self._start_of(ctx, request_id, input_data)
    true_t = input_data.shape[1]
    chunk = self._prefill_chunk()
    outs, off0 = [], 0
    if true_t > chunk and not ctx.shard.is_last_layer:
      # A mid-ring shard's long prompt: the leading whole segments through the scan
      # prefill (hidden states out, no unembedding anywhere), the rest segment by segment.
      split = ((true_t - 1) // chunk) * chunk
      h = self._scan_prefill(ctx, request_id, input_data[:, :split], chunk, want_hidden=True)
      if h is not None:
        outs.append(h)
        off0 = split
    for off in range(off0, true_t, chunk):
      out, t = self._forward_segment(ctx, request_id, input_data[:, off:off + chunk])
      outs.append(out[:, :t])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    self._observe_forward(ctx, ("infer", _bucket(true_t)), true_t, start, paged, t0, captures)
    return self._hop_output(ctx, out, keep_on_device)

  def _hop_output(self, ctx: _ShardContext, out: torch.Tensor, keep_on_device: bool):
    """A forward's output as the caller takes it: the device tensor for a co-located
    next partition (counted in `device_hops`), else on the host (a hidden state's bytes
    counted in `host_hop_bytes`)."""
    if keep_on_device:
      self.device_hops += 1
      return out
    out = out.cpu()
    if not ctx.shard.is_last_layer:
      self.host_hop_bytes += out.numel() * out.element_size()
    return out if out.dtype == torch.bfloat16 else out.numpy()

  async def infer_prompt(self, request_id: str, shard: Shard, prompt: str,
                         inference_state: Optional[dict] = None, images: Optional[list] = None,
                         keep_on_device: bool = False) -> Tuple[Any, Optional[dict]]:
    """The text path (encode, then infer_tensor), or with `images` the multimodal
    prefill (`_infer_multimodal_sync`): its logits, or hidden states on a first shard
    that is not the last, come back to the host, which samples the first token.
    `keep_on_device`: see infer_tensor."""
    ctx = await self._ensure_ctx(shard)
    if not images:
      return await super().infer_prompt(request_id, shard, prompt, inference_state,
                                        keep_on_device=keep_on_device)
    if not ctx.cfg.is_multimodal:
      # The API refuses this earlier; never answer about an image the model cannot see.
      raise ValueError(f"model {shard.model_id} does not support image input")
    tokens = await self.encode(shard, prompt)
    with self._engine_span("engine.prefill", request_id,
                           {"tokens": int(tokens.size), "images": len(images)}):
      out = await self._run(self._infer_multimodal_sync, ctx, request_id, tokens.reshape(-1),
                            images, keep_on_device)
    return out, inference_state

  def _infer_multimodal_sync(self, ctx: _ShardContext, request_id: str, token_ids: np.ndarray,
                             images: list, keep_on_device: bool = False):
    """The multimodal prefill (JAX's): the images through the vision tower and the
    projector, their features spliced in at the `<image>` placeholders of the prompt's
    embeddings, and the merged sequence, padded to its bucket, through the text stack
    as a hidden input in one forward: from position 0 through K1 on the card. The
    request's state is a contiguous cache (`_prep_state`); under XOT_PAGED_KV its first
    decode chunk commits it to pool pages. Returns the real positions' fp32 logits
    (numpy) on the last shard, else their hidden states as `_infer_sync` returns them.

    Over a serving mesh (JAX's tower runs replicated and feeds the sharded stack) the
    tower and the projector run once, unsharded, on the engine's device (the mesh's first
    position's); the prompt's embedding comes from the sharded params (gathered there),
    and the merged sequence enters the mesh forward as a replicated hidden input: each
    tp position's K1 on its heads, the from-zero segment by ring attention over sp where
    `_ring_prefill` takes it, the experts over ep."""
    if ctx.vision is None:
      raise RuntimeError("vision weights unavailable for multimodal request")
    t0, captures = time.monotonic(), self._captures(ctx)
    vparams, pparams = ctx.vision
    cfg = ctx.cfg
    pixels = torch.from_numpy(preprocess_images(images, cfg.vision.image_size)).to(self.device)
    feats = encode_images(vparams, pixels, cfg.vision, feature_layer=cfg.vision_feature_layer,
                          select=cfg.vision_feature_select)
    feats = project_features(pparams, feats, act=cfg.projector_hidden_act)
    ids = torch.from_numpy(np.asarray(token_ids, dtype=np.int64)).to(self.device)
    token_embeds = embed(ctx.params, ids[None], cfg)[0]
    merged = merge_image_features(token_embeds, token_ids, feats, cfg.image_token_index)
    true_t = merged.shape[0]
    bucket = 1 if true_t == 1 else _bucket(true_t)
    state = self._prep_state(ctx, request_id, bucket)
    x = merged[None].to(self.dtype)
    if bucket != true_t:
      x = torch.cat([x, x.new_zeros((1, bucket - true_t, x.shape[-1]))], dim=1)
    use_flash = true_t > 1 and state.pos == 0
    ring = true_t > 1 and self._ring_prefill(ctx, state.pos, x)
    start = state.pos
    out, _ = forward_shard(ctx.params, x, state.cache, state.pos, cfg, is_first=False,
                           is_last=ctx.shard.is_last_layer, use_flash=use_flash,
                           use_flash_decode=not use_flash, start_layer=ctx.shard.start_layer,
                           route=self.quant_route, ring=ring)
    self.sp_ring_prefills += ring
    self._advance(ctx, state, true_t)
    self._observe_forward(ctx, ("multimodal", bucket), true_t, start, False, t0, captures)
    return self._hop_output(ctx, out[:, :true_t], keep_on_device)

  # The Node hands a co-located next partition the device tensor when the engine has
  # this flag (`keep_on_device`).
  supports_device_io = True

  async def infer_tensor(self, request_id: str, shard: Shard, input_data,
                         inference_state: Optional[dict] = None,
                         keep_on_device: bool = False) -> Tuple[Any, Optional[dict]]:
    """The shard's forward of `input_data` (tokens, or a hidden state: numpy, a CPU
    tensor off the wire, or a device tensor from a co-located partition). With
    `keep_on_device` the output stays on the device for the next partition in this
    process (the JAX engine's device-resident hop), else it comes to the host."""
    ctx = await self._ensure_ctx(shard)
    out = await self._run(self._infer_sync, ctx, request_id, input_data, keep_on_device)
    return out, inference_state

  async def infer_sample_tensor(
    self, request_id: str, shard: Shard, input_data: np.ndarray,
    temp: float = DEFAULT_TEMP, top_k: int = DEFAULT_TOP_K,
    inference_state: Optional[dict] = None, top_p: float = 0.0,
    sampling: Optional[dict] = None,
  ) -> Tuple[int, Optional[dict]]:
    """Last-shard prefill + sampling on the device: the host receives one int.
    `sampling`: OpenAI's extras {seed, logit_bias, presence_penalty,
    frequency_penalty, min_p, logprobs}, validated by the API, bound to the request's
    state on its first call and kept across its later ones (the ring's per-token
    hops), the penalty counts advancing with every sampled token."""
    ctx = await self._ensure_ctx(shard)
    if not shard.is_last_layer:
      raise ValueError(f"infer_sample_tensor requires the last-layer shard, got {shard}")
    tok = await self._prefill_and_sample(ctx, request_id, input_data, float(temp), int(top_k),
                                         float(top_p), sampling)
    return tok, inference_state

  async def _prefill_and_sample(self, ctx: _ShardContext, request_id: str, input_data,
                                temp: float, top_k: int, top_p: float,
                                sampling: Optional[dict]) -> int:
    """Prefill and first-token sampling. One executor call (_infer_sample_sync) unless
    the prompt is co-scheduled: XOT_PREFILL_COSCHED on, a batch cap above 1, other
    requests active (queued in the batcher, or used within the last second) and a
    batch-1 prompt longer than one segment. Then the prologue, slices of
    XOT_PREFILL_CHUNK_BUDGET segments and the sampled last segment each ride the
    batcher's prefill lane, one a drain cycle after its decode dispatches."""
    chunk = self._prefill_chunk()
    tokens_in = int(input_data.shape[1]) if getattr(input_data, "ndim", 0) == 2 else 0
    now = time.monotonic()
    # A snapshot of the states: the executor thread adds and evicts them meanwhile.
    others_active = ((ctx.batcher is not None
                      and bool(ctx.batcher.pending or ctx.batcher.pending_prefill))
                     or any(now - st.last_used < 1.0
                            for rid, st in list(ctx.states.items()) if rid != request_id))
    cosched = (self.cosched and self.decode_batch > 1 and others_active and tokens_in > chunk
               and input_data.shape[0] == 1)
    if not cosched:
      if tokens_in <= 1:
        # A one-token ring step rides this entry point too; a span per token would
        # swamp the trace buffer.
        return await self._run(self._infer_sample_sync, ctx, request_id, input_data, temp,
                               top_k, top_p, sampling)
      with self._engine_span("engine.prefill", request_id, {"tokens": tokens_in, "cosched": False}):
        return await self._run(self._infer_sample_sync, ctx, request_id, input_data, temp,
                               top_k, top_p, sampling)
    if ctx.batcher is None:
      ctx.batcher = _DecodeBatcher(self, ctx)
    batcher = ctx.batcher
    paged_native = self._paged_segment(ctx, request_id, input_data)
    is_fresh = request_id not in ctx.states
    with self._engine_span("engine.prefill", request_id, {"tokens": tokens_in, "cosched": True}):
      # The prologue rides the lane too: it may restore a prefix from the host tier.
      full_prompt, consumed = await batcher.submit_prefill(
        partial(self._prefill_begin_sync, ctx, request_id, input_data, paged_native))
      rest = input_data[:, consumed:]
      try:
        true_t = rest.shape[1]
        split = ((true_t - 1) // chunk) * chunk if true_t > chunk else 0
        step = self._prefill_chunk_budget * chunk
        for off in range(0, split, step):
          sl = rest[:, off:min(off + step, split)]
          # Only the first slice of a request with no prefix hit may create its state.
          expected = consumed + off if (consumed or off) else None
          fill_t = int(sl.shape[1])
          await batcher.submit_prefill(
            partial(self._prefill_fill_sync, ctx, request_id, sl, paged_native, expected,
                    true_t if off == 0 else None),
            tokens=fill_t, key=("prefill", _bucket(fill_t), paged_native, "fill"),
            start=consumed + off)
        tail_t = int(true_t - split)
        return await batcher.submit_prefill(
          partial(self._prefill_sample_sync, ctx, request_id, rest[:, split:], temp, top_k, top_p,
                  sampling, full_prompt, consumed + split if (consumed or split) else None),
          tokens=tail_t, key=("prefill", _bucket(tail_t), top_k, top_p, bool(sampling)),
          start=consumed + split)
      except CacheExhausted:
        # Exhaustion mid-prefill fails only this request: its partial pages go back at
        # once, so the streams it interleaved with never feel the pressure.
        if is_fresh:
          await self._run(self._abort_paged_prefill, ctx, request_id)
        raise

  def _infer_sample_sync(self, ctx: _ShardContext, request_id: str, input_data: np.ndarray,
                         temp: float, top_k: int, top_p: float,
                         sampling: Optional[dict] = None) -> int:
    """The one-call prefill: prologue (prefix reuse), the rest's leading whole segments
    as a fill, the last segment sampled. Attribution books only the positions that ran
    after the prologue."""
    start, paged_native = self._start_of(ctx, request_id, input_data)
    is_fresh = request_id not in ctx.states
    full_prompt, consumed = self._prefill_begin_sync(ctx, request_id, input_data, paged_native)
    rest = input_data[:, consumed:]
    true_t = rest.shape[1]
    chunk = self._prefill_chunk()
    t0, captures = time.monotonic(), self._captures(ctx)
    try:
      tail = rest
      if true_t > chunk:
        # Leading whole segments fill the cache without the unembedding.
        split = ((true_t - 1) // chunk) * chunk
        self._prefill_fill_sync(ctx, request_id, rest[:, :split], paged_native)
        tail = rest[:, split:]
      tok = self._prefill_sample_sync(ctx, request_id, tail, temp, top_k, top_p, sampling,
                                      full_prompt)
    except CacheExhausted:
      if is_fresh:
        self._abort_paged_prefill(ctx, request_id)
      raise
    ex = ctx.states[request_id].extras or graphs.PLAIN
    self._observe_forward(ctx, ("prefill", _bucket(true_t), top_k, top_p, ex.key()), true_t,
                          start + consumed, paged_native, t0, captures)
    return tok

  def _prefill_sample_sync(self, ctx: _ShardContext, request_id: str, input_data,
                           temp: float, top_k: int, top_p: float, sampling: Optional[dict],
                           full_prompt: Optional[np.ndarray],
                           expected_pos: Optional[int] = None) -> int:
    """The last prefill segment's forward with the first token sampled on the device
    (the one-call and co-scheduled paths' shared epilogue), then the prefix store."""
    self._check_prefill_continuity(ctx, request_id, expected_pos)
    x, seg_t, state, cache, kw = self._segment_setup(ctx, request_id, input_data)
    if sampling and state.extras is None:
      state.extras = self._build_extras(ctx, sampling)
    ex = state.extras or graphs.PLAIN
    out, _ = forward_sample(
      ctx.params, x, cache, state.pos, seg_t - 1, ctx.cfg, x.ndim == 2, temp, top_k, top_p,
      start_layer=ctx.shard.start_layer,
      generator=self._generator_for(ex, request_id, state.pos + seg_t - 1),
      **ex.sampler_kwargs(), **kw)
    self._advance(ctx, state, seg_t)
    if ex.top_lp >= 0:
      tok, lp, top_ids, top_lps = out
      self._record_logprobs(request_id, lp[0:1], top_ids[0:1], top_lps[0:1])
    else:
      tok = out
    tok_int = int(tok.reshape(-1)[0].item())
    if full_prompt is not None:
      self._prefix_store(ctx, request_id, full_prompt)
    if ex.counts is not None:
      # The first sampled token counts before decode; the prompt never does.
      ex.counts[0, tok_int % ctx.cfg.vocab_size] += 1
    return tok_int


  # ------------------------------------------------------ speculative decode

  async def verify_draft(self, request_id: str, shard: Shard, prev_token: int,
                         draft: list) -> Optional[list]:
    """Greedy draft verification (JAX's): ONE forward over [prev_token] + draft; the
    longest prefix of the draft that matches the model's own argmax is accepted, and
    the model's next token after it taken as a bonus. Returns 1..len(draft)+1 tokens,
    each what sequential greedy decode would produce, or None when the fast path does
    not apply (no room for the padded bucket, a page pool too full for it): the caller
    then decodes plainly. The rejected positions' K/V stay past the rolled-back
    position, where no query reads them and the next write overwrites them. A paged
    request verifies on the arena itself (XOT_PAGED_SPEC), others on their contiguous
    cache."""
    if not (shard.is_first_layer and shard.is_last_layer) or not draft:
      return None
    ctx = self._contexts.get(shard)
    if ctx is None:
      raise RequestStateLost(f"request {request_id}: model context {shard.model_id} evicted "
                             f"mid-generation")
    state = ctx.states.get(request_id)
    if state is None:
      raise RequestStateLost(f"request {request_id}: device state evicted mid-generation")
    # The padded bucket is what the forward claims, judged from the committed position
    # (a chunk in flight is rolled back first).
    if self._committed_pos(ctx, request_id, state) + _bucket(1 + len(draft)) > ctx.max_cache_len:
      return None
    self._contexts.move_to_end(shard)
    ctx.states.move_to_end(request_id)
    return await self._run(self._verify_draft_sync, ctx, request_id, int(prev_token),
                           [int(t) for t in draft])

  def _accept(self, ctx: _ShardContext, request_id: str, draft: list, preds: np.ndarray,
              pos_before: int, paged: bool, t0: float, bucket: int, captures: int,
              alloc: Optional[int]) -> list:
    """The accepted tokens of a verify whose argmax is `preds` (preds[i] = the model's
    greedy pick after [prev_token] + draft[:i]): the longest agreeing prefix of the
    draft and the bonus token after it. Moves the request to the accepted position and
    books the round (counters, EWMAs, the verify lane, a `spec.verify` flight event)."""
    n_acc = 0
    while n_acc < len(draft) and int(preds[n_acc]) == draft[n_acc]:
      n_acc += 1
    accepted = draft[:n_acc] + [int(preds[n_acc])]
    state = ctx.states[request_id]
    state.pos = pos_before + 1 + n_acc
    state.last_used = time.monotonic()
    self._spec_proposed += len(draft)
    self._spec_accepted += n_acc
    self._observe_spec(len(draft), n_acc)
    self._observe_dispatch("verify", ("verify", bucket, paged), time.monotonic() - t0,
                           tokens=bucket, ctx=ctx, rows=[(pos_before, paged, alloc)],
                           captured=self._captures(ctx) - captures, emitted=len(accepted))
    if self.flight is not None:
      self.flight.record("spec.verify", request_id, drafted=len(draft), accepted=n_acc,
                         paged=paged)
    return accepted

  def _verify_draft_sync(self, ctx: _ShardContext, request_id: str, prev_token: int,
                         draft: list) -> Optional[list]:
    """The contiguous verify: [prev_token] + draft padded to a power-of-two bucket,
    forwarded from the committed position through K2 at T > 1 (K2q on an int8 cache)
    with every position's argmax: one graph replay on the card
    (graphs.verify_contiguous), the same `forward_argmax` eagerly on the CPU. A paged
    request goes to _verify_draft_paged_sync, or, with XOT_PAGED_SPEC=0, is gathered
    back to a contiguous cache first (`_unpage_state`)."""
    state = ctx.states.get(request_id)
    if state is None:
      raise RequestStateLost(f"request {request_id}: device state evicted mid-generation")
    if self._paged_spec_ok(state):
      return self._verify_draft_paged_sync(ctx, request_id, prev_token, draft)
    # The committed position, read before anything below moves it.
    self._discard_spec(request_id, state)
    self._discard_batch_spec_for(ctx, request_id)
    T = 1 + len(draft)
    if state.cache is None and state.pages is not None:
      self._unpage_state(ctx, state, min_len=state.pos + _bucket(T))
    pos_before = state.pos
    t0, captures = time.monotonic(), self._captures(ctx)
    x, true_t, state, cache, kw = self._segment_setup(
      ctx, request_id, np.asarray([[prev_token] + draft], dtype=np.int64))
    if ctx.graphs is not None:
      preds = graphs.verify_contiguous(ctx.graphs, ctx.params, x, cache, pos_before, ctx.cfg,
                                       start_layer=ctx.shard.start_layer, route=self.quant_route)
    else:
      preds, _ = forward_argmax(ctx.params, x, cache, pos_before, ctx.cfg,
                                start_layer=ctx.shard.start_layer, route=self.quant_route)
    preds = preds[0, :true_t].cpu().numpy()
    return self._accept(ctx, request_id, draft, preds, pos_before, False, t0, x.shape[1],
                        captures, state.cache["k"].shape[2])

  def _paged_spec_ok(self, state: _RequestState) -> bool:
    """A request verifies natively on the arena when it lives in pool pages and
    XOT_PAGED_SPEC is on."""
    return self.paged_spec and state.cache is None and state.pages is not None

  def _verify_draft_paged_sync(self, ctx: _ShardContext, request_id: str, prev_token: int,
                               draft: list) -> Optional[list]:
    """Verification native to the page arena: the request's page table is extended over
    the padded bucket first (pool pages taken before any device work; a pool that cannot
    give them returns None), then [prev_token] + draft run as one ragged query through
    K4 (K4q) with every position's argmax: one graph replay on the card
    (graphs.verify_paged, a static table of a power-of-two width), `forward_argmax_paged`
    on the CPU. Rollback is whole pages: the table is cut back to pages_for(pos) and the
    pages past it, all taken for this round, go back to the pool. The request never
    leaves the arena: no gather, no commit copy."""
    state = ctx.states[request_id]
    self._discard_spec(request_id, state)
    self._discard_batch_spec_for(ctx, request_id)
    pos_before = state.pos
    T = 1 + len(draft)
    bucket = _bucket(T)
    try:
      self._prep_state_paged(ctx, request_id, bucket)
    except CacheExhausted:
      return None
    pool = ctx.page_pool
    x = np.zeros((1, bucket), dtype=np.int64)
    x[0, :T] = [prev_token] + draft
    xd = torch.as_tensor(x, device=self.device)
    table = self._paged_table_for(ctx, state)
    t0, captures = time.monotonic(), self._captures(ctx)
    if ctx.graphs is not None:
      preds = graphs.verify_paged(ctx.graphs, ctx.params, xd, pool.arena, table, pos_before, ctx.cfg,
                                  start_layer=ctx.shard.start_layer, route=self.quant_route)
    else:
      preds, _ = forward_argmax_paged(ctx.params, xd, pool.arena, table, pos_before, ctx.cfg,
                                      start_layer=ctx.shard.start_layer, route=self.quant_route)
    preds = preds[0, :T].cpu().numpy()
    accepted = self._accept(ctx, request_id, draft, preds, pos_before, True, t0, bucket, captures,
                            None)
    # Every page past pages_for(pos) was taken for this round: shared prefix pages are
    # whole pages below pos_before and never sit in the cut tail.
    freed = state.pages.trim_to(pool.pages_for(state.pos))
    if freed:
      pool.decref(freed)
    self._vkv_window_release(ctx, state)
    return accepted

  def _unpage_state(self, ctx: _ShardContext, state: _RequestState, min_len: int = 0) -> None:
    """Gather a paged request back into a contiguous cache (the reverse of the commit),
    for XOT_PAGED_SPEC=0's verify only; its next paged chunk commits it again. Counted
    in `_unpage_calls` (xot_kv_unpage_total)."""
    self._unpage_calls += 1
    pool = ctx.page_pool
    need = min(max(min_len, state.pos, 1), ctx.max_cache_len)
    length = ctx.cache_len
    while length < need and length < ctx.max_cache_len:
      length *= 2
    length = min(length, ctx.max_cache_len)
    cache = init_kv_cache(ctx.cfg, ctx.shard.get_layer_count(), 1, length, self.dtype, self.device,
                          kv_quant=self.kv_quant is not None, mesh=ctx.mesh)
    if len(state.pages):
      # Released (windowed) slots resolve to the scratch page: zeros no query reads.
      ids = vkv.resolve_page_table([state.pages], len(state.pages))[0]
      gathered = gather_pages(pool.arena, ids)
      cut = min(len(state.pages) * pool.page_size, length)
      for name, buf in cache.items():
        buf[:, :, :cut].copy_(gathered[name][:, :, :cut])
      pool.decref(state.pages.live())
    state.cache = cache
    state.pages = None

  # ----------------------------------------------- draft-model speculation

  @staticmethod
  def _draft_rid(request_id: str) -> str:
    """The draft model's state of a request lives under its own key: the target's chunk
    records (`_spec_next`) are keyed by the request id, and a draft state under the same
    key would pop and misapply them."""
    return request_id + "#draft"

  async def draft_tokens(self, request_id: str, context_tokens, k: int) -> list:
    """k greedy draft tokens from the resident draft model (XOT_DRAFT_MODEL), for the
    target to verify in one forward. `context_tokens` is the whole accepted sequence
    (prompt and output); the draft keeps its own cache of the request in its own context
    and feeds only the suffix it has not seen. The draft model must share the target's
    tokenizer. Returns [] when drafting is off, k < 2, the draft model is unknown or
    failed to load (then drafting pauses for XOT_DRAFT_RETRY_S on this engine), or its
    cache is full: the caller falls back to prompt lookup or plain decode."""
    mid = self.draft_model
    if not mid or k < 2 or time.monotonic() < self._draft_retry_at:
      return []
    shard = build_full_shard(mid, type(self).__name__)
    if shard is None:
      return []
    try:
      ctx = await self._ensure_ctx(shard)
    except Exception as e:
      if DEBUG >= 1:
        print(f"draft model {mid} failed to load, pausing drafting {self._draft_retry_s:.0f} s: "
              f"{e!r}")
      self._draft_retry_at = time.monotonic() + self._draft_retry_s
      return []
    return await self._run(self._draft_sync, ctx, self._draft_rid(request_id),
                           [int(t) for t in context_tokens], int(k))

  def _draft_sync(self, ctx: _ShardContext, rid: str, context: list, k: int) -> list:
    """Feed the draft state the accepted tokens it has not seen but the last (scan
    groups of whole segments, then segments), then k greedy steps from the last one
    through the context's decode graphs (the eager chunk on the CPU), on a contiguous
    cache, at temperature 0 on the draft's own generator. Only the real token's slot is
    committed: the k drafted slots are scratch that the next round's feed overwrites. []
    when the draft cache is full."""
    st = ctx.states.get(rid)
    seen = st.pos if st is not None else 0
    suffix = context[seen:]
    if not suffix:
      # The draft state is ahead of the accepted sequence: start it again.
      self._drop_state(ctx, rid)
      seen, suffix = 0, list(context)
    try:
      state = self._prep_state(ctx, rid, len(suffix) + k)
      fill = np.asarray([suffix[:-1]], dtype=np.int64)
      chunk = self._prefill_chunk()
      done, n_fill = 0, fill.shape[1]
      if n_fill:
        split = (n_fill // chunk) * chunk
        if split and self._scan_prefill(ctx, rid, fill[:, :split], chunk):
          done = split
        for off in range(done, n_fill, chunk):
          self._forward_segment(ctx, rid, fill[:, off:off + chunk], fill=True)
      pos = state.pos
      it = _Pending(rid, state, int(suffix[-1]), k, 0.0, 0, 0.0, None)
      toks = self._dispatch_contiguous(ctx, [it], self._device_values([[it.prev_token]], torch.int64),
                                       k, torch.zeros((1,), dtype=torch.float32, device=self.device),
                                       0, 0.0, generator=self._draft_generator)
    except CacheExhausted:
      return []
    state.pos = pos + 1
    state.last_used = time.monotonic()
    return [int(t) for t in toks[0].cpu().tolist()]

  # ------------------------------------------------------ sampling extras

  def _build_extras(self, ctx: _ShardContext, sampling: dict) -> graphs.SamplerExtras:
    """A request's sampling extras on the device (JAX's `_build_extras`), one row, as
    both the graph chunk and the eager one take them: a dense [1, V] bias from the
    sparse logit_bias (ids past the vocabulary dropped, never wrapped); [1, V] counts
    starting at zero when a penalty is set (OpenAI's formula counts the tokens SAMPLED
    before the current position, so the prompt carries no penalty), with the penalties
    and min-p as [1] tensors made by fills (no host-to-device copy)."""
    V = ctx.cfg.vocab_size
    full = lambda v: torch.full((1,), float(v), dtype=torch.float32, device=self.device)  # noqa: E731
    presence = float(sampling.get("presence_penalty") or 0.0)
    frequency = float(sampling.get("frequency_penalty") or 0.0)
    ex = graphs.SamplerExtras(
      seed=sampling.get("seed"),
      min_p=full(sampling["min_p"]) if sampling.get("min_p") else None,
      top_lp=-1 if sampling.get("logprobs") is None else int(sampling["logprobs"]))
    pairs = [(int(t), float(v)) for t, v in (sampling.get("logit_bias") or {}).items()
             if 0 <= int(t) < V]
    if pairs:
      bias = np.zeros((1, V), np.float32)
      for t, v in pairs:
        bias[0, t] += v
      ex.bias = torch.from_numpy(bias).to(self.device)
    if presence or frequency:
      ex.counts = torch.zeros((1, V), dtype=torch.int32, device=self.device)
      ex.presence, ex.frequency = full(presence), full(frequency)
    return ex

  def _generator_for(self, extras: graphs.SamplerExtras, request_id: str,
                     sample_pos: int) -> torch.Generator:
    """The generator a sampling call or chunk draws from: a seeded request's stream
    restarts at (seed, the absolute position of the first token it samples, the choice
    index of an `n` sibling "rid#i"), so the same request reproduces its tokens on any
    server while siblings draw distinct streams (JAX's `_extras_key`; the bits differ,
    the PRNGs do); any other request takes the engine-global stream."""
    if extras.seed is None:
      return self.generator
    choice = 0
    if "#" in request_id:
      tail = request_id.rsplit("#", 1)[1]
      # crc32, not hash(): PYTHONHASHSEED randomises hash() per process.
      choice = int(tail) if tail.isdigit() else zlib.crc32(tail.encode())
    digest = hashlib.blake2b(f"{int(extras.seed)}:{sample_pos}:{choice}".encode(),
                             digest_size=8).digest()
    self._sample_generator.manual_seed(int.from_bytes(digest, "little") >> 1)
    return self._sample_generator

  def _record_logprobs(self, request_id: str, lp: torch.Tensor, top_ids: torch.Tensor,
                       top_lps: torch.Tensor) -> None:
    """Append one entry a sampled token ([T] lp, [T, K] ids and logprobs) for the API to
    drain through pop_logprobs. A bounded LRU of 512 requests: an abandoned request's
    entries age out."""
    lp, top_ids, top_lps = (t.cpu().tolist() for t in (lp, top_ids, top_lps))
    entries = [{"logprob": float(lp[i]),
                "top": [(int(t), float(p)) for t, p in zip(top_ids[i], top_lps[i])]}
               for i in range(len(lp))]
    with self._logprob_lock:
      self._logprob_store.setdefault(request_id, []).extend(entries)
      self._logprob_store.move_to_end(request_id)
      while len(self._logprob_store) > 512:
        self._logprob_store.popitem(last=False)

  def pop_logprobs(self, request_id: str, n: Optional[int] = None) -> Optional[list]:
    """Drain up to `n` (default all) of a request's logprob entries, in sampling
    order; None when it recorded none (a plain request, or one sampled on another
    peer)."""
    with self._logprob_lock:
      store = self._logprob_store.get(request_id)
      if store is None:
        return None
      if n is None or n >= len(store):
        self._logprob_store.pop(request_id, None)
        return store
      out, self._logprob_store[request_id] = store[:n], store[n:]
      return out

  async def generate_chunk(
    self, request_id: str, shard: Shard, prev_token: int, num_tokens: int,
    temp: float = DEFAULT_TEMP, top_k: int = DEFAULT_TOP_K, top_p: float = 0.0,
    next_size: Optional[int] = None,
  ) -> Optional[np.ndarray]:
    """Up to `num_tokens` decoded tokens with sampling on the device, for a request
    whose prompt is already prefilled. None when the shard does not span the whole
    model. A coalesced batch runs at the smallest size its rows asked for, so the
    returned length is authoritative. `next_size` is the caller's next chunk, which a
    solo contiguous chunk dispatches ahead (XOT_OVERLAP_CHUNKS). Recency is refreshed
    for the request and for its model context, as in JAX."""
    if not (shard.is_first_layer and shard.is_last_layer) or num_tokens < 1:
      return None
    ctx = self._contexts.get(shard)
    if ctx is None:
      raise RequestStateLost(f"request {request_id}: model context {shard.model_id} evicted "
                             f"mid-generation")
    state = ctx.states.get(request_id)
    if state is None:
      raise RequestStateLost(f"request {request_id}: device state evicted mid-generation")
    self._contexts.move_to_end(shard)
    ctx.states.move_to_end(request_id)
    # Capacity by the committed position: a chunk in flight has advanced state.pos by its
    # size, and judging by that would end the request a chunk early.
    pos = self._committed_pos(ctx, request_id, state)
    if pos + num_tokens > ctx.max_cache_len:
      if pos + 1 > ctx.max_cache_len:
        raise CacheExhausted(f"request {request_id}: cache full at {pos}/{ctx.max_cache_len}")
      # Shrink to the cache tail: the largest power of two that still fits.
      tail = ctx.max_cache_len - pos
      num_tokens = min(num_tokens, 1 << (tail.bit_length() - 1))
    if self.decode_batch > 1 and state.extras is None:
      # Continuous batching: a lone request flows through as a batch of one. A request
      # with sampling extras decodes in a chunk of its own, so the common path's graphs
      # and the batcher's grouping never carry [B, V] extras.
      if ctx.batcher is None:
        ctx.batcher = _DecodeBatcher(self, ctx)
      return await ctx.batcher.submit(request_id, state, int(prev_token), num_tokens,
                                      float(temp), int(top_k), float(top_p),
                                      int(next_size) if next_size else None)
    item = _Pending(request_id, state, int(prev_token), num_tokens, float(temp), int(top_k),
                    float(top_p), None, next_size=int(next_size) if next_size else None)
    out = await self._run(self._decode_batch_sync, ctx, [item], num_tokens, int(top_k),
                          float(top_p))
    return out[0]

  def _decode_batch_sync(self, ctx: _ShardContext, items: List[_Pending], num_tokens: int,
                         top_k: int, top_p: float) -> List[np.ndarray]:
    """One decode chunk for 1..B requests in a single dispatch: every member grows to
    a common cache length, and the chunk decodes the stacked caches with per-row
    positions and temperatures: on the card as replays of the captured step over the
    context's slab (models/graphs.decode_contiguous), on the CPU eagerly
    (models/generate.decode_chunk_batched). Under XOT_PAGED_KV the chunk indexes the
    shared page arena instead (_decode_batch_paged_sync)."""
    for it in items:
      if ctx.states.get(it.request_id) is not it.state:
        raise RequestStateLost(f"request {it.request_id}: device state evicted mid-generation")
    if len(items) > 1 and any(it.state.extras is not None for it in items):
      raise AssertionError("a request with sampling extras decodes in a chunk of its own")
    t0, captures = time.monotonic(), self._captures(ctx)
    # The KV each row reads: K2 and K3 read a row's resident keys, not its allocation.
    rows = [(self._committed_pos(ctx, it.request_id, it.state), self.paged, None) for it in items]
    if self.paged:
      out = self._decode_batch_paged_sync(ctx, items, num_tokens, top_k, top_p)
    else:
      out = self._decode_batch_contiguous_sync(ctx, items, num_tokens, top_k, top_p)
    ex = items[0].state.extras or graphs.PLAIN
    n = len(out[0])
    self._observe_dispatch("decode", ("decode", self.paged, _bucket(len(items), 1), n, top_k, top_p,
                                      ex.key()),
                           time.monotonic() - t0, batch=len(items), tokens=n, ctx=ctx, rows=rows,
                           captured=self._captures(ctx) - captures)
    return out

  def _decode_batch_contiguous_sync(self, ctx: _ShardContext, items: List[_Pending],
                                    num_tokens: int, top_k: int, top_p: float) -> List[np.ndarray]:
    """The contiguous chunk of _decode_batch_sync: a solo chunk (`_decode_solo_sync`)
    or a batch (`_decode_multi_sync`), each of which may run the next one ahead."""
    if len(items) == 1:
      return [self._decode_solo_sync(ctx, items[0], num_tokens, top_k, top_p)]
    return self._decode_multi_sync(ctx, items, num_tokens, top_k, top_p)

  def _device_values(self, values: list, dtype: torch.dtype) -> torch.Tensor:
    """Host values on the engine's device. On the card through pinned memory and a
    copy that does not wait: a plain host-to-device copy synchronizes the stream, and
    with a chunk in flight that would wait for it."""
    t = torch.tensor(values, dtype=dtype)
    if self.device.type != "cuda":
      return t
    return t.pin_memory().to(self.device, non_blocking=True)

  def _dispatch_contiguous(self, ctx: _ShardContext, items: List[_Pending], toks_in: torch.Tensor,
                           num_tokens: int, temps: torch.Tensor, top_k: int, top_p: float,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Enqueue one decode chunk over the items' contiguous caches from `toks_in` [B, 1]
    (on the device) at their current positions, and advance the positions; returns the
    [B, num_tokens] tokens on the device, not yet read back. Every member grows to a
    common cache length first. On the card the chunk is replays of the captured step
    over the context's slab (models/graphs.decode_contiguous), on the CPU the eager
    chunk (models/generate.decode_chunk_batched). `generator` overrides the request's
    (`_generator_for`)."""
    states = [it.state for it in items]
    target = max(max(s.pos + num_tokens for s in states),
                 max(s.cache["k"].shape[2] for s in states))
    for state in states:
      if state.cache["k"].shape[2] < target:
        self._grow_cache(ctx, state, target)
    if len({s.cache["k"].shape for s in states}) != 1:
      raise AssertionError(f"batched decode needs one cache shape, got "
                           f"{sorted({tuple(s.cache['k'].shape) for s in states})}")
    pos = self._device_values([s.pos for s in states], torch.int32)
    ex = states[0].extras or graphs.PLAIN
    generator = generator or self._generator_for(ex, items[0].request_id, states[0].pos)
    if ctx.graphs is not None:
      # The card: replays of the captured step over the context's slab; each request's
      # cache is updated in place.
      toks, report = graphs.decode_contiguous(
        ctx.graphs, ctx.params, [s.cache for s in states], toks_in, pos, ctx.cfg, num_tokens,
        temps, top_k, top_p, route=self.quant_route, generator=generator, extras=ex)
    else:
      B = len(states)
      toks, caches, *rest = decode_chunk_batched(
        ctx.params, [s.cache for s in states], toks_in, pos, ctx.cfg, num_tokens, temps, top_k,
        top_p, use_flash_decode=True, pad_rows=_bucket(B, 1) - B, generator=generator,
        route=self.quant_route, **ex.sampler_kwargs())
      for state, cache in zip(states, caches):
        state.cache = cache
      report = ex.absorb(rest)
    if report is not None:
      self._record_logprobs(items[0].request_id, *(t[0] for t in report))
    for state in states:
      self._advance(ctx, state, num_tokens)
    return toks

  def _read_back(self, ctx: _ShardContext, toks: torch.Tensor, ahead) -> np.ndarray:
    """A chunk's tokens on the host. `ahead` is (host tensor, event) from graphs.host_copy
    when the next chunk was enqueued behind this one: waiting on the event waits for
    this chunk alone."""
    if ahead is not None:
      host, event = ahead
      event.synchronize()
      return host.numpy().astype(np.int64)
    return toks.cpu().numpy().astype(np.int64)

  def _decode_solo_sync(self, ctx: _ShardContext, it: _Pending, num_tokens: int, top_k: int,
                        top_p: float) -> np.ndarray:
    """One request's chunk, with the JAX engine's overlap (XOT_OVERLAP_CHUNKS): first
    resolve the chunk the last call dispatched ahead (a hit when its input token, size,
    temperature and sampler match and the position is where it left it; a miss rolls the
    position back), then dispatch the caller's next chunk (`next_size`) from this chunk's
    last token on the device, and only then read this chunk back. A chunk runs ahead for
    a request with no sampling extras, no other request used in the last second (its
    next chunk would join a batch and miss), and room under max_cache_len.

    Where the card could quietly lose the overlap, or get it wrong:

    - `.cpu()` waits for everything the stream holds: with chunk N+1 enqueued, reading
      chunk N that way would wait for N+1 too, with no error. So chunk N's tokens are
      copied into pinned host memory on the graph cache's stream, and an event recorded
      behind the copy, BEFORE N+1 is enqueued; the host then waits on that event alone
      (graphs.host_copy). The records `_run_steps` returns are clones made on that
      stream before N+1's replays, which rewrite the token record in place.
    - Chunk N+1's input token is chunk N's last one, copied device to device into the
      step's static token buffer; its positions and temperatures reach the card through
      pinned memory without a synchronizing copy (`_device_values`).
    - A sampled chunk ahead draws from the engine's generator in the order the chunks
      run, as JAX's `_sample_calls` fold does: an all-hits run samples the stream of the
      overlap-off run, and a miss leaves the generator advanced, as in JAX. A seeded or
      extras request never runs ahead.
    - A key seen for the first time is captured during the dispatch ahead, and a capture
      synchronizes the card (graphs.capture_guard): correct, but that chunk boundary
      then overlaps nothing.
    - Chunk N+1 stacks into the slab again from the caches that chunk N split back into;
      stream order makes that right, at the cost of the two slab copies a chunk pays."""
    rid, state = it.request_id, it.state
    # A solo chunk cannot resolve a batch dispatched ahead: its members roll back.
    self._discard_batch_spec_for(ctx, rid)
    spec = self._spec_next.pop(rid, None)
    hit = (spec is not None and state.extras is None and spec["prev"] == it.prev_token
           and spec["n"] == num_tokens and spec["temp"] == it.temp and spec["top_k"] == top_k
           and spec["top_p"] == top_p and state.pos == spec["pos"] + spec["n"])
    if spec is not None:
      self._overlap_hits += hit
      self._overlap_misses += not hit
      if not hit and state.pos == spec["pos"] + spec["n"]:
        state.pos = spec["pos"]
    if hit:
      toks, temps = spec["toks"], spec["temps"]
    else:
      temps = self._device_values([it.temp], torch.float32)
      toks = self._dispatch_contiguous(ctx, [it], self._device_values([[it.prev_token]], torch.int64),
                                       num_tokens, temps, top_k, top_p)
    nxt = int(it.next_size or 0)
    now = time.monotonic()
    others_active = any(st is not state and now - st.last_used < 1.0
                        for st in list(ctx.states.values()))
    ahead = record = None
    if (nxt and self.overlap and state.extras is None and not others_active
        and state.pos + nxt <= ctx.max_cache_len):
      if ctx.graphs is not None:
        ahead = graphs.host_copy(ctx.graphs, toks)
      pos_before = state.pos
      ntoks = self._dispatch_contiguous(ctx, [it], toks[:, -1:], nxt, temps, top_k, top_p)
      record = {"toks": ntoks, "n": nxt, "pos": pos_before, "temp": it.temp, "top_k": top_k,
                "top_p": top_p, "temps": temps}
    host = self._read_back(ctx, toks, ahead)[0]
    if record is not None:
      record["prev"] = int(host[-1])
      self._spec_next[rid] = record
    state.last_used = time.monotonic()
    return host

  def _decode_multi_sync(self, ctx: _ShardContext, items: List[_Pending], num_tokens: int,
                         top_k: int, top_p: float) -> List[np.ndarray]:
    """A batched chunk of 2..B requests. Any solo chunk a member dispatched ahead is
    discarded first. With XOT_OVERLAP_BATCH (off by default, as in JAX: a batch whose
    membership changes from cycle to cycle mostly misses) the next batch runs ahead from
    this one's last tokens on the device, and the next cycle takes it when the members,
    sizes, temperatures, sampler and input tokens all match; otherwise every member
    rolls back."""
    for it in items:
      self._discard_spec(it.request_id, it.state)
    states = [it.state for it in items]
    rids = tuple(it.request_id for it in items)
    temps_key = tuple(float(it.temp) for it in items)
    prevs = [int(it.prev_token) for it in items]
    bspec = ctx.batch_spec
    bhit = (bspec is not None and bspec["rids"] == rids and bspec["n"] == num_tokens
            and bspec["temps_key"] == temps_key and bspec["top_k"] == top_k
            and bspec["top_p"] == top_p and bspec["prev"] == prevs
            and all(a is b for a, b in zip(bspec["states"], states))
            and all(st.pos == p + num_tokens for st, p in zip(states, bspec["pos"])))
    if bspec is not None:
      self._overlap_batch_hits += bhit
      self._overlap_batch_misses += not bhit
    if bhit:
      ctx.batch_spec = None
      out, temps = bspec["toks"], bspec["temps"]
    else:
      self._discard_batch_spec(ctx)
      temps = self._device_values(list(temps_key), torch.float32)
      out = self._dispatch_contiguous(ctx, items, self._device_values([[t] for t in prevs], torch.int64),
                                      num_tokens, temps, top_k, top_p)
    next_sizes = [it.next_size for it in items]
    ahead = record = None
    if (self.overlap_batch and all(next_sizes) and all(s.extras is None for s in states)):
      n2 = min(int(n) for n in next_sizes)
      if all(s.pos + n2 <= ctx.max_cache_len for s in states):
        if ctx.graphs is not None:
          ahead = graphs.host_copy(ctx.graphs, out)
        pos2 = [s.pos for s in states]
        toks2 = self._dispatch_contiguous(ctx, items, out[:, -1:], n2, temps, top_k, top_p)
        record = {"rids": rids, "n": n2, "toks": toks2, "pos": pos2, "temps_key": temps_key,
                  "temps": temps, "top_k": top_k, "top_p": top_p, "states": list(states)}
    host = self._read_back(ctx, out, ahead)
    if record is not None:
      record["prev"] = [int(host[i, -1]) for i in range(len(states))]
      ctx.batch_spec = record
    now = time.monotonic()
    for state in states:
      state.last_used = now
    return [host[i] for i in range(len(states))]

  # ------------------------------------------------------------ the fused ring
  #
  # A ring whose partitions all live in this process (the Node's _inprocess_chain)
  # decodes a chunk as one composite program, driven from the last partition's engine:
  # every partition keeps its params and its request's cache in its own engine's
  # context, where the per-token ring keeps them, so entering or leaving the fused
  # path moves nothing. The driving engine touches the other partitions' states only
  # here, for the request's lifetime (the ring loop is its only driver).

  # The Node's fusion check: every partition of a chain must be served, in this
  # process, by an engine with this flag.
  supports_ring_fusion = True

  def _ring_decline(self, reason: str) -> None:
    self._ring_declines[reason] = self._ring_declines.get(reason, 0) + 1

  def ring_stats(self) -> Dict[str, Any]:
    """The fused ring's counts on this (driving) engine: chunks run, batched dispatches
    and their rows, chunks that declined to the per-token ring by reason, and the ring
    chunks dispatched ahead that hit and missed (with the solo ones)."""
    return {"chunks": self._ring_chunks, "batch_dispatches": self._ring_batch_dispatches,
            "batch_rows": self._ring_batch_rows, "declines": dict(self._ring_declines),
            "overlap_hits": self._overlap_hits, "overlap_misses": self._overlap_misses}

  async def generate_chunk_ring(
    self, request_id: str, chain, prev_token: int, num_tokens: int,
    temp: float = DEFAULT_TEMP, top_k: int = DEFAULT_TOP_K, top_p: float = 0.0,
    next_size: Optional[int] = None,
  ) -> Optional[np.ndarray]:
    """Up to `num_tokens` tokens of a co-located ring's request in one fused chunk:
    `chain` is the ring-ordered [(engine, shard)] covering layers 0..N-1, every engine in
    this process. On the card the chunk is replays of one captured composite step
    (graphs.decode_ring), on the CPU the eager body (generate.decode_chunk_ring). With
    XOT_DECODE_BATCH > 1 concurrent requests on the same chain coalesce into one batched
    dispatch. Returns None where the chain or the request does not qualify
    (`_resolve_ring_segs`) or its positions left lockstep: the caller takes the
    per-token ring."""
    if num_tokens < 1:
      return None
    segs = self._resolve_ring_segs(request_id, chain)
    if segs is None:
      return None
    nxt = int(next_size) if next_size else None
    if self.decode_batch > 1:
      chain_key = tuple((id(eng), sh) for eng, sh in chain)
      batcher = self._ring_batchers.get(chain_key)
      if batcher is None:
        batcher = self._ring_batchers[chain_key] = _DecodeBatcher(self, None,
                                                                  dispatch=self._ring_batch_sync)
      return await batcher.submit(request_id, segs, int(prev_token), int(num_tokens), float(temp),
                                  int(top_k), float(top_p), nxt)
    return await self._run(self._ring_chunk_sync, segs, request_id, int(prev_token),
                           int(num_tokens), float(temp), int(top_k), float(top_p), nxt)

  def _resolve_ring_segs(self, request_id: str, chain) -> Optional[list]:
    """The [(engine, context, state)] segments of a co-located chain, or None (counted)
    when it does not qualify: fewer than two partitions, partitions that do not cover
    layers 0..N-1 contiguously, an engine that cannot fuse, or a request with sampling
    extras (its sampler applies them per token). A segment whose context or request
    state is gone raises RequestStateLost, as generate_chunk does. One rule for the
    fused chunk, the batch and the ring's verify."""
    shards = [s for _, s in chain]
    if (len(chain) < 2 or not (shards[0].is_first_layer and shards[-1].is_last_layer)
        or any(b.start_layer != a.end_layer + 1 for a, b in zip(shards, shards[1:]))):
      self._ring_decline("chain")
      return None
    segs = []
    for eng, sh in chain:
      if not (getattr(eng, "supports_ring_fusion", False)
              and isinstance(eng, TorchShardInferenceEngine)):
        self._ring_decline("engine")
        return None
      ctx = eng._contexts.get(sh)
      if ctx is None:
        raise RequestStateLost(f"request {request_id}: model context {sh.model_id} "
                               f"[{sh.start_layer}-{sh.end_layer}] evicted mid-generation")
      state = ctx.states.get(request_id)
      if state is None:
        raise RequestStateLost(f"request {request_id}: device state for layers "
                               f"[{sh.start_layer}-{sh.end_layer}] evicted mid-generation")
      if state.extras is not None:
        self._ring_decline("extras")
        return None
      eng._contexts.move_to_end(sh)
      ctx.states.move_to_end(request_id)
      segs.append((eng, ctx, state))
    return segs

  def _ring_graph_cache(self, segs: list) -> Optional[graphs.GraphCache]:
    """The graph cache of this chain of contexts, made at its first use and listed in
    every segment context's cache as a dependent (whatever clears a segment's graphs
    clears the ring's); None where the contexts have no graph caches (the CPU)."""
    ctxs = [ctx for _, ctx, _ in segs]
    if any(c.graphs is None for c in ctxs):
      return None
    key = tuple(id(c) for c in ctxs)
    entry = self._ring_graphs.get(key)
    if entry is not None and all(r() is c for r, c in zip(entry[0], ctxs)):
      return entry[1]
    if entry is not None:  # another chain of contexts at recycled addresses
      entry[1].clear()
    gc = type(ctxs[-1].graphs)(self.device)
    for c in ctxs:
      c.graphs.dependents.add(gc)
    self._ring_graphs[key] = ([weakref.ref(c) for c in ctxs], gc)
    return gc

  def _ring_dispatch(self, members: List[list], toks_in: torch.Tensor, num_tokens: int,
                     temps: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Enqueue one fused chunk for 1..B requests of one chain (`members`: each request's
    segments) from `toks_in` [B, 1] on the device, and advance every segment's position;
    returns the [B, num_tokens] tokens on the device, not yet read back. Every cache of
    the chain first grows to one length that holds the chunk (one key for all the
    segments)."""
    n_seg = len(members[0])
    states = [st for m in members for _, _, st in m]
    target = max(max(st.pos + num_tokens for st in states),
                 max(st.cache["k"].shape[2] for st in states))
    for m in members:
      for eng, ctx, st in m:
        if st.cache["k"].shape[2] < target:
          eng._grow_cache(ctx, st, target)
    segs0 = members[0]
    params_segs = [ctx.params for _, ctx, _ in segs0]
    start_layers = [ctx.shard.start_layer for _, ctx, _ in segs0]
    cfg = segs0[-1][1].cfg
    seg_caches = [[m[i][2].cache for m in members] for i in range(n_seg)]
    pos = self._device_values([m[0][2].pos for m in members], torch.int32)
    gc = self._ring_graph_cache(segs0)
    t0, captures = time.monotonic(), gc.captures if gc is not None else 0
    if gc is not None:
      toks = graphs.decode_ring(gc, params_segs, seg_caches, toks_in, pos, cfg, num_tokens, temps,
                                top_k, top_p, start_layers, route=self.quant_route,
                                generator=self.generator)
    elif len(members) == 1:
      toks, _ = decode_chunk_ring(params_segs, toks_in, [c[0] for c in seg_caches], pos, cfg,
                                  num_tokens, temps, top_k, top_p, start_layers,
                                  route=self.quant_route, generator=self.generator)
    else:
      B = len(members)
      toks, split = decode_chunk_ring_batched(
        params_segs, seg_caches, toks_in, pos, cfg, num_tokens, temps, top_k, top_p, start_layers,
        pad_rows=_bucket(B, 1) - B, route=self.quant_route, generator=self.generator)
      for i in range(n_seg):
        for m, cache in zip(members, split[i]):
          m[i][2].cache = cache
    now = time.monotonic()
    for st in states:
      st.pos += num_tokens
      st.last_used = now
    self._ring_chunks += 1
    self._observe_dispatch("decode", ("ring", n_seg, _bucket(len(members), 1), top_k, top_p),
                           now - t0, batch=len(members), tokens=num_tokens,
                           captured=(gc.captures - captures) if gc is not None else 0)
    return toks

  def _ring_chunk_sync(self, segs: list, request_id: str, prev_token: int, num_tokens: int,
                       temp: float, top_k: int, top_p: float,
                       next_size: Optional[int]) -> Optional[np.ndarray]:
    """One request's fused ring chunk, with the solo overlap (XOT_OVERLAP_CHUNKS) over
    the whole chain: the chunk the last call dispatched ahead is taken when it matches
    (same states, input token, size and sampler, every position where it left them),
    else every segment rolls back; then the caller's next chunk is dispatched from this
    chunk's last token on the device before this one is read back. None (counted) when
    the segments' positions left lockstep. Capacity is the shortest segment's
    max_cache_len: a chunk past it shrinks to the largest power of two that fits."""
    states = [st for _, _, st in segs]
    spec = self._ring_spec.pop(request_id, None)
    hit = (spec is not None and len(spec["states"]) == len(states)
           and all(a is b for a, b in zip(spec["states"], states))
           and spec["prev"] == prev_token and spec["n"] == num_tokens and spec["temp"] == temp
           and spec["top_k"] == top_k and spec["top_p"] == top_p
           and all(st.pos == spec["pos"] + spec["n"] for st in states))
    if spec is not None:
      self._overlap_hits += hit
      self._overlap_misses += not hit
      if not hit:
        self._ring_rollback(spec)
    max_len = min(ctx.max_cache_len for _, ctx, _ in segs)
    if hit:
      toks, temps = spec["toks"], spec["temps"]
    else:
      pos = states[0].pos
      if any(st.pos != pos for st in states):
        self._ring_decline("lockstep")
        return None
      if pos + num_tokens > max_len:
        if pos + 1 > max_len:
          raise CacheExhausted(f"request {request_id}: cache full at {pos}/{max_len}")
        num_tokens = min(num_tokens, 1 << ((max_len - pos).bit_length() - 1))
      temps = self._device_values([temp], torch.float32)
      toks = self._ring_dispatch([segs], self._device_values([[prev_token]], torch.int64),
                                 num_tokens, temps, top_k, top_p)
    now = time.monotonic()
    last_ctx, last_state = segs[-1][1], states[-1]
    others_active = any(st is not last_state and now - st.last_used < 1.0
                        for st in list(last_ctx.states.values()))
    ahead = record = None
    if next_size and self.overlap and not others_active and states[0].pos + next_size <= max_len:
      gc = self._ring_graph_cache(segs)
      if gc is not None and self.device.type == "cuda":
        ahead = graphs.host_copy(gc, toks)
      pos_before = states[0].pos
      ntoks = self._ring_dispatch([segs], toks[:, -1:], next_size, temps, top_k, top_p)
      record = {"toks": ntoks, "n": next_size, "pos": pos_before, "temp": temp, "top_k": top_k,
                "top_p": top_p, "temps": temps, "states": list(states)}
    host = self._read_back(None, toks, ahead)[0]
    if record is not None:
      record["prev"] = int(host[-1])
      self._ring_spec[request_id] = record
    return host

  @staticmethod
  def _ring_rollback(spec: dict) -> None:
    """Roll back the states a ring chunk dispatched ahead advanced (the recorded ones:
    a replaced state keeps its own position)."""
    for st in spec["states"]:
      if st.pos == spec["pos"] + spec["n"]:
        st.pos = spec["pos"]

  def _ring_batch_sync(self, items: List[_Pending], num_tokens: int, top_k: int,
                       top_p: float) -> list:
    """The ring batcher's dispatch (an item's `state` holds its segments). A batch of
    one is `_ring_chunk_sync`, with its overlap; 2..B requests roll back any chunk
    dispatched ahead for them and run one batched fused chunk
    (decode_chunk_ring_batched's program). A member whose positions left lockstep, or
    whose caches cannot hold the chunk, gets None (counted): its loop takes the
    per-token ring, which drains the cache's tail."""
    if len(items) == 1:
      it = items[0]
      return [self._ring_chunk_sync(it.state, it.request_id, it.prev_token, num_tokens, it.temp,
                                    top_k, top_p, it.next_size)]
    results: list = [None] * len(items)
    members = []
    for i, it in enumerate(items):
      states = [st for _, _, st in it.state]
      spec = self._ring_spec.pop(it.request_id, None)
      if spec is not None:
        self._overlap_misses += 1
        self._ring_rollback(spec)
      if any(st.pos != states[0].pos for st in states):
        self._ring_decline("lockstep")
        continue
      if states[0].pos + num_tokens > min(ctx.max_cache_len for _, ctx, _ in it.state):
        self._ring_decline("capacity")
        continue
      members.append((i, it))
    if not members:
      return results
    temps = self._device_values([it.temp for _, it in members], torch.float32)
    toks_in = self._device_values([[it.prev_token] for _, it in members], torch.int64)
    toks = self._ring_dispatch([it.state for _, it in members], toks_in, num_tokens, temps,
                               top_k, top_p)
    host = self._read_back(None, toks, None)
    for b, (i, _) in enumerate(members):
      results[i] = host[b]
    self._ring_batch_dispatches += 1
    self._ring_batch_rows += len(members)
    return results

  async def verify_draft_ring(self, request_id: str, chain, prev_token: int,
                              draft: list) -> Optional[list]:
    """Greedy draft verification through every partition of a co-located ring in one
    composite forward (JAX's): [prev_token] + draft, the longest agreeing prefix and the
    bonus token, as verify_draft on one shard. None where the chain does not qualify or
    there is no room: the caller decodes plainly."""
    if not draft:
      return None
    segs = self._resolve_ring_segs(request_id, chain)
    if segs is None:
      return None
    return await self._run(self._ring_verify_sync, segs, request_id, int(prev_token),
                           [int(t) for t in draft])

  def _ring_verify_sync(self, segs: list, request_id: str, prev_token: int,
                        draft: list) -> Optional[list]:
    """[prev_token] + draft padded to a power-of-two bucket through every segment from
    the committed position (K2 at T > 1 in each; one graph replay on the card,
    graphs.verify_ring, the eager forward_argmax_ring on the CPU). Room is judged from
    the committed position before the chunk dispatched ahead is dropped (near the
    cache's end every round would otherwise throw it away); a verify that runs rolls
    it back first. Every segment moves to the accepted position."""
    states = [st for _, _, st in segs]
    T = 1 + len(draft)
    T_pad = _bucket(T)
    max_len = min(ctx.max_cache_len for _, ctx, _ in segs)
    spec = self._ring_spec.get(request_id)
    committed = (spec["pos"] if spec is not None
                 and all(st.pos == spec["pos"] + spec["n"] for st in spec["states"])
                 else states[0].pos)
    if committed + T_pad > max_len:
      return None
    spec = self._ring_spec.pop(request_id, None)
    if spec is not None:
      self._overlap_misses += 1
      self._ring_rollback(spec)
    pos = states[0].pos
    if any(st.pos != pos for st in states):
      self._ring_decline("lockstep")
      return None
    for eng, ctx, st in segs:
      if st.cache["k"].shape[2] < pos + T_pad:
        eng._grow_cache(ctx, st, pos + T_pad)
    t0 = time.monotonic()
    row = [prev_token] + draft + [0] * (T_pad - T)
    x = self._device_values([row], torch.int64)
    params_segs = [ctx.params for _, ctx, _ in segs]
    start_layers = [ctx.shard.start_layer for _, ctx, _ in segs]
    caches = [st.cache for st in states]
    gc = self._ring_graph_cache(segs)
    captures = gc.captures if gc is not None else 0
    if gc is not None:
      preds = graphs.verify_ring(gc, params_segs, x, caches, pos, segs[-1][1].cfg, start_layers,
                                 route=self.quant_route)
    else:
      preds, _ = forward_argmax_ring(params_segs, x, caches, pos, segs[-1][1].cfg, start_layers,
                                     route=self.quant_route)
    preds = preds[0, :T].cpu().numpy()
    n_acc = 0
    while n_acc < len(draft) and int(preds[n_acc]) == draft[n_acc]:
      n_acc += 1
    accepted = draft[:n_acc] + [int(preds[n_acc])]
    now = time.monotonic()
    for st in states:
      st.pos = pos + 1 + n_acc
      st.last_used = now
    self._spec_proposed += len(draft)
    self._spec_accepted += n_acc
    self._observe_spec(len(draft), n_acc)
    self._observe_dispatch("verify", ("verify", "ring", T_pad), now - t0, tokens=T_pad,
                           captured=(gc.captures - captures) if gc is not None else 0,
                           emitted=len(accepted))
    if self.flight is not None:
      self.flight.record("spec.verify", request_id, drafted=len(draft), accepted=n_acc,
                         paged=False)
    return accepted

  def _discard_spec(self, request_id: str, state: Optional[_RequestState] = None) -> None:
    """Drop a request's chunk dispatched ahead and roll its position back. Every other
    touch of the request's device state (a segment forward, a verify, a batched chunk,
    clearing it) calls this first: it must see the committed position. The rolled-back
    slots hold the unused chunk's K/V past the position, where no query reads them and
    the next write overwrites them."""
    spec = self._spec_next.pop(request_id, None)
    if spec is not None and state is not None and state.pos == spec["pos"] + spec["n"]:
      state.pos = spec["pos"]

  def _discard_batch_spec(self, ctx: _ShardContext) -> None:
    """Drop the context's batch dispatched ahead: every member rolls back."""
    spec, ctx.batch_spec = ctx.batch_spec, None
    if spec is None:
      return
    for st, p in zip(spec["states"], spec["pos"]):
      if st.pos == p + spec["n"]:
        st.pos = p

  def _discard_batch_spec_for(self, ctx: _ShardContext, request_id: str) -> None:
    """Discard the batch dispatched ahead if `request_id` is one of its members."""
    if ctx.batch_spec is not None and request_id in ctx.batch_spec["rids"]:
      self._discard_batch_spec(ctx)

  def _committed_pos(self, ctx: _ShardContext, request_id: str, state: _RequestState) -> int:
    """The request's position without a chunk in flight for it: what capacity checks
    judge by."""
    spec = self._spec_next.get(request_id)
    if spec is not None and state.pos == spec["pos"] + spec["n"]:
      return spec["pos"]
    b = ctx.batch_spec
    if b is not None and request_id in b["rids"]:
      i = b["rids"].index(request_id)
      if state.pos == b["pos"][i] + b["n"]:
        return b["pos"][i]
    return state.pos

  # ------------------------------------------------------------ paged KV
  #
  # XOT_PAGED_KV=1: requests' KV lives as fixed-size pages in ONE shared arena per
  # context (paged_cache.PagePool). With paged-native prefill (XOT_PAGED_PREFILL, on
  # by default) every prompt segment writes straight into pool pages, so the arena
  # is a request's home for its whole life; with it off a request prefills into a
  # contiguous buffer and is committed to pages at its first decode chunk. Decode
  # chunks index the arena through per-request page tables resolved from VirtualKV
  # handles at each dispatch: batch membership is metadata, appends allocate pages
  # instead of grow-copying, and attention reads only each row's occupied pages.

  def _ensure_page_pool(self, ctx: _ShardContext) -> PagePool:
    if ctx.page_pool is None:
      page = self.kv_page
      tokens = knobs.get_int("XOT_KV_POOL_TOKENS")
      if tokens <= 0:
        # Room for one max-length context plus a resident set of initial-size ones.
        tokens = ctx.max_cache_len + self.max_resident * ctx.cache_len
      num_pages = -(-tokens // page) + 1  # +1: the scratch page 0
      ctx.page_pool = PagePool(ctx.cfg, ctx.shard.get_layer_count(), num_pages, page,
                               dtype=self.dtype, device=self.device,
                               kv_quant=self.kv_quant is not None, mesh=ctx.mesh)
      if DEBUG >= 1:
        print(f"KV page pool ready: {num_pages - 1} pages x {page} tokens")
    return ctx.page_pool

  def _pool_alloc(self, ctx: _ShardContext, pool: PagePool, n: int) -> list:
    """pool.alloc with reclaim: prefix entries are caches and yield to live requests
    under pool pressure. Evict the oldest entry (spilled to the host tier first) and
    retry; an entry whose pages live requests share frees nothing and the loop goes
    on. Only with no entry left does CacheExhausted surface. Flight events:
    `pool.alloc` for pages taken, `pool.pressure` for each failed attempt."""
    while True:
      try:
        ids = pool.alloc(n)
        if self.flight is not None and n > 0:
          self.flight.record("pool.alloc", None, pages=n, free=pool.free_pages)
        return ids
      except CacheExhausted:
        if self.flight is not None:
          self.flight.record("pool.pressure", None, need=n, free=pool.free_pages,
                             in_use=pool.pages_in_use)
        evicted = False
        while ctx.prefix_cache and not evicted:
          evicted = self._evict_oldest_prefix(ctx)
        if not evicted:
          raise

  def _commit_state_to_pages(self, ctx: _ShardContext, state: _RequestState) -> None:
    """Move a request prefilled into a contiguous buffer (XOT_PAGED_PREFILL=0) into
    pool pages and free the buffer. Shared prefix pages it was seeded from
    (`paged_seed`, whole pages below pos) become the table's head; only the rest is
    copied."""
    pool = self._ensure_page_pool(ctx)
    seed = list(state.paged_seed or [])
    fresh = self._pool_alloc(ctx, pool, pool.pages_for(state.pos) - len(seed))
    if fresh:
      commit_pages(pool.arena, state.cache, fresh, start_page=len(seed))
      for leaf in pool.arena.values():  # [L, P, page, ...]: K/V, an int8 arena's scales
        self._commit_copy_bytes += len(fresh) * leaf[:, 0].numel() * leaf.element_size()
    state.pages = VirtualKV(seed + fresh)
    state.paged_seed = None
    state.cache = None

  def _get_or_create_paged_state(self, ctx: _ShardContext, request_id: str) -> _RequestState:
    """The page-backed twin of _get_or_create_state: the state never owns a contiguous
    buffer (cache None, no pages yet)."""
    state = ctx.states.get(request_id)
    if state is None:
      self._check_not_lost(request_id)
      state = self._admit(ctx, request_id, _RequestState(cache=None, pos=0,
                                                         last_used=time.monotonic(),
                                                         pages=VirtualKV()))
    ctx.states.move_to_end(request_id)
    return state

  def _prep_state_paged(self, ctx: _ShardContext, request_id: str, bucket: int) -> _RequestState:
    """Page-backed twin of _prep_state: capacity for `bucket` more tokens is pages.
    The table covers the padded bucket, whose garbage lands in pages this request
    owns (_advance trims them afterwards). Pool exhaustion raises CacheExhausted
    before any device work, for this request only."""
    pool = self._ensure_page_pool(ctx)
    state = self._get_or_create_paged_state(ctx, request_id)
    self._discard_spec(request_id, state)
    self._discard_batch_spec_for(ctx, request_id)
    needed = state.pos + bucket
    if needed > ctx.max_cache_len:
      raise CacheExhausted(
        f"Request {request_id}: {bucket} new tokens at pos {state.pos} "
        f"exceed max cache length {ctx.max_cache_len}")
    need_pages = pool.pages_for(needed)
    if need_pages > len(state.pages):
      state.pages.extend(self._pool_alloc(ctx, pool, need_pages - len(state.pages)))
    return state

  def _paged_table_for(self, ctx: _ShardContext, state: _RequestState) -> torch.Tensor:
    """The request's [1, maxp] page table on the device, the width bucketed to a
    power of two (0-padded: the scratch page, masked)."""
    maxp = _bucket(max(len(state.pages), 1), 1)
    return torch.as_tensor(vkv.resolve_page_table([state.pages], maxp), device=self.device)

  def _paged_fill_sync(self, ctx: _ShardContext, request_id: str, input_data) -> None:
    """Fill-only paged-native prefill of whole segments: they go straight into the
    request's pool pages through the scan prefill (K4, one program for each
    power-of-two group, from one segment up, as in JAX). A windowed model then gives
    back the pages its window slid past: later segments' queries sit past them."""
    chunk = self._prefill_chunk()
    total = int(input_data.shape[1])
    state = self._prep_state_paged(ctx, request_id, total)
    x = self._to_device_input(input_data)
    table = self._paged_table_for(ctx, state)
    self._prefill_groups(ctx, state, x, ctx.page_pool.arena, chunk, False, page_table=table)
    state.pos += total
    self._vkv_window_release(ctx, state)
    state.last_used = time.monotonic()

  def _decode_batch_paged_sync(self, ctx: _ShardContext, items: List[_Pending], num_tokens: int,
                               top_k: int, top_p: float) -> List[np.ndarray]:
    """Paged twin of the batched chunk: commit any member still on its prefill
    buffer, append pages to cover the chunk, and run ONE decode_chunk_paged dispatch
    over the shared arena. The table width is bucketed to a power of two."""
    pool = self._ensure_page_pool(ctx)
    states = [it.state for it in items]
    for it in items:
      # The paged path runs no chunk ahead; a record left by the contiguous path goes.
      self._discard_spec(it.request_id, it.state)
      self._discard_batch_spec_for(ctx, it.request_id)
    for it in items:
      if it.state.pos + 1 > ctx.max_cache_len:
        raise CacheExhausted(f"request {it.request_id}: cache full at "
                             f"{it.state.pos}/{ctx.max_cache_len}")
    tail = min(ctx.max_cache_len - s.pos for s in states)
    if num_tokens > tail:
      num_tokens = 1 << (tail.bit_length() - 1)
    for state in states:
      if state.pages is None:
        self._commit_state_to_pages(ctx, state)
      need = pool.pages_for(state.pos + num_tokens)
      if need > len(state.pages):
        state.pages.extend(self._pool_alloc(ctx, pool, need - len(state.pages)))
    B = len(states)
    maxp = _bucket(max(len(s.pages) for s in states), 1)
    table = torch.as_tensor(vkv.resolve_page_table([s.pages for s in states], maxp),
                            device=self.device)
    toks_in = torch.tensor([[it.prev_token] for it in items], dtype=torch.int64, device=self.device)
    pos = torch.tensor([s.pos for s in states], dtype=torch.int32, device=self.device)
    temps = torch.tensor([it.temp for it in items], dtype=torch.float32, device=self.device)
    ex = states[0].extras or graphs.PLAIN
    generator = self._generator_for(ex, items[0].request_id, states[0].pos)
    if ctx.graphs is not None:
      toks, report = graphs.decode_paged(
        ctx.graphs, ctx.params, pool.arena, table, toks_in, pos, ctx.cfg, num_tokens, temps, top_k,
        top_p, route=self.quant_route, generator=generator, extras=ex)
    else:
      toks, _, *rest = decode_chunk_paged(
        ctx.params, pool.arena, table, toks_in, pos, ctx.cfg, num_tokens, temps, top_k, top_p,
        pad_rows=_bucket(B, 1) - B, generator=generator, route=self.quant_route,
        **ex.sampler_kwargs())
      report = ex.absorb(rest)
    if report is not None:
      self._record_logprobs(items[0].request_id, *(t[0] for t in report))
    host = toks.cpu().numpy().astype(np.int64)
    for state in states:
      self._advance(ctx, state, num_tokens)
    return [host[i] for i in range(B)]

  def _release_state_pages(self, ctx: _ShardContext, state: _RequestState) -> None:
    """Return a finished or evicted request's page references to the pool: its table
    and any prefix pages it was seeded from and has not committed yet. Pages shared
    with the prefix cache or other requests live on through their own references."""
    pool = ctx.page_pool
    if pool is None:
      return
    if state.pages is not None:
      pool.decref(state.pages.live())
      state.pages = None
    if state.paged_seed:
      pool.decref(state.paged_seed)
      state.paged_seed = None

  def _vkv_window_release(self, ctx: _ShardContext, state: _RequestState) -> None:
    """Sliding-window page reclamation: once every layer of the shard is windowed
    (mistral with a window; not gemma2, whose global layers read every page), pages
    wholly behind the widest window can never be read again; their slots go to the
    scratch page and the pages back to the pool."""
    w = vkv.freeable_window(ctx.cfg, ctx.shard.start_layer, ctx.shard.get_layer_count())
    if w <= 0:
      return
    freed = state.pages.release_below(vkv.dead_page_count(state.pos, w, ctx.page_pool.page_size))
    if freed:
      ctx.page_pool.decref(freed)
      if self.flight is not None:
        self.flight.record("vkv.window_free", None, pages=len(freed), pos=state.pos, window=w)

  def _defrag_sync(self, ctx: _ShardContext) -> int:
    """One bounded compaction pass (batcher-idle slots, on the executor): copy the
    highest used pages into the lowest free holes, then rewrite only the virtual
    maps (request tables, uncommitted prefix seeds, prefix entries). Tables are
    resolved afresh at every dispatch, so no request sees the move. Returns the pages
    moved."""
    pool = ctx.page_pool
    plan = pool.defrag_plan(max(1, knobs.get_int("XOT_KV_DEFRAG_MAX_MOVES")))
    if not plan:
      return 0
    migrate_pages(pool.arena, [s for s, _ in plan], [d for _, d in plan])
    mapping = dict(plan)
    for st in ctx.states.values():
      if st.pages is not None:
        st.pages.remap(mapping)
      if st.paged_seed:
        st.paged_seed = vkv.remap_ids(st.paged_seed, mapping)
    for _, entry in ctx.prefix_cache.values():
      if "pages" in entry:
        entry["pages"] = vkv.remap_ids(entry["pages"], mapping)
    pool.apply_moves(plan)
    self.defrag_moves += len(plan)
    if self.flight is not None:
      self.flight.record("vkv.defrag", None, moves=len(plan), fragmentation=pool.fragmentation())
    return len(plan)

  def page_pool_stats(self) -> Optional[Dict[str, int]]:
    """Page-pool occupancy summed over the resident contexts, or None when no pool
    exists."""
    pools = [c.page_pool for c in list(self._contexts.values()) if c.page_pool is not None]
    if not pools:
      return None
    return {"pages_in_use": sum(p.pages_in_use for p in pools),
            "free_pages": sum(p.free_pages for p in pools),
            "peak_pages_in_use": sum(p.peak_pages_in_use for p in pools),
            "fragmentation": sum(p.fragmentation() for p in pools),
            "defrag_moves": self.defrag_moves}

  # ------------------------------------------------------------ prefix cache

  @staticmethod
  def _best_hbm_prefix(ctx: _ShardContext, toks: np.ndarray,
                       limit: int) -> Tuple[Optional[int], int]:
    """(key, common length) of the device prefix entry with the longest common token
    prefix with `toks` (capped at `limit`): the one scan of _prefix_reuse (the entry to
    seed from) and _host_promote (a host entry must beat every device one)."""
    best_key, best_len = None, 0
    for key, (ptoks, _) in ctx.prefix_cache.items():
      common = common_prefix_len(ptoks, toks, limit)
      if common > best_len:
        best_key, best_len = key, common
    return best_key, best_len

  def _prefix_reuse(self, ctx: _ShardContext, request_id: str, tokens_2d: np.ndarray,
                    paged_native: bool = False) -> int:
    """Seed a fresh request from the entry with the longest common token prefix
    (causality: positions below it are valid whatever follows). The host tier is
    consulted first, so a spilled prefix is back on the device before the scan. Returns
    the positions consumed (0: no hit). A paged entry is taken in whole pages: with
    paged-native prefill the matched pages become the request's table head in place
    (one more reference each; nothing is copied); otherwise they are gathered into
    its contiguous prefill buffer and held (`paged_seed`) for its commit. A contiguous
    snapshot is copied into the request's fresh cache."""
    if self._prefix_cache_max <= 0:
      return 0
    toks = np.asarray(tokens_2d).reshape(-1).astype(np.int64)
    self._host_promote(ctx, toks, request_id=request_id)
    if not ctx.prefix_cache:
      return 0
    limit = toks.shape[0] - 1  # at least one token must still be forwarded
    best_key, best_len = self._best_hbm_prefix(ctx, toks, limit)
    if best_key is None or best_len < self._prefix_cache_min:
      return 0
    _, entry = ctx.prefix_cache[best_key]
    ctx.prefix_cache.move_to_end(best_key)
    if "pages" in entry:
      pool = ctx.page_pool
      page = pool.page_size
      # Whole pages only: the suffix and later appends then write past the shared ones.
      consumed = (min(best_len, entry["len"]) // page) * page
      if consumed < self._prefix_cache_min:
        return 0
      ids = list(entry["pages"][:consumed // page])
      if paged_native:
        state = self._get_or_create_paged_state(ctx, request_id)
        pool.incref(ids)
        state.pages = VirtualKV(ids)
      else:
        state = self._get_or_create_state(ctx, request_id, min_len=toks.shape[0])
        gathered = gather_pages(pool.arena, ids)
        for name, buf in state.cache.items():
          buf[:, :, :consumed].copy_(gathered[name][:, :, :consumed])
        pool.incref(ids)
        state.paged_seed = ids
    else:
      consumed = best_len
      state = self._get_or_create_state(ctx, request_id, min_len=toks.shape[0])
      for name, buf in state.cache.items():
        buf[:, :, :consumed].copy_(entry[name][:, :, :consumed])
    state.pos = consumed
    self._prefix_hits += 1
    self._prefix_tokens_saved += consumed
    if DEBUG >= 2:
      print(f"[{request_id}] prefix cache hit: {consumed} tokens reused")
    return consumed

  def _prefix_store(self, ctx: _ShardContext, request_id: str, tokens_2d: np.ndarray) -> None:
    """Keep a finished prefill's KV for later prompts sharing its head. Under
    XOT_PAGED_KV the entry holds one more reference to each of the prompt's whole
    pages (a contiguous request is committed to pages first): one arena copy of a hot
    prompt however many requests and entries hold it. A windowed request whose window
    has released head pages stores nothing. Otherwise the entry is a clone of the
    cache's first T positions: a slice is a view, and decode and the slab copy-back
    write the live cache in place. Past XOT_PREFIX_CACHE entries the oldest is spilled
    and dropped."""
    if self._prefix_cache_max <= 0:
      return
    toks = np.asarray(tokens_2d).reshape(-1).astype(np.int64)
    T = toks.shape[0]
    if T < self._prefix_cache_min:
      return
    state = ctx.states.get(request_id)
    if state is None or state.pos < T:
      return
    key = hash(toks.tobytes())
    if key in ctx.prefix_cache:
      ctx.prefix_cache.move_to_end(key)
      return
    if self.paged:
      try:
        pool = self._ensure_page_pool(ctx)
        if state.pages is None:
          self._commit_state_to_pages(ctx, state)
      except CacheExhausted:
        # Caching is best effort: a full pool must never fail a finished prefill (the
        # decode path commits again and reports capacity where it must).
        return
      n_full = T // pool.page_size
      ids = state.pages.prefix_ids(n_full) if n_full > 0 else None
      if ids is None:
        return
      pool.incref(ids)
      ctx.prefix_cache[key] = (toks, {"pages": ids, "len": n_full * pool.page_size})
    else:
      ctx.prefix_cache[key] = (toks, {name: buf[:, :, :T].clone()
                                      for name, buf in state.cache.items()})
    while len(ctx.prefix_cache) > self._prefix_cache_max:
      self._evict_oldest_prefix(ctx)

  def _evict_oldest_prefix(self, ctx: _ShardContext) -> bool:
    """Spill the least recently used prefix entry to the host tier, then release it.
    True when it held pool pages (whose release may have freed some)."""
    _, (etoks, entry) = ctx.prefix_cache.popitem(last=False)
    self._spill_prefix_entry(ctx, etoks, entry)
    self._prefix_evictions += 1
    if "pages" in entry and ctx.page_pool is not None:
      ctx.page_pool.decref(entry["pages"])
      return True
    return False

  def _clear_prefix_cache(self, ctx: _ShardContext) -> None:
    """Drop every prefix entry, paged ones' page references too, and the host tier's
    entries of this context, unspilled: a caller clears because the entries are no
    longer valid (new weights)."""
    pool = ctx.page_pool
    for _, entry in ctx.prefix_cache.values():
      if pool is not None and "pages" in entry:
        pool.decref(entry["pages"])
    ctx.prefix_cache.clear()
    if self._host_kv is not None:
      self._host_kv.drop_ctx(ctx.shard)

  # ------------------------------------------------------------ host KV tier
  #
  # A second KV tier under the prefix cache (kv_offload.HostKVStore, bounded by
  # XOT_KV_HOST_BYTES, LRU). Every prefix eviction (the LRU bound, pool-pressure
  # reclaim, OOM recovery) copies the entry to the host first; _prefix_reuse consults
  # the tier whenever the device cache misses or matches shorter, and a host hit
  # re-creates the device entry (fresh pool pages, or a fresh snapshot) so that the
  # request then takes the native warm path. Any validation or capacity failure on
  # restore falls back to a cold prefill: never a wrong token, never a client error.

  def _host_kv_store(self) -> Optional[HostKVStore]:
    """The engine's host tier, made at its first use, or None when
    XOT_KV_HOST_BYTES is 0."""
    if self._host_kv_max_bytes <= 0:
      return None
    if self._host_kv is None:
      self._host_kv = HostKVStore(self._host_kv_max_bytes)
      self._host_kv.observer = self._host_evict_event
    return self._host_kv

  def _host_evict_event(self, entries: int, nbytes: int) -> None:
    """The tier's budget evictions, as `host.evict` flight events."""
    if self.flight is not None:
      self.flight.record("host.evict", None, entries=entries, bytes=nbytes)

  def host_kv_stats(self) -> Optional[Dict[str, int]]:
    """The host tier's occupancy for /metrics and /v1/perf, and the restores that fell
    back to a cold prefill; None while the tier does not exist."""
    store = self._host_kv
    if store is None:
      return None
    return {"bytes": store.total_bytes, "entries": len(store),
            "restore_fallbacks": self._host_restore_fallbacks}

  def _cache_leaf_names(self) -> set:
    """The leaves a restored entry must carry for the current cache config: K and V,
    and their scales under an int8 KV cache (whole leaves: a mesh's pieces are joined
    on spill, kv_offload.join_pieces)."""
    names = {"k", "v"}
    if self.kv_quant is not None:
      names |= {"k_scale", "v_scale"}
    return names

  def _leaf_dtype(self, name: str) -> torch.dtype:
    base = name.split("@")[0]
    return torch.int8 if self.kv_quant is not None and base in ("k", "v") else self.dtype

  def _leaf_device(self, ctx: _ShardContext, name: str) -> torch.device:
    """Where a cache leaf lives: a mesh piece on its tp index's device."""
    if ctx.mesh is None:
      return self.device
    return cache_device(ctx.mesh, int(name.split("@")[1]) if "@" in name else 0)

  def _spill_prefix_entry(self, ctx: _ShardContext, toks, entry: dict) -> bool:
    """Copy one evicted prefix entry to the host tier, best effort (it runs inside
    eviction and OOM recovery: a failed spill only means the entry dies). A paged
    entry's pages are gathered into the canonical contiguous layout first, and a mesh's
    cache pieces joined into whole leaves (JAX's layout)."""
    store = self._host_kv_store()
    if store is None:
      return False
    try:
      t0 = time.monotonic()
      toks = np.asarray(toks).reshape(-1).astype(np.int64)
      if "pages" in entry:
        if ctx.page_pool is None:
          return False
        gathered = gather_pages(ctx.page_pool.arena, entry["pages"])
        data = {name: to_host(buf) for name, buf in gathered.items()}
        length = int(entry["len"])
      else:
        data = {name: to_host(buf) for name, buf in entry.items()}
        length = int(data["k"].shape[2])
      n = store.put(ctx.shard, toks, join_pieces(data), length)
      if n > 0:
        self._host_spill_bytes += n
        if self.flight is not None:
          self.flight.record("host.spill", None, tokens=length, bytes=n,
                             secs=round(time.monotonic() - t0, 4))
      return n > 0
    except Exception as e:
      if DEBUG >= 1:
        print(f"host KV spill failed (entry dropped): {e!r}")
      return False

  def _host_promote(self, ctx: _ShardContext, toks: np.ndarray,
                    request_id: Optional[str] = None) -> None:
    """If the host tier holds a usable prefix of `toks` longer than any device entry,
    copy it back and re-create the device entry: fresh pool pages under XOT_PAGED_KV
    (whole pages), else a snapshot cut to the tokens the entry covers (a paged spill
    keeps the whole prompt's tokens but only its whole pages' KV). A torn entry, or one
    spilled under another cache config, is dropped; a restore that races pool pressure
    leaves the entry for later. Either way the request prefills cold
    (`_host_restore_fallbacks` counts it). Runs on the executor, on the prefill lane
    when co-scheduled."""
    store = self._host_kv_store()
    limit = toks.shape[0] - 1
    if store is None or limit <= 0 or (len(store) == 0 and self._fabric_client() is None):
      return
    _, hbm_best = self._best_hbm_prefix(ctx, toks, limit)
    entry, common = store.match(ctx.shard, toks, limit) if len(store) else (None, 0)
    local_usable = min(common, entry.length) if entry is not None else 0
    # A local miss, or a shorter local match, consults the fabric first: an imported
    # entry lands in the host tier and is restored by the code below. Only an entry
    # worth a restore is fetched: past every local tier and at least
    # XOT_PREFIX_CACHE_MIN tokens (JAX's engine fetches any longer match, one that
    # shares just a chat template's first tokens too, and then restores none of it).
    if local_usable < limit and self._fabric_consult(
        ctx, toks, limit, max(local_usable, hbm_best, self._prefix_cache_min - 1),
        request_id=request_id):
      entry, common = store.match(ctx.shard, toks, limit)
    if entry is None:
      return
    t0 = time.monotonic()
    usable = min(common, entry.length)
    cfg = ctx.cfg
    try:
      leaf = entry.data.get("k")
      if (set(entry.data) != self._cache_leaf_names() or leaf is None or leaf.ndim != 5
          or leaf.shape[0] != ctx.shard.get_layer_count()
          or leaf.shape[3:] != (cfg.num_kv_heads, cfg.head_dim)
          or any(a.shape[2] < entry.length for a in entry.data.values())):
        # Torn, or spilled under another cache config: unusable here, and keeping it
        # would shadow fresher entries.
        store.drop(ctx.shard, entry.toks)
        self._host_restore_fallbacks += 1
        return
      # A mesh's cache takes the whole leaves back as its pieces.
      data = split_pieces(entry.data, ctx.mesh.axis_size("tp") if ctx.mesh is not None else 1)
      if self.paged:
        pool = self._ensure_page_pool(ctx)
        page = pool.page_size
        if (usable // page) * page <= max(hbm_best, self._prefix_cache_min - 1):
          return  # the scan would not take what a restore brought back
        n_full = entry.length // page
        if n_full <= 0:
          return
        ids = self._pool_alloc(ctx, pool, n_full)
        try:
          scatter_pages(pool.arena, data, ids)
        except Exception:
          pool.decref(ids)
          raise
        restored = (entry.toks, {"pages": ids, "len": n_full * page})
      else:
        if usable <= max(hbm_best, self._prefix_cache_min - 1):
          return
        restored = (np.ascontiguousarray(entry.toks[:entry.length]),
                    {name: from_host(arr[:, :, :entry.length], self._leaf_dtype(name),
                                     self._leaf_device(ctx, name))
                     for name, arr in data.items()})
    except CacheExhausted:
      # Live requests hold every page: the entry waits in the tier for a calmer moment.
      self._host_restore_fallbacks += 1
      return
    except Exception as e:
      if DEBUG >= 1:
        print(f"host KV restore failed (entry dropped, cold prefill): {e!r}")
      store.drop(ctx.shard, entry.toks)
      self._host_restore_fallbacks += 1
      return
    key = hash(np.ascontiguousarray(restored[0]).tobytes())
    old = ctx.prefix_cache.pop(key, None)
    if old is not None and "pages" in old[1] and ctx.page_pool is not None:
      ctx.page_pool.decref(old[1]["pages"])
    ctx.prefix_cache[key] = restored
    while len(ctx.prefix_cache) > self._prefix_cache_max:
      self._evict_oldest_prefix(ctx)
    self._host_kv_hits += 1
    self._host_hits_by_source[entry.source] = self._host_hits_by_source.get(entry.source, 0) + 1
    self._host_fetch_bytes += entry.nbytes
    if self.flight is not None:
      self.flight.record("host.restore", None, tokens=entry.length, bytes=entry.nbytes,
                         source=entry.source, secs=round(time.monotonic() - t0, 4))
    if DEBUG >= 2:
      print(f"[{request_id}] host KV tier hit: {entry.length}-token prefix restored "
            f"({entry.nbytes} bytes)")

  # ------------------------------------------------------------ KV fabric
  #
  # Cross-replica prefix transfer (fabric/): a prefix that misses the device cache and
  # the local host tier consults sibling replicas, the offer directory first (the
  # router's prefill chain and spill pre-announce land offers there), then the static
  # XOT_FABRIC_PEERS probes, and imports the longest covering entry into the host tier
  # with its digest verified. _host_promote then restores it as it restores a local
  # spill (fresh pool pages, or a snapshot), held to the same leaf and shape checks.
  # Every failure (an unreachable peer, a torn blob, a digest mismatch, a stale offer)
  # is counted and the request prefills cold.

  def _fabric_client(self, create: bool = False):
    """The fabric's pull client, or None while the fabric is idle: built when
    XOT_FABRIC_PEERS names siblings, or at the first offer (`create`)."""
    if self._fabric is None:
      if not self._fabric_peers and not create:
        return None
      from xotorch_tpu_torch.fabric.client import FabricClient
      self._fabric = FabricClient(self._fabric_peers, timeout_s=self._fabric_timeout_s,
                                  offer_ttl_s=self._fabric_offer_ttl_s)
    return self._fabric

  def fabric_offer(self, shard: Shard, toks, length: int, nbytes: int, url: str) -> bool:
    """Record a sibling's announce (`POST /v1/kv/offer`): peer `url` holds a host-tier
    entry covering `toks`, so the next local miss resolves coverage without a probe.
    False when the host tier is off (an import would have nowhere to land)."""
    if self._host_kv_max_bytes <= 0:
      return False
    key = self._fabric_client(create=True).offers.record(shard, toks, length, nbytes, url)
    if self.flight is not None:
      self.flight.record("fabric.offer", None, key=key[:16], tokens=int(length),
                         bytes=int(nbytes), peer=url)
    return True

  async def prefetch_fabric_offer(self, shard: Shard, toks) -> bool:
    """Pull a just-offered prefix ahead of its request: the fabric fetch and the
    restore run while the chained request is still on its way here. The loaded
    context only, through the prefill lane when a batcher exists; best effort. True
    when fabric bytes were imported."""
    ctx = self._contexts.get(shard)
    toks = np.asarray(toks, dtype=np.int64).reshape(-1)
    if ctx is None or toks.shape[0] < 2:
      return False
    fetched_before = self._fabric_bytes
    promote = partial(self._host_promote, ctx, toks)
    if ctx.batcher is not None:
      await ctx.batcher.submit_prefill(promote)
    else:
      await self._run(promote)
    return self._fabric_bytes > fetched_before

  def _fabric_consult(self, ctx: _ShardContext, toks: np.ndarray, limit: int, have: int,
                      request_id: Optional[str] = None) -> bool:
    """Fetch the best sibling entry covering `toks` past `have` (what the local tiers
    cover) and import it into the host tier. Runs on the executor inside
    _host_promote; the transfer is its own span (engine.fabric_fetch). True when an
    entry landed."""
    client = self._fabric_client()
    store = self._host_kv_store()
    if client is None or store is None:
      return False
    t0 = time.monotonic()
    with self._engine_span("engine.fabric_fetch", request_id):
      res = client.fetch(ctx.shard, toks, limit, better_than=have)
    self._fabric_errors += res.errors
    if res.payload is None:
      self._fabric_misses += 1
      return False
    n = store.import_entry(ctx.shard, res.payload, source="fabric")
    if n <= 0:
      # A digest mismatch or an over-budget payload: dropped as a torn local entry is.
      self._fabric_errors += 1
      self._fabric_misses += 1
      if DEBUG >= 1:
        print(f"fabric import rejected (torn or over-budget transfer from {res.url})")
      return False
    self._fabric_hits += 1
    self._fabric_bytes += n
    if self.flight is not None:
      self.flight.record("fabric.fetch", request_id, tokens=int(res.payload["length"]), bytes=n,
                         peer=res.url, secs=round(time.monotonic() - t0, 4))
    if DEBUG >= 2:
      print(f"[{request_id}] fabric fetch: {res.payload['length']}-token prefix imported "
            f"from {res.url} ({n} bytes)")
    return True

  async def prefill_export(self, shard: Shard, prompt: str) -> Optional[dict]:
    """Disaggregated prefill (XOT_FABRIC_ROLE=prefill): prefill the prompt here, copy
    the resulting prefix entry into the host tier (the device entry stays) and return
    a transfer handle, which the router offers at a decode replica. None when the
    prompt is too short to cache or the host tier or the prefix cache is off (the
    router then forwards plainly)."""
    if self._host_kv_max_bytes <= 0 or self._prefix_cache_max <= 0:
      return None
    import uuid
    ctx = await self._ensure_ctx(shard)
    toks = np.asarray(ctx.tokenizer.encode(prompt), dtype=np.int64).reshape(-1)
    if toks.shape[0] < max(2, self._prefix_cache_min):
      return None
    rid = f"fabric-prefill-{uuid.uuid4().hex[:12]}"
    try:
      await self.infer_sample_tensor(rid, shard, toks.reshape(1, -1), temp=0.0)
      return await self._run(self._export_prefix_sync, ctx, toks)
    finally:
      await self.clear_request(rid)

  def _export_prefix_sync(self, ctx: _ShardContext, toks: np.ndarray) -> Optional[dict]:
    """Copy a just-prefilled prompt's device prefix entry to the host tier (a copy: the
    entry and its live references stay) and describe the host entry for an offer."""
    store = self._host_kv_store()
    if store is None:
      return None
    hit = ctx.prefix_cache.get(hash(np.ascontiguousarray(toks).tobytes()))
    if hit is not None:
      self._spill_prefix_entry(ctx, *hit)
    entry, common = store.match(ctx.shard, toks, toks.shape[0])
    if entry is None or entry.length <= 0:
      return None
    from xotorch_tpu_torch.fabric import entry_key
    return {"key": entry_key(ctx.shard, entry.toks), "length": int(entry.length),
            "nbytes": int(entry.nbytes), "covered": int(min(common, entry.length)),
            "tokens": [int(t) for t in entry.toks]}

  async def prefetch_host_prefix(self, shard: Shard, prompt: str) -> bool:
    """Restore a queued prompt's spilled prefix from the host tier (or, through it,
    from a sibling over the fabric) before the request is admitted, so that it then
    takes the native warm path. Best effort: the loaded context only (a prefetch never
    loads a model), through the batcher's prefill lane when one exists (decode first).
    True when bytes were restored."""
    store = self._host_kv
    ctx = self._contexts.get(shard)
    if (store is None or len(store) == 0) and self._fabric_client() is None:
      return False
    if self._host_kv_store() is None or ctx is None:
      return False  # no tier: an import would have nowhere to land
    try:
      toks = np.asarray(ctx.tokenizer.encode(prompt), dtype=np.int64).reshape(-1)
    except Exception:
      return False  # the request itself will report an unusable tokenizer
    if toks.shape[0] < 2:
      return False
    fetched_before = self._host_fetch_bytes
    promote = partial(self._host_promote, ctx, toks)
    if ctx.batcher is not None:
      await ctx.batcher.submit_prefill(promote)
    else:
      await self._run(promote)
    return self._host_fetch_bytes > fetched_before

  # ------------------------------------------------------------ KV state

  async def clear_request(self, request_id: str) -> None:
    """Free a request's state in every context, its draft model's state (`rid#draft`)
    too, with the chunk it has dispatched ahead; a batch dispatched ahead with it as a
    member rolls every member back (on the executor: those positions are never moved
    under a running dispatch)."""
    def _clear() -> None:
      self._spec_next.pop(request_id, None)
      self._ring_spec.pop(request_id, None)
      for ctx in list(self._contexts.values()):
        self._discard_batch_spec_for(ctx, request_id)
        for rid in (request_id, self._draft_rid(request_id)):
          self._drop_state(ctx, rid)
    await self._run(_clear, oom_as_cache_exhausted=False)

  def _drop_state(self, ctx: _ShardContext, request_id: str) -> None:
    state = ctx.states.pop(request_id, None)
    if state is not None:
      self._release_state_pages(ctx, state)

  def _check_not_lost(self, request_id: str) -> None:
    """A request whose state OOM recovery dropped fails loudly on its next touch
    rather than starting over from an empty cache."""
    if request_id in self._states_lost_to_oom:
      raise RequestStateLost(f"request {request_id}: device state dropped by OOM recovery")

  def _admit(self, ctx: _ShardContext, request_id: str, state: _RequestState) -> _RequestState:
    """Make `state` resident, evicting the least recently used states past
    XOT_MAX_RESIDENT_REQUESTS (their pages go back to the pool)."""
    ctx.states[request_id] = state
    while len(ctx.states) > self.max_resident:
      evicted, est = ctx.states.popitem(last=False)
      self._release_state_pages(ctx, est)
      if DEBUG >= 2:
        print(f"Evicted request state {evicted}")
    return state

  def _prep_state(self, ctx: _ShardContext, request_id: str, bucket: int) -> _RequestState:
    """State + capacity for `bucket` more tokens (the padded bucket, since the
    padding is written to the cache too)."""
    state = self._get_or_create_state(ctx, request_id, min_len=bucket)
    # A segment forward (a prefill slice, a per-token ring step, a verify) supersedes a
    # chunk dispatched ahead: the capacity below is the committed position's.
    self._discard_spec(request_id, state)
    self._discard_batch_spec_for(ctx, request_id)
    needed = state.pos + bucket
    if needed > ctx.max_cache_len:
      raise CacheExhausted(
        f"Request {request_id}: {bucket} new tokens at pos {state.pos} "
        f"exceed max cache length {ctx.max_cache_len}")
    if needed > state.cache["k"].shape[2]:
      self._grow_cache(ctx, state, needed)
    return state

  def _grow_cache(self, ctx: _ShardContext, state: _RequestState, needed: int) -> None:
    """Double the request's KV buffers (every leaf, an int8 cache's scales too) until
    they fit `needed` (bounded by max_cache_len); contents are kept, new slots are
    zero."""
    S = state.cache["k"].shape[2]
    new_len = S
    while new_len < needed:
      new_len *= 2
    new_len = min(new_len, ctx.max_cache_len)
    grown = {}
    for name, buf in state.cache.items():
      new = torch.zeros(buf.shape[:2] + (new_len,) + buf.shape[3:], dtype=buf.dtype,
                        device=buf.device)
      new[:, :, :S] = buf
      grown[name] = new
    state.cache = grown
    self._grow_copies += 1
    if DEBUG >= 2:
      print(f"KV cache grown {S} -> {new_len}")

  def _get_or_create_state(self, ctx: _ShardContext, request_id: str, min_len: int = 0) -> _RequestState:
    state = ctx.states.get(request_id)
    if state is None:
      self._check_not_lost(request_id)
      length = ctx.cache_len
      while length < min_len and length < ctx.max_cache_len:
        length *= 2
      length = min(length, ctx.max_cache_len)
      state = self._admit(ctx, request_id, _RequestState(
        cache=init_kv_cache(ctx.cfg, ctx.shard.get_layer_count(), 1, length, self.dtype,
                            self.device, kv_quant=self.kv_quant is not None, mesh=ctx.mesh),
        pos=0, last_used=time.monotonic()))
    ctx.states.move_to_end(request_id)
    return state
