"""TorchShardInferenceEngine: the port's compute backend for one NVIDIA GPU.

The port of the single-shard subset of xotorch_tpu/inference/jax_engine/engine.py:

- `ensure_shard` loads a shard: a dense card's HF safetensors checkpoint from the
  directory its downloader gives (models/weights.load_shard_params, straight to the
  device), with the tokenizer of that directory, or the DummyTokenizer and the
  config's eos where none can be built; a synthetic card's random weights from a
  seed. Weights are quantized on the device under `quantize=` / XOT_QUANTIZE (int8 or
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
  hidden state leaves in the model's dtype (bf16 on the card) for the next peer.

Per-request state is either a contiguous [L, 1, S, Hkv, D] KV cache that grows by
powers of two, or (XOT_PAGED_KV=1) a VirtualKV handle of pages in the context's
PagePool, plus a position. With `kv_quant="int8"` / XOT_KV_QUANT=int8 both hold int8
K/V with a scale per (position, head), and attention takes the kernels' int8
variants (K2q, K3q, K4q). Every device computation runs on one executor thread; an
asyncio lock serialises shard loads. The engine reads its knobs when it is built.
It runs on `cuda` unless the caller passes device="cpu" (the tests do), and raises
when no GPU is present rather than falling back to the CPU.

Left out so far: the prefix cache, the host KV tier, co-scheduled prefill,
speculative and overlapped chunks, sampling extras, the fused in-process ring
(`supports_ring_fusion`) and device-resident hops.
"""
from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from xotorch_tpu_torch.inference.engine import CacheExhausted, InferenceEngine, RequestStateLost
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer, tokenizer_for_dir
from xotorch_tpu_torch.inference.torch_engine import vkv
from xotorch_tpu_torch.inference.torch_engine.paged_cache import PagePool, commit_pages, migrate_pages
from xotorch_tpu_torch.inference.torch_engine.vkv import VirtualKV
from xotorch_tpu_torch.models.config import ModelConfig, config_from_hf_dict, load_model_config
from xotorch_tpu_torch.models import graphs
from xotorch_tpu_torch.models.generate import (decode_chunk_batched, decode_chunk_paged, forward_sample,
                                               prefill_scan, scan_groups)
from xotorch_tpu_torch.models.quantize import QUANT_DTYPES, quantize_params
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.transformer import (forward_shard, init_kv_cache, init_random_params,
                                                  quant_route)
from xotorch_tpu_torch.models.weights import load_shard_params
from xotorch_tpu_torch.ops import flash_attention, flash_decode, paged_attention
from xotorch_tpu_torch.ops.sampling import DEFAULT_TEMP, DEFAULT_TOP_K, sample_logits
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG, spawn_detached

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


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


class _DecodeBatcher:
  """Continuous batching at chunk granularity (the port of the JAX engine's
  _DecodeBatcher, without its prefill lane, ring dispatch and speculative slot).

  Concurrent requests each drive their own decode loop; this collector coalesces
  their generate_chunk calls into ONE batched dispatch per drain cycle. Coalescing
  comes from the drain loop, not a timer: while one batch computes on the engine's
  executor, every request that becomes ready queues into `pending`, and the next
  cycle takes them all, so the batch width follows the load. Rows are grouped by
  (top_k, top_p); temperature is per row. A group runs at its smallest requested
  size (bigger requesters loop again) and is cut at XOT_DECODE_BATCH rows. When the
  queue drains, the idle slot goes to one bounded page-pool defrag pass."""

  def __init__(self, engine: "TorchShardInferenceEngine", ctx: _ShardContext):
    self.engine = engine
    self.ctx = ctx
    self.pending: List[_Pending] = []
    self._draining = False
    self._drain_task = None  # strong ref: the loop only weakly holds tasks
    # Dispatches run, rows over all of them (mean width = rows / dispatches), and
    # decode steps over all of them.
    self.dispatches = 0
    self.rows = 0
    self.steps = 0

  async def submit(self, request_id: str, state: _RequestState, prev_token: int,
                   num_tokens: int, temp: float, top_k: int, top_p: float) -> np.ndarray:
    fut = asyncio.get_running_loop().create_future()
    self.pending.append(_Pending(request_id, state, prev_token, num_tokens, temp, top_k, top_p,
                                 fut))
    if not self._draining:
      self._draining = True
      self._drain_task = spawn_detached(self._drain())
    return await fut

  async def _drain(self) -> None:
    batch: List[_Pending] = []
    try:
      # One wait before the first take (an event-loop tick at XOT_BATCH_WINDOW_MS=0):
      # loops woken in the same pass coalesce at once.
      await asyncio.sleep(self.engine.batch_window_s)
      while self.pending:
        batch, self.pending = self.pending, []
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
              results = await self.engine._run(self.engine._decode_batch_sync, self.ctx, chunk,
                                               num_tokens, top_k, top_p)
              self.dispatches += 1
              self.rows += len(chunk)
              self.steps += len(results[0])
              for it, toks in zip(chunk, results):
                if not it.future.done():
                  it.future.set_result(toks)
            except Exception as e:  # fails this dispatch's requests, not the loop
              for it in chunk:
                if not it.future.done():
                  it.future.set_exception(e)
        # Let the resolved requests' loops take their tokens and submit again before
        # the next take, so steady-state batches stay wide.
        await asyncio.sleep(0)
      pool = self.ctx.page_pool
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
      for it in batch + failed:
        if not it.future.done():
          it.future.set_exception(e)
    finally:
      self._draining = False
      if self.pending:
        # A submit slipped in after the last take and saw _draining set.
        self._draining = True
        self._drain_task = spawn_detached(self._drain())


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
    if not knobs.get_bool("XOT_RAGGED_PREFILL"):
      raise ValueError("XOT_RAGGED_PREFILL=0 (the gathered paged view) is not ported: paged "
                       "segments read the pages in place through K4/K4q")
    # The kernels' tile knobs and page sizes are refused here, on the CPU as on the card,
    # rather than at a launch in the middle of a request (the CPU never launches one).
    flash_attention.flash_blocks()
    flash_decode.decode_blocks()
    self.executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torch-engine")
    self._ctx: Optional[_ShardContext] = None
    self._shard_lock = asyncio.Lock()
    self._configured_cache_len = knobs.get_int("XOT_CACHE_LEN")
    self._configured_max_cache_len = knobs.get_int("XOT_MAX_CACHE_LEN")
    self.max_resident = knobs.get_int("XOT_MAX_RESIDENT_REQUESTS")
    self.decode_batch = knobs.get_int("XOT_DECODE_BATCH")
    self.batch_window_s = knobs.get_float("XOT_BATCH_WINDOW_MS") / 1000.0
    self.paged = knobs.get_bool("XOT_PAGED_KV")
    self.kv_page = knobs.get_int("XOT_KV_PAGE")
    if self.paged and self.kv_page not in paged_attention.PAGE_SIZES:
      raise ValueError(f"XOT_KV_PAGE={self.kv_page} with XOT_PAGED_KV=1: the paged kernels "
                       f"(K3, K4) are built for pages of {paged_attention.PAGE_SIZES} tokens")
    self.paged_prefill = knobs.get_bool("XOT_PAGED_PREFILL")
    self.defrag = knobs.get_bool("XOT_KV_DEFRAG")
    self.defrag_moves = 0
    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(int(time.time()) if seed is None else int(seed))

  # ------------------------------------------------------------- accessors

  @property
  def shard(self) -> Optional[Shard]:
    return self._ctx.shard if self._ctx else None

  @property
  def cfg(self) -> Optional[ModelConfig]:
    return self._ctx.cfg if self._ctx else None

  @property
  def tokenizer(self):
    return self._ctx.tokenizer if self._ctx else None

  async def _run(self, fn, *args):
    """Every device computation funnels through the single-worker executor."""
    def call():
      with torch.inference_mode():
        return fn(*args)
    return await asyncio.get_running_loop().run_in_executor(self.executor, call)

  # ------------------------------------------------------------- shard setup

  async def ensure_shard(self, shard: Shard) -> None:
    await self._ensure_ctx(shard)

  async def _ensure_ctx(self, shard: Shard) -> _ShardContext:
    if self._ctx is not None and self._ctx.shard == shard:
      return self._ctx
    async with self._shard_lock:
      if self._ctx is None or self._ctx.shard != shard:
        self._ctx = None  # drop the previous model before loading the next
        card = get_model_card(shard.model_id) or {}
        model_dir = None
        if card.get("synthetic_config") is None:
          if self.shard_downloader is None:
            raise ValueError(f"{shard.model_id}: a checkpoint needs a shard downloader")
          model_dir = Path(await self.shard_downloader.ensure_shard(shard, type(self).__name__))
        ctx = await self._run(self._load_shard, shard, model_dir)
        if model_dir is not None:
          ctx.tokenizer = await tokenizer_for_dir(model_dir)
        self._ctx = ctx
    return self._ctx

  def _load_shard(self, shard: Shard, model_dir: Optional[Path]) -> _ShardContext:
    """The shard's config and weights on the device: from the checkpoint in
    `model_dir`, or a synthetic card's random weights when it is None."""
    if model_dir is None:
      cfg = config_from_hf_dict(get_model_card(shard.model_id)["synthetic_config"])
    else:
      cfg = load_model_config(model_dir)
    self._check_kernel_shapes(shard.model_id, cfg)
    if model_dir is None:
      params = init_random_params(cfg, shard.get_layer_count(), shard.is_first_layer,
                                  shard.is_last_layer, seed=0, dtype=self.dtype,
                                  device=self.device, start_layer=shard.start_layer)
    else:
      params = load_shard_params(model_dir, cfg, shard, dtype=self.dtype, device=self.device)
    if self.quantize:
      params = quantize_params(params, self.quantize, scale_dtype=self.dtype, inplace=True)
    cache_len = min(self._configured_cache_len, cfg.max_seq_len)
    max_cache_len = max(cache_len, min(self._configured_max_cache_len, cfg.max_seq_len))
    tokenizer = DummyTokenizer()  # a checkpoint's own replaces it (_ensure_ctx)
    if cfg.eos_token_ids:
      tokenizer.eos_token_id = cfg.eos_token_ids[0]
    if DEBUG >= 1:
      print(f"torch engine ready for {shard} on {self.device} from {model_dir or 'a seed'} "
            f"(dtype={self.dtype}, quantize={self.quantize}, kv_quant={self.kv_quant}, "
            f"cache_len={cache_len}, paged={self.paged})")
    return _ShardContext(shard=shard, cfg=cfg, params=params, cache_len=cache_len,
                         max_cache_len=max_cache_len, tokenizer=tokenizer,
                         states=OrderedDict(), model_dir=model_dir,
                         graphs=graphs.GraphCache(self.device) if self.device.type == "cuda" else None)

  def _check_kernel_shapes(self, model_id: str, cfg: ModelConfig) -> None:
    """Refuse, when a shard is loaded, a model whose attention shapes the kernels are not
    built for: head_dim outside K1's and K2's builds or more q heads per kv head than
    K2 takes, and under XOT_PAGED_KV=1 head_dim or groups outside K3's and K4's."""
    groups = cfg.num_heads // cfg.num_kv_heads
    dims = flash_decode.HEAD_DIMS
    if cfg.head_dim not in dims or groups > flash_decode.MAX_GROUPS:
      raise ValueError(f"{model_id}: head_dim {cfg.head_dim} with {groups} q heads per kv head; "
                       f"the attention kernels K1/K2 are built for head_dim {dims} and at most "
                       f"{flash_decode.MAX_GROUPS} q heads per kv head")
    dims = paged_attention.HEAD_DIMS
    if self.paged and (cfg.head_dim not in dims or groups > paged_attention.MAX_GROUPS):
      raise ValueError(f"{model_id}: head_dim {cfg.head_dim} with {groups} q heads per kv head "
                       f"under XOT_PAGED_KV=1; the paged kernels K3/K4 are built for head_dim "
                       f"{dims} and at most {paged_attention.MAX_GROUPS} q heads per kv head")

  def eos_token_ids_for(self, shard: Shard) -> Tuple[int, ...]:
    ctx = self._ctx
    if ctx is None or ctx.shard != shard:
      return ()
    eos = getattr(ctx.tokenizer, "eos_token_id", None)
    return tuple(((eos,) if eos is not None else ()) + tuple(ctx.cfg.eos_token_ids or ()))

  # ---------------------------------------------------------------- tokens

  async def encode(self, shard: Shard, prompt: str) -> np.ndarray:
    ctx = await self._ensure_ctx(shard)
    return np.asarray(ctx.tokenizer.encode(prompt), dtype=np.int64)

  async def decode(self, shard: Shard, tokens: np.ndarray) -> str:
    ctx = await self._ensure_ctx(shard)
    return ctx.tokenizer.decode(np.asarray(tokens).reshape(-1).tolist())

  async def sample(self, x: np.ndarray, temp: float = DEFAULT_TEMP, top_k: int = DEFAULT_TOP_K,
                   top_p: float = 0.0) -> np.ndarray:
    def _sample() -> np.ndarray:
      logits = torch.as_tensor(np.asarray(x), device=self.device)
      if logits.ndim == 3:
        logits = logits[:, -1, :]
      elif logits.ndim == 1:
        logits = logits[None, :]
      tok = sample_logits(logits, temp=temp, top_k=top_k, top_p=top_p, generator=self.generator)
      return tok.cpu().numpy().astype(np.int64)
    return await self._run(_sample)

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
    out, _ = forward_shard(ctx.params, x, cache, state.pos, ctx.cfg, is_first=x.ndim == 2,
                           is_last=ctx.shard.is_last_layer and not fill,
                           start_layer=ctx.shard.start_layer, **kw)
    self._advance(ctx, state, true_t)
    return out, true_t

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
    state = self._prep_state(ctx, request_id, total)
    x = self._to_device_input(input_data)
    h = self._prefill_groups(ctx, state, x, state.cache, chunk, want_hidden)
    state.pos += total
    state.last_used = time.monotonic()
    return h if want_hidden else True

  def _prefill_fill_sync(self, ctx: _ShardContext, request_id: str, input_data,
                         paged_native: bool) -> None:
    """Cache-fill forward of a prompt's leading whole segments, outputs dropped on the
    device: the scan prefill where it applies, else segment by segment."""
    if paged_native:
      self._paged_fill_sync(ctx, request_id, input_data)
      return
    chunk = self._prefill_chunk()
    if not self._scan_prefill(ctx, request_id, input_data, chunk):
      for off in range(0, input_data.shape[1], chunk):
        self._forward_segment(ctx, request_id, input_data[:, off:off + chunk], fill=True)

  def _infer_sync(self, ctx: _ShardContext, request_id: str, input_data):
    """The shard's output on the host: fp32 logits from the last shard as numpy; a
    hidden state in the model's dtype, so a hop carries what the next shard computes
    in. numpy has no bfloat16, so a bf16 hidden state stays a CPU torch tensor, which
    the wire codec sends as raw bf16."""
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
    out = (outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)).cpu()
    return out if out.dtype == torch.bfloat16 else out.numpy()

  async def infer_tensor(self, request_id: str, shard: Shard, input_data,
                         inference_state: Optional[dict] = None) -> Tuple[Any, Optional[dict]]:
    ctx = await self._ensure_ctx(shard)
    out = await self._run(self._infer_sync, ctx, request_id, input_data)
    return out, inference_state

  async def infer_sample_tensor(
    self, request_id: str, shard: Shard, input_data: np.ndarray,
    temp: float = DEFAULT_TEMP, top_k: int = DEFAULT_TOP_K,
    inference_state: Optional[dict] = None, top_p: float = 0.0,
  ) -> Tuple[int, Optional[dict]]:
    """Last-shard prefill + sampling on the device: the host receives one int."""
    ctx = await self._ensure_ctx(shard)
    if not shard.is_last_layer:
      raise ValueError(f"infer_sample_tensor requires the last-layer shard, got {shard}")
    tok = await self._run(self._infer_sample_sync, ctx, request_id, input_data,
                          float(temp), int(top_k), float(top_p))
    return tok, inference_state

  def _infer_sample_sync(self, ctx: _ShardContext, request_id: str, input_data: np.ndarray,
                         temp: float, top_k: int, top_p: float) -> int:
    true_t = input_data.shape[1]
    chunk = self._prefill_chunk()
    is_fresh = request_id not in ctx.states
    paged_native = self._paged_segment(ctx, request_id, input_data)
    try:
      if true_t > chunk:
        # Leading whole segments fill the cache without the unembedding.
        split = ((true_t - 1) // chunk) * chunk
        self._prefill_fill_sync(ctx, request_id, input_data[:, :split], paged_native)
        input_data = input_data[:, split:]
      x, seg_t, state, cache, kw = self._segment_setup(ctx, request_id, input_data)
      tok, _ = forward_sample(ctx.params, x, cache, state.pos, seg_t - 1, ctx.cfg, x.ndim == 2,
                              temp, top_k, top_p, start_layer=ctx.shard.start_layer,
                              generator=self.generator, **kw)
    except CacheExhausted:
      if is_fresh:
        # The request can never produce a token: what it holds (pool pages above
        # all, which co-resident streams need) goes back at once.
        self._drop_state(ctx, request_id)
      raise
    self._advance(ctx, state, seg_t)
    return int(tok.reshape(-1)[0].item())

  async def generate_chunk(
    self, request_id: str, shard: Shard, prev_token: int, num_tokens: int,
    temp: float = DEFAULT_TEMP, top_k: int = DEFAULT_TOP_K, top_p: float = 0.0,
    next_size: Optional[int] = None,
  ) -> Optional[np.ndarray]:
    """Up to `num_tokens` decoded tokens with sampling on the device, for a request
    whose prompt is already prefilled. None when the shard does not span the whole
    model. A coalesced batch runs at the smallest size its rows asked for, so the
    returned length is authoritative. `next_size` (the caller's next chunk) is
    accepted for the Node's contract; this engine dispatches nothing ahead."""
    if not (shard.is_first_layer and shard.is_last_layer) or num_tokens < 1:
      return None
    ctx = self._ctx
    if ctx is None or ctx.shard != shard:
      raise RequestStateLost(f"request {request_id}: model context {shard.model_id} gone mid-generation")
    state = ctx.states.get(request_id)
    if state is None:
      raise RequestStateLost(f"request {request_id}: device state evicted mid-generation")
    ctx.states.move_to_end(request_id)
    if state.pos + num_tokens > ctx.max_cache_len:
      if state.pos + 1 > ctx.max_cache_len:
        raise CacheExhausted(f"request {request_id}: cache full at {state.pos}/{ctx.max_cache_len}")
      # Shrink to the cache tail: the largest power of two that still fits.
      tail = ctx.max_cache_len - state.pos
      num_tokens = min(num_tokens, 1 << (tail.bit_length() - 1))
    if self.decode_batch > 1:
      # Continuous batching: a lone request flows through as a batch of one.
      if ctx.batcher is None:
        ctx.batcher = _DecodeBatcher(self, ctx)
      return await ctx.batcher.submit(request_id, state, int(prev_token), num_tokens,
                                      float(temp), int(top_k), float(top_p))
    item = _Pending(request_id, state, int(prev_token), num_tokens, float(temp), int(top_k),
                    float(top_p), None)
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
    if self.paged:
      return self._decode_batch_paged_sync(ctx, items, num_tokens, top_k, top_p)
    states = [it.state for it in items]
    toks_in = torch.tensor([[it.prev_token] for it in items], dtype=torch.int64, device=self.device)
    target = max(max(s.pos + num_tokens for s in states),
                 max(s.cache["k"].shape[2] for s in states))
    for state in states:
      if state.cache["k"].shape[2] < target:
        self._grow_cache(ctx, state, target)
    if len({s.cache["k"].shape for s in states}) != 1:
      raise AssertionError(f"batched decode needs one cache shape, got "
                           f"{sorted({tuple(s.cache['k'].shape) for s in states})}")
    pos = torch.tensor([s.pos for s in states], dtype=torch.int32, device=self.device)
    temps = torch.tensor([it.temp for it in items], dtype=torch.float32, device=self.device)
    if ctx.graphs is not None:
      # The card: replays of the captured step over the context's slab; each request's
      # cache is updated in place.
      toks = graphs.decode_contiguous(ctx.graphs, ctx.params, [s.cache for s in states], toks_in,
                                      pos, ctx.cfg, num_tokens, temps, top_k, top_p,
                                      route=self.quant_route, generator=self.generator)
    else:
      B = len(states)
      toks, caches = decode_chunk_batched(
        ctx.params, [s.cache for s in states], toks_in, pos, ctx.cfg, num_tokens, temps, top_k,
        top_p, use_flash_decode=True, pad_rows=_bucket(B, 1) - B, generator=self.generator,
        route=self.quant_route)
      for state, cache in zip(states, caches):
        state.cache = cache
    host = toks.cpu().numpy().astype(np.int64)
    for state in states:
      self._advance(ctx, state, num_tokens)
    return [host[i] for i in range(len(states))]

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
                               kv_quant=self.kv_quant is not None)
      if DEBUG >= 1:
        print(f"KV page pool ready: {num_pages - 1} pages x {page} tokens")
    return ctx.page_pool

  def _commit_state_to_pages(self, ctx: _ShardContext, state: _RequestState) -> None:
    """Move a request prefilled into a contiguous buffer (XOT_PAGED_PREFILL=0) into
    fresh pool pages and free the buffer."""
    pool = self._ensure_page_pool(ctx)
    fresh = pool.alloc(pool.pages_for(state.pos))
    commit_pages(pool.arena, state.cache, fresh, start_page=0)
    state.pages = VirtualKV(fresh)
    state.cache = None

  def _prep_state_paged(self, ctx: _ShardContext, request_id: str, bucket: int) -> _RequestState:
    """Page-backed twin of _prep_state: capacity for `bucket` more tokens is pages.
    The table covers the padded bucket, whose garbage lands in pages this request
    owns (_advance trims them afterwards). Pool exhaustion raises CacheExhausted
    before any device work, for this request only."""
    pool = self._ensure_page_pool(ctx)
    state = ctx.states.get(request_id)
    if state is None:
      state = self._admit(ctx, request_id, _RequestState(cache=None, pos=0,
                                                         last_used=time.monotonic(),
                                                         pages=VirtualKV()))
    ctx.states.move_to_end(request_id)
    needed = state.pos + bucket
    if needed > ctx.max_cache_len:
      raise CacheExhausted(
        f"Request {request_id}: {bucket} new tokens at pos {state.pos} "
        f"exceed max cache length {ctx.max_cache_len}")
    need_pages = pool.pages_for(needed)
    if need_pages > len(state.pages):
      state.pages.extend(pool.alloc(need_pages - len(state.pages)))
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
        state.pages.extend(pool.alloc(need - len(state.pages)))
    B = len(states)
    maxp = _bucket(max(len(s.pages) for s in states), 1)
    table = torch.as_tensor(vkv.resolve_page_table([s.pages for s in states], maxp),
                            device=self.device)
    toks_in = torch.tensor([[it.prev_token] for it in items], dtype=torch.int64, device=self.device)
    pos = torch.tensor([s.pos for s in states], dtype=torch.int32, device=self.device)
    temps = torch.tensor([it.temp for it in items], dtype=torch.float32, device=self.device)
    if ctx.graphs is not None:
      toks = graphs.decode_paged(ctx.graphs, ctx.params, pool.arena, table, toks_in, pos, ctx.cfg,
                                 num_tokens, temps, top_k, top_p, route=self.quant_route,
                                 generator=self.generator)
    else:
      toks, _ = decode_chunk_paged(ctx.params, pool.arena, table, toks_in, pos, ctx.cfg, num_tokens,
                                   temps, top_k, top_p, pad_rows=_bucket(B, 1) - B,
                                   generator=self.generator, route=self.quant_route)
    host = toks.cpu().numpy().astype(np.int64)
    for state in states:
      self._advance(ctx, state, num_tokens)
    return [host[i] for i in range(B)]

  def _release_state_pages(self, ctx: _ShardContext, state: _RequestState) -> None:
    """Return a finished or evicted request's page references to the pool."""
    if ctx.page_pool is not None and state.pages is not None:
      ctx.page_pool.decref(state.pages.live())
      state.pages = None

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

  def _defrag_sync(self, ctx: _ShardContext) -> int:
    """One bounded compaction pass (batcher-idle slots, on the executor): copy the
    highest used pages into the lowest free holes, then rewrite only the virtual
    maps. Tables are resolved afresh at every dispatch, so no request sees the move.
    Returns the pages moved."""
    pool = ctx.page_pool
    plan = pool.defrag_plan(max(1, knobs.get_int("XOT_KV_DEFRAG_MAX_MOVES")))
    if not plan:
      return 0
    migrate_pages(pool.arena, [s for s, _ in plan], [d for _, d in plan])
    mapping = dict(plan)
    for st in ctx.states.values():
      if st.pages is not None:
        st.pages.remap(mapping)
    pool.apply_moves(plan)
    self.defrag_moves += len(plan)
    return len(plan)

  def page_pool_stats(self) -> Optional[Dict[str, int]]:
    """Page-pool occupancy, or None when no pool exists."""
    pool = self._ctx.page_pool if self._ctx is not None else None
    if pool is None:
      return None
    return {"pages_in_use": pool.pages_in_use, "free_pages": pool.free_pages,
            "peak_pages_in_use": pool.peak_pages_in_use,
            "fragmentation": pool.fragmentation(), "defrag_moves": self.defrag_moves}

  # ------------------------------------------------------------ KV state

  async def clear_request(self, request_id: str) -> None:
    def _clear() -> None:
      if self._ctx is not None:
        self._drop_state(self._ctx, request_id)
    await self._run(_clear)

  def _drop_state(self, ctx: _ShardContext, request_id: str) -> None:
    state = ctx.states.pop(request_id, None)
    if state is not None:
      self._release_state_pages(ctx, state)

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
    if DEBUG >= 2:
      print(f"KV cache grown {S} -> {new_len}")

  def _get_or_create_state(self, ctx: _ShardContext, request_id: str, min_len: int = 0) -> _RequestState:
    state = ctx.states.get(request_id)
    if state is None:
      length = ctx.cache_len
      while length < min_len and length < ctx.max_cache_len:
        length *= 2
      length = min(length, ctx.max_cache_len)
      state = self._admit(ctx, request_id, _RequestState(
        cache=init_kv_cache(ctx.cfg, ctx.shard.get_layer_count(), 1, length, self.dtype,
                            self.device, kv_quant=self.kv_quant is not None),
        pos=0, last_used=time.monotonic()))
    ctx.states.move_to_end(request_id)
    return state
