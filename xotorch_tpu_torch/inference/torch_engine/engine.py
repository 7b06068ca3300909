"""TorchShardInferenceEngine: the port's compute backend for one NVIDIA GPU.

The port of the contiguous single-shard subset of
xotorch_tpu/inference/jax_engine/engine.py:

- `ensure_shard` loads a shard (synthetic cards: random weights from a seed);
- `infer_sample_tensor` prefills in XOT_PREFILL_CHUNK segments, each padded to a
  power-of-two bucket, and samples the first token on the device. The first segment
  of a fresh request goes to the prefill kernel (K1), later segments to the cached
  kernel (K2);
- `generate_chunk` decodes K tokens per call with sampling on the device (K2 for
  every step), with the same CacheExhausted semantics at XOT_MAX_CACHE_LEN and the
  same power-of-two cache growth;
- `infer_tensor` / `sample` keep the per-token contract.

Per-request state is a contiguous [L, 1, S, Hkv, D] KV cache plus a position. Every
device computation runs on one executor thread, so requests are served one call at a
time; an asyncio lock serialises shard loads. The engine runs on `cuda` unless the
caller passes device="cpu" (the tests do), and raises when no GPU is present
rather than falling back to the CPU.
"""
from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from xotorch_tpu_torch.inference.engine import CacheExhausted, InferenceEngine, RequestStateLost
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer
from xotorch_tpu_torch.models.config import ModelConfig, config_from_hf_dict
from xotorch_tpu_torch.models.generate import decode_chunk, forward_sample
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, init_random_params
from xotorch_tpu_torch.ops.sampling import DEFAULT_TEMP, DEFAULT_TOP_K, sample_logits
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG

# Request states kept per shard before the least recently used is dropped (the JAX
# engine's XOT_MAX_RESIDENT_REQUESTS default).
MAX_RESIDENT_REQUESTS = 8

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
  cache: Dict[str, torch.Tensor]  # {"k", "v"}: [L, 1, S, Hkv, D]
  pos: int  # tokens already resident in the cache
  last_used: float


@dataclass
class _ShardContext:
  shard: Shard
  cfg: ModelConfig
  params: Any
  cache_len: int
  max_cache_len: int
  tokenizer: Any
  states: "OrderedDict[str, _RequestState]"


class TorchShardInferenceEngine(InferenceEngine):
  def __init__(self, shard_downloader=None, dtype: Optional[str] = None,
               device: Optional[str] = None, seed: Optional[int] = None):
    self.device = resolve_device(device)
    self.shard_downloader = shard_downloader
    self.dtype = DTYPES[dtype or knobs.get_str("XOT_DTYPE")]
    self.executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torch-engine")
    self._ctx: Optional[_ShardContext] = None
    self._shard_lock = asyncio.Lock()
    self._configured_cache_len = knobs.get_int("XOT_CACHE_LEN")
    self._configured_max_cache_len = knobs.get_int("XOT_MAX_CACHE_LEN")
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
        self._ctx = await self._run(self._load_shard, shard)
    return self._ctx

  def _load_shard(self, shard: Shard) -> _ShardContext:
    card = get_model_card(shard.model_id) or {}
    synthetic_cfg = card.get("synthetic_config")
    if synthetic_cfg is None:
      raise NotImplementedError(
        f"{shard.model_id}: only synthetic cards load in xotorch_tpu_torch so far "
        "(safetensors loading is a later slice)")
    cfg = config_from_hf_dict(synthetic_cfg)
    params = init_random_params(cfg, shard.get_layer_count(), shard.is_first_layer,
                                shard.is_last_layer, seed=0, dtype=self.dtype,
                                device=self.device, start_layer=shard.start_layer)
    cache_len = min(self._configured_cache_len, cfg.max_seq_len)
    max_cache_len = max(cache_len, min(self._configured_max_cache_len, cfg.max_seq_len))
    tokenizer = DummyTokenizer()
    if cfg.eos_token_ids:
      tokenizer.eos_token_id = cfg.eos_token_ids[0]
    if DEBUG >= 1:
      print(f"torch engine ready for {shard} on {self.device} "
            f"(dtype={self.dtype}, cache_len={cache_len})")
    return _ShardContext(shard=shard, cfg=cfg, params=params, cache_len=cache_len,
                         max_cache_len=max_cache_len, tokenizer=tokenizer,
                         states=OrderedDict())

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

  def _to_device_input(self, input_data: np.ndarray) -> torch.Tensor:
    input_data = np.asarray(input_data)
    if input_data.ndim == 2:
      return torch.as_tensor(input_data.astype(np.int64), device=self.device)
    if input_data.ndim == 3:
      return torch.as_tensor(input_data, device=self.device).to(self.dtype)
    raise ValueError(f"expected 2-D tokens or 3-D hidden state, got ndim={input_data.ndim}")

  def _prefill_chunk(self) -> int:
    return knobs.get_int("XOT_PREFILL_CHUNK")

  def _segment_setup(self, ctx: _ShardContext, request_id: str, input_data: np.ndarray):
    """Device transfer, bucket padding, state and capacity, and the kernel choice:
    a fresh request's multi-token segment goes to K1, everything else to K2."""
    x = self._to_device_input(input_data)
    true_t = x.shape[1]
    bucket = 1 if true_t == 1 else _bucket(true_t)
    state = self._prep_state(ctx, request_id, bucket)
    if bucket != true_t:
      pad = torch.zeros((x.shape[0], bucket - true_t) + tuple(x.shape[2:]), dtype=x.dtype,
                        device=x.device)
      x = torch.cat([x, pad], dim=1)
    use_flash = true_t > 1 and state.pos == 0
    return x, true_t, state, use_flash, not use_flash

  def _forward_segment(self, ctx: _ShardContext, request_id: str, input_data: np.ndarray,
                       fill: bool = False):
    """One segment's forward; returns (device output, true length). `fill` skips the
    unembedding (cache-fill segments whose logits nobody reads)."""
    x, true_t, state, use_flash, use_fd = self._segment_setup(ctx, request_id, input_data)
    out, state.cache = forward_shard(
      ctx.params, x, state.cache, state.pos, ctx.cfg, is_first=x.ndim == 2,
      is_last=ctx.shard.is_last_layer and not fill, use_flash=use_flash,
      use_flash_decode=use_fd, start_layer=ctx.shard.start_layer)
    state.pos += true_t
    state.last_used = time.monotonic()
    return out, true_t

  def _infer_sync(self, ctx: _ShardContext, request_id: str, input_data: np.ndarray) -> np.ndarray:
    true_t = input_data.shape[1]
    chunk = self._prefill_chunk()
    outs = []
    for off in range(0, true_t, chunk):
      out, t = self._forward_segment(ctx, request_id, input_data[:, off:off + chunk])
      outs.append(out[:, :t].float().cpu().numpy())
    return np.concatenate(outs, axis=1)

  async def infer_tensor(self, request_id: str, shard: Shard, input_data: np.ndarray,
                         inference_state: Optional[dict] = None) -> Tuple[np.ndarray, Optional[dict]]:
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
    if true_t > chunk:
      # Leading full segments fill the cache without the unembedding.
      split = ((true_t - 1) // chunk) * chunk
      for off in range(0, split, chunk):
        self._forward_segment(ctx, request_id, input_data[:, off:off + chunk], fill=True)
      input_data = input_data[:, split:]
    x, seg_t, state, use_flash, use_fd = self._segment_setup(ctx, request_id, input_data)
    tok, state.cache = forward_sample(
      ctx.params, x, state.cache, state.pos, seg_t - 1, ctx.cfg, x.ndim == 2, temp, top_k,
      top_p, use_flash=use_flash, use_flash_decode=use_fd, start_layer=ctx.shard.start_layer,
      generator=self.generator)
    state.pos += seg_t
    state.last_used = time.monotonic()
    return int(tok.reshape(-1)[0].item())

  async def generate_chunk(
    self, request_id: str, shard: Shard, prev_token: int, num_tokens: int,
    temp: float = DEFAULT_TEMP, top_k: int = DEFAULT_TOP_K, top_p: float = 0.0,
    next_size: Optional[int] = None,
  ) -> Optional[np.ndarray]:
    """Up to `num_tokens` decoded tokens with sampling on the device, for a request
    whose prompt is already prefilled. None when the shard does not span the whole
    model. `next_size` (the caller's next chunk) is accepted for the Node's contract;
    this engine dispatches nothing ahead."""
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

    def _chunk() -> np.ndarray:
      if state.pos + num_tokens > state.cache["k"].shape[2]:
        self._grow_cache(ctx, state, state.pos + num_tokens)
      tok = torch.tensor([[int(prev_token)]], dtype=torch.int64, device=self.device)
      toks, state.cache = decode_chunk(ctx.params, tok, state.cache, state.pos, ctx.cfg,
                                       num_tokens, float(temp), int(top_k), float(top_p),
                                       use_flash_decode=True, generator=self.generator)
      state.pos += num_tokens
      state.last_used = time.monotonic()
      return toks[0].cpu().numpy().astype(np.int64)

    return await self._run(_chunk)

  async def clear_request(self, request_id: str) -> None:
    def _clear() -> None:
      if self._ctx is not None:
        self._ctx.states.pop(request_id, None)
    await self._run(_clear)

  # ------------------------------------------------------------ KV state

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
    """Double the request's KV buffer until it fits `needed` (bounded by
    max_cache_len); contents are kept, new slots are zero."""
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
      state = _RequestState(
        cache=init_kv_cache(ctx.cfg, ctx.shard.get_layer_count(), 1, length, self.dtype,
                            self.device),
        pos=0, last_used=time.monotonic())
      ctx.states[request_id] = state
      while len(ctx.states) > MAX_RESIDENT_REQUESTS:
        evicted, _ = ctx.states.popitem(last=False)
        if DEBUG >= 2:
          print(f"Evicted request state {evicted}")
    ctx.states.move_to_end(request_id)
    return state
