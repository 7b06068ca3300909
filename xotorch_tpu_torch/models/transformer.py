"""The shard transformer: plain functions over a stacked-layer parameter dictionary.

The port of the dense path of xotorch_tpu/models/transformer.py: llama, qwen2 (q/k/v
biases), qwen3 (qk-norm), mistral (sliding windows), phi3 and gemma2 (the (1 + w)
norm, sandwich post-norms, gelu-tanh, the sqrt(hidden) embedding scale,
`query_pre_attn_scalar`, attention and final-logit softcaps, windows that alternate
by absolute layer index). Parameters
keep the JAX package's layout (`params["layers"][name]` stacked along a leading layer
axis, weights [in, out]) so the two packages' tensors map one to one
(models/weights.params_from_jax). The KV cache is a [L, B, S, Hkv, D] buffer per
leaf, or with a page table the shared page arena [L, P, page, Hkv, D]; either is
written IN PLACE at each row's position — where JAX donated the cache to the compiled
step and got a new one back, the port updates the one buffer. An int8 cache
(`kv_quant`) adds `k_scale`/`v_scale` leaves, one scale per (position, head) in the
compute dtype; fresh K/V are quantized on the way in.

Attention on the card goes through the hand-written kernels: a prefill from
position 0 (`use_flash`) through K1 (ops/flash_attention.py) over the fresh K/V,
decode steps and segments at pos > 0 (`use_flash_decode`) through K2, or K2q over
the raw int8 cache and its scales (ops/flash_decode.py); over the page arena, decode
steps through K3/K3q and prefill segments through K4/K4q (ops/paged_attention.py).
The plain `gqa_attention` path runs only on the CPU.
Weight-quantized slots (models/quantize.py) go through `_linear`: decode-sized
projections through the GEMV kernels K5, K5v4 and K6 (ops/int4_matmul.py,
ops/int8_matmul.py), prefill through the dequantized product. Each layer's window
(`cfg.layer_window` of its absolute index), the softcap and the score scale reach
every attention call. MoE, vision and LoRA slots raise NotImplementedError instead
of returning a wrong answer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from xotorch_tpu_torch.models.config import ModelConfig
from xotorch_tpu_torch.models.quantize import quantize_tensor, unpack_int4
from xotorch_tpu_torch.ops.attention import gqa_attention
from xotorch_tpu_torch.ops.flash_attention import flash_attention
from xotorch_tpu_torch.ops.flash_decode import dequantize_kv, flash_cached_attention
from xotorch_tpu_torch.ops.int4_matmul import int4_grouped_matmul
from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul
from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention
from xotorch_tpu_torch.ops.rope import apply_rope, rope_frequencies
from xotorch_tpu_torch.utils import knobs

Params = Dict[str, Any]


ACTIVATIONS = ("silu", "gelu_pytorch_tanh")


def check_supported(cfg: ModelConfig) -> None:
  """Raise for config features the port's model does not implement yet."""
  unsupported = {
    "MoE": cfg.is_moe,
    "vision": cfg.is_multimodal,
    f"activation {cfg.hidden_act}": cfg.hidden_act not in ACTIVATIONS,
  }
  missing = [name for name, used in unsupported.items() if used]
  if missing:
    raise NotImplementedError(
      f"{cfg.model_family} config uses {', '.join(missing)}: not ported to xotorch_tpu_torch yet")


def _check_params(layer: Params) -> None:
  for slot in layer:
    if slot.startswith("lora_"):
      raise NotImplementedError(f"parameter slot {slot!r} (LoRA) is not ported yet")


@dataclasses.dataclass(frozen=True)
class QuantRoute:
  """Where decode-sized projections (B*T <= 8) over quantized weights go: int4
  through K5 or K5v4 (`int4_variant` 4) when `int4_kernel`, int8 through K6 when
  `int8_kernel`. Decided once, by `quant_route`; on the CPU a kernel's function
  runs through its plain version."""
  int4_kernel: bool = False
  int4_variant: int = 1
  int8_kernel: bool = False


def quant_route(on_card: bool) -> QuantRoute:
  """The route the knobs ask for, read once (the engine does so when it is built).
  On the card int4 decode projections always take K5/K5v4, whatever
  XOT_INT4_KERNEL says: the dequantized product is K5's own function, and `0`,
  which the JAX package sets only for a tensor-parallel mesh, is reserved until
  the port has one. Elsewhere `force` takes the kernels' functions. K6 rounds the
  activations to int8, so int8 takes it only when XOT_INT8_KERNEL asks (`1` on the
  card, `force` anywhere)."""
  k8 = knobs.get_str("XOT_INT8_KERNEL")
  return QuantRoute(int4_kernel=on_card or knobs.get_str("XOT_INT4_KERNEL") == "force",
                    int4_variant=knobs.get_int("XOT_INT4_V"),
                    int8_kernel=k8 == "force" or (on_card and k8 == "1"))


def _linear(layer: Params, slot: str, h: torch.Tensor, route: QuantRoute) -> torch.Tensor:
  """h [B, T, in] @ layer[slot], dequantizing weight-quantized slots
  (models/quantize.py): `<slot>_gscale` marks int4 (packed [G, gs/2, out]),
  `<slot>_scale` int8 per output channel. Decode-sized inputs (B*T <= 8) go to the
  kernels by `route` (K5, K5v4, K6); larger ones run the plain dequantized product
  (JAX leaves that einsum to XLA)."""
  w = layer[slot]
  gscale = layer.get(slot + "_gscale")
  B, T, _ = h.shape
  if gscale is not None:
    if B * T <= 8 and route.int4_kernel:
      out = int4_grouped_matmul(h.reshape(B * T, h.shape[-1]).contiguous(), w, gscale,
                                route.int4_variant)
      return out.reshape(B, T, -1).to(h.dtype)
    G, gs_half, d_out = w.shape
    dense = (unpack_int4(w).to(h.dtype) * gscale.to(h.dtype)[:, None, :]).reshape(G * gs_half * 2, d_out)
    return h @ dense
  scale = layer.get(slot + "_scale")
  if scale is None:
    return h @ w
  if B * T <= 8 and route.int8_kernel:
    out = int8_rowquant_matmul(h.reshape(B * T, h.shape[-1]).contiguous(), w, scale)
    return out.reshape(B, T, -1).to(h.dtype)
  return (h @ w.to(h.dtype)) * scale.to(h.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
  """offset=True is the gemma convention: weights are stored zero-centred and the
  norm multiplies by (1 + w), all in fp32."""
  x32 = x.to(torch.float32)
  norm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
  w32 = weight.to(torch.float32)
  if offset:
    w32 = 1.0 + w32
  return (norm * w32).to(x.dtype)


def _mlp_act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
  if cfg.hidden_act == "gelu_pytorch_tanh":
    return F.gelu(x, approximate="tanh")
  return F.silu(x)


def _dense_mlp(layer: Params, h: torch.Tensor, cfg: ModelConfig, route: QuantRoute) -> torch.Tensor:
  gate = _mlp_act(cfg, _linear(layer, "w_gate", h, route))
  return _linear(layer, "w_down", gate * _linear(layer, "w_up", h, route), route)


def init_kv_cache(cfg: ModelConfig, num_layers: int, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device="cpu", kv_quant: bool = False) -> Dict[str, torch.Tensor]:
  """KV buffers [L, B, S, Hkv, D]. `kv_quant` stores K/V as int8 with one scale per
  (position, head), `k_scale`/`v_scale` [L, B, S, Hkv] in `dtype`: half the cache
  bytes per token. The scale leaves are what marks the cache as int8."""
  shape = (num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
  if not kv_quant:
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
  return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
          "v": torch.zeros(shape, dtype=torch.int8, device=device),
          "k_scale": torch.zeros(shape[:-1], dtype=dtype, device=device),
          "v_scale": torch.zeros(shape[:-1], dtype=dtype, device=device)}


def _quantize_kv(x: torch.Tensor, scale_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
  """Per-(position, head) symmetric int8 over the head dim: [B, T, H, D] ->
  (int8 [B, T, H, D], scale [B, T, H]), the weights' quantizer on another axis."""
  return quantize_tensor(x, axis=-1, scale_dtype=scale_dtype)


def _kv_entries(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor):
  """(leaf name, value) pairs a write puts into `cache`: the fresh K/V, or for an
  int8 cache their codes and scales."""
  if "k_scale" not in cache:
    return (("k", k), ("v", v))
  qk, sk = _quantize_kv(k, cache["k_scale"].dtype)
  qv, sv = _quantize_kv(v, cache["v_scale"].dtype)
  return (("k", qk), ("v", qv), ("k_scale", sk), ("v_scale", sv))


def _cache_write(cache: Dict[str, torch.Tensor], layer_idx: int, k: torch.Tensor, v: torch.Tensor,
                 start_pos: Union[int, torch.Tensor], slots: Optional[torch.Tensor]) -> None:
  """Insert fresh K/V at each row's position, in place, quantizing on the way in when
  the cache is int8: one slice for an int `start_pos`, per-row [B, T] `slots`
  (already inside the cache) for a [B] tensor."""
  T, S = k.shape[1], cache["k"].shape[2]
  if torch.is_tensor(start_pos):
    index = (torch.arange(k.shape[0], device=k.device)[:, None], slots)
  elif start_pos < 0 or start_pos + T > S:
    raise ValueError(f"cache write [{start_pos}, {start_pos + T}) outside the {S}-slot cache")
  else:
    index = (slice(None), slice(start_pos, start_pos + T))
  for name, val in _kv_entries(cache, k, v):
    buf = cache[name][layer_idx]
    buf[index] = val.to(buf.dtype)


def _cache_read(cache: Dict[str, torch.Tensor], layer_idx: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
  """(K, V) of one layer in `dtype`; an int8 cache is dequantized (code times scale,
  both in `dtype`)."""
  k, v = cache["k"][layer_idx], cache["v"][layer_idx]
  if "k_scale" in cache:
    return dequantize_kv(k, v, cache["k_scale"][layer_idx], cache["v_scale"][layer_idx], dtype)
  return k.to(dtype), v.to(dtype)


def _attention_block(layer: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor], layer_idx: int,
                     positions: torch.Tensor, kv_valid_len: torch.Tensor,
                     start_pos: Union[int, torch.Tensor], q_start: torch.Tensor, cfg: ModelConfig,
                     inv_freq: torch.Tensor, use_flash: bool, use_flash_decode: bool,
                     route: QuantRoute, page_table: Optional[torch.Tensor] = None,
                     slots: Any = None, window: int = 0) -> torch.Tensor:
  """The attention half of a layer: the residual branch's output (after the sandwich
  post-norm where the config has one). `window` is this layer's (0 = global)."""
  B, T, _ = x.shape
  h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
  q = _linear(layer, "wq", h, route)
  k = _linear(layer, "wk", h, route)
  v = _linear(layer, "wv", h, route)
  if "bq" in layer:
    q = q + layer["bq"]
    k = k + layer["bk"]
    v = v + layer["bv"]
  q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
  k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
  v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
  if cfg.qk_norm:
    q = rms_norm(q, layer["q_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    k = rms_norm(k, layer["k_norm"], cfg.rms_norm_eps, cfg.norm_offset)
  q = apply_rope(q, positions, inv_freq)
  k = apply_rope(k, positions, inv_freq)
  scales = {name: cache[name][layer_idx] for name in ("k_scale", "v_scale") if name in cache}
  # The gemma family's score adjustments; 0 / None (1 / sqrt(D)) for the others.
  adj = dict(window=window, softcap=cfg.attn_logit_softcap,
             scale=cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar else None)
  if page_table is not None:
    # Paged KV: `cache` is the shared page arena. Position p of row b lands at
    # (table[b, p // page], p % page) (`slots`), in the payload pages and, for an
    # int8 arena, in the scale pages alike; reads stop at each row's own occupied
    # pages.
    pidx, off = slots
    for name, val in _kv_entries(cache, k, v):
      pages = cache[name][layer_idx]
      pages[pidx, off] = val.reshape(B * T, *val.shape[2:]).to(pages.dtype)
    k_pages, v_pages = cache["k"][layer_idx], cache["v"][layer_idx]
    ks, vs = scales.get("k_scale"), scales.get("v_scale")
    if T == 1:
      attn = paged_decode_attention(q, k_pages, v_pages, page_table, kv_valid_len,
                                    k_scale_pages=ks, v_scale_pages=vs, **adj)
    else:
      attn = paged_prefill_attention(q, k_pages, v_pages, page_table, kv_valid_len,
                                     k_scale_pages=ks, v_scale_pages=vs, **adj)
    return _attention_out(layer, attn, cfg, route)
  _cache_write(cache, layer_idx, k, v, start_pos, slots)
  if use_flash:
    # Prefill from position 0: the fresh segment is the whole visible context, so
    # the kernel attends over the fresh k/v and never reads the cache (an int8
    # cache included).
    attn = flash_attention(q, k.contiguous(), v.contiguous(), **adj)
  elif use_flash_decode:
    # Decode steps and segments at pos > 0: the cache up to each row's last
    # visible position; an int8 cache passes its raw codes and scales (K2q).
    attn = flash_cached_attention(q, cache["k"][layer_idx], cache["v"][layer_idx], q_start,
                                  k_scale=scales.get("k_scale"), v_scale=scales.get("v_scale"),
                                  **adj)
  elif x.device.type == "cpu":
    k_all, v_all = _cache_read(cache, layer_idx, q.dtype)
    attn = gqa_attention(q, k_all, v_all, positions, kv_valid_len, **adj)
  else:
    raise ValueError("attention on the card goes through a kernel: pass use_flash "
                     "(prefill from 0) or use_flash_decode")
  return _attention_out(layer, attn, cfg, route)


def _attention_out(layer: Params, attn: torch.Tensor, cfg: ModelConfig,
                   route: QuantRoute) -> torch.Tensor:
  """The output projection of attention [B, T, Hq, D], then the sandwich post-norm."""
  B, T = attn.shape[0], attn.shape[1]
  out = _linear(layer, "wo", attn.reshape(B, T, cfg.num_heads * cfg.head_dim), route)
  if cfg.sandwich_norms:
    out = rms_norm(out, layer["post_attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
  return out


def _page_slots(page_table: torch.Tensor, positions: torch.Tensor, page: int):
  """(physical page, slot) of every [B, T] position, flattened. Page indices are
  clamped into the table, as JAX's mode="clip" scatter does: a batch's pad rows
  (all-zero table, positions stepping from 0) then stay on the scratch page."""
  B, T = positions.shape
  if T > 1 and B != 1:
    raise ValueError(f"paged prefill serves per-request segments (B == 1), got B={B}")
  logical = torch.clamp(positions // page, max=page_table.shape[1] - 1)
  pidx = torch.gather(page_table.to(torch.int64), 1, logical)
  return pidx.reshape(-1), (positions % page).reshape(-1)


def forward_shard(
  params: Params,
  x: torch.Tensor,  # [B, T] int tokens (first shard) or [B, T, H] hidden
  cache: Dict[str, torch.Tensor],
  start_pos: Union[int, torch.Tensor],  # position of x[:, 0]: an int, or [B] per row
  cfg: ModelConfig,
  is_first: bool,
  is_last: bool,
  use_flash: bool = False,
  use_flash_decode: bool = False,
  start_layer: int = 0,
  page_table: Optional[torch.Tensor] = None,  # [B, max_pages] int32: `cache` is the arena
  route: Optional[QuantRoute] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """Run one shard. Returns (hidden, or fp32 logits on the last shard; the cache,
  updated in place). `use_flash` is valid only when start_pos == 0.

  A [B] `start_pos` puts each row at its own depth (continuous batching): per-row
  RoPE positions, cache slots and visible lengths. With `page_table`, `cache` is the
  shared page arena (paged_cache.PagePool): decode steps (T == 1) attend through K3,
  segments (T > 1, B == 1) through K4; `use_flash`/`use_flash_decode` are ignored. A
  cache with `k_scale`/`v_scale` leaves is int8 and takes the kernels' int8 variants.
  `route` sends quantized decode projections to their kernels; by default the
  knobs' route (`quant_route`) for the device of `x`."""
  check_supported(cfg)
  if use_flash and not (isinstance(start_pos, int) and start_pos == 0):
    raise ValueError("use_flash serves a prefill from position 0 only")
  h = embed(params, x, cfg) if is_first else x
  B, T = h.shape[0], h.shape[1]
  device = h.device
  steps = torch.arange(T, device=device)
  if torch.is_tensor(start_pos):
    q_start = start_pos.to(device=device, dtype=torch.int32)
    positions = q_start.to(torch.int64)[:, None] + steps[None, :]
    kv_valid_len = q_start + T
  else:
    positions = (start_pos + steps)[None, :].expand(B, T)
    kv_valid_len = torch.full((B,), start_pos + T, dtype=torch.int32, device=device)
    q_start = torch.full((B,), start_pos, dtype=torch.int32, device=device)
  slots = None  # where the fresh K/V go, for the tensor-indexed writes
  if page_table is not None:
    slots = _page_slots(page_table, positions, cache["k"].shape[2])
  elif torch.is_tensor(start_pos):
    # Per-row writes stay inside the buffer (JAX's dynamic_update_slice clamps too);
    # the engine sizes the cache so that real rows never reach the clamp.
    slots = torch.clamp(positions, max=cache["k"].shape[2] - 1)
  inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=device)
  if route is None:
    route = quant_route(device.type == "cuda")
  stacked = params["layers"]
  _check_params(stacked)
  L = stacked["wq"].shape[0]
  # Which layers slide is a property of the absolute layer index (gemma2 alternates),
  # so a shard that starts mid-model windows by start_layer + i; 0 = global.
  windows = ([cfg.layer_window(start_layer + i) for i in range(L)] if cfg.uses_sliding_window
             else [0] * L)
  for i in range(L):
    layer = {name: w[i] for name, w in stacked.items()}
    h = h + _attention_block(layer, h, cache, i, positions, kv_valid_len, start_pos, q_start,
                             cfg, inv_freq, use_flash, use_flash_decode, route, page_table, slots,
                             windows[i])
    mlp_out = _dense_mlp(layer, rms_norm(h, layer["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset),
                         cfg, route)
    if cfg.sandwich_norms:
      mlp_out = rms_norm(mlp_out, layer["post_mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    h = h + mlp_out
  if not is_last:
    return h, cache
  return unembed(params, h, cfg), cache


def unembed(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
  """Final norm + (tied-embedding or lm_head) unembedding -> fp32 logits, soft-capped
  in fp32 where the config says so."""
  h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps, cfg.norm_offset)
  if cfg.tie_word_embeddings and "lm_head" not in params:
    emb = params["embed"]["embedding"]
    row_scale = params["embed"].get("embedding_scale")
    if row_scale is None:
      logits = h @ emb.T
    else:
      # Tied int8 table: the per-row scale becomes a per-vocab-column scale.
      logits = (h @ emb.to(h.dtype).T) * row_scale.to(h.dtype)[None, None, :]
  else:
    head_scale = params.get("lm_head_scale")
    if head_scale is None:
      logits = h @ params["lm_head"]
    else:
      logits = (h @ params["lm_head"].to(h.dtype)) * head_scale.to(h.dtype)[None, None, :]
  logits = logits.to(torch.float32)
  if cfg.final_logit_softcap:
    cap = float(cfg.final_logit_softcap)
    logits = torch.tanh(logits / cap) * cap
  return logits


def embed(params: Params, x: torch.Tensor, cfg: Optional[ModelConfig] = None) -> torch.Tensor:
  """Token rows of the embedding; an int8 table rescales each looked-up row by its
  own scale, in the scale's (compute) dtype. Gemma scales the rows by sqrt(hidden),
  the factor rounded to the rows' dtype first, as HF does."""
  emb = params["embed"]["embedding"]
  row_scale = params["embed"].get("embedding_scale")
  if row_scale is None:
    h = emb[x]
  else:
    h = emb[x].to(row_scale.dtype) * row_scale[x][..., None]
  if cfg is not None and cfg.scale_embedding:
    # The factor rounded to the rows' dtype on the host, then a scalar multiply: the
    # same bits as multiplying by a device tensor of that dtype, with no host-to-device
    # copy (a captured step refuses one).
    h = h * torch.tensor(cfg.hidden_size ** 0.5, dtype=h.dtype).item()
  return h


def init_random_params(
  cfg: ModelConfig, num_local_layers: int, is_first: bool, is_last: bool, seed: int = 0,
  dtype=torch.float32, device="cpu", scale: float = 0.02, start_layer: int = 0,
) -> Params:
  """Random shard params in the stacked layout, drawn on `device`.

  Each tensor has its own generator, seeded from (seed, absolute layer index, slot),
  so a shard holding layers [a, b] gets the same weights as those layers of a
  full-model init. The draws differ from the JAX package's jax.random ones; to hold
  the two packages on the same weights, carry JAX's params across with
  models/weights.params_from_jax."""
  check_supported(cfg)
  H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size

  def rnd(abs_idx: int, slot: int, *shape):
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + abs_idx) * 16 + slot)
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32) * scale
    return w.to(dtype)

  # Norm weights as JAX initialises them: zeros under the gemma (1 + w) offset.
  norm_init = torch.zeros if cfg.norm_offset else torch.ones

  def layer_params(a: int) -> Params:
    p = {
      "attn_norm": norm_init(H, dtype=dtype, device=device),
      "mlp_norm": norm_init(H, dtype=dtype, device=device),
      "wq": rnd(a, 0, H, cfg.num_heads * D),
      "wk": rnd(a, 1, H, cfg.num_kv_heads * D),
      "wv": rnd(a, 2, H, cfg.num_kv_heads * D),
      "wo": rnd(a, 3, cfg.num_heads * D, H),
      "w_gate": rnd(a, 4, H, I),
      "w_up": rnd(a, 5, H, I),
      "w_down": rnd(a, 6, I, H),
    }
    if cfg.sandwich_norms:
      p["post_attn_norm"] = norm_init(H, dtype=dtype, device=device)
      p["post_mlp_norm"] = norm_init(H, dtype=dtype, device=device)
    if cfg.attention_bias:
      for n, width in (("bq", cfg.num_heads * D), ("bk", cfg.num_kv_heads * D),
                       ("bv", cfg.num_kv_heads * D)):
        p[n] = torch.zeros(width, dtype=dtype, device=device)
    if cfg.qk_norm:
      p["q_norm"] = torch.ones(D, dtype=dtype, device=device)
      p["k_norm"] = torch.ones(D, dtype=dtype, device=device)
    return p

  per_layer = [layer_params(start_layer + i) for i in range(num_local_layers)]
  params: Params = {"layers": {name: torch.stack([p[name] for p in per_layer])
                               for name in per_layer[0]}}
  del per_layer
  if is_first or cfg.tie_word_embeddings:
    params["embed"] = {"embedding": rnd(1_000_000, 0, cfg.vocab_size, H)}
  if is_last:
    params["final_norm"] = norm_init(H, dtype=dtype, device=device)
    if not cfg.tie_word_embeddings:
      params["lm_head"] = rnd(1_000_001, 0, H, cfg.vocab_size)
  return params
