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
every attention call.

MoE (qwen3_moe) as JAX computes it, outside any kernel: the router in fp32, softmax,
top-k with JAX's tie order (`_moe_route`), `norm_topk_prob`; decode-sized inputs (B*T
<= 8) gather only the chosen experts' weights (`_moe_mlp_routed`), larger ones run
every expert and zero the others in the combine (`_moe_mlp`). int8 experts carry one
scale per (expert, output channel) and are dequantized in the product. One card holds
every expert, so the routed form is always taken where it applies (JAX passes
`moe_routed=False` only over an expert-parallel mesh). A multimodal (llava) model's
text stack is this transformer fed the merged text-and-image embeddings as a hidden
input (models/vision.py).

LoRA (train/lora.py builds the tensors): a slot with `lora_<slot>_a` [L, in, r] and
`lora_<slot>_b` [L, r, out] adds `LORA_SCALE * (h @ A) @ B` to its projection, at
JAX's seven sites (wq, wk, wv, wo and the dense MLP's w_gate, w_up, w_down; experts
are never a target). The delta is two plain products, as JAX computes it outside any
kernel; over a quantized base it adds to the GEMV kernel's output (decode) or to the
dequantized product (prefill). Presence decides: a tree without adapters runs as
before.

Training (train/step.py) runs `forward_shard` with no cache from position 0: attention
through `flash_attention_train` (K1 forward, K1b backward on the card), quantized slots
through the dequantized product (its route, `TRAIN_ROUTE`), every op differentiable.

Over a serving mesh (parallel/mesh.py: params a `MeshParams`, the cache or arena split
over tp by `shard_cache`) `forward_shard` runs `_forward_mesh`: JAX's forward under
`tp_mesh` / `ring_mesh` with the collectives GSPMD inserts written out
(parallel/collectives.py). With no cache it is the training forward over the mesh, a
dp axis included (`forward_replicas`), and LoRA adapters are replicated leaves of which
each tp position takes its views. Every kernel above runs once per position on its own heads
or slices, quantized ones included (JAX turns its int4/int8 kernels off under a mesh,
which GSPMD cannot partition; the port has no such limit).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from xotorch_tpu_torch.models.config import ModelConfig
from xotorch_tpu_torch.models.quantize import quantize_tensor, unpack_int4
from xotorch_tpu_torch.ops.attention import gqa_attention
from xotorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_train
from xotorch_tpu_torch.ops.flash_decode import dequantize_kv, flash_cached_attention
from xotorch_tpu_torch.ops.int4_matmul import int4_grouped_matmul
from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul
from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention
from xotorch_tpu_torch.ops.rope import apply_rope, rope_frequencies
from xotorch_tpu_torch.parallel.collectives import all_gather, all_reduce
from xotorch_tpu_torch.parallel.mesh import (MeshParams, cache_device, cache_piece, dp_rows,
                                             piece_name)
from xotorch_tpu_torch.utils import knobs

Params = Dict[str, Any]


ACTIVATIONS = ("silu", "gelu_pytorch_tanh")


def check_supported(cfg: ModelConfig) -> None:
  """Raise for config features the port's model does not implement."""
  if cfg.hidden_act not in ACTIVATIONS:
    raise NotImplementedError(f"{cfg.model_family} config uses activation {cfg.hidden_act}: "
                              f"not ported to xotorch_tpu_torch")


LORA_SCALE = 2.0  # alpha / r with alpha = 2r (train/lora.py builds the tensors)

# The slots that may carry LoRA tensors (train/lora.py's ATTN_SLOTS + MLP_SLOTS).
LORA_SLOTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _check_params(layer: Params) -> None:
  """Refuse an adapter leaf the forward would not apply: one outside the seven dense
  slots (experts are never a target), or an A without its B. Quantized slots
  (`_scale`, `_gscale`) pass as they are."""
  for name in layer:
    if not name.startswith("lora_"):
      continue
    slot, _, part = name[len("lora_"):].rpartition("_")
    if slot not in LORA_SLOTS or part not in ("a", "b"):
      raise NotImplementedError(f"parameter slot {name!r}: LoRA serves only {LORA_SLOTS}")
    if f"lora_{slot}_a" not in layer or f"lora_{slot}_b" not in layer:
      raise ValueError(f"parameter slot {name!r}: LoRA slot {slot} lacks its a/b pair")


# The row-parallel slots: over a mesh their input is a tp position's slice.
_ROW_SLOTS = ("wo", "w_down")


def _maybe_lora(layer: Params, slot: str, h: torch.Tensor, base_out: torch.Tensor) -> torch.Tensor:
  """base_out + LORA_SCALE * (h @ A) @ B when `slot` carries LoRA tensors (JAX's
  `_maybe_lora`): two plain products, the delta cast to the output's dtype.

  At a mesh position (a layer with TP_INDEX) the adapters are the whole replicated
  leaves, and the position takes views of them: a column-parallel slot its out-columns
  of B, a row-parallel slot (`wo`, `w_down`) its in-rows of A, whose delta then adds to
  the position's partial sum before the all-reduce completes it."""
  a = layer.get(f"lora_{slot}_a")
  if a is None:
    return base_out
  b = layer[f"lora_{slot}_b"]
  j, tp = layer.get(TP_INDEX, (0, 1))
  if tp > 1:
    if slot in _ROW_SLOTS:
      part = a.shape[0] // tp
      a = a[j * part:(j + 1) * part]
    else:
      part = b.shape[1] // tp
      b = b[:, j * part:(j + 1) * part]
  delta = (h @ a) @ b
  return base_out + delta.to(base_out.dtype) * LORA_SCALE


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
  which the JAX package sets only under a tensor-parallel mesh because GSPMD cannot
  split its kernel, stays reserved: the port's mesh runs the kernel on each
  position's slice. Elsewhere `force` takes the kernels' functions. K6 rounds the
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
    rows = w.shape[0] * w.shape[1] * 2
    if rows != h.shape[-1]:
      # A row-parallel slot of a mesh whose groups do not split over tp stays whole at
      # every position (parallel/mesh._int4_shape_guard): the position's input slice
      # goes in at its own rows, zeros at the others, so the product is its partial sum.
      j, tp = layer[TP_INDEX]
      part = h.shape[-1]
      h = F.pad(h, (j * part, rows - (j + 1) * part))
      B, T, _ = h.shape
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


# The key of a mesh position's layer dict that holds its (tp index, tp width).
TP_INDEX = "@tp"


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
  gate = _mlp_act(cfg, _maybe_lora(layer, "w_gate", h, _linear(layer, "w_gate", h, route)))
  up = gate * _maybe_lora(layer, "w_up", h, _linear(layer, "w_up", h, route))
  return _maybe_lora(layer, "w_down", up, _linear(layer, "w_down", up, route))


def _moe_einsum(layer: Params, slot: str, eq: str, h: torch.Tensor) -> torch.Tensor:
  """An expert product over every expert ('e...' output); int8 experts dequantize
  through their per-(expert, out) scales, broadcast over the leading E axis."""
  w = layer[slot]
  scale = layer.get(slot + "_scale")
  if scale is None:
    return torch.einsum(eq, h, w)
  out = torch.einsum(eq, h, w.to(h.dtype))
  return out * scale.to(h.dtype)[:, None, None, :]


def _moe_take(layer: Params, slot: str, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """A routed expert product: gather only the chosen experts' weight slices (`idx` [N, k]
  expert ids) and contract each token's input with each of its k slices: x [N, in] (the
  same row for all k) or [N, k, in] -> [N, k, out]. int8 experts dequantize through their
  gathered scales. One batched matmul over the gathered [N, k, in, out] slices as they
  lie (JAX's einsum; torch.einsum permuted them into a copy first)."""
  w = layer[slot][idx]  # [N, k, in, out]
  scale = layer.get(slot + "_scale")
  rows = x[:, None, None, :] if x.dim() == 2 else x[:, :, None, :]
  out = torch.matmul(rows, w if scale is None else w.to(x.dtype))[:, :, 0, :]
  return out if scale is None else out * scale[idx].to(x.dtype)


def _moe_route(layer: Params, h: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
  """(top_vals, top_idx) [B, T, k] of each token: the router in fp32, softmax, the k
  largest probabilities (renormalised under `norm_topk_prob`). Ties go to the lower
  expert index first, as `jax.lax.top_k` orders them: a stable descending sort, where
  `torch.topk` promises no order among equal values."""
  logits = h.to(torch.float32) @ layer["router"].to(torch.float32)  # [B, T, E]
  probs = torch.softmax(logits, dim=-1)
  vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
  k = cfg.num_experts_per_tok
  top_vals, top_idx = vals[..., :k], idx[..., :k]
  if cfg.norm_topk_prob:
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
  return top_vals, top_idx


def _moe_mlp_routed(layer: Params, h: torch.Tensor, top_vals: torch.Tensor,
                    top_idx: torch.Tensor) -> torch.Tensor:
  """The top-k experts of each token, only: a decode step reads k experts' weights
  instead of all E. The same math as the dense combine, whose E - k other terms are
  zero."""
  B, T, H = h.shape
  N, k = B * T, top_idx.shape[-1]
  x = h.reshape(N, H)
  idx = top_idx.reshape(N, k)
  vals = top_vals.reshape(N, k).to(h.dtype)
  gate = F.silu(_moe_take(layer, "we_gate", idx, x))
  up = _moe_take(layer, "we_up", idx, x)
  down = _moe_take(layer, "we_down", idx, gate * up)
  return torch.einsum("nkh,nk->nh", down, vals).reshape(B, T, H)


# Decode-sized inputs (B*T at or under this) take the routed gather; prefill segments
# (bucketed to >= 16 tokens) and verifies stay dense.
_MOE_ROUTED_MAX_TOKENS = 8


def _moe_mlp(layer: Params, h: torch.Tensor, cfg: ModelConfig, routed: bool = True,
             experts: Optional[Tuple[int, int]] = None) -> torch.Tensor:
  """Top-k MoE (qwen3-moe): the routed gather for B*T <= 8 when `routed`, else every
  expert computed and the unchosen ones zeroed by the combine weights (JAX's two
  regimes; JAX's `moe_routed` is false only over an expert-parallel mesh). `experts`
  (lo, hi) is an ep position's resident experts, whose weights `layer` holds: the
  combine then keeps their columns, and the result is the position's partial sum."""
  B, T, _ = h.shape
  top_vals, top_idx = _moe_route(layer, h, cfg)
  if routed and B * T <= _MOE_ROUTED_MAX_TOKENS:
    return _moe_mlp_routed(layer, h, top_vals, top_idx)
  combine = torch.zeros(B, T, cfg.num_experts, dtype=top_vals.dtype, device=h.device)
  combine = combine.scatter(-1, top_idx, top_vals)  # [B, T, E]
  if experts is not None:
    combine = combine[..., experts[0]:experts[1]]
  gate = F.silu(_moe_einsum(layer, "we_gate", "bth,ehi->ebti", h))
  up = _moe_einsum(layer, "we_up", "bth,ehi->ebti", h)
  expert_out = _moe_einsum(layer, "we_down", "ebti,eih->ebth", gate * up)
  return torch.einsum("ebth,bte->bth", expert_out, combine.to(h.dtype))


def init_kv_cache(cfg: ModelConfig, num_layers: int, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device="cpu", kv_quant: bool = False,
                  mesh=None) -> Dict[str, torch.Tensor]:
  """KV buffers [L, B, S, Hkv, D]. `kv_quant` stores K/V as int8 with one scale per
  (position, head), `k_scale`/`v_scale` [L, B, S, Hkv] in `dtype`: half the cache
  bytes per token. The scale leaves are what marks the cache as int8. With a `mesh`,
  the pieces of parallel/mesh.shard_cache made in place: Hkv/tp heads each, piece j
  on its tp index's device (`device` is then unused)."""
  if mesh is not None:
    return mesh_pieces(mesh, lambda local, d: init_kv_cache(local, num_layers, batch, max_seq,
                                                            dtype, d, kv_quant), cfg)
  shape = (num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
  if not kv_quant:
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
  return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
          "v": torch.zeros(shape, dtype=torch.int8, device=device),
          "k_scale": torch.zeros(shape[:-1], dtype=dtype, device=device),
          "v_scale": torch.zeros(shape[:-1], dtype=dtype, device=device)}


def mesh_pieces(mesh, make, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
  """A flat sharded cache or arena: `make(local cfg, device)` for each tp index j,
  with the kv heads of one position, its leaves renamed `piece_name(leaf, j)`."""
  tp = mesh.axis_size("tp")
  local = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                              num_kv_heads=cfg.num_kv_heads // tp)
  out = {}
  for j in range(tp):
    out.update({piece_name(n, j): t for n, t in make(local, cache_device(mesh, j)).items()})
  return out


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


def _qkv(layer: Params, h: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
         inv_freq: torch.Tensor, route: QuantRoute):
  """The normed input's queries, keys and values [B, T, heads, D], biased, qk-normed
  and rotated. `cfg`'s head counts are the caller's: a tp position's share."""
  B, T, _ = h.shape
  q = _maybe_lora(layer, "wq", h, _linear(layer, "wq", h, route))
  k = _maybe_lora(layer, "wk", h, _linear(layer, "wk", h, route))
  v = _maybe_lora(layer, "wv", h, _linear(layer, "wv", h, route))
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
  return apply_rope(q, positions, inv_freq), apply_rope(k, positions, inv_freq), v


def _score_adjustments(cfg: ModelConfig, window: int) -> dict:
  """The gemma family's score adjustments; 0 / None (1 / sqrt(D)) for the others."""
  return dict(window=window, softcap=cfg.attn_logit_softcap,
              scale=cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar else None)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]],
            layer_idx: int, positions: torch.Tensor, kv_valid_len: torch.Tensor,
            start_pos: Union[int, torch.Tensor], q_start: torch.Tensor, use_flash: bool,
            use_flash_decode: bool, page_table: Optional[torch.Tensor], slots: Any,
            adj: dict) -> torch.Tensor:
  """Write the fresh K/V into the cache (or the page arena) and attend [B, T, Hq, D]
  through the kernel the path takes."""
  B, T = q.shape[0], q.shape[1]
  if cache is None:
    # The training and evaluation forward (train/step.py): from position 0 over the
    # fresh K/V with nothing to write, differentiable through K1b on the card.
    return flash_attention_train(q, k.contiguous(), v.contiguous(), **adj)
  scales = {name: cache[name][layer_idx] for name in ("k_scale", "v_scale") if name in cache}
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
      return paged_decode_attention(q, k_pages, v_pages, page_table, kv_valid_len,
                                    k_scale_pages=ks, v_scale_pages=vs, **adj)
    return paged_prefill_attention(q, k_pages, v_pages, page_table, kv_valid_len,
                                   k_scale_pages=ks, v_scale_pages=vs, **adj)
  _cache_write(cache, layer_idx, k, v, start_pos, slots)
  if use_flash:
    # Prefill from position 0: the fresh segment is the whole visible context, so
    # the kernel attends over the fresh k/v and never reads the cache (an int8
    # cache included).
    return flash_attention(q, k.contiguous(), v.contiguous(), **adj)
  if use_flash_decode:
    # Decode steps and segments at pos > 0: the cache up to each row's last
    # visible position; an int8 cache passes its raw codes and scales (K2q).
    return flash_cached_attention(q, cache["k"][layer_idx], cache["v"][layer_idx], q_start,
                                  k_scale=scales.get("k_scale"), v_scale=scales.get("v_scale"),
                                  **adj)
  if q.device.type == "cpu":
    k_all, v_all = _cache_read(cache, layer_idx, q.dtype)
    return gqa_attention(q, k_all, v_all, positions, kv_valid_len, **adj)
  raise ValueError("attention on the card goes through a kernel: pass use_flash "
                   "(prefill from 0) or use_flash_decode")


def _attention_block(layer: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor], layer_idx: int,
                     positions: torch.Tensor, kv_valid_len: torch.Tensor,
                     start_pos: Union[int, torch.Tensor], q_start: torch.Tensor, cfg: ModelConfig,
                     inv_freq: torch.Tensor, use_flash: bool, use_flash_decode: bool,
                     route: QuantRoute, page_table: Optional[torch.Tensor] = None,
                     slots: Any = None, window: int = 0) -> torch.Tensor:
  """The attention half of a layer up to its output projection (the sandwich post-norm
  is the caller's). `window` is this layer's (0 = global)."""
  h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
  q, k, v = _qkv(layer, h, cfg, positions, inv_freq, route)
  attn = _attend(q, k, v, cache, layer_idx, positions, kv_valid_len, start_pos, q_start,
                 use_flash, use_flash_decode, page_table, slots, _score_adjustments(cfg, window))
  return _attention_out(layer, attn, route)


def _attention_out(layer: Params, attn: torch.Tensor, route: QuantRoute) -> torch.Tensor:
  """The output projection of attention [B, T, heads, D]."""
  B, T = attn.shape[0], attn.shape[1]
  attn2d = attn.reshape(B, T, attn.shape[2] * attn.shape[3])
  return _maybe_lora(layer, "wo", attn2d, _linear(layer, "wo", attn2d, route))


def _post_norm(layer: Params, name: str, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
  """The sandwich post-norm `name` where the config has one."""
  if cfg.sandwich_norms:
    return rms_norm(out, layer[name], cfg.rms_norm_eps, cfg.norm_offset)
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


def _position_tensors(start_pos: Union[int, torch.Tensor], B: int, T: int, device):
  """(positions [B, T], kv_valid_len [B], q_start [B]) of a segment of T tokens from
  `start_pos` (an int, or [B] per row) on `device`."""
  steps = torch.arange(T, device=device)
  if torch.is_tensor(start_pos):
    q_start = start_pos.to(device=device, dtype=torch.int32)
    return q_start.to(torch.int64)[:, None] + steps[None, :], q_start + T, q_start
  positions = (start_pos + steps)[None, :].expand(B, T)
  return (positions, torch.full((B,), start_pos + T, dtype=torch.int32, device=device),
          torch.full((B,), start_pos, dtype=torch.int32, device=device))


def _write_slots(cache: Optional[Dict[str, torch.Tensor]], page_table: Optional[torch.Tensor],
                 positions: torch.Tensor, start_pos: Union[int, torch.Tensor]):
  """Where the fresh K/V go, for the tensor-indexed writes: page slots on the arena,
  per-row positions for a [B] `start_pos`; None for one slice at an int."""
  if page_table is not None:
    return _page_slots(page_table, positions, cache["k"].shape[2])
  if torch.is_tensor(start_pos):
    # Per-row writes stay inside the buffer (JAX's dynamic_update_slice clamps too);
    # the engine sizes the cache so that real rows never reach the clamp.
    return torch.clamp(positions, max=cache["k"].shape[2] - 1)
  return None


def _windows(cfg: ModelConfig, start_layer: int, L: int) -> list:
  """Each layer's window: which layers slide is a property of the absolute layer index
  (gemma2 alternates), so a shard that starts mid-model windows by start_layer + i;
  0 = global."""
  if cfg.uses_sliding_window:
    return [cfg.layer_window(start_layer + i) for i in range(L)]
  return [0] * L


def forward_shard(
  params: Union[Params, MeshParams],
  x: torch.Tensor,  # [B, T] int tokens (first shard) or [B, T, H] hidden
  cache: Optional[Dict[str, torch.Tensor]],
  start_pos: Union[int, torch.Tensor],  # position of x[:, 0]: an int, or [B] per row
  cfg: ModelConfig,
  is_first: bool,
  is_last: bool,
  use_flash: bool = False,
  use_flash_decode: bool = False,
  start_layer: int = 0,
  page_table: Optional[torch.Tensor] = None,  # [B, max_pages] int32: `cache` is the arena
  route: Optional[QuantRoute] = None,
  ring: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """Run one shard. Returns (hidden, or fp32 logits on the last shard; the cache,
  updated in place). `use_flash` is valid only when start_pos == 0.

  A [B] `start_pos` puts each row at its own depth (continuous batching): per-row
  RoPE positions, cache slots and visible lengths. With `page_table`, `cache` is the
  shared page arena (paged_cache.PagePool): decode steps (T == 1) attend through K3,
  segments (T > 1, B == 1) through K4; `use_flash`/`use_flash_decode` are ignored. A
  cache with `k_scale`/`v_scale` leaves is int8 and takes the kernels' int8 variants.
  `route` sends quantized decode projections to their kernels; by default the
  knobs' route (`quant_route`) for the device of `x`. With no `cache` (None, a prefill
  from 0 with `use_flash`: the training forward of train/step.py) nothing is written
  and attention goes through `flash_attention_train`, which autograd differentiates.

  `params` placed on a mesh (parallel/mesh.MeshParams, with a cache split by
  parallel/mesh.shard_cache, or no cache: the training forward) runs the mesh path
  (`_forward_mesh`); `ring` there is JAX's `ring_mesh`: a forward from 0 whose
  positions split over the sp axis and whose attention is ring attention. A mesh with
  a dp axis serves only the training forward: each dp index runs its rows of the
  batch (`forward_replicas`), gathered here on the mesh's first device."""
  check_supported(cfg)
  if use_flash and not (isinstance(start_pos, int) and start_pos == 0):
    raise ValueError("use_flash serves a prefill from position 0 only")
  if cache is None and (not use_flash or page_table is not None):
    raise ValueError("a forward without a cache is a prefill from position 0 (use_flash)")
  if isinstance(params, MeshParams):
    mesh = params.mesh
    if mesh.axis_size("dp") == 1:
      return _forward_mesh(params, x, cache, start_pos, cfg, is_first, is_last, use_flash,
                           use_flash_decode, start_layer, page_table, route, ring)
    if cache is not None:
      raise ValueError("a mesh with a dp axis runs the training forward (no cache): "
                       "serving meshes have none")
    outs = forward_replicas(params, x, cfg, is_first, is_last, start_layer, route, ring)
    return all_gather(outs, mesh.devices[:1], dim=0)[0], None
  if ring:
    raise ValueError("ring attention runs over a mesh's sp axis: params placed on a mesh")
  h = embed(params, x, cfg) if is_first else x
  B, T = h.shape[0], h.shape[1]
  device = h.device
  positions, kv_valid_len, q_start = _position_tensors(start_pos, B, T, device)
  slots = _write_slots(cache, page_table, positions, start_pos)
  inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=device)
  if route is None:
    route = quant_route(device.type == "cuda")
  stacked = params["layers"]
  _check_params(stacked)
  L = stacked["wq"].shape[0]
  windows = _windows(cfg, start_layer, L)
  for i in range(L):
    layer = {name: w[i] for name, w in stacked.items()}
    attn = _attention_block(layer, h, cache, i, positions, kv_valid_len, start_pos, q_start,
                            cfg, inv_freq, use_flash, use_flash_decode, route, page_table, slots,
                            windows[i])
    h = h + _post_norm(layer, "post_attn_norm", attn, cfg)
    mlp_in = rms_norm(h, layer["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    mlp_out = _moe_mlp(layer, mlp_in, cfg) if cfg.is_moe else _dense_mlp(layer, mlp_in, cfg, route)
    h = h + _post_norm(layer, "post_mlp_norm", mlp_out, cfg)
  if not is_last:
    return h, cache
  return unembed(params, h, cfg), cache


class _PerDevice(dict):
  """Values computed once for each device (`make(device)`), as the mesh path needs its
  positions, page tables and RoPE frequencies at every position's device."""

  def __init__(self, make):
    super().__init__()
    self._make = make

  def __missing__(self, device):
    self[device] = value = self._make(device)
    return value


def forward_replicas(mp: MeshParams, x: torch.Tensor, cfg: ModelConfig, is_first: bool,
                     is_last: bool, start_layer: int = 0, route: Optional[QuantRoute] = None,
                     ring: bool = False) -> list:
  """The training forward (from 0, no cache) over a mesh with a dp axis: dp index d runs
  rows d of the batch (parallel/mesh.dp_rows) on its own positions, and its output
  stays on its replica (the device of its first position), one per dp index in order.
  The loss divides by the count over the whole batch (train/step.full_model_loss)."""
  return [_forward_mesh(mp, xd, None, 0, cfg, is_first, is_last, True, False, start_layer,
                        None, route, ring, replica=d)[0]
          for d, xd in enumerate(dp_rows(x, mp.mesh))]


def _forward_mesh(mp: MeshParams, x: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]],
                  start_pos: Union[int, torch.Tensor], cfg: ModelConfig, is_first: bool,
                  is_last: bool, use_flash: bool, use_flash_decode: bool, start_layer: int,
                  page_table: Optional[torch.Tensor], route: Optional[QuantRoute],
                  ring: bool, replica: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """forward_shard over a mesh (JAX's forward under `tp_mesh` / `ring_mesh`, with the
  collectives GSPMD inserts written out, parallel/collectives.py), on the positions of
  dp index `replica`.

  Each tp position j runs its Hq/tp query heads over its Hkv/tp cache or arena heads
  (`cache_piece(cache, j)`) through the same kernels as one device, with the group
  size, grid and page table unchanged: no traffic inside attention. Its column slices
  of wq/wk/wv/w_gate/w_up and row slices of wo/w_down give partial sums, which one
  all-reduce over the tp positions completes (in rank order). The embedding's hidden
  slices are all-gathered; the vocab-split logits too (a tied table's hidden slices
  give partial logits, all-reduced). MoE experts run where they lie: each (ep, tp)
  position its resident experts' inner slice, the combine's partial sums all-reduced
  over every position; the routed gather only where ep is 1 (JAX's `_moe_routed_for`).
  Positions that differ only along ep compute attention once, at ep 0; positions that
  differ along sp compute only under `ring`, where chunk c of the prompt's positions
  goes to the positions with sp index c, K/V chunks rotate round each tp index's ring
  (ops/ring_attention.py) and are written into cache piece j, and the hidden chunks
  are gathered at the end. With no cache (the training forward, every op
  differentiable) each tp position attends through `flash_attention_train` (K1, K1b in
  the backward) over its fresh K/V, or the ring rotates the fresh chunks and writes
  nothing. Returns the output on the device of the replica's first position."""
  from xotorch_tpu_torch.ops.ring_attention import ring_attention

  mesh = mp.mesh
  dev = mesh.devices
  tp, ep, sp = mesh.axis_size("tp"), mesh.axis_size("ep"), mesh.axis_size("sp")
  local = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                              num_kv_heads=cfg.num_kv_heads // tp)
  B, T = x.shape[0], x.shape[1]
  chunks = sp if ring else 1
  if ring:
    if not (x.ndim == (2 if is_first else 3) and isinstance(start_pos, int) and start_pos == 0
            and page_table is None and T % sp == 0):
      raise ValueError("ring prefill: tokens (or a hidden input, as a multimodal prompt's "
                       "merged sequence) from position 0 on a contiguous cache or none, T "
                       f"divisible by sp={sp}")
    if cfg.uses_sliding_window or cfg.attn_logit_softcap or cfg.query_pre_attn_scalar:
      raise ValueError("ring attention implements no window, softcap or query_pre_attn_scalar")
  Tl = T // chunks
  # Attention: one position per tp index; MoE layers: every ep index too.
  att = [mesh.positions(dp=replica, ep=0, sp=c) for c in range(chunks)]
  live = [mesh.positions(dp=replica, sp=c) if cfg.is_moe else att[c] for c in range(chunks)]
  tp_of = {p: mesh.coord(p, "tp") for p in range(mesh.size)}
  if route is None:
    route = quant_route(dev[0].type == "cuda")
  _check_params(mp.pieces[0]["layers"])
  L = mp.pieces[0]["layers"]["wq"].shape[0]
  windows = _windows(cfg, start_layer, L)
  inv_freq = _PerDevice(lambda d: rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                                   cfg.rope_scaling, device=d))
  # Per chunk: its positions' tensors at each device; the cache pieces' write slots.
  pos_at = [_PerDevice(lambda d, c=c: _position_tensors(
    c * Tl if ring else (start_pos.to(d) if torch.is_tensor(start_pos) else start_pos), B, Tl, d))
            for c in range(chunks)]
  pieces = [cache_piece(cache, j) if cache is not None else None for j in range(tp)]
  tables = _PerDevice(lambda d: page_table.to(d) if page_table is not None else None)
  slots = [None if ring or cache is None else
           _write_slots(pieces[j], tables[dev[att[0][j]]], pos_at[0][dev[att[0][j]]][0], start_pos)
           for j in range(tp)]

  # The residual stream: chunk c's hidden state at each of live[c]'s positions.
  hs = []
  for c in range(chunks):
    xc = x[:, c * Tl:(c + 1) * Tl]
    if is_first:
      rows = [embed(mp.pieces[p], xc.to(dev[p]), cfg) for p in att[c]]
      hs.append(all_gather(rows, [dev[p] for p in live[c]], dim=-1))
    else:
      hs.append([xc.to(dev[p]) for p in live[c]])

  def at(c: int, p: int) -> torch.Tensor:
    return hs[c][live[c].index(p)]

  for i in range(L):
    layers = {p: _mesh_layer(mp.pieces[p], i, tp_of[p], tp) for c in range(chunks) for p in live[c]}
    adj = _score_adjustments(cfg, windows[i])
    qkv = {}
    for c in range(chunks):
      for p in att[c]:
        layer, d = layers[p], dev[p]
        h = rms_norm(at(c, p), layer["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        qkv[c, tp_of[p]] = _qkv(layer, h, local, pos_at[c][d][0], inv_freq[d], route)
    attn = {}
    for j in range(tp):
      home_j = dev[att[0][j]]
      if ring:
        for c in range(chunks):
          if cache is not None:
            _, k, v = qkv[c, j]
            _cache_write(pieces[j], i, k.to(home_j), v.to(home_j), c * Tl, None)
        ring_devs = [dev[att[c][j]] for c in range(chunks)]
        outs = ring_attention([qkv[c, j][0] for c in range(chunks)],
                              [qkv[c, j][1] for c in range(chunks)],
                              [qkv[c, j][2] for c in range(chunks)], ring_devs)
        for c in range(chunks):
          attn[c, j] = outs[c]
      else:
        q, k, v = qkv[0, j]
        positions, kv_valid_len, q_start = pos_at[0][home_j]
        attn[0, j] = _attend(q, k, v, pieces[j], i, positions, kv_valid_len,
                             start_pos.to(home_j) if torch.is_tensor(start_pos) else start_pos,
                             q_start, use_flash, use_flash_decode, tables[home_j], slots[j], adj)
    for c in range(chunks):
      parts = [_attention_out(layers[p], attn[c, tp_of[p]], route) for p in att[c]]
      summed = all_reduce(parts, [dev[p] for p in live[c]])
      hs[c] = [h + _post_norm(layers[p], "post_attn_norm", s, cfg)
               for p, h, s in zip(live[c], hs[c], summed)]
      if cfg.is_moe:
        E = cfg.num_experts // ep
        parts = []
        for p in live[c]:
          e = mesh.coord(p, "ep")
          mlp_in = rms_norm(at(c, p), layers[p]["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
          parts.append(_moe_mlp(layers[p], mlp_in, cfg, routed=ep == 1,
                                experts=(e * E, (e + 1) * E)))
      else:
        parts = [_dense_mlp(layers[p], rms_norm(at(c, p), layers[p]["mlp_norm"], cfg.rms_norm_eps,
                                                cfg.norm_offset), cfg, route) for p in att[c]]
      summed = all_reduce(parts, [dev[p] for p in live[c]])
      hs[c] = [h + _post_norm(layers[p], "post_mlp_norm", s, cfg)
               for p, h, s in zip(live[c], hs[c], summed)]
  home = dev[att[0][0]]
  if chunks > 1:
    h = all_gather([hs[c][0] for c in range(chunks)], [home], dim=1)[0]
  else:
    h = hs[0][0]
  if not is_last:
    return h, cache
  return unembed(mp, h, cfg, replica), cache


def _mesh_layer(piece: Params, i: int, j: int, tp: int) -> Params:
  """Layer i of a mesh position's param tree, with its (tp index, tp width)."""
  layer = {name: w[i] for name, w in piece["layers"].items()}
  layer[TP_INDEX] = (j, tp)
  return layer


def _head_logits(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
  """h [B, T, H'] (normed) times the tied embedding's or lm_head's columns, in the
  compute dtype; int8 tables rescale per vocab column."""
  if cfg.tie_word_embeddings and "lm_head" not in params:
    emb = params["embed"]["embedding"]
    row_scale = params["embed"].get("embedding_scale")
    if row_scale is None:
      return h @ emb.T
    # Tied int8 table: the per-row scale becomes a per-vocab-column scale.
    return (h @ emb.to(h.dtype).T) * row_scale.to(h.dtype)[None, None, :]
  head_scale = params.get("lm_head_scale")
  if head_scale is None:
    return h @ params["lm_head"]
  return (h @ params["lm_head"].to(h.dtype)) * head_scale.to(h.dtype)[None, None, :]


def unembed(params: Union[Params, MeshParams], h: torch.Tensor, cfg: ModelConfig,
            replica: int = 0) -> torch.Tensor:
  """Final norm + (tied-embedding or lm_head) unembedding -> fp32 logits, soft-capped
  in fp32 where the config says so. Over a mesh the tp positions of dp index `replica`
  each compute their vocab columns (all-gathered) or, from a tied table's hidden slice,
  partial logits (all-reduced in fp32), on the replica's first device."""
  if isinstance(params, MeshParams):
    mesh = params.mesh
    att = mesh.positions(dp=replica, ep=0, sp=0)
    tied = cfg.tie_word_embeddings and "lm_head" not in params
    parts = []
    for j, p in enumerate(att):
      piece = params.pieces[p]
      hp = rms_norm(h.to(mesh.devices[p]), piece["final_norm"], cfg.rms_norm_eps, cfg.norm_offset)
      if tied:
        width = piece["embed"]["embedding"].shape[1]
        hp = hp[..., j * width:(j + 1) * width]
      parts.append(_head_logits(piece, hp, cfg).to(torch.float32))
    home = [mesh.devices[att[0]]]
    combine = all_reduce(parts, home) if tied else all_gather(parts, home, -1)
    logits = combine[0]
  else:
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    logits = _head_logits(params, h, cfg).to(torch.float32)
  if cfg.final_logit_softcap:
    cap = float(cfg.final_logit_softcap)
    logits = torch.tanh(logits / cap) * cap
  return logits


def embed(params: Union[Params, MeshParams], x: torch.Tensor,
          cfg: Optional[ModelConfig] = None) -> torch.Tensor:
  """Token rows of the embedding; an int8 table rescales each looked-up row by its
  own scale, in the scale's (compute) dtype. Gemma scales the rows by sqrt(hidden),
  the factor rounded to the rows' dtype first, as HF does. Over a mesh the tp
  positions' hidden slices are all-gathered on the mesh's first device."""
  if isinstance(params, MeshParams):
    mesh = params.mesh
    rows = [embed(params.pieces[p], x.to(mesh.devices[p]), cfg)
            for p in mesh.positions(dp=0, ep=0, sp=0)]
    return all_gather(rows, mesh.devices[:1], dim=-1)[0]
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
  E, MI = cfg.num_experts, cfg.moe_intermediate_size or I

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
    }
    if cfg.is_moe:
      # JAX's slots: the router and the stacked experts [E, in, out] at 4-7.
      p["router"] = rnd(a, 4, H, E)
      p["we_gate"] = rnd(a, 5, E, H, MI)
      p["we_up"] = rnd(a, 6, E, H, MI)
      p["we_down"] = rnd(a, 7, E, MI, H)
    else:
      p["w_gate"] = rnd(a, 4, H, I)
      p["w_up"] = rnd(a, 5, H, I)
      p["w_down"] = rnd(a, 6, I, H)
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
