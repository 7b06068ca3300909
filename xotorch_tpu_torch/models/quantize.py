"""Weight-only quantization: int8 per output channel, int4 group-wise.

The port's copy of xotorch_tpu/models/quantize.py. The stored layouts are the JAX
package's, byte for byte, so a quantized tree moves between the two packages as it
is:

- a quantized projection keeps its slot: `<slot>` becomes int8 with the same shape
  and `<slot>_scale` holds one scale per output channel (compute dtype), reduced
  over the input (contraction) axis: `y = (x @ q) * scale`;
- int4 packs two values per uint8 along each group of the contraction axis:
  `<slot>` [L, G, gs/2, out], element 2i in the LOW nibble, and `<slot>_gscale`
  [L, G, out] holds one scale per (group, output channel);
- the embedding is int8 per row (`embedding_scale` [vocab]): a lookup rescales by
  its row's scale, and a tied unembedding uses the same scale per vocab column;
  `lm_head` [H, vocab] gets `lm_head_scale` [vocab];
- norms stay in the compute dtype.

Rounding is `torch.round` (half to even, as `jnp.round`) of `w32 / scale` in fp32.
`quantize_params(..., inplace=True)` replaces each slot as it goes, layer by layer,
so a full-size bf16 model never needs its whole fp32 image at once: the engine
quantizes on the card right after the weights are drawn.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

# Stacked-layer matmul slots ([L, in, out] / [L, E, in, out]). Keys absent from a
# layer dict are skipped.
LAYER_SLOTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "we_gate", "we_up", "we_down")

# int4's stored dtype is uint8: two nibbles per byte (pack_int4).
QUANT_DTYPES = {"int8": torch.int8, "int4": torch.uint8}

# int4 quantizes group-wise along the contraction axis: [.., in, out] reshapes to
# [.., G, gs, out] with one scale per (group, out channel).
INT4_GROUP_SIZE = 128

# int4 keeps the embedding, lm_head and MoE experts at int8.
_INT4_LAYER_SLOTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_tensor(w: torch.Tensor, axis: int, dtype=torch.int8,
                    scale_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-channel quantization reducing over `axis` (the matmul
  contraction axis). Returns (q, scale) with scale squeezed over `axis`."""
  qmax = float(torch.iinfo(dtype).max)
  w32 = w.to(torch.float32)
  scale = torch.amax(torch.abs(w32), dim=axis, keepdim=True) / qmax
  scale = torch.clamp(scale, min=1e-12)  # all-zero channels quantize to zeros
  q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(dtype)
  return q, scale.squeeze(axis).to(scale_dtype)


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor, axis: int,
                      dtype=torch.bfloat16) -> torch.Tensor:
  """Inverse of quantize_tensor."""
  return (q.to(torch.float32) * scale.to(torch.float32).unsqueeze(axis)).to(dtype)


def _group_size(d_in: int, group_size: int = INT4_GROUP_SIZE) -> int:
  """`group_size` when it divides the contraction dim, else the whole dim."""
  return group_size if d_in % group_size == 0 else d_in


def pack_int4(q: torch.Tensor) -> torch.Tensor:
  """int4 values (int32 in [-8, 7], [..., gs, out]) -> uint8 nibble pairs
  [..., gs // 2, out]: element 2i in the LOW nibble, 2i+1 in the high."""
  *lead, gs, d_out = q.shape
  pairs = q.reshape(*lead, gs // 2, 2, d_out)
  lo = pairs[..., 0, :] & 0xF
  hi = pairs[..., 1, :] & 0xF
  return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
  """Inverse of pack_int4: [..., gs // 2, out] uint8 -> [..., gs, out] int8."""
  lo = (packed & 0xF).to(torch.int8)
  hi = (packed >> 4).to(torch.int8)
  lo = torch.where(lo > 7, lo - 16, lo)
  hi = torch.where(hi > 7, hi - 16, hi)
  *lead, gs_half, d_out = packed.shape
  return torch.stack([lo, hi], dim=-2).reshape(*lead, gs_half * 2, d_out)


def quantize_tensor_grouped(w: torch.Tensor, scale_dtype=torch.bfloat16,
                            group_size: int = INT4_GROUP_SIZE) -> Tuple[torch.Tensor, torch.Tensor]:
  """Group-wise symmetric int4 quantization of a stacked weight [L, in, out] ->
  (packed uint8 [L, G, gs // 2, out], scale [L, G, out])."""
  L, d_in, d_out = w.shape
  gs = _group_size(d_in, group_size)
  qmax = 7.0
  wg = w.to(torch.float32).reshape(L, d_in // gs, gs, d_out)
  scale = torch.amax(torch.abs(wg), dim=2, keepdim=True) / qmax
  scale = torch.clamp(scale, min=1e-12)
  q = torch.clamp(torch.round(wg / scale), -qmax, qmax).to(torch.int32)
  return pack_int4(q), scale.squeeze(2).to(scale_dtype)


def dequantize_tensor_grouped(q: torch.Tensor, scale: torch.Tensor,
                              dtype=torch.bfloat16) -> torch.Tensor:
  """Inverse of quantize_tensor_grouped: packed [L, G, gs // 2, out] -> [L, in, out]."""
  unpacked = unpack_int4(q)
  L, G, gs, d_out = unpacked.shape
  w = unpacked.to(torch.float32) * scale.to(torch.float32)[:, :, None, :]
  return w.reshape(L, G * gs, d_out).to(dtype)


def _contraction_axis(slot: str, ndim: int) -> int:
  """Input axis of a stacked weight: [L, in, out] -> 1, MoE [L, E, in, out] -> 2."""
  return ndim - 2


def _per_layer(fn, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """fn over each layer of a stacked weight, results restacked: the fp32
  temporaries are one layer's, not the stack's. The reductions never cross layers,
  so the result equals fn over the whole stack."""
  qs, scales = zip(*(fn(w[i:i + 1]) for i in range(w.shape[0])))
  return torch.cat(qs), torch.cat(scales)


def quantize_params(params: Dict[str, Any], fmt: str = "int8", scale_dtype=torch.bfloat16,
                    inplace: bool = False) -> Dict[str, Any]:
  """Quantize a shard's matmul weights, embedding and lm_head.

  Returns a new tree (leaves shared where unquantized), or with `inplace` the same
  tree with each slot replaced as soon as it is quantized. Already-quantized leaves
  are left alone."""
  if fmt not in QUANT_DTYPES:
    raise ValueError(f"Unsupported quantization format {fmt!r}; have {sorted(QUANT_DTYPES)}")
  int4 = fmt == "int4"

  out: Dict[str, Any] = params if inplace else dict(params)
  layers = params["layers"] if inplace else dict(params["layers"])
  for slot in LAYER_SLOTS:
    w = layers.get(slot)
    if (w is None or w.dtype in (torch.int8, torch.uint8)
        or slot + "_gscale" in layers):
      continue
    if (int4 and slot in _INT4_LAYER_SLOTS
        and _group_size(w.shape[-2]) % 2 == 0):  # nibble pairs need even groups
      q, gscale = _per_layer(lambda x: quantize_tensor_grouped(x, scale_dtype), w)
      layers[slot] = q
      layers[slot + "_gscale"] = gscale
    else:
      axis = _contraction_axis(slot, w.ndim)
      q, scale = _per_layer(lambda x: quantize_tensor(x, axis, torch.int8, scale_dtype), w)
      layers[slot] = q
      layers[slot + "_scale"] = scale
    del w
  out["layers"] = layers

  embed = params.get("embed")
  if embed is not None and embed["embedding"].dtype != torch.int8:
    # [vocab, H]: the per-row scale serves the lookup and a tied unembedding.
    q, scale = quantize_tensor(embed["embedding"], 1, torch.int8, scale_dtype)
    out["embed"] = {"embedding": q, "embedding_scale": scale}

  head = params.get("lm_head")
  if head is not None and head.dtype != torch.int8:
    q, scale = quantize_tensor(head, 0, torch.int8, scale_dtype)  # [H, vocab] -> [vocab]
    out["lm_head"] = q
    out["lm_head_scale"] = scale
  return out


def dequantize_params(params: Dict[str, Any], dtype=torch.bfloat16) -> Dict[str, Any]:
  """A compute-dtype tree rebuilt from a quantized one."""
  out: Dict[str, Any] = dict(params)
  layers = dict(params["layers"])
  for slot in LAYER_SLOTS:
    gscale = layers.pop(slot + "_gscale", None)
    if gscale is not None:
      layers[slot] = dequantize_tensor_grouped(layers[slot], gscale, dtype)
      continue
    scale = layers.pop(slot + "_scale", None)
    if scale is None:
      continue
    w = layers[slot]
    layers[slot] = dequantize_tensor(w, scale, _contraction_axis(slot, w.ndim), dtype)
  out["layers"] = layers
  embed = params.get("embed")
  if embed is not None and "embedding_scale" in embed:
    out["embed"] = {"embedding": dequantize_tensor(embed["embedding"], embed["embedding_scale"],
                                                   1, dtype)}
  scale = out.pop("lm_head_scale", None)
  if scale is not None:
    out["lm_head"] = dequantize_tensor(params["lm_head"], scale, 0, dtype)
  return out


def is_quantized(params: Dict[str, Any]) -> bool:
  return (any(k.endswith("_scale") or k.endswith("_gscale") for k in params.get("layers", {}))
          or "lm_head_scale" in params)


def _leaves(tree):
  if isinstance(tree, dict):
    for v in tree.values():
      yield from _leaves(v)
  elif torch.is_tensor(tree):
    yield tree


def quantized_bytes(params: Dict[str, Any]) -> int:
  """Bytes the tree's tensors occupy (packed int4 counts half a byte a value)."""
  return sum(t.numel() * t.element_size() for t in _leaves(params))
