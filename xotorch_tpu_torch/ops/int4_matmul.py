"""K5 and K5v4: decode GEMVs over group-wise int4 weights packed two to a byte.

The port of xotorch_tpu/ops/int4_matmul.py. The weight of one projection is stored
as models/quantize.pack_int4 leaves it: uint8 [G, gs/2, out], packed row p of group
g holding logical rows g*gs + 2p (low nibble) and g*gs + 2p + 1 (high nibble), with
gscale [G, out]. A sum is order-free, so the contraction never re-interleaves the
nibbles:

    h @ W  ==  h_even @ unpack_lo(W) + h_odd @ unpack_hi(W)

- K5 (`int4_w4a16_matmul`, variants 1-3 of the JAX package, which differ on the TPU
  only in where the scale multiply sits): exact W4A16, fp32 arithmetic.
- K5v4 (`int4_w4a8_matmul`, variant 4): W4A8. h_even and h_odd are row-quantized to
  int8 SEPARATELY (two [rows, 1] scales, ops/int8_matmul.rowquant_int8), the nibble
  dots accumulate in int32 per group, and the scales compose after the dot:
  out = sum_g (pe_g * s_even + po_g * s_odd) * gscale[g]. Approximate by design.

Both kernels are hand-written CUDA for Hopper (csrc/quant_matvec.cu): the nibbles
are unpacked in registers after the packed read, so the card streams half a byte a
weight. Both are K6's design (ops/int8_matmul.py): split-K over a thread-block cluster
on the `gemv_plan` ranges, tensor-core products, one launch. K5
(`w4a16_cluster_kernel`) multiplies bf16 nibbles by bf16 h with one fp32 fragment a
group. K5v4 (`w4a8_cluster_kernel`) quantizes its activations inside its launch, bit
for bit as the plain version (the cluster agrees on the even and the odd maxima), and
multiplies int8 nibbles by int8 h with two int32 fragments a group (even, odd),
composed in fp32 when the group ends. One decode row over a short contraction takes
the one-row kernels instead (`w4a16_kernel`, `w4a8_kernel`: a block a 32 columns on
the CUDA cores), as the plan says. The plain PyTorch versions sit beside them (K5's
mirrors the JAX v1 body; K5v4's takes the integer dots in float64, which holds them
exactly). The wrappers take them only for tensors on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

from xotorch_tpu_torch.ops import _build
from xotorch_tpu_torch.ops.flash_decode import _sm_count
from xotorch_tpu_torch.ops.int8_matmul import check_operands, gemv_plan, rowquant_int8


def _nibbles(w_packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Sign-extended low and high nibbles of a packed weight, int8, same shape."""
  p8 = w_packed.view(torch.int8)  # the uint8 bytes reinterpreted, as JAX's modular astype
  return (p8 << 4) >> 4, p8 >> 4


def _halves(h: torch.Tensor, G: int, gs_half: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """h [rows, G*gs] -> (h_even, h_odd), each [rows, G*gs/2]: the columns that meet
  the low and the high nibbles."""
  hg = h.reshape(h.shape[0], G, 2 * gs_half)
  return (hg[:, :, 0::2].reshape(h.shape[0], G * gs_half),
          hg[:, :, 1::2].reshape(h.shape[0], G * gs_half))


def _check_shapes(name: str, h: torch.Tensor, w_packed: torch.Tensor, gscale: torch.Tensor) -> None:
  G, gs_half, d_out = w_packed.shape
  if h.dim() != 2 or h.shape[1] != G * gs_half * 2 or gscale.shape != (G, d_out):
    raise ValueError(f"{name}: packed weight {tuple(w_packed.shape)} and gscale "
                     f"{tuple(gscale.shape)} do not cover h {tuple(h.shape)}")


def int4_w4a16_matmul_ref(h: torch.Tensor, w_packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
  """Plain K5: the nibbles scaled into fp32 operands, two fp32 dots."""
  G, gs_half, d_out = w_packed.shape
  he, ho = _halves(h.to(torch.float32), G, gs_half)
  lo, hi = _nibbles(w_packed)
  scale = gscale.to(torch.float32)[:, None, :]
  lo_f = (lo.to(torch.float32) * scale).reshape(G * gs_half, d_out)
  hi_f = (hi.to(torch.float32) * scale).reshape(G * gs_half, d_out)
  return (he @ lo_f + ho @ hi_f).to(h.dtype)


def int4_w4a8_matmul_ref(h: torch.Tensor, w_packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
  """Plain K5v4: h_even and h_odd row-quantized apart, per-group integer dots
  (exact in float64), scales composed after the dot in fp32, summed over groups."""
  G, gs_half, d_out = w_packed.shape
  rows = h.shape[0]
  he, ho = _halves(h, G, gs_half)
  he8, he_s = rowquant_int8(he)
  ho8, ho_s = rowquant_int8(ho)
  lo, hi = _nibbles(w_packed)
  dot = lambda a8, w8: torch.einsum("rgi,gio->gro", a8.reshape(rows, G, gs_half).to(torch.float64),
                                    w8.to(torch.float64)).to(torch.float32)
  part = (dot(he8, lo) * he_s[None] + dot(ho8, hi) * ho_s[None]) * gscale.to(torch.float32)[:, None, :]
  return part.sum(dim=0).to(h.dtype)


def _launch(fn_name: str, h: torch.Tensor, w_packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
  """Launch `fn_name` on the operands, with the tile and splits of `gemv_plan`."""
  G, gs_half, d_out = w_packed.shape
  rows, d_in = h.shape
  if gs_half % 16 or d_out % 4:
    raise ValueError(f"{fn_name}: the kernel takes groups of a multiple of 32 values and "
                     f"out % 4 == 0, got gs={2 * gs_half} out={d_out}")
  check_operands(fn_name, h, w_packed, gscale, torch.uint8)
  out = torch.empty((rows, d_out), dtype=h.dtype, device=h.device)
  tile, splits = gemv_plan(rows, d_in, d_out, _sm_count(h.device.index))
  rc = getattr(_build.load("quant_matvec"), fn_name)(
    h.data_ptr(), w_packed.data_ptr(), gscale.data_ptr(), out.data_ptr(), rows, d_in, d_out,
    2 * gs_half, tile, splits, torch.cuda.current_stream(h.device).cuda_stream)
  _build.check(rc, f"{fn_name} (rows={rows} in={d_in} out={d_out} gs={2 * gs_half} "
                   f"tile={tile} splits={splits})")
  return out


def int4_w4a16_matmul(h: torch.Tensor, w_packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
  """K5: h [rows, in] @ dequant(w_packed [G, gs/2, out], gscale [G, out]), exact.
  CPU tensors take the plain version; CUDA tensors launch the kernel (bf16 h and
  gscale, rows <= 8, gs % 32 == 0, out % 4 == 0) or raise."""
  _check_shapes("int4_w4a16_matmul", h, w_packed, gscale)
  if h.device.type == "cpu":
    return int4_w4a16_matmul_ref(h, w_packed, gscale)
  if h.device.type != "cuda":
    raise ValueError(f"int4_w4a16_matmul runs on cuda or cpu tensors, got {h.device}")
  out = _launch("xot_w4a16_matvec_bf16", h, w_packed, gscale)
  int4_w4a16_matmul.launches += 1
  return out


int4_w4a16_matmul.launches = 0


def int4_w4a8_matmul(h: torch.Tensor, w_packed: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
  """K5v4: as int4_w4a16_matmul with h_even/h_odd row-quantized to int8 and int32
  dots per group (approximate). Same operands and rules."""
  _check_shapes("int4_w4a8_matmul", h, w_packed, gscale)
  if h.device.type == "cpu":
    return int4_w4a8_matmul_ref(h, w_packed, gscale)
  if h.device.type != "cuda":
    raise ValueError(f"int4_w4a8_matmul runs on cuda or cpu tensors, got {h.device}")
  out = _launch("xot_w4a8_matvec_bf16", h, w_packed, gscale)
  int4_w4a8_matmul.launches += 1
  return out


int4_w4a8_matmul.launches = 0


def int4_grouped_matmul(h: torch.Tensor, w_packed: torch.Tensor, gscale: torch.Tensor,
                        variant: int = 1) -> torch.Tensor:
  """h @ dequant(w) with the nibble unpack fused: [rows, out] in h's dtype.
  `variant` (XOT_INT4_V, read by models/transformer.quant_route): 4 takes K5v4,
  any other K5."""
  if variant == 4:
    return int4_w4a8_matmul(h, w_packed, gscale)
  return int4_w4a16_matmul(h, w_packed, gscale)
