"""K6: the W8A8 decode GEMV over int8 weights, and the shared activation quantizer.

The port of xotorch_tpu/ops/int8_matmul.py. A decode-sized activation h [rows <= 8,
in] is row-quantized to int8 (`rowquant_int8`), multiplied by the int8 weight [in,
out] with int32 accumulation, and rescaled after the dot:

    out[r, o] = acc_i32[r, o] * a_scale[r] * w_scale[o]     (fp32, in that order)

then cast to h's dtype. Approximate by design: the activation rounds to 8 bits
(~1/255 relative per dot); the exact int8 path is transformer._linear's default.

The kernel is hand-written CUDA for Hopper (csrc/quant_matvec.cu,
`w8a8_cluster_kernel`): split-K over a thread-block cluster on the tensor cores. The
contraction of each column tile is cut into `gemv_plan` ranges, one block each; the
cluster's blocks agree on the activation's scale and quantize it in the same launch,
bit for bit as `rowquant_int8` does, and the cluster sums the ranges in rank order
through distributed shared memory, so a projection costs one launch. One decode row
over a short contraction takes the one-row kernel instead (`w8a8_kernel`: a block a 32
columns over the whole contraction, on the CUDA cores), which a decode step runs faster
there. K5 and K5v4 (ops/int4_matmul.py) run on the same plan. The plain PyTorch version sits
beside it and is exact too: the int32 sums are taken in float64, which holds them
without rounding. The wrapper takes it only for tensors on the CPU.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from xotorch_tpu_torch.ops import _build
from xotorch_tpu_torch.ops.flash_decode import _sm_count

MAX_ROWS = 8  # decode rows one launch takes (transformer._linear sends B*T <= 8)
GEMV_TILES = (128, 64, 32, 16)  # output columns a GEMV cluster block may own, widest first
GEMV_ROW_MAX_K = 4096  # one decode row over a contraction this short: the one-row kernel
GEMV_KSTEP = 32  # logical rows of a k-step: a split is whole k-steps (the last ends at K)
GEMV_MAX_SPLITS = 8  # blocks of a cluster: the portable cluster size
GEMV_BLOCKS_PER_SM = 2  # blocks a plan aims at for each SM


@functools.lru_cache(maxsize=None)
def gemv_plan(rows: int, K: int, N: int, sm_count: int) -> Tuple[int, int]:
  """(tile, splits) of a K5, K5v4 or K6 launch on a card with `sm_count` SMs. One row over
  K <= GEMV_ROW_MAX_K: (0, 1), the one-row kernel (a block a 32 columns over the whole
  contraction, on the CUDA cores), which a decode step runs faster there than the
  cluster kernels with their fixed barriers (PERF.md, Findings on K5 and K6). Otherwise the cluster
  kernels: the widest column tile (wide rows read whole cache lines) whose ceil(N /
  tile) tiles, each cut into enough splits of the contraction to aim at
  GEMV_BLOCKS_PER_SM blocks an SM, give at least one block an SM; splits at most
  GEMV_MAX_SPLITS (one cluster) and one a k-step. From static shapes only: the host
  never reads a device tensor."""
  if rows == 1 and K <= GEMV_ROW_MAX_K:
    return 0, 1
  steps = -(-K // GEMV_KSTEP)
  for tile in GEMV_TILES:
    tiles = -(-N // tile)
    splits = max(1, min(GEMV_MAX_SPLITS, steps, -(-GEMV_BLOCKS_PER_SM * sm_count // tiles)))
    if tiles * splits >= sm_count:
      break
  return tile, splits


def split_ranges(K: int, splits: int) -> List[Tuple[int, int]]:
  """The ranges [k0, k1) of the contraction that the kernels' blocks take, in rank
  order: split i starts at k-step i * steps // splits, so no range is empty."""
  steps = -(-K // GEMV_KSTEP)
  edges = [i * steps // splits * GEMV_KSTEP for i in range(splits)] + [K]
  return [(edges[i], min(K, edges[i + 1])) for i in range(splits)]


def rowquant_int8(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-row int8 quantization: (int8 values, [rows, 1] fp32 scales).
  s = max|a| / 127 (1 where the row is all zero), q = round(a / s), half to even:
  the one recipe K5v4 and K6 share, as in the JAX package."""
  a = a.to(torch.float32)
  s = torch.amax(torch.abs(a), dim=1, keepdim=True) / 127.0
  s = torch.where(s == 0.0, torch.ones_like(s), s)
  return torch.round(a / s).to(torch.int8), s


def int8_rowquant_matmul_ref(h: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
  """Plain version: rowquant_int8, the integer product (exact in float64), then
  the two scales in fp32."""
  h8, a_scale = rowquant_int8(h)
  acc = (h8.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)
  return (acc * a_scale * w_scale.to(torch.float32)[None, :]).to(h.dtype)


def check_operands(name: str, h: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   w_dtype: torch.dtype) -> None:
  """What the quantized GEMV kernels take: bf16 h [rows <= 8, in] and scales, the
  weight in its stored dtype, all contiguous on one card, 4-byte aligned."""
  if not 1 <= h.shape[0] <= MAX_ROWS:
    raise ValueError(f"{name}: {h.shape[0]} rows; the kernel takes 1..{MAX_ROWS} (decode)")
  for what, t, dtype in (("h", h, torch.bfloat16), ("w", w, w_dtype), ("scale", scale, torch.bfloat16)):
    if t.dtype != dtype or t.device != h.device or not t.is_contiguous():
      raise ValueError(f"{name}: {what} must be contiguous {dtype} on {h.device}, "
                       f"got {t.dtype} on {t.device}")
    if t.data_ptr() % 4:
      raise ValueError(f"{name}: {what} is not 4-byte aligned")


def int8_rowquant_matmul(h: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
  """h [rows, in] @ (w [in, out] int8 * w_scale [out]) with h row-quantized to int8.
  Returns [rows, out] in h's dtype.

  CPU tensors take the plain version. CUDA tensors launch K6 (bf16 h and scale,
  rows <= 8, in % 4 == 0, out % 4 == 0) or raise."""
  if h.device.type == "cpu":
    return int8_rowquant_matmul_ref(h, w, w_scale)
  if h.device.type != "cuda":
    raise ValueError(f"int8_rowquant_matmul runs on cuda or cpu tensors, got {h.device}")
  rows, d_in = h.shape
  d_out = w.shape[1]
  if w.shape != (d_in, d_out) or w_scale.shape != (d_out,) or d_in % 4 or d_out % 4:
    raise ValueError(f"int8_rowquant_matmul: shapes h{tuple(h.shape)} w{tuple(w.shape)} "
                     f"w_scale{tuple(w_scale.shape)}")
  check_operands("int8_rowquant_matmul", h, w, w_scale, torch.int8)
  out = torch.empty((rows, d_out), dtype=h.dtype, device=h.device)
  tile, splits = gemv_plan(rows, d_in, d_out, _sm_count(h.device.index))
  lib = _build.load("quant_matvec")
  rc = lib.xot_w8a8_matvec_bf16(h.data_ptr(), w.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
                                rows, d_in, d_out, tile, splits,
                                torch.cuda.current_stream(h.device).cuda_stream)
  _build.check(rc, f"int8_rowquant_matmul (rows={rows} in={d_in} out={d_out} tile={tile} "
                   f"splits={splits})")
  int8_rowquant_matmul.launches += 1
  return out


int8_rowquant_matmul.launches = 0
