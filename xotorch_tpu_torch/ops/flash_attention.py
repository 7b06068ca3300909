"""K1: causal grouped-query flash attention for a prefill that starts at position 0.

The port of xotorch_tpu/ops/flash_attention.py (`_flash_kernel` and
`_flash_kernel_windowed`). The kernel is hand-written CUDA for Hopper
(csrc/flash_attention.cu, on the tensor-core tile core of csrc/attention_mma.cuh);
window, softcap and scale are runtime arguments, so one kernel serves global and
sliding-window layers. `XOT_FLASH_BLOCK_Q` is the query rows a block holds (positions x
query heads of one kv head) and `XOT_FLASH_BLOCK_K` the keys a shared-memory tile
holds, each 64 or 128; at head_dim 256 the kernel is built for one tile shape, 64 rows
by 64 keys (`WIDE_BLOCKS`), which it takes whatever the knobs say. `flash_attention_ref` beside it is the plain PyTorch version,
built on `gqa_attention`: the wrapper takes it only for tensors on the CPU.

K1b (csrc/flash_attention_bwd.cu) is K1's gradient: dQ, dK and dV of the same function
(window, softcap and scale included), for head_dim 16-128 (`BWD_HEAD_DIMS`). The JAX
package has no kernel there (XLA differentiates `gqa_attention` when it trains). Its
plain version, `flash_attention_bwd_ref`, is autograd through `flash_attention_ref`.
`flash_attention_train` is the training forward's attention: a `torch.autograd.Function`
whose forward is K1 (`flash_attention`, counted there) and whose backward is K1b.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from xotorch_tpu_torch.ops import _build
from xotorch_tpu_torch.ops.attention import gqa_attention
from xotorch_tpu_torch.utils import knobs

HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = (16, 32, 64, 128)  # K1b's builds
BLOCKS = (64, 128)  # XOT_FLASH_BLOCK_Q (query rows a block) and XOT_FLASH_BLOCK_K (keys a tile)
WIDE_BLOCKS = (64, 64)  # (query rows, keys) of the one head_dim 256 build


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0,
                        softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
  """Plain version: query t attends keys [max(0, t - window + 1), t] of the segment."""
  B, T = q.shape[0], q.shape[1]
  pos = torch.arange(T, device=q.device)[None, :].expand(B, T)
  return gqa_attention(q, k, v, pos, torch.full((B,), T, device=q.device),
                       scale=scale, softcap=softcap, window=window)


def flash_blocks():
  """(XOT_FLASH_BLOCK_Q, XOT_FLASH_BLOCK_K), each 64 or 128; anything else raises
  ValueError naming both knobs. The engine calls this when it is built."""
  block_q = knobs.get_int("XOT_FLASH_BLOCK_Q")
  block_k = knobs.get_int("XOT_FLASH_BLOCK_K")
  if block_q not in BLOCKS or block_k not in BLOCKS:
    raise ValueError(f"flash_attention: XOT_FLASH_BLOCK_Q={block_q} and XOT_FLASH_BLOCK_K="
                     f"{block_k}: the kernel takes {BLOCKS} query rows a block and keys a tile")
  return block_q, block_k


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
  """Causal GQA attention of one segment over its own K/V, in the JAX layout:
  q [B, T, Hq, D], k/v [B, T, Hkv, D] -> [B, T, Hq, D] in q's dtype.

  CPU tensors take the plain version. CUDA tensors launch the kernel (bf16,
  contiguous) or raise."""
  if q.device.type == "cpu":
    return flash_attention_ref(q, k, v, window=window, softcap=softcap, scale=scale)
  B, T, Hq, D = q.shape
  if k.shape != (B, T, k.shape[2], D) or v.shape != k.shape or Hq % k.shape[2]:
    raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
  for name, t in (("q", q), ("k", k), ("v", v)):
    if t.dtype != torch.bfloat16 or t.device != q.device or not t.is_contiguous():
      raise ValueError(f"flash_attention: {name} must be contiguous bf16 on {q.device}, "
                       f"got {t.dtype} on {t.device}")
  if D not in HEAD_DIMS:
    raise ValueError(f"flash_attention: built for head_dim {HEAD_DIMS}, got {D}")
  block_q, block_k = flash_blocks() if D <= 128 else WIDE_BLOCKS
  if q.device.type != "cuda":
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
  scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
  out = torch.empty_like(q)
  lib = _build.load("flash_attention")
  rc = lib.xot_flash_attention_bf16(
    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, Hq, k.shape[2], D,
    block_q, block_k, int(window or 0), scale, float(softcap or 0.0),
    torch.cuda.current_stream(q.device).cuda_stream)
  _build.check(rc, f"flash_attention (B={B} T={T} Hq={Hq} D={D} block_q={block_q} block_k={block_k})")
  flash_attention.launches += 1
  if window:
    flash_attention.windowed_launches += 1  # K1w: the same kernel with a window
  return out


flash_attention.launches = 0
flash_attention.windowed_launches = 0


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
                            window: int = 0, softcap: float = 0.0,
                            scale: Optional[float] = None):
  """Plain version of K1b: (dq, dk, dv) by autograd through `flash_attention_ref`, in
  the inputs' dtype (the card's reference passes fp32 copies)."""
  with torch.enable_grad():
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = flash_attention_ref(qq, kk, vv, window=window, softcap=softcap, scale=scale)
    return torch.autograd.grad(out, (qq, kk, vv), dout)


def check_bwd_head_dim(head_dim: int, what: str = "flash_attention_bwd") -> None:
  """Raise ValueError for a head width K1b is not built for."""
  if head_dim not in BWD_HEAD_DIMS:
    raise ValueError(f"{what}: the attention gradient kernel K1b is built for head_dim "
                     f"{BWD_HEAD_DIMS}, got {head_dim}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, window: int = 0, softcap: float = 0.0,
                        scale: Optional[float] = None):
  """The gradient of `flash_attention(q, k, v, window, softcap, scale)` given its output
  `out` and the output's gradient `dout` [B, T, Hq, D]: (dq, dk, dv) in the JAX layout,
  dk/dv summed over each kv head's query group.

  CPU tensors take the plain version. CUDA tensors launch K1b (bf16, contiguous) or
  raise."""
  if q.device.type == "cpu":
    return flash_attention_bwd_ref(q, k, v, dout, window=window, softcap=softcap, scale=scale)
  B, T, Hq, D = q.shape
  Hkv = k.shape[2]
  if (k.shape != (B, T, Hkv, D) or v.shape != k.shape or out.shape != q.shape
      or dout.shape != q.shape or Hq % Hkv):
    raise ValueError(f"flash_attention_bwd: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                     f"v{tuple(v.shape)} out{tuple(out.shape)} dout{tuple(dout.shape)}")
  for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
    if t.dtype != torch.bfloat16 or t.device != q.device or not t.is_contiguous():
      raise ValueError(f"flash_attention_bwd: {name} must be contiguous bf16 on {q.device}, "
                       f"got {t.dtype} on {t.device}")
  check_bwd_head_dim(D)
  if q.device.type != "cuda":
    raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, got {q.device}")
  scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
  dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
  lse = torch.empty((B, T, Hq), dtype=torch.float32, device=q.device)
  delta = torch.empty_like(lse)
  lib = _build.load("flash_attention_bwd")
  rc = lib.xot_flash_attention_bwd_bf16(
    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
    dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, T, Hq, Hkv, D,
    int(window or 0), scale, float(softcap or 0.0),
    torch.cuda.current_stream(q.device).cuda_stream)
  _build.check(rc, f"flash_attention_bwd (B={B} T={T} Hq={Hq} Hkv={Hkv} D={D})")
  flash_attention_bwd.launches += 1
  return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
  """K1 forward, K1b backward; q, k and v are saved with the output for the backward
  (no [B, Hq, T, T] score tensor is kept)."""

  @staticmethod
  def forward(ctx, q, k, v, window, softcap, scale):
    out = flash_attention(q, k, v, window=window, softcap=softcap, scale=scale)
    ctx.save_for_backward(q, k, v, out)
    ctx.adj = (window, softcap, scale)
    return out

  @staticmethod
  def backward(ctx, dout):
    q, k, v, out = ctx.saved_tensors
    window, softcap, scale = ctx.adj
    dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), window=window,
                                     softcap=softcap, scale=scale)
    return dq, dk, dv, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0,
                          softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
  """`flash_attention` that autograd differentiates through K1b (its plain version on
  the CPU): the attention of the training and evaluation forwards."""
  return _FlashAttention.apply(q, k, v, window, softcap, scale)
