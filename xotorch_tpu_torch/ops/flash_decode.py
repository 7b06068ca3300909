"""K2: cached grouped-query attention of queries at an offset over the resident KV
cache — decode steps (T == 1) and chunked-prefill segments at q_start > 0.

The port of xotorch_tpu/ops/flash_decode.py (`_cached_kernel` and
`_cached_kernel_windowed`; the int8-cache variant waits for the KV-quant slice). The
kernel is hand-written CUDA for Hopper (csrc/flash_decode.cu): it reads the cache only
up to each row's last visible position, so decode cost follows occupancy. The plain
PyTorch version `flash_cached_attention_ref` sits beside it, built on `gqa_attention`;
the wrapper takes it only for tensors on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from xotorch_tpu_torch.ops import _build
from xotorch_tpu_torch.ops.attention import gqa_attention
from xotorch_tpu_torch.utils import knobs

# Rows (positions x groups) one CUDA block holds: the q tile lives in shared memory.
MAX_ROWS = 64


def flash_cached_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                               q_start: torch.Tensor, window: int = 0, softcap: float = 0.0,
                               scale: Optional[float] = None) -> torch.Tensor:
  """Plain version: query t of row b attends cache positions
  [max(0, q_start[b] + t - window + 1), q_start[b] + t]."""
  T = q.shape[1]
  pos = q_start.to(torch.int64)[:, None] + torch.arange(T, device=q.device)[None, :]
  return gqa_attention(q, k_cache, v_cache, pos, None, scale=scale, softcap=softcap,
                       window=window)


def flash_cached_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           q_start: torch.Tensor, window: int = 0, softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
  """q [B, T, Hq, D] at absolute positions q_start[b] + [0, T) over the cache
  k/v [B, S, Hkv, D] (the segment already written); q_start [B] int32.
  Returns [B, T, Hq, D] in q's dtype.

  CPU tensors take the plain version. CUDA tensors launch the kernel (bf16,
  contiguous, q_start int32 on the same card) or raise. The caller guarantees
  q_start[b] + T <= S."""
  if q.device.type == "cpu":
    return flash_cached_attention_ref(q, k_cache, v_cache, q_start, window=window,
                                      softcap=softcap, scale=scale)
  if q.device.type != "cuda":
    raise ValueError(f"flash_cached_attention runs on cuda or cpu tensors, got {q.device}")
  B, T, Hq, D = q.shape
  S, Hkv = k_cache.shape[1], k_cache.shape[2]
  if (k_cache.shape != (B, S, Hkv, D) or v_cache.shape != k_cache.shape or Hq % Hkv
      or q_start.shape != (B,)):
    raise ValueError(f"flash_cached_attention: shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} "
                     f"v{tuple(v_cache.shape)} q_start{tuple(q_start.shape)}")
  for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
    if t.dtype != torch.bfloat16 or t.device != q.device or not t.is_contiguous():
      raise ValueError(f"flash_cached_attention: {name} must be contiguous bf16 on {q.device}, "
                       f"got {t.dtype} on {t.device}")
  if q_start.dtype != torch.int32 or q_start.device != q.device:
    raise ValueError(f"flash_cached_attention: q_start must be int32 on {q.device}")
  groups = Hq // Hkv
  if groups > MAX_ROWS:
    raise ValueError(f"flash_cached_attention: {groups} q heads per kv head exceed {MAX_ROWS}")
  # Positions per block: the knob, capped by T and by the block's row budget.
  block_q = max(1, min(knobs.get_int("XOT_FD_BLOCK_Q"), T, MAX_ROWS // groups))
  block_k = knobs.get_int("XOT_FD_BLOCK_K")
  scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
  out = torch.empty_like(q)
  lib = _build.load("flash_decode")
  rc = lib.xot_flash_cached_attention_bf16(
    q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), q_start.data_ptr(), out.data_ptr(),
    B, T, S, Hq, Hkv, D, block_q, block_k, int(window or 0), scale, float(softcap or 0.0),
    torch.cuda.current_stream(q.device).cuda_stream)
  _build.check(rc, f"flash_cached_attention (B={B} T={T} S={S} Hq={Hq} D={D} "
                   f"block_q={block_q} block_k={block_k})")
  flash_cached_attention.launches += 1
  return out


flash_cached_attention.launches = 0


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           kv_valid: torch.Tensor, window: int = 0, softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
  """Single-token decode attention (T == 1): kv_valid [B] is the occupied prefix
  length including this step."""
  return flash_cached_attention(q, k_cache, v_cache, (kv_valid - 1).to(torch.int32),
                                window=window, softcap=softcap, scale=scale)
