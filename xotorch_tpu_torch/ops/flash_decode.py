"""K2 and K2q: cached grouped-query attention of queries at an offset over the
resident KV cache — decode steps (T == 1) and chunked-prefill segments at q_start > 0.

The port of xotorch_tpu/ops/flash_decode.py (`_cached_kernel` and
`_cached_kernel_windowed`, with and without `quant`). The kernels are hand-written
CUDA for Hopper (csrc/flash_decode.cu). A decode step is split-K flash-decoding
(csrc/decode_split.cuh): each row's cache positions are cut into ranges of whole
64-key tiles (`split_plan`, from the static shapes and the card's SM count, so the
host never reads a position), one CUDA block a range, and a second kernel merges the
ranges; ranges past a row's position read nothing, so decode cost follows occupancy.
A segment (T > 1) runs on the tensor-core tile core of csrc/attention_mma.cuh, as K1
does. K2 reads a bf16 cache; K2q (`flash_cached_attention_int8`) reads an int8 cache
with one scale per (position, head) and dequantizes each tile as it stages it, exactly
as JAX's `_load_kv` does. The plain PyTorch version `flash_cached_attention_ref` sits
beside them, built on `gqa_attention`; the wrappers take it only for tensors on the
CPU.

Knobs: `XOT_FD_BLOCK_Q` is the query rows a segment block holds (positions x query
heads of one kv head), 64 or 128 (at head_dim 256 the one build takes 64,
`WIDE_BLOCK_Q`, whatever it says); `XOT_FD_BLOCK_K` is the most keys one decode split
reads, a multiple of 64. `decode_blocks` reads and checks both.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from xotorch_tpu_torch.ops import _build
from xotorch_tpu_torch.ops.attention import gqa_attention
from xotorch_tpu_torch.utils import knobs

MAX_GROUPS = 64  # q heads per kv head
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernels' instantiations
ROW_BLOCKS = (64, 128)  # XOT_FD_BLOCK_Q: a segment block's query rows
WIDE_BLOCK_Q = 64  # a segment block's query rows at head_dim 256
SPLIT_TILE = 64  # keys a staged tile of the decode kernels; a split is whole tiles
SPLIT_BLOCKS_PER_SM = 4  # decode blocks a split plan aims at for each SM


def split_plan(B: int, Hkv: int, S: int, sm_count: int, max_keys: int = 256) -> Tuple[int, int]:
  """(splits, keys a split) of a split-K decode launch over cache positions [0, S):
  ranges of whole 64-key tiles, the fewest keys a range for which the B x Hkv x splits
  blocks stay within SPLIT_BLOCKS_PER_SM blocks an SM (one tile a range when even that
  does not reach it), and at most `max_keys` (a multiple of 64). From static shapes
  only: the host never needs a position. The last range reaches S; none lies wholly
  past it."""
  tiles = -(-S // SPLIT_TILE)
  want = -(-SPLIT_BLOCKS_PER_SM * sm_count // (B * Hkv))  # splits for the blocks aimed at
  per = max(1, min(-(-tiles // want), max_keys // SPLIT_TILE))  # tiles a split
  return -(-tiles // per), per * SPLIT_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan(B: int, Hkv: int, S: int, device: int, max_keys: int) -> Tuple[int, int]:
  return split_plan(B, Hkv, S, _sm_count(device), max_keys)


def decode_blocks() -> Tuple[int, int]:
  """(XOT_FD_BLOCK_Q, XOT_FD_BLOCK_K): a segment block's query rows (64 or 128) and the
  most keys a decode split reads (a positive multiple of 64). Anything else raises
  ValueError naming the knob; the engine calls this when it is built."""
  block_q, block_k = knobs.get_int("XOT_FD_BLOCK_Q"), knobs.get_int("XOT_FD_BLOCK_K")
  if block_q not in ROW_BLOCKS:
    raise ValueError(f"XOT_FD_BLOCK_Q={block_q}: K2/K2q take {ROW_BLOCKS} query rows a block")
  if block_k < SPLIT_TILE or block_k % SPLIT_TILE:
    raise ValueError(f"XOT_FD_BLOCK_K={block_k}: K2/K2q's decode splits are whole "
                     f"{SPLIT_TILE}-key tiles (a positive multiple of {SPLIT_TILE})")
  return block_q, block_k


def dequantize_kv(k: torch.Tensor, v: torch.Tensor, k_scale: torch.Tensor, v_scale: torch.Tensor,
                  dtype) -> Tuple[torch.Tensor, torch.Tensor]:
  """int8 K/V [..., Hkv, D] with scales [..., Hkv] -> K/V in `dtype`: code times scale,
  both cast to `dtype` first, as the JAX package's `_cache_read` and `_load_kv` do."""
  return (k.to(dtype) * k_scale.to(dtype)[..., None], v.to(dtype) * v_scale.to(dtype)[..., None])


def flash_cached_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                               q_start: torch.Tensor, window: int = 0, softcap: float = 0.0,
                               scale: Optional[float] = None, k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Plain version: query t of row b attends cache positions
  [max(0, q_start[b] + t - window + 1), q_start[b] + t]. An int8 cache (with
  `k_scale`/`v_scale`) is dequantized in q's dtype first."""
  if k_scale is not None:
    k_cache, v_cache = dequantize_kv(k_cache, v_cache, k_scale, v_scale, q.dtype)
  T = q.shape[1]
  pos = q_start.to(torch.int64)[:, None] + torch.arange(T, device=q.device)[None, :]
  return gqa_attention(q, k_cache, v_cache, pos, None, scale=scale, softcap=softcap,
                       window=window)


def check_kv_quant(name: str, k: torch.Tensor, v: torch.Tensor, k_scale, v_scale) -> bool:
  """Whether a call reads an int8 cache. Int8 K/V come with both scales, and scales
  only with int8 K/V; anything else raises ValueError."""
  int8 = (k.dtype == torch.int8, v.dtype == torch.int8)
  scales = (k_scale is not None, v_scale is not None)
  if int8 == (True, True) and scales == (True, True):
    return True
  if int8 == (False, False) and scales == (False, False):
    return False
  raise ValueError(f"{name}: an int8 cache goes with both scales and scales with an int8 cache; "
                   f"got k {k.dtype}, v {v.dtype}, k_scale {'given' if scales[0] else 'None'}, "
                   f"v_scale {'given' if scales[1] else 'None'}")


def flash_cached_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           q_start: torch.Tensor, window: int = 0, softcap: float = 0.0,
                           scale: Optional[float] = None, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """K2. q [B, T, Hq, D] at absolute positions q_start[b] + [0, T) over the cache
  k/v [B, S, Hkv, D] (the segment already written); q_start [B] int32.
  Returns [B, T, Hq, D] in q's dtype. An int8 cache passes its raw buffers with
  `k_scale`/`v_scale` [B, S, Hkv] and launches K2q, counted on
  `flash_cached_attention_int8`.

  CPU tensors take the plain version. CUDA tensors launch the kernel (q bf16, K/V
  bf16 or int8 with bf16 scales, all contiguous on one card, q_start int32) or raise
  ValueError. The caller guarantees q_start[b] + T <= S."""
  quant = check_kv_quant("flash_cached_attention", k_cache, v_cache, k_scale, v_scale)
  if q.device.type == "cpu":
    return flash_cached_attention_ref(q, k_cache, v_cache, q_start, window=window,
                                      softcap=softcap, scale=scale, k_scale=k_scale,
                                      v_scale=v_scale)
  name = "flash_cached_attention_int8" if quant else "flash_cached_attention"
  B, T, Hq, D = q.shape
  S, Hkv = k_cache.shape[1], k_cache.shape[2]
  if (k_cache.shape != (B, S, Hkv, D) or v_cache.shape != k_cache.shape or Hq % Hkv
      or q_start.shape != (B,)
      or (quant and (k_scale.shape != (B, S, Hkv) or v_scale.shape != k_scale.shape))):
    raise ValueError(f"{name}: shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} "
                     f"v{tuple(v_cache.shape)} q_start{tuple(q_start.shape)}"
                     + (f" k_scale{tuple(k_scale.shape)} v_scale{tuple(v_scale.shape)}"
                        if quant else ""))
  kv = torch.int8 if quant else torch.bfloat16
  operands = [("q", q, torch.bfloat16), ("k_cache", k_cache, kv), ("v_cache", v_cache, kv),
              ("q_start", q_start, torch.int32)]
  if quant:
    operands += [("k_scale", k_scale, torch.bfloat16), ("v_scale", v_scale, torch.bfloat16)]
  for what, t, dtype in operands:
    if t.dtype != dtype or t.device != q.device or not t.is_contiguous():
      raise ValueError(f"{name}: {what} must be contiguous {dtype} on {q.device}, "
                       f"got {t.dtype} on {t.device}")
  if Hq // Hkv > MAX_GROUPS:
    raise ValueError(f"{name}: {Hq // Hkv} q heads per kv head exceed {MAX_GROUPS}")
  if D not in HEAD_DIMS:
    raise ValueError(f"{name}: built for head_dim {HEAD_DIMS}, got {D}")
  block_q, block_k = decode_blocks()
  if D > 128:
    block_q = WIDE_BLOCK_Q
  if q.device.type != "cuda":
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {q.device}")
  scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
  out = torch.empty_like(q)
  part, splits, kps = None, 0, 0
  if T == 1:  # the splits' fp32 partials: acc [B * Hq * splits, D], then (m, l)
    splits, kps = _plan(B, Hkv, S, q.device.index or 0, block_k)
    part = torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32, device=q.device)
  lib = _build.load("flash_decode")
  rest = (q_start.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(), B, T, S,
          Hq, Hkv, D, block_q, splits, kps, int(window or 0), scale, float(softcap or 0.0),
          torch.cuda.current_stream(q.device).cuda_stream)
  if quant:
    rc = lib.xot_flash_cached_attention_kv8(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                            k_scale.data_ptr(), v_scale.data_ptr(), *rest)
  else:
    rc = lib.xot_flash_cached_attention_bf16(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                             *rest)
  _build.check(rc, f"{name} (B={B} T={T} S={S} Hq={Hq} Hkv={Hkv} D={D} block_q={block_q} "
                   f"splits={splits} x {kps} keys)")
  counted = flash_cached_attention_int8 if quant else flash_cached_attention
  counted.launches += 1
  if window:
    counted.windowed_launches += 1  # K2w / K2qw: the same kernels with a window
  return out


flash_cached_attention.launches = 0
flash_cached_attention.windowed_launches = 0


def flash_cached_attention_int8(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                                k_scale: torch.Tensor, v_scale: torch.Tensor, q_start: torch.Tensor,
                                window: int = 0, softcap: float = 0.0,
                                scale: Optional[float] = None) -> torch.Tensor:
  """K2q: `flash_cached_attention` over an int8 cache k/v [B, S, Hkv, D] with one
  scale per (position, head), k_scale/v_scale [B, S, Hkv]. The kernel dequantizes
  each staged tile to bf16 (code x scale, rounded once) and then runs K2's
  arithmetic, so the cache streams as int8 bytes. Its launches are counted here."""
  if not check_kv_quant("flash_cached_attention_int8", k_cache, v_cache, k_scale, v_scale):
    raise ValueError("flash_cached_attention_int8 reads an int8 cache with its scales")
  return flash_cached_attention(q, k_cache, v_cache, q_start, window=window, softcap=softcap,
                                scale=scale, k_scale=k_scale, v_scale=v_scale)


flash_cached_attention_int8.launches = 0
flash_cached_attention_int8.windowed_launches = 0


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           kv_valid: torch.Tensor, window: int = 0, softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
  """Single-token decode attention (T == 1): kv_valid [B] is the occupied prefix
  length including this step."""
  return flash_cached_attention(q, k_cache, v_cache, (kv_valid - 1).to(torch.int32),
                                window=window, softcap=softcap, scale=scale)
