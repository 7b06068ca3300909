"""K3 and K4 (and their int8 variants K3q and K4q): grouped-query attention over the
shared paged KV arena.

The port of xotorch_tpu/ops/paged_attention.py (`paged_decode_attention`, K3, and
`paged_prefill_attention`'s ragged path, K4). The paged pool
(inference/torch_engine/paged_cache.py) stores every resident request's cache as
fixed-size pages in ONE arena per layer; each batch row reaches its tokens through a
page table and is read only up to its own occupied pages, not the batch maximum.

The kernels are hand-written CUDA for Hopper (csrc/paged_attention.cu) and read each
layer's arena [P, page, Hkv, D] in place, at any page size (as JAX's pool: a page that
is a multiple of 64 is read one page a tile, any other one page id a row) and up to
64 q heads per kv head: K3 and K3q as split-K flash-decoding on the core of
csrc/decode_split.cuh (each row's table positions cut into ranges of whole 64-key
tiles by `flash_decode.split_plan`, from the table's width and the SM count, never
from the lengths, then merged by a second kernel; above 8 groups a kv head's row
blocks of 8 share each staged tile), K4 and K4q on the tensor-core tile core of
csrc/attention_mma.cuh, 64 query rows (positions x groups) a block. An int8 arena
carries scale pages [P, page, Hkv] (`k_scale_pages`/`v_scale_pages`), indexed by the
same page id and slot as the payload; K3q and K4q dequantize as they read. The plain PyTorch versions
sit beside them: gather each row's pages into a contiguous view (dequantized), then
the shared masked attention (`gqa_attention`), as the JAX package's XLA path does.
The wrappers take the plain version only for tensors on the CPU. Under a serving mesh
(JAX's `_tp_sharded_call`) the transformer calls K3/K4 once per tp position, on its
Hq/tp query heads over its own Hkv/tp arena heads with the one page table
(models/transformer._forward_mesh): the group size and the grid's shape stay, and no
traffic crosses positions inside the kernel. Not ported: the legacy gathered view
(`ragged=False`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from xotorch_tpu_torch.ops import _build
from xotorch_tpu_torch.ops.attention import gqa_attention
from xotorch_tpu_torch.ops.flash_decode import _plan, check_kv_quant, dequantize_kv

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUPS = 64  # K3, K4: q heads per kv head (K2's)
ROWS = 64  # K4: query rows (positions x groups) a block, 4 warps of 16
SPLIT_KEYS = 256  # K3: the most keys one decode split reads


def _gather(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
  """Each row's pages [B, maxp, page, ...] as one contiguous [B, maxp * page, ...] copy."""
  B, maxp = page_table.shape
  return pages[page_table.to(torch.int64)].reshape(B, maxp * pages.shape[1], *pages.shape[2:])


def gather_paged_view(k_pages: torch.Tensor, v_pages: torch.Tensor, page_table: torch.Tensor,
                      k_scale_pages: Optional[torch.Tensor] = None,
                      v_scale_pages: Optional[torch.Tensor] = None, dtype=None):
  """Each row's pages as a contiguous [B, maxp * page, Hkv, D] view (a copy). Padded
  table slots gather the scratch page; their positions are masked downstream. An int8
  arena is dequantized in `dtype` (as JAX's `_gather_paged_view` does)."""
  k, v = _gather(k_pages, page_table), _gather(v_pages, page_table)
  if k_scale_pages is not None:
    k, v = dequantize_kv(k, v, _gather(k_scale_pages, page_table),
                         _gather(v_scale_pages, page_table), dtype)
  return k, v


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, window: int = 0,
                               softcap: float = 0.0, scale: Optional[float] = None,
                               k_scale_pages=None, v_scale_pages=None):
  """Plain version of K3 and K3q: row b's query, at position lengths[b] - 1, attends
  positions [0, lengths[b]) of its pages (the last `window` of them when window > 0)."""
  k, v = gather_paged_view(k_pages, v_pages, page_table, k_scale_pages, v_scale_pages, q.dtype)
  lens = lengths.to(torch.int64)
  return gqa_attention(q, k, v, (lens - 1)[:, None], kv_valid_len=lens, scale=scale,
                       softcap=softcap, window=window)


def paged_prefill_attention_ref(q, k_pages, v_pages, page_table, kv_valid_len, window: int = 0,
                                softcap: float = 0.0, scale: Optional[float] = None,
                                k_scale_pages=None, v_scale_pages=None):
  """Plain version of K4 and K4q: query t of row b, at position kv_valid_len[b] - T + t,
  attends every occupied position at or before its own (above its own minus the
  window when window > 0)."""
  T = q.shape[1]
  k, v = gather_paged_view(k_pages, v_pages, page_table, k_scale_pages, v_scale_pages, q.dtype)
  lens = kv_valid_len.to(torch.int64)
  pos = (lens - T)[:, None] + torch.arange(T, device=q.device)[None, :]
  return gqa_attention(q, k, v, pos, kv_valid_len=lens, scale=scale, softcap=softcap,
                       window=window)


def _check(name: str, q, k_pages, v_pages, page_table, rows, k_scale_pages=None,
           v_scale_pages=None):
  """Shapes, types and devices a kernel takes; raises ValueError on anything else.
  With scale pages the arena is int8 and the scales bf16 [P, page, Hkv]."""
  B, T, Hq, D = q.shape
  P, page, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
  quant = k_scale_pages is not None
  if (k_pages.shape != (P, page, Hkv, D) or v_pages.shape != k_pages.shape or Hq % Hkv
      or page_table.ndim != 2 or page_table.shape[0] != B or rows.shape != (B,)
      or (quant and (k_scale_pages.shape != (P, page, Hkv)
                     or v_scale_pages.shape != k_scale_pages.shape))):
    raise ValueError(f"{name}: shapes q{tuple(q.shape)} pages{tuple(k_pages.shape)} "
                     f"v{tuple(v_pages.shape)} table{tuple(page_table.shape)} "
                     f"rows{tuple(rows.shape)}"
                     + (f" scale pages{tuple(k_scale_pages.shape)}" if quant else ""))
  arena = torch.int8 if quant else torch.bfloat16
  operands = [("q", q, torch.bfloat16), ("k_pages", k_pages, arena), ("v_pages", v_pages, arena)]
  if quant:
    operands += [("k_scale_pages", k_scale_pages, torch.bfloat16),
                 ("v_scale_pages", v_scale_pages, torch.bfloat16)]
  for what, t, dtype in operands:
    if t.dtype != dtype or t.device != q.device or not t.is_contiguous():
      raise ValueError(f"{name}: {what} must be contiguous {dtype} on {q.device}, "
                       f"got {t.dtype} on {t.device}")
  for what, t in (("page_table", page_table), ("lengths", rows)):
    if t.dtype != torch.int32 or t.device != q.device or not t.is_contiguous():
      raise ValueError(f"{name}: {what} must be contiguous int32 on {q.device}")
  if D not in HEAD_DIMS or page < 1:
    raise ValueError(f"{name}: built for head_dim {HEAD_DIMS} and pages of one or more "
                     f"positions, got head_dim {D}, page {page}")
  if Hq // Hkv > MAX_GROUPS:
    raise ValueError(f"{name}: {Hq // Hkv} q heads per kv head exceed {MAX_GROUPS}")
  return B, T, Hq, D, P, page, Hkv


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor, window: int = 0,
                           softcap: float = 0.0, scale: Optional[float] = None,
                           k_scale_pages: Optional[torch.Tensor] = None,
                           v_scale_pages: Optional[torch.Tensor] = None) -> torch.Tensor:
  """K3. q [B, 1, Hq, D] over one layer's arena k/v [P, page, Hkv, D] through
  page_table [B, maxp] int32; lengths [B] int32 counts each row's occupied positions
  including this step. Returns [B, 1, Hq, D] in q's dtype. An int8 arena passes its
  scale pages [P, page, Hkv] and launches K3q, counted on `paged_decode_attention_int8`.

  CPU tensors take the plain version. CUDA tensors launch the kernel (bf16 or int8
  with bf16 scale pages, contiguous, int32 table and lengths on the same card) or
  raise. The caller guarantees lengths[b] <= maxp * page."""
  quant = check_kv_quant("paged_decode_attention", k_pages, v_pages, k_scale_pages, v_scale_pages)
  if q.device.type == "cpu":
    return paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, window=window,
                                      softcap=softcap, scale=scale, k_scale_pages=k_scale_pages,
                                      v_scale_pages=v_scale_pages)
  name = "paged_decode_attention_int8" if quant else "paged_decode_attention"
  B, T, Hq, D, P, page, Hkv = _check(name, q, k_pages, v_pages, page_table, lengths,
                                     k_scale_pages, v_scale_pages)
  if q.device.type != "cuda":
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {q.device}")
  if T != 1:
    raise ValueError(f"{name}: one query per row, got T={T}")
  scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
  maxp = page_table.shape[1]
  splits, kps = _plan(B, Hkv, maxp * page, q.device.index or 0, SPLIT_KEYS)
  out = torch.empty_like(q)
  part = torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32, device=q.device)
  lib = _build.load("paged_attention")
  rest = (page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), part.data_ptr(), B, maxp,
          P, page, Hq, Hkv, D, splits, kps, int(window or 0), scale, float(softcap or 0.0),
          torch.cuda.current_stream(q.device).cuda_stream)
  if quant:
    rc = lib.xot_paged_decode_attention_kv8(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                                            k_scale_pages.data_ptr(), v_scale_pages.data_ptr(),
                                            *rest)
  else:
    rc = lib.xot_paged_decode_attention_bf16(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                                             *rest)
  _build.check(rc, f"{name} (B={B} maxp={maxp} P={P} page={page} Hq={Hq} Hkv={Hkv} D={D} "
                   f"splits={splits} x {kps} keys)")
  counted = paged_decode_attention_int8 if quant else paged_decode_attention
  counted.launches += 1
  if window:
    counted.windowed_launches += 1  # K3w: the same kernels with a window
  return out


paged_decode_attention.launches = 0
paged_decode_attention.windowed_launches = 0


def paged_decode_attention_int8(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                                k_scale_pages: torch.Tensor, v_scale_pages: torch.Tensor,
                                page_table: torch.Tensor, lengths: torch.Tensor, window: int = 0,
                                softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
  """K3q: `paged_decode_attention` over an int8 arena k/v [P, page, Hkv, D] with its
  bf16 scale pages [P, page, Hkv]. Its launches are counted here."""
  if not check_kv_quant("paged_decode_attention_int8", k_pages, v_pages, k_scale_pages,
                        v_scale_pages):
    raise ValueError("paged_decode_attention_int8 reads an int8 arena with its scale pages")
  return paged_decode_attention(q, k_pages, v_pages, page_table, lengths, window=window,
                                softcap=softcap, scale=scale, k_scale_pages=k_scale_pages,
                                v_scale_pages=v_scale_pages)


paged_decode_attention_int8.launches = 0
paged_decode_attention_int8.windowed_launches = 0


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                            page_table: torch.Tensor, kv_valid_len: torch.Tensor,
                            window: int = 0, softcap: float = 0.0,
                            scale: Optional[float] = None,
                            k_scale_pages: Optional[torch.Tensor] = None,
                            v_scale_pages: Optional[torch.Tensor] = None) -> torch.Tensor:
  """K4. q [B, T, Hq, D], a ragged segment per row whose query t sits at absolute
  position kv_valid_len[b] - T + t, over one layer's arena through page_table
  [B, maxp] int32 (the segment's K/V already written). Returns [B, T, Hq, D]. An int8
  arena passes its scale pages [P, page, Hkv] and launches K4q, counted on
  `paged_prefill_attention_int8`.

  CPU tensors take the plain version. CUDA tensors launch the kernel or raise. The
  caller guarantees T <= kv_valid_len[b] <= maxp * page."""
  quant = check_kv_quant("paged_prefill_attention", k_pages, v_pages, k_scale_pages,
                         v_scale_pages)
  if q.device.type == "cpu":
    return paged_prefill_attention_ref(q, k_pages, v_pages, page_table, kv_valid_len,
                                       window=window, softcap=softcap, scale=scale,
                                       k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
  name = "paged_prefill_attention_int8" if quant else "paged_prefill_attention"
  B, T, Hq, D, P, page, Hkv = _check(name, q, k_pages, v_pages, page_table, kv_valid_len,
                                     k_scale_pages, v_scale_pages)
  if q.device.type != "cuda":
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {q.device}")
  scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
  out = torch.empty_like(q)
  lib = _build.load("paged_attention")
  rest = (page_table.data_ptr(), kv_valid_len.data_ptr(), out.data_ptr(), B, T,
          page_table.shape[1], P, page, Hq, Hkv, D, ROWS, int(window or 0), scale,
          float(softcap or 0.0), torch.cuda.current_stream(q.device).cuda_stream)
  if quant:
    rc = lib.xot_paged_prefill_attention_kv8(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                                             k_scale_pages.data_ptr(), v_scale_pages.data_ptr(),
                                             *rest)
  else:
    rc = lib.xot_paged_prefill_attention_bf16(q.data_ptr(), k_pages.data_ptr(),
                                              v_pages.data_ptr(), *rest)
  _build.check(rc, f"{name} (B={B} T={T} maxp={page_table.shape[1]} P={P} page={page} "
                   f"Hq={Hq} Hkv={Hkv} D={D})")
  counted = paged_prefill_attention_int8 if quant else paged_prefill_attention
  counted.launches += 1
  if window:
    counted.windowed_launches += 1  # K4w: the same kernels with a window
  return out


paged_prefill_attention.launches = 0
paged_prefill_attention.windowed_launches = 0


def paged_prefill_attention_int8(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                                 k_scale_pages: torch.Tensor, v_scale_pages: torch.Tensor,
                                 page_table: torch.Tensor, kv_valid_len: torch.Tensor,
                                 window: int = 0, softcap: float = 0.0,
                                 scale: Optional[float] = None) -> torch.Tensor:
  """K4q: `paged_prefill_attention` over an int8 arena k/v [P, page, Hkv, D] with its
  bf16 scale pages [P, page, Hkv]. Its launches are counted here."""
  if not check_kv_quant("paged_prefill_attention_int8", k_pages, v_pages, k_scale_pages,
                        v_scale_pages):
    raise ValueError("paged_prefill_attention_int8 reads an int8 arena with its scale pages")
  return paged_prefill_attention(q, k_pages, v_pages, page_table, kv_valid_len, window=window,
                                 softcap=softcap, scale=scale, k_scale_pages=k_scale_pages,
                                 v_scale_pages=v_scale_pages)


paged_prefill_attention_int8.launches = 0
paged_prefill_attention_int8.windowed_launches = 0
