"""Paged KV-cache pool: one fixed arena per shard context, per-request page tables
(XOT_PAGED_KV=1).

The port of xotorch_tpu/inference/jax_engine/paged_cache.py without the host tier
(`scatter_pages`). Arena leaves are [L, num_pages, page_size, Hkv, D] torch tensors on
the engine's device; an int8 arena (`kv_quant`) pairs int8 K/V pages with scale pages
`k_scale`/`v_scale` [L, num_pages, page_size, Hkv] from the same allocator, so one page
id indexes payload and scales alike and every copy below carries all four. Page 0 is a
reserved SCRATCH page, never allocated: page tables are padded with 0 (reads are
masked by each row's length) and a batched dispatch's pad rows write their garbage
there (their table is all zeros).

Allocation metadata (free list, refcounts) is host-side numpy: page churn follows
the request rate, not the token rate. Where JAX donated the arena to each program
and got a new one back, the port updates the one arena IN PLACE.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from xotorch_tpu_torch.inference.engine import CacheExhausted


class PagePool:
  """Fixed-size K/V page arena + free-list allocator with refcounts.

  One pool per shard context. All mutation happens on the engine's single-worker
  executor thread, so no locking is needed."""

  def __init__(self, cfg, num_layers: int, num_pages: int, page_size: int,
               dtype=torch.bfloat16, device="cpu", kv_quant: bool = False):
    if num_pages < 2:
      raise ValueError(f"page pool needs >= 2 pages (1 scratch + 1 usable), got {num_pages}")
    shape = (num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if kv_quant else dtype
    self.arena: Dict[str, torch.Tensor] = {
      "k": torch.zeros(shape, dtype=kv_dtype, device=device),
      "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
    if kv_quant:
      self.arena["k_scale"] = torch.zeros(shape[:-1], dtype=dtype, device=device)
      self.arena["v_scale"] = torch.zeros(shape[:-1], dtype=dtype, device=device)
    self.page_size = int(page_size)
    self.num_pages = int(num_pages)
    # Page 0 is permanently "allocated" (ref 1) so it can never be handed out.
    self._ref = np.zeros(num_pages, np.int32)
    self._ref[0] = 1
    # Pop from the END yields ascending ids.
    self._free: List[int] = list(range(num_pages - 1, 0, -1))
    # High-water mark of concurrently referenced pages: the pool-sizing signal.
    self.peak_pages_in_use = 0

  @property
  def free_pages(self) -> int:
    return len(self._free)

  @property
  def pages_in_use(self) -> int:
    return self.num_pages - 1 - len(self._free)  # scratch page excluded

  def pages_for(self, tokens: int) -> int:
    """Pages needed to hold `tokens` cache slots."""
    return -(-int(tokens) // self.page_size)

  def refcount(self, page_id: int) -> int:
    return int(self._ref[page_id])

  def alloc(self, n: int) -> List[int]:
    """Allocate `n` pages (ref 1 each). Raises CacheExhausted when the pool cannot
    satisfy the request."""
    if n <= 0:
      return []
    if n > len(self._free):
      raise CacheExhausted(
        f"KV page pool exhausted: need {n} pages, {len(self._free)} free "
        f"of {self.num_pages - 1} (page_size={self.page_size})")
    ids = [self._free.pop() for _ in range(n)]
    for p in ids:
      self._ref[p] = 1
    if self.pages_in_use > self.peak_pages_in_use:
      self.peak_pages_in_use = self.pages_in_use
    return ids

  def incref(self, page_ids) -> None:
    for p in page_ids:
      if self._ref[p] <= 0:
        raise AssertionError(f"incref of free page {p}")
      self._ref[p] += 1

  def decref(self, page_ids) -> None:
    """Drop one reference per page; pages reaching zero return to the free list.
    Their contents are not zeroed: a freshly allocated page is overwritten before its
    positions become visible (reads are masked by each row's length)."""
    for p in page_ids:
      if p == 0:
        raise AssertionError("decref of the reserved scratch page")
      if self._ref[p] <= 0:
        raise AssertionError(f"decref of free page {p}")
      self._ref[p] -= 1
      if self._ref[p] == 0:
        self._free.append(int(p))

  def fragmentation(self) -> int:
    """Free pages stranded BELOW the highest used page id: the holes a compaction
    pass could close. 0 means the used set is a dense prefix."""
    used = np.nonzero(self._ref[1:] > 0)[0]
    if used.size == 0:
      return 0
    hi = int(used[-1]) + 1  # highest used id (offset for the scratch slice)
    return sum(1 for p in self._free if p < hi)

  def defrag_plan(self, max_moves: int) -> List[tuple]:
    """(src, dst) migration pairs that compact the used set downward: the highest
    used pages move into the lowest free holes, stopping when the sets cross (or at
    max_moves). Pure bookkeeping: the device copy and the virtual-map rewrite are the
    engine's job."""
    if max_moves <= 0 or not self._free:
      return []
    used = sorted((int(p) for p in np.nonzero(self._ref[1:] > 0)[0] + 1), reverse=True)
    holes = sorted(self._free)
    moves = []
    for src, dst in zip(used, holes):
      if src <= dst or len(moves) >= max_moves:
        break
      moves.append((src, dst))
    return moves

  def apply_moves(self, moves) -> None:
    """Commit a defrag migration's allocator state: refcounts transfer src -> dst,
    sources return to the free list. Call only AFTER the device copy
    (migrate_pages) and the virtual-map rewrite."""
    if not moves:
      return
    srcs = {int(s) for s, _ in moves}
    dsts = {int(d) for _, d in moves}
    for src, dst in moves:
      if self._ref[src] <= 0:
        raise AssertionError(f"defrag move from free page {src}")
      if self._ref[dst] != 0:
        raise AssertionError(f"defrag move into used page {dst}")
      self._ref[dst] = self._ref[src]
      self._ref[src] = 0
    self._free = sorted((set(self._free) - dsts) | srcs, reverse=True)


def _ids(page_ids, device) -> torch.Tensor:
  return torch.as_tensor(np.asarray(page_ids, np.int64), device=device)


def commit_pages(arena: Dict[str, torch.Tensor], cache: Dict[str, torch.Tensor], page_ids,
                 start_page: int) -> Dict[str, torch.Tensor]:
  """Copy contiguous cache pages [start_page, start_page + len(page_ids)) into the
  arena at `page_ids`, in place, leaf by leaf. `cache` leaves are [L, 1, S, ...]; source
  positions past S copy as zeros, and positions past the request's pos are copied
  but never read. Returns the arena."""
  n = len(page_ids)
  if n == 0:
    return arena
  page = arena["k"].shape[2]
  ids = _ids(page_ids, arena["k"].device)
  lo, hi = start_page * page, (start_page + n) * page
  for name, buf in arena.items():
    src = cache[name][:, 0]  # [L, S, Hkv, D]
    seg = torch.zeros((src.shape[0], hi - lo) + tuple(src.shape[2:]), dtype=buf.dtype,
                      device=buf.device)
    have = max(0, min(hi, src.shape[1]) - lo)
    seg[:, :have] = src[:, lo:lo + have]
    buf[:, ids] = seg.reshape(src.shape[0], n, page, *src.shape[2:])
  return arena


def gather_pages(arena: Dict[str, torch.Tensor], page_ids) -> Dict[str, torch.Tensor]:
  """Gather `page_ids` back into contiguous form: leaves [L, 1, n*page, ...]."""
  ids = _ids(page_ids, arena["k"].device)
  out = {}
  for name, buf in arena.items():
    g = buf[:, ids]  # [L, n, page, Hkv, D]
    out[name] = g.reshape(g.shape[0], 1, g.shape[1] * g.shape[2], *g.shape[3:])
  return out


def migrate_pages(arena: Dict[str, torch.Tensor], src_ids, dst_ids) -> Dict[str, torch.Tensor]:
  """Copy pages `src_ids` over pages `dst_ids` (defrag compaction), in place. The
  sources are gathered into a temporary first, so the copy is right even where the
  two sets overlap (defrag_plan makes them disjoint). The caller rewrites the
  virtual maps and the allocator state (PagePool.apply_moves) afterwards. Returns
  the arena."""
  if len(src_ids) == 0:
    return arena
  src = _ids(src_ids, arena["k"].device)
  dst = _ids(dst_ids, arena["k"].device)
  for buf in arena.values():
    buf[:, dst] = buf[:, src]  # advanced indexing gathers a copy before the write
  return arena
