"""Virtual KV addressing: logical page handles over the physical arena.

The port of xotorch_tpu/inference/jax_engine/vkv.py (pure host code, numpy only).
Requests hold a VirtualKV, an ordered list of LOGICAL page slots, each naming a
physical page id in the PagePool arena; compute never consumes physical ids
directly. Every dispatch resolves handles into a [B, max_pages] int32 table with
`resolve_page_table`, so remapping pages under a request (window release, defrag
migration) changes only data.

Slot value 0 is the pool's reserved scratch page and doubles as the "released"
sentinel: when a sliding window slides past a page, the slot is zeroed in place and
the physical page decrefs back to the pool. Released slots stay in the list, so
position p still lives at logical slot p // page_size and `len(handle) ==
pages_for(pos)` holds everywhere; the kernels' window bound never reads them.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


def freeable_window(cfg, start_layer: int, n_layers: int) -> int:
  """Largest window such that positions <= pos - w are dead for EVERY layer of this
  shard; 0 when any layer attends globally (nothing frees). Pages below this bound
  decref back to the pool as decode advances."""
  if not cfg.uses_sliding_window:
    return 0
  windows = [cfg.layer_window(start_layer + i) for i in range(n_layers)]
  if any(w <= 0 for w in windows):
    return 0
  return max(windows)


def dead_page_count(pos: int, window: int, page_size: int) -> int:
  """Number of leading FULLY-dead logical pages once the next query sits at absolute
  position `pos`: a page is dead when its last position is <= pos - window. Never
  reaches the page holding `pos` itself, so the current write page stays live."""
  if window <= 0:
    return 0
  return max(0, int(pos) - int(window) + 1) // int(page_size)


class VirtualKV:
  """Logical block list + window base for one paged request.

  blocks[i] is the physical page backing logical page i (0 = released). `base`
  counts the leading released slots: everything below it resolves to scratch."""

  __slots__ = ("blocks", "base")

  def __init__(self, blocks: Optional[Iterable[int]] = None, base: int = 0):
    self.blocks: List[int] = [int(b) for b in blocks] if blocks is not None else []
    self.base = int(base)

  def __len__(self) -> int:
    return len(self.blocks)

  def __iter__(self) -> Iterator[int]:
    return iter(self.blocks)

  def __getitem__(self, idx):
    return self.blocks[idx]

  def __eq__(self, other) -> bool:
    """Equal to another handle with the same slots and base, or to a plain sequence
    with the same slots."""
    if isinstance(other, VirtualKV):
      return self.blocks == other.blocks and self.base == other.base
    if isinstance(other, (list, tuple)):
      return self.blocks == [int(b) for b in other]
    return NotImplemented

  __hash__ = None  # mutable, like the list it stands for

  def __repr__(self) -> str:
    return f"VirtualKV(blocks={self.blocks!r}, base={self.base})"

  def append(self, page_id: int) -> None:
    self.blocks.append(int(page_id))

  def extend(self, page_ids: Iterable[int]) -> None:
    self.blocks.extend(int(p) for p in page_ids)

  def live(self) -> List[int]:
    """Physical ids this handle still holds a reference to."""
    return [p for p in self.blocks if p != 0]

  def trim_to(self, n_slots: int) -> List[int]:
    """Drop logical slots past n_slots (bucket-padding overshoot), returning the
    live physical ids released. Tail slots are always live."""
    if n_slots >= len(self.blocks):
      return []
    freed = [p for p in self.blocks[n_slots:] if p != 0]
    del self.blocks[n_slots:]
    return freed

  def release_below(self, dead_slots: int) -> List[int]:
    """Zero slots [base, dead_slots) (the window slid past them) and return the
    physical ids to decref. Idempotent per slot."""
    dead_slots = min(int(dead_slots), len(self.blocks))
    if dead_slots <= self.base:
      return []
    freed = [p for p in self.blocks[self.base:dead_slots] if p != 0]
    for i in range(self.base, dead_slots):
      self.blocks[i] = 0
    self.base = dead_slots
    return freed

  def prefix_ids(self, n_slots: int) -> Optional[List[int]]:
    """First n logical pages as physical ids; None when the window has already
    punched holes in that range."""
    if self.base > 0 or n_slots > len(self.blocks):
      return None
    ids = self.blocks[:n_slots]
    return None if any(p == 0 for p in ids) else list(ids)

  def remap(self, mapping: Dict[int, int]) -> int:
    """Rewrite physical ids per a defrag migration map. Returns the number of slots
    rewritten. Slot 0 (released) never remaps."""
    n = 0
    for i, p in enumerate(self.blocks):
      if p != 0 and p in mapping:
        self.blocks[i] = int(mapping[p])
        n += 1
    return n


def as_handle(pages) -> VirtualKV:
  """Adopt a plain id list as a handle."""
  return pages if isinstance(pages, VirtualKV) else VirtualKV(pages)


def remap_ids(ids: Sequence[int], mapping: Dict[int, int]) -> List[int]:
  """Defrag-rewrite a plain physical id list."""
  return [int(mapping.get(int(p), int(p))) for p in ids]


def resolve_page_table(handles: Sequence[Sequence[int]], width: int) -> np.ndarray:
  """The once-per-dispatch physical resolution: [B, width] int32, one row per
  handle, unused slots on the scratch page."""
  table = np.zeros((len(handles), int(width)), np.int32)
  for row, h in enumerate(handles):
    blocks = h.blocks if isinstance(h, VirtualKV) else list(h)
    n = min(len(blocks), table.shape[1])
    if n:
      table[row, :n] = np.asarray(blocks[:n], np.int32)
  return table
