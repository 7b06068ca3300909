"""Host-tier KV offload: spill warm prefix KV to host RAM instead of destroying it
(XOT_KV_HOST_BYTES).

The port's copy of xotorch_tpu/inference/jax_engine/kv_offload.py, the fleet fabric's
transfer half (`snapshot_keys`, `export_entry`, `import_entry`) included.

The prefix cache is a KV tier in device memory. Under pool pressure its entries yield
to live requests (engine._pool_alloc), its LRU bound evicts the oldest
(engine._prefix_store) and OOM recovery drops them all (engine._free_device_memory);
each of those spills the entry here first. `HostKVStore` is that second tier: a
bounded host-RAM arena, LRU by prefix key, holding evicted prefix entries as plain
numpy in ONE canonical layout, contiguous [L, 1, T, Hkv, D] per cache leaf (an int8
cache's `k_scale`/`v_scale` [L, 1, T, Hkv] too), so a spill from either device layout
(a page gather or a contiguous snapshot) restores into either (a scatter into fresh
pool pages, or a contiguous snapshot), whatever the page size at spill time. numpy
has no bfloat16: a bf16 leaf is held as its raw 16-bit words (paged_cache.to_host
and from_host). The store never touches the device; the engine does the copy out on
spill and the copy in on restore (engine._spill_prefix_entry / engine._host_promote).

Integrity over availability: entries are inserted atomically under the lock, `match`
reports only the verified common token prefix, and the engine checks leaf names and
shapes against the live cache config before restoring; a mismatch drops the entry and
the request prefills cold. Across a process boundary (the KV fabric) an entry travels
with `entry_digest`, which the importer recomputes: a torn or stale transfer is refused
as a torn local entry is.

An engine serving over a mesh holds its cache as tp pieces along the kv heads ("k",
"k@1", ...: parallel/mesh.shard_cache). Its spills are joined into whole leaves
(`join_pieces`) and its restores split again (`split_pieces`), so the tier holds JAX's
layout whatever the mesh (JAX's device_get hands the tier whole arrays): an entry, its
digest and its blob on the fabric's wire are the same from a tp-2 replica and from a
single-card one, and either imports the other's.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def leaf_dtype_name(arr: np.ndarray) -> str:
  """The dtype name a host leaf goes by in a digest and on the fabric's wire: numpy's,
  except that raw 16-bit words are a bf16 leaf (the only leaf the port holds as uint16)
  and go by JAX's name for it, "bfloat16". So the same entry digests and packs to the
  same bytes in both packages, and each verifies the other's blobs."""
  return "bfloat16" if arr.dtype == np.uint16 else str(arr.dtype)


def join_pieces(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
  """Host leaves of a mesh engine's cache, piece j of leaf `n` named "n@j" (piece 0
  "n"), as whole leaves: the pieces concatenated along the kv-head axis (axis 3 of
  [L, 1, T, Hkv, D] and of the int8 scales' [L, 1, T, Hkv]) in tp order. A leaf with
  no pieces passes as it is."""
  out = {}
  for base in (n for n in data if "@" not in n):
    pieces, j = [data[base]], 1
    while f"{base}@{j}" in data:
      pieces.append(data[f"{base}@{j}"])
      j += 1
    out[base] = pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=3)
  return out


def split_pieces(data: Dict[str, np.ndarray], tp: int) -> Dict[str, np.ndarray]:
  """Whole host leaves cut into the tp pieces of a mesh engine's cache (the inverse of
  `join_pieces`): piece j holds kv heads [j Hkv/tp, (j + 1) Hkv/tp), as views."""
  if tp <= 1:
    return dict(data)
  out = {}
  for base, arr in data.items():
    n = arr.shape[3] // tp
    for j in range(tp):
      out[base if j == 0 else f"{base}@{j}"] = arr[:, :, :, j * n:(j + 1) * n]
  return out


def entry_digest(toks: np.ndarray, length: int, data: Dict[str, np.ndarray]) -> str:
  """Content digest of one entry: sha256 over the token ids, the covered length, and
  every leaf's name, dtype (`leaf_dtype_name`), shape and bytes in sorted-name order.
  The integrity check of KV that crosses a process boundary."""
  h = hashlib.sha256()
  toks = np.ascontiguousarray(np.asarray(toks).reshape(-1).astype(np.int64))
  h.update(toks.tobytes())
  h.update(str(int(length)).encode())
  for name in sorted(data):
    arr = np.ascontiguousarray(data[name])
    h.update(name.encode())
    h.update(leaf_dtype_name(arr).encode())
    h.update(repr(tuple(arr.shape)).encode())
    h.update(arr.tobytes())
  return h.hexdigest()


def common_prefix_len(stored: np.ndarray, probe: np.ndarray, limit: int) -> int:
  """Length of the common token prefix of `stored` and `probe`, capped at
  min(len(stored), limit). The one matching rule of both tiers: the device prefix
  cache's scan (engine._best_hbm_prefix) and the host tier's `match`."""
  n = min(int(stored.shape[0]), int(limit))
  if n <= 0:
    return 0
  neq = np.nonzero(stored[:n] != probe[:n])[0]
  return int(neq[0]) if neq.size else n


@dataclass
class HostKVEntry:
  """One spilled prefix: `toks` the full prompt that stored it, `data` the canonical
  [L, 1, T, ...] host copies of every cache leaf, `length` the tokens actually covered
  (a paged spill covers whole pages only, so length <= toks.shape[0]). `digest` is its
  `entry_digest`, kept once known (an entry is never written once inserted): the one an
  import verified, or the one its first export computed."""
  toks: np.ndarray
  data: Dict[str, np.ndarray]
  length: int
  nbytes: int
  source: str = "local"
  digest: Optional[str] = None


class HostKVStore:
  """Bounded host-RAM tier under the device prefix cache.

  Keys are (ctx_key, prefix_key): ctx_key the engine's Shard (one namespace per model
  and layer range), prefix_key the same token hash the device prefix cache uses. All
  methods are thread-safe: spills and restores run on the engine's executor while
  /metrics reads the stats from the event loop."""

  def __init__(self, max_bytes: int):
    self.max_bytes = int(max_bytes)
    self._entries: "OrderedDict[Tuple[Any, int], HostKVEntry]" = OrderedDict()
    self._bytes = 0
    self._lock = threading.Lock()
    # Optional eviction callback `(entries_dropped, bytes_dropped)`, called outside
    # the lock after a put() had to LRU-evict to fit the budget (the engine records a
    # `host.evict` flight event).
    self.observer = None

  @property
  def total_bytes(self) -> int:
    with self._lock:
      return self._bytes

  def __len__(self) -> int:
    with self._lock:
      return len(self._entries)

  def put(self, ctx_key: Any, toks: np.ndarray, data: Dict[str, np.ndarray],
          length: int, source: str = "local", digest: Optional[str] = None) -> int:
    """Insert (or refresh) an entry; LRU-evict until the arena fits the budget.
    Returns the bytes newly stored (0 when the entry alone exceeds the budget and is
    rejected)."""
    toks = np.ascontiguousarray(np.asarray(toks).reshape(-1).astype(np.int64))
    nbytes = int(sum(int(a.nbytes) for a in data.values()) + toks.nbytes)
    if nbytes > self.max_bytes:
      return 0
    entry = HostKVEntry(toks=toks, data=dict(data), length=int(length), nbytes=nbytes,
                        source=source, digest=digest)
    key = (ctx_key, hash(toks.tobytes()))
    dropped, dropped_bytes = 0, 0
    with self._lock:
      old = self._entries.pop(key, None)
      if old is not None:
        self._bytes -= old.nbytes
      self._entries[key] = entry
      self._bytes += nbytes
      while self._bytes > self.max_bytes and len(self._entries) > 1:
        _, evicted = self._entries.popitem(last=False)
        self._bytes -= evicted.nbytes
        dropped += 1
        dropped_bytes += evicted.nbytes
    if dropped and self.observer is not None:
      try:
        self.observer(dropped, dropped_bytes)
      except Exception:
        pass  # observability must never fail a spill
    return nbytes

  def match(self, ctx_key: Any, toks: np.ndarray,
            limit: int) -> Tuple[Optional[HostKVEntry], int]:
    """Best entry for this context by longest common token prefix (capped at `limit`:
    at least one token must remain to forward). Refreshes the winner's LRU slot.
    Returns (entry, common length) or (None, 0)."""
    toks = np.asarray(toks).reshape(-1).astype(np.int64)
    with self._lock:
      best_key, best, best_len = None, None, 0
      for key, entry in self._entries.items():
        if key[0] != ctx_key:
          continue
        common = common_prefix_len(entry.toks, toks, limit)
        if common > best_len:
          best_key, best, best_len = key, entry, common
      if best_key is not None:
        self._entries.move_to_end(best_key)
      return best, best_len

  # ------------------------------------------------------ fabric transfer

  def snapshot_keys(self) -> List[Tuple[Any, np.ndarray]]:
    """The (ctx_key, toks) identity of every resident entry: what the fabric's server
    side enumerates to resolve a content-addressed key without holding the lock across
    an export."""
    with self._lock:
      return [(k[0], e.toks) for k, e in self._entries.items()]

  def export_entry(self, ctx_key: Any, toks: np.ndarray) -> Optional[Dict[str, Any]]:
    """One exact entry as a transfer payload (None when absent): token ids, covered
    length, every canonical leaf and its `entry_digest`. The arrays are the store's own
    (entries are never written once inserted): an export copies nothing."""
    key = (ctx_key, hash(np.ascontiguousarray(
      np.asarray(toks).reshape(-1).astype(np.int64)).tobytes()))
    with self._lock:
      entry = self._entries.get(key)
      if entry is None:
        return None
      toks, length, data = entry.toks, entry.length, dict(entry.data)
    if entry.digest is None:
      # Outside the lock: hashing tens of MB. Racing exports compute the same value.
      entry.digest = entry_digest(toks, length, data)
    return {"toks": toks, "length": length, "data": data, "digest": entry.digest}

  def import_entry(self, ctx_key: Any, payload: Dict[str, Any],
                   source: str = "fabric") -> int:
    """Insert a payload that `export_entry` made, here or on another replica. The
    digest is recomputed over the received bytes and must equal the declared one: a
    torn or stale transfer is refused (returns 0) and the caller prefills cold. The
    insert is `put`'s: atomic under the lock, evicting to the budget."""
    toks = np.ascontiguousarray(np.asarray(payload["toks"]).reshape(-1).astype(np.int64))
    length = int(payload["length"])
    data = {name: np.ascontiguousarray(arr) for name, arr in payload["data"].items()}
    if not data or length <= 0 or toks.shape[0] < length:
      return 0
    digest = entry_digest(toks, length, data)
    if digest != payload.get("digest"):
      return 0
    return self.put(ctx_key, toks, data, length, source=source, digest=digest)

  def drop(self, ctx_key: Any, toks: np.ndarray) -> None:
    """Remove one entry (torn or mismatched data found at restore time)."""
    key = (ctx_key, hash(np.ascontiguousarray(
      np.asarray(toks).reshape(-1).astype(np.int64)).tobytes()))
    with self._lock:
      entry = self._entries.pop(key, None)
      if entry is not None:
        self._bytes -= entry.nbytes

  def drop_ctx(self, ctx_key: Any) -> int:
    """Invalidate every entry of one context (its weights changed: spilled KV is
    stale). Returns the entries dropped."""
    with self._lock:
      dead = [k for k in self._entries if k[0] == ctx_key]
      for k in dead:
        self._bytes -= self._entries.pop(k).nbytes
      return len(dead)

  def clear(self) -> None:
    with self._lock:
      self._entries.clear()
      self._bytes = 0
