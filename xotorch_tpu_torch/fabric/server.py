"""The fabric's serving side (transport-free): resolve and serve host-tier entries.

The port's copy of xotorch_tpu/fabric/server.py: the bodies of the `/v1/kv/*` routes the
API serves (api/chatgpt_api.py). Each takes the `HostKVStore` and plain data and returns
plain data or packed bytes. Serving copies nothing until it packs: `snapshot_keys` gives
the identities without holding the store's lock across an export, and `export_entry`
hands back the store's own arrays. An eviction between the resolve and the export turns
the request into a miss (404), never a torn blob.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from xotorch_tpu_torch.fabric import entry_key, pack_entry, shard_key
from xotorch_tpu_torch.inference.torch_engine.kv_offload import (HostKVStore, common_prefix_len,
                                                                  leaf_dtype_name)


def resolve_key(store: HostKVStore, key: str) -> Optional[Tuple[Any, np.ndarray]]:
  """The (ctx_key, toks) identity behind a content-addressed key, or None."""
  for ctx_key, toks in store.snapshot_keys():
    if entry_key(ctx_key, toks) == key:
      return ctx_key, toks
  return None


def match_response(store: HostKVStore, shard: str, toks: np.ndarray, limit: int) -> Dict[str, Any]:
  """The answer to a sibling's `POST /v1/kv/match`: the resident entry of namespace
  `shard` with the longest common prefix with `toks`, worth the least of that and the
  KV it covers. {"key": None} on a miss, else {"key", "common", "length", "nbytes"}."""
  toks = np.asarray(toks).reshape(-1).astype(np.int64)
  best: Optional[Tuple[Any, np.ndarray]] = None
  best_common = 0
  for ctx_key, etoks in store.snapshot_keys():
    if shard_key(ctx_key) != shard:
      continue
    common = common_prefix_len(etoks, toks, limit)
    if common > best_common:
      best, best_common = (ctx_key, etoks), common
  if best is None:
    return {"key": None}
  payload = store.export_entry(*best)
  if payload is None:  # evicted between the snapshot and the export: a miss
    return {"key": None}
  usable = min(best_common, int(payload["length"]))
  if usable <= 0:
    return {"key": None}
  nbytes = int(sum(int(a.nbytes) for a in payload["data"].values()))
  return {"key": entry_key(*best), "common": usable, "length": int(payload["length"]),
          "nbytes": nbytes}


def manifest(store: HostKVStore, key: str) -> Optional[Dict[str, Any]]:
  """`GET /v1/kv/{key}` without the payload: the entry's covered length, leaf table and
  digest, so a peer can size the transfer first."""
  ident = resolve_key(store, key)
  if ident is None:
    return None
  payload = store.export_entry(*ident)
  if payload is None:
    return None
  return {
    "key": key, "length": int(payload["length"]),
    "n_toks": int(np.asarray(payload["toks"]).shape[0]),
    "digest": payload["digest"],
    "leaves": [{"name": name, "dtype": leaf_dtype_name(arr), "shape": list(arr.shape),
                "nbytes": int(arr.nbytes)}
               for name, arr in sorted(payload["data"].items())],
  }


def serve_entry(store: HostKVStore, key: str) -> Optional[bytes]:
  """`GET /v1/kv/{key}?payload=1`: the packed blob of one entry, or None when it is not
  (or no longer) resident."""
  ident = resolve_key(store, key)
  if ident is None:
    return None
  payload = store.export_entry(*ident)
  if payload is None:
    return None
  return pack_entry(payload)
