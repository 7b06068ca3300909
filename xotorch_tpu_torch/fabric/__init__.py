"""The fleet-wide KV fabric: cross-replica prefix transfer (the transport-free half).

The port's copy of xotorch_tpu/fabric/__init__.py. N replicas each keep a private host
KV tier (kv_offload.HostKVStore); the fabric makes them one warm set. A replica exports
a spilled prefix entry in the canonical contiguous [L, 1, T, Hkv, D] layout, a sibling
imports it with its content digest verified and restores it through the engine's own
host-tier path (engine._host_promote: fresh pool pages or a snapshot), so a remote hit
is the same restore as a local one. An engine on a serving mesh keeps whole leaves in
its tier too (its tp pieces joined along the kv heads on spill, split again on
restore: kv_offload.join_pieces / split_pieces), so an entry, its digest and its blob
do not depend on either side's mesh.

Everything here is numpy and JSON over bytes, testable without a socket:

- `shard_key` / `entry_key`: identities stable across processes (sha256 over the
  shard's fields and the token ids; Python's `hash()` is salted per process);
- `pack_entry` / `unpack_entry`: the wire format, a JSON header (leaf names, dtypes
  and shapes, covered length, digest) and the raw buffers. A bf16 leaf, which the
  port holds as raw 16-bit words, travels under JAX's dtype name "bfloat16"
  (kv_offload.leaf_dtype_name) and unpacks to words again, so the port's blob of an
  entry is byte for byte the JAX package's and each package imports the other's;
- `OfferDirectory`: the offers peers announced. An offer carries the full token ids, so
  "who covers my prompt?" is a local longest-common-prefix scan
  (kv_offload.common_prefix_len, the one matching rule of every tier).

Failure semantics: a fetch that fails (an unreachable peer, a torn transfer, a digest
mismatch, a stale offer) is counted and the request prefills cold. The fabric changes
where KV comes from, never which tokens a request gets. The transport is
fabric/client.py (urllib on the engine's executor) and fabric/server.py (request bodies
the API serves).
"""
from __future__ import annotations

import hashlib
import json
import struct
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from xotorch_tpu_torch.inference.torch_engine.kv_offload import common_prefix_len, leaf_dtype_name

# Wire magic and version: an unknown magic is a torn transfer, never KV.
_MAGIC = b"XOTKV1\n"


def shard_key(ctx_key: Any) -> str:
  """Stable cross-process identity of a store namespace: a Shard's declared fields
  (an adapter context's model id names its adapter, so `base@name` never matches its
  base's entries); anything else (a test's plain string) stringifies."""
  to_dict = getattr(ctx_key, "to_dict", None)
  if callable(to_dict):
    d = to_dict()
    return (f'{d.get("model_id")}:{d.get("start_layer")}'
            f':{d.get("end_layer")}:{d.get("n_layers")}')
  return str(ctx_key)


def entry_key(ctx_key: Any, toks: np.ndarray) -> str:
  """Content address of one host-tier entry: sha256 over the namespace and the full
  token ids. Two replicas that spilled the same prefix of the same shard agree on it."""
  toks = np.ascontiguousarray(np.asarray(toks).reshape(-1).astype(np.int64))
  h = hashlib.sha256()
  h.update(shard_key(ctx_key).encode())
  h.update(b"\x00")
  h.update(toks.tobytes())
  return h.hexdigest()


def _resolve_dtype(name: str) -> np.dtype:
  """A wire dtype name as a numpy dtype. "bfloat16" is the port's raw 16-bit words (by
  name: the port needs no ml_dtypes). Anything numpy does not know raises ValueError:
  a blob declaring it is a torn transfer."""
  if name == "bfloat16":
    return np.dtype(np.uint16)
  try:
    return np.dtype(name)
  except TypeError:
    raise ValueError(f"unknown leaf dtype {name!r}") from None


def pack_entry(payload: Dict[str, Any]) -> bytes:
  """An `export_entry` payload on the wire: the magic, a length-prefixed JSON header
  (covered length, digest, token count, the leaves' name/dtype/shape table), then the
  raw buffers, token ids first, leaves in sorted-name order."""
  toks = np.ascontiguousarray(np.asarray(payload["toks"]).reshape(-1).astype(np.int64))
  names = sorted(payload["data"])
  leaves = []
  bufs = [toks.tobytes()]
  for name in names:
    arr = np.ascontiguousarray(payload["data"][name])
    leaves.append({"name": name, "dtype": leaf_dtype_name(arr), "shape": list(arr.shape)})
    bufs.append(arr.tobytes())
  header = json.dumps({
    "version": 1, "length": int(payload["length"]), "digest": payload["digest"],
    "n_toks": int(toks.shape[0]), "leaves": leaves,
  }).encode()
  return b"".join([_MAGIC, struct.pack("<I", len(header)), header] + bufs)


def unpack_entry(blob: bytes) -> Dict[str, Any]:
  """A `pack_entry` blob back as an import payload. Every malformation (bad magic, a
  short header or buffer, an unknown dtype) raises ValueError, which the caller counts
  as a torn transfer. The digest is not checked here: `import_entry` recomputes it over
  the parsed arrays, so it covers exactly the bytes a restore would use."""
  if not blob.startswith(_MAGIC):
    raise ValueError("bad fabric blob magic")
  off = len(_MAGIC)
  if len(blob) < off + 4:
    raise ValueError("truncated fabric header")
  (hlen,) = struct.unpack_from("<I", blob, off)
  off += 4
  if len(blob) < off + hlen:
    raise ValueError("truncated fabric header")
  try:
    header = json.loads(blob[off:off + hlen].decode())
  except (UnicodeDecodeError, json.JSONDecodeError) as e:
    raise ValueError(f"unparseable fabric header: {e}") from None
  off += hlen
  n_toks = int(header["n_toks"])
  end = off + n_toks * 8
  if len(blob) < end:
    raise ValueError("truncated token buffer")
  toks = np.frombuffer(blob, dtype=np.int64, count=n_toks, offset=off)
  off = end
  data: Dict[str, np.ndarray] = {}
  for leaf in header["leaves"]:
    dtype = _resolve_dtype(leaf["dtype"])
    shape = tuple(int(s) for s in leaf["shape"])
    count = int(np.prod(shape)) if shape else 1
    end = off + count * dtype.itemsize
    if len(blob) < end:
      raise ValueError(f"truncated leaf buffer {leaf['name']!r}")
    data[leaf["name"]] = np.frombuffer(blob, dtype=dtype, count=count, offset=off).reshape(shape)
    off = end
  return {"toks": toks, "length": int(header["length"]), "data": data,
          "digest": header.get("digest")}


@dataclass
class FabricOffer:
  """One announced entry: which peer holds which prefix. `toks` rides the offer, so
  coverage is decided locally without a probe."""
  key: str
  shard: str
  toks: np.ndarray
  length: int
  nbytes: int
  url: str
  at: float


class OfferDirectory:
  """Bounded, TTL'd directory of peer offers (what `POST /v1/kv/offer` records).
  Thread-safe: offers arrive on the event loop while `best` runs on the engine's
  executor during a prefix miss. `clock` is injectable (tests); monotonic by default."""

  def __init__(self, ttl_s: float = 120.0, cap: int = 256, clock=time.monotonic):
    self.ttl_s = float(ttl_s)
    self.cap = int(cap)
    self.clock = clock
    self._offers: "OrderedDict[str, FabricOffer]" = OrderedDict()
    self._lock = threading.Lock()

  def record(self, ctx_key: Any, toks: np.ndarray, length: int, nbytes: int, url: str) -> str:
    toks = np.ascontiguousarray(np.asarray(toks).reshape(-1).astype(np.int64))
    key = entry_key(ctx_key, toks)
    offer = FabricOffer(key=key, shard=shard_key(ctx_key), toks=toks, length=int(length),
                        nbytes=int(nbytes), url=url.rstrip("/"), at=self.clock())
    with self._lock:
      self._offers.pop(key, None)
      self._offers[key] = offer
      while len(self._offers) > self.cap:
        self._offers.popitem(last=False)
    return key

  def best(self, ctx_key: Any, toks: np.ndarray, limit: int) -> Optional[Tuple[FabricOffer, int]]:
    """The offer with the longest usable common prefix for `toks` (the least of the
    token match and the KV it covers; the first recorded wins a tie), or None. Expired
    offers are dropped in passing."""
    toks = np.asarray(toks).reshape(-1).astype(np.int64)
    skey = shard_key(ctx_key)
    now = self.clock()
    with self._lock:
      dead = [k for k, o in self._offers.items() if now - o.at > self.ttl_s]
      for k in dead:
        del self._offers[k]
      best, best_common = None, 0
      for offer in self._offers.values():
        if offer.shard != skey:
          continue
        common = min(common_prefix_len(offer.toks, toks, limit), offer.length)
        if common > best_common:
          best, best_common = offer, common
      return (best, best_common) if best is not None else None

  def __len__(self) -> int:
    with self._lock:
      return len(self._offers)
