"""FabricClient: the pull side of the KV fabric.

The port's copy of xotorch_tpu/fabric/client.py. It runs synchronously on the engine's
executor: a consult happens inside `_host_promote`, which already rides the batcher's
prefill lane, so a peer round trip never blocks the event loop or stalls resident
decode. The transport is urllib with a hard timeout (XOT_FABRIC_TIMEOUT_S): one small
probe and one GET a cold prefix is the whole traffic.

Lookup order:
1. the offer directory (no network): offers carry full token ids, so coverage is a
   local longest-common-prefix scan. The router's prefill chain and its spill
   pre-announce land offers here ahead of the request;
2. the static peers (XOT_FABRIC_PEERS): `POST /v1/kv/match` probes, the best usable
   coverage wins. A probe miss is remembered for a short window and an unreachable
   peer backs off, so a fleet with nothing to offer costs a cold prompt at most one
   probe round a window.

Every failure (a timeout, an HTTP error, a torn blob, short coverage) comes back as a
miss or a counted transfer error, never as an exception.
"""
from __future__ import annotations

import json
import random
import threading
import time
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from xotorch_tpu_torch.fabric import OfferDirectory, shard_key, unpack_entry

# The probe-miss memo's window and an unreachable peer's back-off.
_MISS_TTL_S = 15.0
_PEER_DOWN_S = 10.0
# One bounded probe retry before a peer counts as down (a replica mid-respawn, a
# dropped connection), jittered exponentially: base * 2**attempt * (0.5 + rand).
_PROBE_RETRIES = 1
_PROBE_BACKOFF_S = 0.05


@dataclass
class FetchResult:
  """One consult's outcome. `errors` counts failed transfer attempts (reachability,
  torn blobs), which a clean miss does not."""
  payload: Optional[Dict[str, Any]] = None
  url: str = ""
  common: int = 0
  errors: int = 0


class FabricClient:

  def __init__(self, peers: List[str], timeout_s: float = 2.0, offer_ttl_s: float = 120.0):
    self.peers = [p.rstrip("/") for p in peers if p]
    self.timeout_s = float(timeout_s)
    self.offers = OfferDirectory(ttl_s=offer_ttl_s)
    self._miss_recent: "OrderedDict[Tuple[str, bytes], float]" = OrderedDict()
    self._peer_down: Dict[str, float] = {}
    self._lock = threading.Lock()

  # ------------------------------------------------------------- transport

  def _get_bytes(self, url: str) -> bytearray:
    """The body read straight into one writable buffer: the unpacked leaves are views
    of it that a restore hands to torch without another copy."""
    with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
      length = resp.headers.get("Content-Length")
      if length is None:
        return bytearray(resp.read())
      buf = bytearray(int(length))
      view, got = memoryview(buf), 0
      while got < len(buf):
        n = resp.readinto(view[got:])
        if not n:
          raise OSError(f"short fabric transfer: {got} of {len(buf)} bytes")
        got += n
      return buf

  def _post_json(self, url: str, obj: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
      return json.loads(resp.read().decode())

  # ----------------------------------------------------------- negative cache

  def _probe_key(self, skey: str, toks: np.ndarray) -> Tuple[str, bytes]:
    return (skey, np.ascontiguousarray(toks[:64]).tobytes())

  def _recently_missed(self, key: Tuple[str, bytes]) -> bool:
    now = time.monotonic()
    with self._lock:
      at = self._miss_recent.get(key)
      return at is not None and now - at < _MISS_TTL_S

  def _note_miss(self, key: Tuple[str, bytes]) -> None:
    with self._lock:
      self._miss_recent[key] = time.monotonic()
      self._miss_recent.move_to_end(key)
      while len(self._miss_recent) > 256:
        self._miss_recent.popitem(last=False)

  def _peer_usable(self, url: str) -> bool:
    at = self._peer_down.get(url)
    return at is None or time.monotonic() - at > _PEER_DOWN_S

  def _probe_peer(self, peer: str, body: dict, result: FetchResult) -> Optional[dict]:
    """One static-peer probe with one jittered retry. Only when the retry fails too
    does the peer back off and the failure count as a transfer error."""
    for attempt in range(_PROBE_RETRIES + 1):
      try:
        return self._post_json(peer + "/v1/kv/match", body)
      except Exception:
        if attempt < _PROBE_RETRIES:
          time.sleep(_PROBE_BACKOFF_S * (2 ** attempt) * (0.5 + random.random()))
          continue
        self._peer_down[peer] = time.monotonic()
        result.errors += 1
    return None

  # ----------------------------------------------------------------- fetch

  def fetch(self, ctx_key: Any, toks: np.ndarray, limit: int, better_than: int = 0) -> FetchResult:
    """The best sibling entry covering `toks` past `better_than` positions (what the
    local tiers already cover), unpacked as an import payload, or a miss. Never
    raises."""
    toks = np.ascontiguousarray(np.asarray(toks).reshape(-1).astype(np.int64))
    skey = shard_key(ctx_key)
    result = FetchResult()
    candidates: List[Tuple[int, str, str]] = []  # (common, base url, key)
    offer = self.offers.best(ctx_key, toks, limit)
    if offer is not None and offer[1] > better_than:
      candidates.append((offer[1], offer[0].url, offer[0].key))
    else:
      probe_key = self._probe_key(skey, toks)
      if self.peers and not self._recently_missed(probe_key):
        body = {"shard": skey, "toks": toks.tolist(), "limit": int(limit)}
        for peer in self.peers:
          if not self._peer_usable(peer):
            continue
          resp = self._probe_peer(peer, body, result)
          if resp is None:
            continue
          if resp.get("key") and int(resp.get("common") or 0) > better_than:
            candidates.append((int(resp["common"]), peer, resp["key"]))
        if not candidates:
          self._note_miss(probe_key)
    for common, base_url, key in sorted(candidates, reverse=True):
      try:
        payload = unpack_entry(self._get_bytes(f"{base_url}/v1/kv/{key}?payload=1"))
      except Exception:
        # Unreachable mid-transfer or a torn blob: a counted error, then the next
        # candidate (or a clean cold prefill).
        result.errors += 1
        continue
      result.payload, result.url, result.common = payload, base_url, common
      return result
    return result
