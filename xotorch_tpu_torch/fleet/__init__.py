"""The elastic replica fleet: the controller half, which owns the replica set.

The port's copy of xotorch_tpu/fleet. The router observes and steers its replicas;
the fleet also starts and stops them:

- `FleetLease` (here): a file-based TTL lease that gates actuation (spawn, retire,
  respawn), so that several identical routers can all route (rendezvous hashing
  already makes them agree on placement) while one acts. The lease is a JSON file on
  the shared host, renewed by atomic replace; a holder that dies stops renewing and
  the TTL hands actuation over. Without XOT_FLEET_LEASE_PATH a lone router always
  holds it;
- `load_template` (here): the slot template, every replica the fleet may run, active or
  latent, each `{name, url, active, argv, env, log}`;
- `FleetSpawner` (spawner.py): starts and stops slots as processes (a port replica is
  `python -m xotorch_tpu_torch.main ...`); pids go to a sidecar file, so a new lease
  holder can stop what a dead one started;
- `FleetController` (controller.py): one tick a router poll: adoption, dead detection
  and respawn into the warm path (the prefix pre-announce before the replica enters
  rotation), scale-up on fleet-wide queue pressure, and scale-down of the spares it
  added through the drain path, so that no request in flight dies.

The port has no XLA compile cache (the JAX fleet's XOT_COMPILE_CACHE_DIR): a respawned
replica loads the kernels already built under xotorch_tpu_torch/build/ and captures its
CUDA graphs again, and its warm path is the prefix pre-announce alone. Replicas share
nothing at runtime; the controller touches them through their HTTP surface and POSIX
process management only.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional


def load_template(path: str) -> List[Dict[str, Any]]:
  """Parse a fleet template file: `{"slots": [{name, url, active, argv,
  env, log}, ...]}`. The slot list is the fleet's whole possible world —
  `active` slots are expected to be running already (spawned by the
  operator or harness); latent ones are what scale-up has to offer.
  Validation is strict: a malformed template must fail at boot, not at
  the first 3 a.m. respawn."""
  with open(path) as f:
    doc = json.load(f)
  slots = doc.get("slots")
  if not isinstance(slots, list) or not slots:
    raise ValueError(f"fleet template {path}: 'slots' must be a non-empty list")
  seen = set()
  for s in slots:
    if not isinstance(s, dict) or not s.get("name") or not s.get("url"):
      raise ValueError(f"fleet template {path}: every slot needs name + url")
    if s["name"] in seen:
      raise ValueError(f"fleet template {path}: duplicate slot {s['name']!r}")
    seen.add(s["name"])
    if not isinstance(s.get("argv"), list) or not s["argv"]:
      raise ValueError(f"fleet template {path}: slot {s['name']!r} needs argv")
  return slots


class FleetLease:
  """TTL'd actuation lease over a shared file. `try_acquire()` is the only
  verb: it acquires when the lease is free or expired, renews when we
  already hold it, and reports False while another holder's lease is
  live. Writes go through temp-file + os.replace (atomic on POSIX) and
  are confirmed by read-back, so of two routers racing an expired lease
  at most one can see its own id in the file. The read-back window still
  admits one overlapping tick under a perfectly symmetric race — the
  actuations behind it are idempotent (a double-spawned slot loses the
  port bind and exits), and the very next renewal resolves ownership.

  `path=None` is solo mode: a single router with no HA peers always holds
  the lease and pays zero file I/O."""

  def __init__(self, path: Optional[str], holder: str, ttl_s: float):
    self.path = path
    self.holder = holder
    self.ttl_s = max(0.5, float(ttl_s))
    self.held = path is None
    self.acquired_total = 0
    self.lost_total = 0

  def _read(self) -> Optional[dict]:
    try:
      with open(self.path) as f:
        doc = json.loads(f.read())
      return doc if isinstance(doc, dict) else None
    except (OSError, json.JSONDecodeError):
      return None

  def _write(self, doc: dict) -> bool:
    try:
      d = os.path.dirname(self.path) or "."
      os.makedirs(d, exist_ok=True)
      fd, tmp = tempfile.mkstemp(dir=d, prefix=".lease.")
      with os.fdopen(fd, "w") as f:
        f.write(json.dumps(doc))
      os.replace(tmp, self.path)
      return True
    except OSError:
      return False

  def peek(self) -> Optional[dict]:
    """The current lease row (holder, expires) without touching it."""
    return None if self.path is None else self._read()

  def try_acquire(self, now: Optional[float] = None) -> bool:
    """One tick of the lease protocol. Returns whether we hold actuation
    AFTER this call; the caller diffs against its previous view to emit
    lease.acquired / lease.lost transitions."""
    if self.path is None:
      return True
    now = time.time() if now is None else now
    was = self.held
    cur = self._read()
    free = (cur is None or cur.get("holder") == self.holder
            or float(cur.get("expires") or 0.0) <= now)
    if free and self._write({"holder": self.holder,
                             "expires": now + self.ttl_s, "at": now}):
      back = self._read()
      self.held = bool(back and back.get("holder") == self.holder)
    else:
      self.held = False
    if self.held and not was:
      self.acquired_total += 1
    elif was and not self.held:
      self.lost_total += 1
    return self.held

  def release(self) -> None:
    """Drop the lease on clean shutdown so a peer takes over NOW instead
    of after a full TTL. Best-effort — a crash skips this by definition."""
    if self.path is None or not self.held:
      return
    cur = self._read()
    if cur and cur.get("holder") == self.holder:
      self._write({"holder": "", "expires": 0.0, "at": time.time()})
    self.held = False

  def status(self) -> dict:
    return {
      "mode": "solo" if self.path is None else "file",
      "path": self.path, "holder_id": self.holder, "held": self.held,
      "ttl_s": self.ttl_s, "lease": self.peek(),
      "acquired_total": self.acquired_total, "lost_total": self.lost_total,
    }
