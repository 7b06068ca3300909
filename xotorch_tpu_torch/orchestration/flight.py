"""Flight recorder: a bounded, always-on ring of structured runtime events.

The port's copy of xotorch_tpu/orchestration/flight.py.

Spans and metrics answer "how long / how many"; they cannot answer "what was
this node DOING in the two seconds before the watchdog killed request X".
An abort would otherwise surface as a single log line — the arming of the
watchdog, the batcher decisions that starved the request, the pool pressure
that evicted its prefix, the health transitions of the peer it was waiting
on are all gone by the time anyone looks. The flight recorder keeps them:

- `record(event, request_id, **attrs)` appends into a bounded deque; cheap
  enough to stay ON in production (one tuple append under a lock — the
  prometheus counters on the same paths do strictly more work). Event names
  are declared in `EVENTS` below and validated at record time; xotlint's
  metrics-consistency checker validates every call-site literal statically,
  so a typo'd event string fails CI before it fails at runtime.
- On a terminal anomaly (watchdog abort, deadline expiry, peer eviction,
  OOM recovery) the node calls `freeze(request_id, reason)`: the events
  relevant to that request — its own plus node-scoped ones — are copied
  into a bounded snapshot store and served at `/v1/debug/flight`, turning
  the abort log line into a replayable timeline.

Knobs (utils/knobs.py): `XOT_FLIGHT` (default on) disables recording
entirely, `XOT_FLIGHT_EVENTS` sizes the ring, `XOT_FLIGHT_SNAPSHOTS`
bounds the frozen-snapshot store.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from xotorch_tpu_torch.utils import knobs

# The full event vocabulary. Declarative on purpose: xotlint statically
# checks that every `*.record("<name>", ...)` literal in the tree is
# declared here AND that every declared name is recorded somewhere — a
# typo'd string or a dead event is a lint failure, exactly like the knob
# registry. Names are `<subsystem>.<event>`.
EVENTS = (
  # request lifecycle (orchestration/node.py)
  "request.admitted",
  "request.finished",
  "request.aborted",
  # bounded admission gate (orchestration/admission.py): a request that
  # waited for a slot, and one shed as a 429 — the overload evidence that
  # used to surface only as watchdog "stalled" aborts.
  "admission.queued",
  "admission.rejected",
  # router replica lifecycle (router/app.py): one event per state-machine
  # transition, so the front door's decisions (who was drained on which
  # alert, when probes readmitted it) are replayable like any node anomaly.
  "replica.draining",
  "replica.probing",
  "replica.readmitted",
  # request hedging (router/app.py): a duplicate fired at the least-loaded
  # other replica after the p99-derived delay, the attempt that won the
  # first-byte race, and the loser's server-side cancellation — the three
  # edges a postmortem needs to prove no request was double-served.
  "hedge.fired",
  "hedge.won",
  "hedge.cancelled",
  # elastic fleet controller (fleet/controller.py, recorded in the owning
  # router's flight recorder): spawn/respawn/retire actuations, a replica
  # declared dead past the unreachable streak, and the TTL'd actuation
  # lease changing hands — the controller's whole decision record.
  "fleet.spawn",
  "fleet.respawn",
  "fleet.retire",
  "fleet.dead",
  "lease.acquired",
  "lease.lost",
  # ring hops (peer handles send; node receives/dedups)
  "hop.send",
  "hop.recv",
  "hop.dedup_drop",
  # engine decode batcher (inference/jax_engine/engine.py)
  "batcher.dispatch",
  "batcher.prefill_slice",
  # paged KV pool
  "pool.alloc",
  "pool.pressure",
  # virtual KV addressing (inference/jax_engine/vkv.py via engine): pages a
  # sliding window released back to the pool mid-decode, and idle-slot
  # defrag passes (moves + the fragmentation they left behind) — the two
  # silent arena mutations a postmortem must be able to replay.
  "vkv.window_free",
  "vkv.defrag",
  # host KV tier
  "host.spill",
  "host.restore",
  "host.evict",
  # fleet-wide KV fabric (xotorch_tpu/fabric via engine + api): a sibling's
  # announce landing in the offer directory, a cross-replica entry imported
  # into the local host tier, and this node serving an entry to a peer —
  # the three edges a cross-replica warm hit is made of, each with peer,
  # token, and byte attribution for postmortems.
  "fabric.offer",
  "fabric.fetch",
  "fabric.serve",
  # engine-level events
  "engine.compile",
  "engine.oom_recovery",
  # speculative decoding: one event per draft verification (drafted vs
  # accepted counts + whether the verify ran native to the page arena), so
  # a frozen snapshot shows how well speculation was paying off for the
  # request that anomalied.
  "spec.verify",
  # survivability layer
  "health.check_failed",
  "peer.evicted",
  "watchdog.armed",
  "watchdog.fired",
  "watchdog.deferred",
  "deadline.expired",
  # SLO burn-rate alert state machine (orchestration/alerts.py): one event
  # per transition, so a frozen snapshot shows pending -> firing -> resolved
  # (or pending -> cancelled when the burn clears before the pending hold
  # elapses) with the burn rates that drove each edge.
  "alert.pending",
  "alert.firing",
  "alert.resolved",
  "alert.cancelled",
  # chronic-drift sentinel (orchestration/history.py, stepped inside the
  # alert loop): the perf_drift state machine's transitions, plus the
  # router-side peer-median naming (`drift.replica`, recorded in the
  # router's own flight recorder when a fleet comparison names a drifter).
  "drift.pending",
  "drift.firing",
  "drift.resolved",
  "drift.cancelled",
  "drift.replica",
  # critical-path latency anatomy (orchestration/anatomy.py via node.py):
  # one event per assembled skew-corrected breakdown, so a frozen snapshot
  # shows which requests had their anatomy extracted and how much of each
  # went unattributed.
  "anatomy.breakdown",
)

_EVENT_SET = frozenset(EVENTS)


class FlightRecorder:
  """Thread-safe bounded event ring + frozen snapshots for one node.

  The engine executor thread, the event loop, and /metrics scrapes all
  touch it concurrently; every method takes the lock for a few appends at
  most. Events are stored as (ts, event, request_id, attrs) tuples and
  rendered to dicts only at export time."""

  def __init__(self, node_id: str = "", capacity: Optional[int] = None,
               max_snapshots: Optional[int] = None):
    self.node_id = node_id
    self.enabled = knobs.get_bool("XOT_FLIGHT")
    cap = capacity if capacity is not None else knobs.get_int("XOT_FLIGHT_EVENTS")
    self.max_snapshots = (max_snapshots if max_snapshots is not None
                          else knobs.get_int("XOT_FLIGHT_SNAPSHOTS"))
    self._ring: deque = deque(maxlen=max(16, int(cap)))
    self._snapshots: "OrderedDict[str, dict]" = OrderedDict()
    self._lock = threading.Lock()
    self._recorded = 0  # lifetime count (ring overwrites; this doesn't)

  # ------------------------------------------------------------------ write

  def record(self, event: str, request_id: Optional[str] = None, **attrs: Any) -> None:
    """Append one event. Unknown names raise: the vocabulary is closed
    (EVENTS) so dashboards and the lint checker can rely on it."""
    if event not in _EVENT_SET:
      raise ValueError(f"unknown flight event {event!r} — declare it in "
                       "orchestration/flight.py EVENTS")
    if not self.enabled:
      return
    entry = (time.time(), event, request_id, attrs or None)
    with self._lock:
      self._ring.append(entry)
      self._recorded += 1

  def freeze(self, request_id: Optional[str] = None,
             reason: str = "") -> Optional[dict]:
    """Copy the request's timeline (its events plus node-scoped ones) into
    the bounded snapshot store. request_id=None freezes the whole ring
    (node-scope anomalies: OOM recovery, peer eviction with no outstanding
    request). Returns the snapshot, or None when recording is disabled."""
    if not self.enabled:
      return None
    with self._lock:
      if request_id is None:
        events = list(self._ring)
      else:
        events = [e for e in self._ring if e[2] == request_id or e[2] is None]
      snap = {
        "node_id": self.node_id,
        "request_id": request_id,
        "reason": reason,
        "frozen_at": time.time(),
        "events": [self._to_dict(e) for e in events],
      }
      key = request_id if request_id is not None else f"node:{reason}"
      self._snapshots[key] = snap
      self._snapshots.move_to_end(key)
      while len(self._snapshots) > max(1, self.max_snapshots):
        self._snapshots.popitem(last=False)
      return snap

  # ------------------------------------------------------------------- read

  @staticmethod
  def _to_dict(entry) -> dict:
    ts, event, request_id, attrs = entry
    d = {"ts": ts, "event": event, "request_id": request_id}
    if attrs:
      d.update(attrs)
    return d

  def snapshot(self, request_id: str) -> Optional[dict]:
    with self._lock:
      return self._snapshots.get(request_id)

  def snapshots(self) -> List[dict]:
    with self._lock:
      return list(self._snapshots.values())

  def tail(self, n: int = 0) -> List[dict]:
    """The most recent `n` live ring events (all when n <= 0)."""
    with self._lock:
      events = list(self._ring)
    if n > 0:
      events = events[-n:]
    return [self._to_dict(e) for e in events]

  def stats(self) -> dict:
    with self._lock:
      return {
        "enabled": self.enabled,
        "events_in_ring": len(self._ring),
        "events_recorded": self._recorded,
        # Named distinctly from the /v1/debug/flight payload's "snapshots"
        # LIST so merging stats into that response can't clobber either key.
        "snapshot_count": len(self._snapshots),
        "capacity": self._ring.maxlen,
      }

  # -------------------------------------------------------------- post-mortem

  def dump_to(self, dir_path, reason: str = "") -> "Optional[str]":
    """Spool the live ring + every frozen snapshot to
    `<dir>/flight_<node_id>_<pid>.json` (post-mortem: a SIGTERM'd node's
    evidence survives the process instead of dying with the last-good
    scrape). Data is copied under the lock; file I/O happens outside it.
    Returns the written path, or None when recording is disabled or the
    write failed (best-effort — a dump must never turn shutdown into a
    crash)."""
    if not self.enabled:
      return None
    import json
    import os
    from pathlib import Path
    with self._lock:
      payload = {
        "node_id": self.node_id,
        "reason": reason,
        "dumped_at": time.time(),
        "events": [self._to_dict(e) for e in self._ring],
        "snapshots": list(self._snapshots.values()),
      }
    try:
      out_dir = Path(dir_path)
      out_dir.mkdir(parents=True, exist_ok=True)
      path = out_dir / f"flight_{self.node_id or 'node'}_{os.getpid()}.json"
      path.write_text(json.dumps(payload) + "\n")
      return str(path)
    except OSError:
      return None
