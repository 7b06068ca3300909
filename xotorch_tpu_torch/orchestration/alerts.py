"""SLO burn-rate alerts + gray-failure localization.

The port's copy of xotorch_tpu/orchestration/alerts.py. The flight recorder,
traces and roofline attribution make the ring legible, but nothing INTERPRETS that telemetry while the
system runs: overload and slow peers surface only as watchdog "stalled"
aborts, and the health monitor is binary — a peer that answers health
checks while silently adding 10x hop latency is invisible. This module is
the sensing layer the replicated-rings router arc needs before it can act:

- **Burn-rate rules** (`RULES`): Prometheus-SRE-style multi-window alerts
  evaluated over WINDOWED DELTAS of the node's own cumulative `NodeMetrics`
  histograms/counters — a bounded ring of timestamped `summary()`
  snapshots, differenced at the fast (`XOT_ALERT_FAST_S`) and slow
  (`XOT_ALERT_SLOW_S`) horizons. A latency rule's burn rate is the
  fraction of windowed observations above the SLO target
  (`XOT_SLO_TTFT_S` / `XOT_SLO_E2E_S`), divided by the error budget
  (1 - `XOT_SLO_TARGET`); the error-rate rule burns
  `requests_failed / requests` against `XOT_SLO_ERROR_RATE`. A rule fires
  only when BOTH windows exceed their thresholds — fast for detection
  latency, slow so a single bad second can't page.
- **State machine**: inactive -> pending (condition first true) -> firing
  (held for `XOT_ALERT_PENDING_S`) -> resolved (clear for
  `XOT_ALERT_RESOLVE_S`, hysteresis). Every transition records an
  `alert.*` flight event; a FIRING alert freezes a node-scope flight
  snapshot (the pre-anomaly timeline, exactly like a watchdog abort) and
  may start the bounded device trace (`XOT_ALERT_DEVICE_TRACE`,
  capture-on-anomaly riding the device trace's auto-stop).
- **Gray-failure localization**: per-peer hop send RTT EWMAs (both peer
  handles time their sends — `PeerHandle.hop_rtt`) plus per-node compute
  time from the perf-attribution compacts riding the status bus, rolled
  into a per-decode-step ring decomposition that scores each peer.
  Slow-but-healthy => advisory `degraded` — surfaced, never auto-evicted
  (acting on it belongs to the router arc). A firing latency alert carries
  this payload, naming the culpable stage (hop vs compute) and peer.

Counter resets (a transparent API restart, a respawned process) make
cumulative deltas go NEGATIVE; `monotonic_violation` detects that and the
engine clamps-and-restarts its snapshot window instead of reporting a
nonsense burn — what keeps burn rates sane across soak kill phases.

Served at `/v1/alerts` (active + recent-resolved + degraded scores,
cluster-rolled over the status bus like `peer_metrics`) and as `/metrics`
gauges (`xot_alerts_firing`, `xot_slo_burn_rate{family=...}`,
`xot_peer_hop_seconds{peer=...}`). Everything here reads host-side state
only — metric cells, EWMAs, timestamps. Zero device syncs by construction.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

from xotorch_tpu_torch.orchestration.metrics import HISTOGRAM_KEYS
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG

# Counter keys of a NodeMetrics.summary() that are monotonic by contract
# (gauges like active_requests/peers legitimately move both ways and must
# not trip the reset detector).
MONOTONIC_COUNTERS = (
  "requests", "tokens", "tensor_hops", "watchdog_aborts", "peer_evictions",
  "request_restarts", "dedup_drops", "requests_failed",
)


@dataclass(frozen=True)
class AlertRule:
  """One SLO rule. Declarative string literals only: xotlint resolves every
  `family`/`bad`/`total` reference against the statically extracted metrics
  surface (a typo'd family would otherwise evaluate to "no data" forever)."""
  name: str
  kind: str               # "latency" (histogram family) | "errors" (counter pair)
  family: str = ""        # summary histogram family, e.g. "ttft_seconds"
  bad: str = ""           # summary counter: the bad events (errors rules)
  total: str = ""         # summary counter: the demand denominator
  target_knob: str = ""   # XOT_SLO_* latency target in seconds (latency rules)
  budget_knob: str = ""   # XOT_SLO_* budget fraction (errors rules)


# The shipped rule set: the two latency families the soak verdict already
# reconciles client-vs-server, plus the failed-request rate. Keep every
# field a plain literal — the lint checker reads this without importing.
RULES: Tuple[AlertRule, ...] = (
  AlertRule(name="slo_ttft", kind="latency", family="ttft_seconds",
            target_knob="XOT_SLO_TTFT_S"),
  AlertRule(name="slo_e2e", kind="latency", family="request_seconds",
            target_knob="XOT_SLO_E2E_S"),
  AlertRule(name="slo_error_rate", kind="errors", bad="requests_failed",
            total="requests", budget_knob="XOT_SLO_ERROR_RATE"),
)


def _le(le) -> float:
  return float("inf") if le in ("+Inf", "inf") else float(le)


def count_at_or_below(rows: Iterable, target_s: float) -> float:
  """Observations <= target from cumulative bucket rows [[le, c], ...],
  linearly interpolated inside the containing bucket. Observations in the
  +Inf bucket sit above any finite target by definition."""
  prev_le, prev_c = 0.0, 0.0
  for le, c in rows:
    b = _le(le)
    if b == float("inf"):
      break
    if target_s < b:
      if b == prev_le:
        return prev_c
      frac = max(0.0, (target_s - prev_le)) / (b - prev_le)
      return prev_c + (float(c) - prev_c) * frac
    prev_le, prev_c = b, float(c)
  return prev_c


def delta_hist(cur: Optional[dict], base: Optional[dict]) -> dict:
  """Windowed histogram delta {count, buckets} between two cumulative
  summaries (base=None means "window opens at zero"). Negative per-bucket
  deltas are clamped at 0 — the reset DETECTOR (monotonic_violation) is
  what restarts the window; the clamp just keeps a torn read from
  producing negative counts."""
  cur = cur or {}
  base_rows = {str(le): float(c) for le, c in ((base or {}).get("buckets") or [])}
  rows = [[le, max(0.0, float(c) - base_rows.get(str(le), 0.0))]
          for le, c in (cur.get("buckets") or [])]
  count = rows[-1][1] if rows else max(0.0, float(cur.get("count", 0.0))
                                       - float((base or {}).get("count", 0.0)))
  return {"count": count, "buckets": rows}


def monotonic_violation(prev: dict, cur: dict) -> Optional[str]:
  """Name the first monotonic series that went BACKWARDS between two
  snapshots (a restarted process re-exporting from zero), or None. The
  alert engine restarts its window on any violation: a negative delta is
  not a burn rate, it's a reboot."""
  for key in MONOTONIC_COUNTERS:
    a, b = prev.get(key), cur.get(key)
    if a is not None and b is not None and float(b) < float(a):
      return f"counter {key} reset ({a} -> {b})"
  for key in HISTOGRAM_KEYS:
    ha, hb = prev.get(key), cur.get(key)
    if not isinstance(ha, dict) or not isinstance(hb, dict):
      continue
    if float(hb.get("count", 0.0)) < float(ha.get("count", 0.0)):
      return f"histogram {key} reset ({ha.get('count')} -> {hb.get('count')})"
  return None


class AlertEngine:
  """Per-node SLO alert evaluation + ring localization. Owned by a Node;
  `evaluate()` runs on the node's event loop (a background cadence task in
  production, driven directly by tests) and reads only host state."""

  def __init__(self, node, rules: Tuple[AlertRule, ...] = RULES):
    self.node = node
    self.rules = rules
    self.enabled = knobs.get_bool("XOT_ALERT")
    self.eval_interval_s = max(0.1, knobs.get_float("XOT_ALERT_EVAL_S"))
    self.fast_s = max(1.0, knobs.get_float("XOT_ALERT_FAST_S"))
    self.slow_s = max(self.fast_s, knobs.get_float("XOT_ALERT_SLOW_S"))
    self.burn_fast_thr = knobs.get_float("XOT_ALERT_BURN_FAST")
    self.burn_slow_thr = knobs.get_float("XOT_ALERT_BURN_SLOW")
    self.pending_s = max(0.0, knobs.get_float("XOT_ALERT_PENDING_S"))
    self.resolve_s = max(0.0, knobs.get_float("XOT_ALERT_RESOLVE_S"))
    self.latency_budget = max(1e-6, 1.0 - min(0.999, knobs.get_float("XOT_SLO_TARGET")))
    self.hop_degraded_floor_s = knobs.get_float("XOT_ALERT_HOP_DEGRADED_S")
    self.degraded_factor = max(1.0, knobs.get_float("XOT_ALERT_DEGRADED_FACTOR"))
    self.capture_device_trace = knobs.get_bool("XOT_ALERT_DEVICE_TRACE")
    self._targets: Dict[str, float] = {}
    for rule in rules:
      if rule.kind == "latency":
        self._targets[rule.name] = knobs.get_float(rule.target_knob)
      else:
        self._targets[rule.name] = max(1e-6, knobs.get_float(rule.budget_knob))
    self._snapshots: deque = deque(maxlen=max(16, knobs.get_int("XOT_ALERT_SNAPSHOTS")))
    history = max(4, knobs.get_int("XOT_ALERT_HISTORY"))
    self._recent: deque = deque(maxlen=history)
    self._states: Dict[str, Dict[str, Any]] = {
      rule.name: {"rule": rule.name, "kind": rule.kind,
                  "family": rule.family or f"{rule.bad}/{rule.total}",
                  "state": "inactive", "since": None, "fired_at": None,
                  "last_true": None, "burn_fast": 0.0, "burn_slow": 0.0,
                  "target": self._targets[rule.name]}
      for rule in rules
    }
    self.window_resets = 0
    # Chronic-drift sentinel (orchestration/history.py): the perf_drift
    # alert class, stepped from this engine's evaluate() tick so drift
    # rides the same flight recorder, compact rollup, and router drain
    # loop as the burn rules. Lazy import: history imports this module's
    # delta/violation helpers.
    from xotorch_tpu_torch.orchestration.history import DriftSentinel
    self.drift = DriftSentinel(node)

  # ------------------------------------------------------------- snapshots

  def observe(self, now: Optional[float] = None,
              summary: Optional[dict] = None) -> None:
    """Append one timestamped metrics snapshot. On a monotonicity violation
    (counter reset: transparent restart, process respawn) the whole window
    restarts — deltas against pre-reset snapshots would be negative."""
    if not self.enabled:
      return
    now = time.monotonic() if now is None else now
    summary = summary if summary is not None else self.node.metrics.summary()
    if self._snapshots:
      why = monotonic_violation(self._snapshots[-1][1], summary)
      if why is not None:
        self._snapshots.clear()
        self.window_resets += 1
        if DEBUG >= 1:
          print(f"alerts[{self.node.id}]: window restarted: {why}")
    self._snapshots.append((now, summary))

  def _window_base(self, now: float, window_s: float) -> Optional[dict]:
    """The snapshot the window opens at: the NEWEST one at least window_s
    old. A younger-than-window ring (startup, post-reset) opens at its
    oldest snapshot — a shorter honest window, never a longer stale one."""
    base = None
    for ts, summary in self._snapshots:
      if ts <= now - window_s:
        base = summary
      else:
        break
    if base is None and self._snapshots:
      base = self._snapshots[0][1]
    return base

  # ------------------------------------------------------------ burn rates

  def _burn(self, rule: AlertRule, cur: dict, base: Optional[dict]) -> float:
    """One window's burn rate: budget-normalized bad fraction (1.0 = exactly
    spending the error budget; >1 = burning it). 0.0 with no demand."""
    if rule.kind == "latency":
      d = delta_hist(cur.get(rule.family), (base or {}).get(rule.family))
      total = d["count"]
      if total <= 0:
        return 0.0
      bad = total - count_at_or_below(d["buckets"], self._targets[rule.name])
      return max(0.0, bad / total) / self.latency_budget
    bad = max(0.0, float(cur.get(rule.bad) or 0.0) - float((base or {}).get(rule.bad) or 0.0))
    total = max(0.0, float(cur.get(rule.total) or 0.0)
                - float((base or {}).get(rule.total) or 0.0))
    total = max(total, bad)  # mid-ring nodes count failures, not admissions
    if total <= 0:
      return 0.0
    return (bad / total) / self._targets[rule.name]

  # ------------------------------------------------------------- evaluation

  def evaluate(self, now: Optional[float] = None,
               summary: Optional[dict] = None) -> List[dict]:
    """One evaluation tick: snapshot, burn rates, state transitions.
    Returns the transitions taken (for tests and the cadence loop's logs).

    Two clocks: `now` (monotonic when not injected) drives every DURATION —
    pending hold, resolve hysteresis, window bases — so an NTP step can't
    stall a pending alert or insta-resolve a burning one; `wall` stamps
    `fired_at`/`resolved_at`, which must compare against cross-process
    fault windows (the soak verdict) in unix seconds. An injected `now`
    (tests) serves as both, keeping synthetic runs single-clock."""
    if not self.enabled:
      return []
    wall = time.time() if now is None else now
    now = time.monotonic() if now is None else now
    self.observe(now, summary)
    cur = self._snapshots[-1][1]
    fast_base = self._window_base(now, self.fast_s)
    slow_base = self._window_base(now, self.slow_s)
    transitions: List[dict] = []
    for rule in self.rules:
      st = self._states[rule.name]
      bf = self._burn(rule, cur, fast_base)
      bs = self._burn(rule, cur, slow_base)
      st["burn_fast"], st["burn_slow"] = round(bf, 4), round(bs, 4)
      cond = bf >= self.burn_fast_thr and bs >= self.burn_slow_thr
      flight = getattr(self.node, "flight", None)
      if cond:
        st["last_true"] = now
        if st["state"] == "inactive":
          st["state"], st["since"] = "pending", now
          if flight is not None:
            flight.record("alert.pending", None, rule=st["rule"], family=st["family"],
                          burn_fast=st["burn_fast"], burn_slow=st["burn_slow"])
          transitions.append({"rule": rule.name, "to": "pending", "at": now})
        if st["state"] == "pending" and now - st["since"] >= self.pending_s:
          st["state"], st["fired_at"] = "firing", wall
          st["localization"] = self.localization()
          if rule.kind == "latency":
            # Per-stage evidence next to the EWMA-level `suspect`: the
            # current skew-corrected stage breakdown (where recent
            # requests' time actually went — orchestration/anatomy.py).
            anat = getattr(self.node, "anatomy", None)
            if anat is not None and anat.enabled:
              st["anatomy"] = anat.stage_summary()
          if flight is not None:
            flight.record("alert.firing", None, rule=st["rule"], family=st["family"],
                          burn_fast=st["burn_fast"], burn_slow=st["burn_slow"],
                          suspect=st["localization"].get("suspect"))
          self._on_firing(st)
          transitions.append({"rule": rule.name, "to": "firing", "at": now})
      else:
        if st["state"] == "pending":
          st["state"], st["since"] = "inactive", None
          if flight is not None:
            flight.record("alert.cancelled", None, rule=st["rule"], family=st["family"],
                          burn_fast=st["burn_fast"], burn_slow=st["burn_slow"])
          transitions.append({"rule": rule.name, "to": "cancelled", "at": now})
        elif st["state"] == "firing" and st["last_true"] is not None \
            and now - st["last_true"] >= self.resolve_s:
          if flight is not None:
            flight.record("alert.resolved", None, rule=st["rule"], family=st["family"],
                          burn_fast=st["burn_fast"], burn_slow=st["burn_slow"])
          self._recent.append({
            "rule": rule.name, "family": st["family"],
            "fired_at": st["fired_at"], "resolved_at": wall,
            "localization": st.get("localization"),
            "anatomy": st.get("anatomy"),
          })
          st.update(state="inactive", since=None, fired_at=None, last_true=None)
          st.pop("localization", None)
          st.pop("anatomy", None)
          transitions.append({"rule": rule.name, "to": "resolved", "at": now})
    transitions.extend(self.drift.evaluate(now, wall))
    return transitions

  def _on_firing(self, st: dict) -> None:
    """Capture-on-anomaly for a freshly firing alert: freeze the node-scope
    flight timeline (the two minutes BEFORE the burn, exactly what a
    postmortem needs) and optionally start the bounded device trace."""
    flight = getattr(self.node, "flight", None)
    if flight is not None:
      flight.freeze(None, reason=f"alert_firing:{st['rule']}")
    if self.capture_device_trace:
      try:
        from xotorch_tpu_torch.orchestration.tracing import start_device_trace
        start_device_trace(f"/tmp/xot_alert_trace_{st['rule']}")
      except Exception as e:  # advisory capture must never break evaluation
        if DEBUG >= 1:
          print(f"alert device-trace capture failed: {e!r}")

  # ----------------------------------------------------------- localization

  def localization(self) -> dict:
    """Per-decode-step ring decomposition: each peer's hop send RTT EWMA
    (transport + remote queueing) and each node's per-dispatch compute time
    (perf-attribution compacts off the status bus). Scores are advisory —
    a degraded peer is NAMED, never evicted; latency alerts attach this
    payload so "the ring is slow" arrives as "node-X's hop is 9x the ring
    median"."""
    rtts: Dict[str, float] = {}
    for p in list(getattr(self.node, "peers", []) or []):
      ewma = getattr(p, "hop_rtt", None)
      v = ewma.value() if ewma is not None else None
      if v is not None:
        rtts[p.id()] = v
    compute: Dict[str, float] = {}
    perf_fn = getattr(self.node.inference_engine, "perf_compact", None)
    local = perf_fn() if callable(perf_fn) else None
    if local and local.get("dispatches"):
      compute[self.node.id] = local["secs"] / max(1, local["dispatches"])
    for nid, summary in getattr(self.node, "peer_metrics", {}).items():
      perf = summary.get("perf") if isinstance(summary, dict) else None
      if perf and perf.get("dispatches"):
        compute[nid] = float(perf.get("secs", 0.0)) / max(1, int(perf["dispatches"]))

    def median(xs: List[float]) -> float:
      xs = sorted(xs)
      return xs[len(xs) // 2] if xs else 0.0

    peers = {}
    for pid, v in rtts.items():
      others = [x for k, x in rtts.items() if k != pid]
      ref = max(median(others), 1e-9) if others else max(self.hop_degraded_floor_s, 1e-9)
      score = v / ref
      degraded = v >= self.hop_degraded_floor_s and (
        not others or v >= self.degraded_factor * median(others))
      peers[pid] = {"hop_rtt_s": round(v, 6), "score": round(score, 2),
                    "degraded": degraded}
    compute_rows = {}
    for nid, v in compute.items():
      others = [x for k, x in compute.items() if k != nid]
      degraded = bool(others) and v >= self.hop_degraded_floor_s \
          and v >= self.degraded_factor * max(median(others), 1e-9)
      compute_rows[nid] = {"avg_dispatch_s": round(v, 6), "degraded": degraded}
    suspect = stage = None
    hop_bad = [(row["hop_rtt_s"], pid) for pid, row in peers.items() if row["degraded"]]
    if hop_bad:
      suspect, stage = max(hop_bad)[1], "hop"
    else:
      comp_bad = [(row["avg_dispatch_s"], nid) for nid, row in compute_rows.items()
                  if row["degraded"]]
      if comp_bad:
        suspect, stage = max(comp_bad)[1], "compute"
    return {"suspect": suspect, "stage": stage, "peers": peers,
            "compute": compute_rows}

  # ---------------------------------------------------------------- exports

  def _alert_row(self, st: dict) -> dict:
    row = {k: st[k] for k in ("rule", "family", "state", "since", "fired_at",
                              "burn_fast", "burn_slow", "target")}
    if st.get("localization") is not None:
      row["localization"] = st["localization"]
    if st.get("anatomy") is not None:
      row["anatomy"] = st["anatomy"]
    return row

  def active(self) -> List[dict]:
    return ([self._alert_row(st) for st in self._states.values()
             if st["state"] != "inactive"] + self.drift.active())

  def recent(self) -> List[dict]:
    return list(self._recent) + self.drift.recent()

  def status(self, localization: Optional[dict] = None) -> dict:
    """The local half of /v1/alerts: every rule's live burn rates, active
    alerts, recent resolved ones, and the current ring decomposition.
    `localization` lets a caller that also needs `compact()` score the
    ring once and share the result."""
    return {
      "enabled": self.enabled,
      "windows": {"fast_s": self.fast_s, "slow_s": self.slow_s,
                  "burn_fast_threshold": self.burn_fast_thr,
                  "burn_slow_threshold": self.burn_slow_thr,
                  "pending_s": self.pending_s, "resolve_s": self.resolve_s},
      "rules": {name: self._alert_row(st) for name, st in self._states.items()},
      "active": self.active(),
      "recent": self.recent(),
      "degraded": localization if localization is not None else self.localization(),
      "drift": self.drift.status(),
      "snapshots": len(self._snapshots),
      "window_resets": self.window_resets,
    }

  def compact(self, localization: Optional[dict] = None) -> dict:
    """Small summary for the status-bus rollup (rides `node_metrics` on the
    topology cadence, like the perf compacts): active + recent alerts with
    just enough to classify and localize from a remote node."""
    def mini(row: dict) -> dict:
      loc = row.get("localization") or {}
      out = {k: row.get(k) for k in ("rule", "family", "class", "state",
                                     "fired_at", "resolved_at", "burn_fast",
                                     "burn_slow")}
      out["suspect"] = loc.get("suspect")
      out["stage"] = loc.get("stage")
      return {k: v for k, v in out.items() if v is not None}

    if localization is None:
      localization = self.localization()
    degraded = [pid for pid, row in localization["peers"].items()
                if row["degraded"]]
    # `firing` counts SLO burns ONLY. Drift rows ride `active`/`recent`
    # (class: perf_drift) as evidence, but must not feed the router's
    # hard drain signal: a drain shifts the fleet's load onto the
    # survivors, moves THEIR gauges off baseline, and a drift-inflated
    # firing count would then drain the survivors too — the detector
    # taking the whole fleet out. Like `degraded`, node-side drift
    # is advisory; the router's own fleet-median comparison (which knows
    # whether the fleet is steady) is the actuator.
    return {
      "active": [mini(r) for r in self.active()],
      "recent": [mini(r) for r in self.recent()],
      "firing": sum(1 for st in self._states.values() if st["state"] == "firing"),
      "degraded_peers": degraded,
    }

  def gauge_stats(self) -> Dict[str, float]:
    """/metrics gauge values (keys are the exposition table's row keys)."""
    return {"firing": float(sum(1 for st in self._states.values()
                                if st["state"] == "firing")),
            "drift_firing": float(self.drift.firing_count())}

  def burn_gauges(self) -> Dict[str, float]:
    """family -> fast-window burn rate, for xot_slo_burn_rate{family=...}."""
    return {st["family"]: st["burn_fast"] for st in self._states.values()}

  def peer_hop_gauges(self) -> Dict[str, float]:
    """peer id -> hop RTT EWMA seconds, for xot_peer_hop_seconds{peer=...}."""
    out = {}
    for p in list(getattr(self.node, "peers", []) or []):
      ewma = getattr(p, "hop_rtt", None)
      v = ewma.value() if ewma is not None else None
      if v is not None:
        out[p.id()] = round(v, 6)
    return out
