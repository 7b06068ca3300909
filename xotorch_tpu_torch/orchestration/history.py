"""Metrics history + chronic-drift sentinel: the fleet remembers.

The port's copy of xotorch_tpu/orchestration/history.py.

The observability stack detects ACUTE failure (burn-rate alerts fire in
seconds over `AlertEngine`'s snapshot ring) and explains SINGLE requests
(latency anatomy), but every window is minutes wide and every ring is
in-memory: a replica whose decode tok/s sags 15% after an OOM-recovery
cache clear, a creeping jit-miss rate, or host-tier thrash never crosses
an SLO burn threshold until users are already hurting — and a restart
forgets even that. This module is the long-memory half:

- **`MetricsHistory`**: a bounded, downsampling time-series store of
  windowed gauge samples derived from the node's own cumulative
  `NodeMetrics.summary()` (TTFT/e2e medians, error rate), the engine's
  host-side gauge hook (`history_gauges`: decode/prefill tok/s against the
  cost-model utilization discipline, spec accept rate, jit dispatch and
  host-tier fetch counters), per-peer hop RTT EWMAs, and the anatomy
  `unattributed` share. Three resolution tiers: a fine ring at the sample
  cadence, and two coarser tiers built by duration-weighted merging as
  windows age (`XOT_HISTORY_MERGE` samples fold into one bucket) — hours
  of record in a few hundred rows. `monotonic_violation` (the alert
  engine's reset detector) classifies counter resets as RESTARTS instead
  of reporting nonsense deltas. An optional JSONL spool
  (`XOT_HISTORY_DIR`) keeps the record across restarts and soak
  teardowns; restored rows join the coarse tier marked as a restart
  boundary.
- **`DriftSentinel`**: the chronic twin of the burn-rate rules, evaluated
  inside the existing `AlertEngine` loop. Each `DriftRule` gauge is
  compared (direction-aware) against its OWN trailing baseline window and
  against the MEDIAN of peer nodes' trailing gauges (ring peers' history
  compacts ride the status bus exactly like the alert compacts; across
  replicas the router runs the same comparison over `/v1/history`
  compacts). A sustained deviation walks pending -> firing -> resolved
  like a burn rule, freezes a flight snapshot, and emits `drift.*` flight
  events. Node-side firings are ADVISORY evidence (rows in the alert
  compacts, never the router's hard `firing` drain signal — a drain
  shifts load onto the survivors and moves their baselines, so a
  self-reported drift must not cascade); the ROUTER's fleet-median
  comparison over `/v1/history` compacts is the actuator that treats a
  sustained deviator as a drain-eligible suspect, closing the loop from
  "slowly getting slower" to "drained, probed, readmitted".

Everything here reads host-side state only — metric cells, EWMAs, engine
counters, wall clocks. `XOT_HISTORY=0` is byte-identical with zero added
hot-path syncs: no sampler task, no wire keys, an inert sentinel.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from xotorch_tpu_torch.orchestration.metrics import quantile_from_buckets
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG

# Cumulative counter keys a `history_gauges()` engine hook may report; the
# sampler differences these between ticks (everything else in the hook is
# already a gauge). Kept declarative so the derived-gauge math below and
# the engine hook can never disagree about which keys are rates.
CUMULATIVE_ENGINE_KEYS = (
  "jit_first_dispatches", "jit_cached_dispatches", "host_fetch_bytes",
)


@dataclass(frozen=True)
class DriftRule:
  """One watched gauge. String/number literals only — like `AlertRule`,
  the table doubles as documentation of exactly what the sentinel watches.

  `worse` names the bad direction ("down": throughput/accept-rate sagging;
  "up": latency/miss-rate/fetch-volume creeping). `floor` is an ABSOLUTE
  deviation floor in the gauge's own unit: a 2x move on a microscopic base
  value is measurement noise, not rot. `differential` marks gauges
  comparable ACROSS peers serving split traffic (latencies, ratios):
  volume-coupled gauges (tok/s, jit-miss, fetch volume) diverge whenever
  load is uneven — which the router's own drains and spills cause — so
  peer-median comparison on them is a feedback loop, not a detector; they
  stay watched against the node's OWN trailing baseline only."""
  name: str
  metric: str
  worse: str      # "down" | "up"
  floor: float
  differential: bool = True


# The shipped watch list: the gauges the tentpole names. decode/prefill
# tok/s carry the cost-model discipline (their companions hbm_util_pct /
# mfu_pct ride every sample as ceiling context); ttft/e2e medians are the
# differential signal replicas serving rendezvous-split traffic must agree
# on even when the engine exposes no perf hook.
DRIFT_RULES: Tuple[DriftRule, ...] = (
  DriftRule(name="decode_tok_s", metric="decode_tok_s", worse="down", floor=1.0,
            differential=False),
  DriftRule(name="prefill_tok_s", metric="prefill_tok_s", worse="down", floor=1.0,
            differential=False),
  DriftRule(name="spec_accept_rate", metric="spec_accept_rate", worse="down", floor=0.05),
  DriftRule(name="jit_miss_fraction", metric="jit_miss_fraction", worse="up", floor=0.05,
            differential=False),
  DriftRule(name="host_fetch_bytes_per_req", metric="host_fetch_bytes_per_req",
            worse="up", floor=4096.0, differential=False),
  DriftRule(name="hop_rtt_s", metric="hop_rtt_s", worse="up", floor=0.02),
  DriftRule(name="unattributed_share", metric="unattributed_share", worse="up", floor=0.05),
  DriftRule(name="ttft_p50_s", metric="ttft_p50_s", worse="up", floor=0.05),
  DriftRule(name="request_p50_s", metric="request_p50_s", worse="up", floor=0.05),
  # The tail the router's hedge delay is derived from (fleet median of the
  # trailing means over /v1/history compacts). Own-baseline only: a p99
  # over a thin per-tick window is far noisier than the median, and a
  # peer-median comparison on it would name healthy replicas on ordinary
  # load imbalance.
  DriftRule(name="request_p99_s", metric="request_p99_s", worse="up", floor=0.25,
            differential=False),
  # Admission-queue wait (the gate's live estimate): the chronic form of
  # the fleet controller's scale-up signal. Own-baseline only — queue
  # depth follows placement, which the router itself skews.
  DriftRule(name="admit_wait_s", metric="admit_wait_s", worse="up", floor=1.0,
            differential=False),
)

DRIFT_RULES_BY_METRIC: Dict[str, DriftRule] = {r.metric: r for r in DRIFT_RULES}


def worse_by(value: float, reference: float, worse: str) -> float:
  """Signed relative worsening of `value` vs `reference` in the rule's bad
  direction (positive = worse). The reference is floored away from zero so
  a cold gauge can't divide the world by epsilon."""
  ref = max(abs(reference), 1e-9)
  delta = (value - reference) if worse == "up" else (reference - value)
  return delta / ref


def median(xs: List[float]) -> Optional[float]:
  xs = sorted(xs)
  if not xs:
    return None
  mid = len(xs) // 2
  return xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2.0


def merge_rows(rows: List[dict]) -> dict:
  """Fold consecutive samples into one duration-weighted bucket. Gauges
  absent from a sample contribute nothing to that gauge's mean (a sample
  with no traffic has no TTFT; averaging in zeros would fake a speedup)."""
  dur = sum(float(r.get("dur_s") or 0.0) for r in rows) or float(len(rows))
  gauges: Dict[str, float] = {}
  weights: Dict[str, float] = {}
  for r in rows:
    w = float(r.get("dur_s") or 1.0)
    for k, v in (r.get("gauges") or {}).items():
      gauges[k] = gauges.get(k, 0.0) + float(v) * w
      weights[k] = weights.get(k, 0.0) + w
  return {
    "ts": min(float(r["ts"]) for r in rows),
    "ts_end": max(float(r.get("ts_end") or r["ts"]) for r in rows),
    "mono": min((r["mono"] for r in rows if r.get("mono") is not None), default=None),
    "dur_s": round(dur, 3),
    "samples": sum(int(r.get("samples") or 1) for r in rows),
    "restart": any(r.get("restart") for r in rows),
    "gauges": {k: round(v / weights[k], 6) for k, v in gauges.items()},
  }


class MetricsHistory:
  """Per-node downsampling gauge history. Owned by a Node; `observe()` runs
  on the node's event loop (a background cadence task in production,
  driven directly by tests) and reads only host state."""

  def __init__(self, node):
    self.node = node
    self.enabled = knobs.get_bool("XOT_HISTORY")
    self.sample_s = max(0.05, knobs.get_float("XOT_HISTORY_SAMPLE_S"))
    self.fine_cap = max(8, knobs.get_int("XOT_HISTORY_SAMPLES"))
    self.merge = max(2, knobs.get_int("XOT_HISTORY_MERGE"))
    self.coarse_cap = max(8, knobs.get_int("XOT_HISTORY_COARSE"))
    self.trailing_s = max(1.0, knobs.get_float("XOT_DRIFT_WINDOW_S"))
    self.spool_dir = knobs.get_str("XOT_HISTORY_DIR")
    # Tiers, oldest first inside each: `fine` at the sample cadence, `mid`
    # at merge-fold resolution, `old` at merge^2-fold. Overflow cascades
    # fine -> mid -> old; `old` finally forgets its oldest bucket.
    self._fine: List[dict] = []
    self._mid: List[dict] = []
    self._old: List[dict] = []
    # Concatenation cache: trailing/drift queries walk all retained rows
    # many times per alert tick (one pass per watched gauge); rebuild the
    # joined list only when a sample lands, not per query.
    self._rows_cache: Optional[List[dict]] = None
    self._prev_summary: Optional[dict] = None
    self._prev_engine: Optional[dict] = None
    self._prev_mono: Optional[float] = None
    self.samples_total = 0
    self.restarts = 0
    self._spool_path = None
    self._spool_err = False
    if self.enabled and self.spool_dir:
      self._restore_spool()

  # ------------------------------------------------------------------ spool

  def _spool_file(self):
    from pathlib import Path
    safe = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in (self.node.id or "node"))
    return Path(self.spool_dir) / f"history_{safe}.jsonl"

  def _restore_spool(self) -> None:
    """Load a previous process's spooled samples into the coarse tier. They
    carry wall timestamps only (`mono: None` — a dead process's monotonic
    clock means nothing here), so windowed queries skip them while the
    served record keeps them. The boundary is a restart by definition."""
    try:
      path = self._spool_file()
      if not path.exists():
        return
      rows: List[dict] = []
      for line in path.read_text().splitlines()[-(self.fine_cap * self.merge):]:
        try:
          r = json.loads(line)
        except json.JSONDecodeError:
          continue
        if isinstance(r, dict) and "ts" in r:
          r["mono"] = None
          rows.append(r)
      if not rows:
        return
      rows[-1]["restart"] = True  # the next live sample starts a new epoch
      for i in range(0, len(rows), self.merge):
        self._old.append(merge_rows(rows[i:i + self.merge]))
      self._old = self._old[-self.coarse_cap:]
      self._rows_cache = None
      self.restarts += 1
      if DEBUG >= 1:
        print(f"history[{self.node.id}]: restored {len(rows)} spooled samples "
              f"from {path}")
    except OSError as e:
      if DEBUG >= 1:
        print(f"history[{self.node.id}]: spool restore failed: {e!r}")

  def _spool_append(self, sample: dict) -> None:
    if not self.spool_dir or self._spool_err:
      return
    try:
      path = self._spool_file()
      path.parent.mkdir(parents=True, exist_ok=True)
      # One bounded rollover keeps the spool from growing without limit on
      # long soaks; the in-memory tiers stay the primary record.
      if path.exists() and path.stat().st_size > 8 * 1024 * 1024:
        path.replace(path.with_suffix(".jsonl.1"))
      with path.open("a") as f:
        f.write(json.dumps(sample) + "\n")
    except OSError as e:
      self._spool_err = True  # log once, never retry a broken disk per tick
      if DEBUG >= 1:
        print(f"history[{self.node.id}]: spool write failed (disabled): {e!r}")

  # ---------------------------------------------------------------- sampling

  @staticmethod
  def _delta(cur: Optional[dict], prev: Optional[dict], key: str) -> float:
    return max(0.0, float((cur or {}).get(key) or 0.0)
               - float((prev or {}).get(key) or 0.0))

  def _hist_quantile(self, cur: dict, prev: Optional[dict], family: str,
                     q: float = 0.5) -> Optional[float]:
    from xotorch_tpu_torch.orchestration.alerts import delta_hist
    d = delta_hist(cur.get(family), (prev or {}).get(family))
    if d["count"] <= 0:
      return None
    return quantile_from_buckets(d["buckets"], q)

  def _gauges(self, summary: dict, prev: Optional[dict],
              engine: Optional[dict], prev_engine: Optional[dict]) -> Dict[str, float]:
    """One sample's gauge row: windowed deltas of the cumulative summary
    plus the engine hook's live gauges and differenced counters. Gauges
    with no evidence this window are OMITTED, never zeroed."""
    out: Dict[str, float] = {}
    requests = self._delta(summary, prev, "requests")
    if requests > 0:
      out["error_rate"] = round(self._delta(summary, prev, "requests_failed")
                                / requests, 6)
    for family, key in (("ttft_seconds", "ttft_p50_s"),
                        ("request_seconds", "request_p50_s")):
      p50 = self._hist_quantile(summary, prev, family)
      if p50 is not None:
        out[key] = round(float(p50), 6)
    # The window's p99: what the router's hedge delay is derived from (the
    # compact's trailing mean of these windows approximates the fleet tail
    # without shipping raw buckets).
    p99 = self._hist_quantile(summary, prev, "request_seconds", 0.99)
    if p99 is not None:
      out["request_p99_s"] = round(float(p99), 6)
    gate = getattr(self.node, "admission", None)
    if gate is not None and getattr(gate, "enabled", False):
      # Live queue-wait estimate, not a delta: the scale-up trend signal.
      out["admit_wait_s"] = round(float(gate.estimate_wait_s()), 6)
    rtts = []
    for p in list(getattr(self.node, "peers", []) or []):
      ewma = getattr(p, "hop_rtt", None)
      v = ewma.value() if ewma is not None else None
      if v is not None:
        rtts.append(float(v))
    if rtts:
      out["hop_rtt_s"] = round(sum(rtts) / len(rtts), 6)
    anat = getattr(self.node, "anatomy", None)
    if anat is not None and anat.enabled:
      astats = anat.gauge_stats()
      if astats.get("breakdowns"):
        out["unattributed_share"] = round(float(astats["unattributed_share"]), 6)
    if engine:
      d_first = self._delta(engine, prev_engine, "jit_first_dispatches")
      d_cached = self._delta(engine, prev_engine, "jit_cached_dispatches")
      # EWMA gauges decay toward 0 while the engine is idle; recording
      # them without window activity would make an IDLE node look like a
      # collapsed one (a drained replica reading 0 tok/s forever is not
      # evidence of rot — it is evidence of being drained).
      if d_first + d_cached > 0:
        for key in ("decode_tok_s", "prefill_tok_s", "spec_accept_rate",
                    "hbm_util_pct", "mfu_pct"):
          v = engine.get(key)
          if v is not None:
            out[key] = round(float(v), 6)
        out["jit_miss_fraction"] = round(d_first / (d_first + d_cached), 6)
      if requests > 0:
        out["host_fetch_bytes_per_req"] = round(
          self._delta(engine, prev_engine, "host_fetch_bytes") / requests, 3)
    return out

  def observe(self, now: Optional[float] = None,
              summary: Optional[dict] = None) -> Optional[dict]:
    """Append one windowed sample. On a monotonicity violation between the
    previous and current cumulative summaries (a counter reset: transparent
    restart, respawned process) the sample is flagged `restart` and carries
    NO delta gauges — a negative delta is a reboot, not a regression."""
    if not self.enabled:
      return None
    from xotorch_tpu_torch.orchestration.alerts import monotonic_violation
    now = time.monotonic() if now is None else now
    wall = time.time()
    summary = summary if summary is not None else self.node.metrics.summary()
    hook = getattr(self.node.inference_engine, "history_gauges", None)
    engine = hook() if callable(hook) else None
    restart_why = None
    if self._prev_summary is not None:
      restart_why = monotonic_violation(self._prev_summary, summary)
    dur = (now - self._prev_mono) if self._prev_mono is not None else self.sample_s
    sample: Dict[str, Any] = {
      "ts": round(wall, 3), "mono": now, "dur_s": round(max(0.0, dur), 3),
      "samples": 1, "restart": restart_why is not None,
    }
    up = getattr(self.node.metrics, "uptime_s", None)
    if callable(up):
      sample["uptime_s"] = round(up(), 1)
    if restart_why is not None:
      self.restarts += 1
      sample["gauges"] = {}
      sample["restart_why"] = restart_why
      if DEBUG >= 1:
        print(f"history[{self.node.id}]: restart boundary: {restart_why}")
    else:
      sample["gauges"] = self._gauges(summary, self._prev_summary,
                                      engine, self._prev_engine)
    self._prev_summary = summary
    self._prev_engine = engine
    self._prev_mono = now
    self._fine.append(sample)
    self._rows_cache = None
    self.samples_total += 1
    self._spool_append(sample)
    if len(self._fine) > self.fine_cap:
      self._mid.append(merge_rows(self._fine[:self.merge]))
      del self._fine[:self.merge]
      if len(self._mid) > self.coarse_cap:
        self._old.append(merge_rows(self._mid[:self.merge]))
        del self._mid[:self.merge]
        self._old = self._old[-self.coarse_cap:]
    return sample

  # ----------------------------------------------------------------- queries

  def _all_rows(self) -> List[dict]:
    if self._rows_cache is None:
      self._rows_cache = self._old + self._mid + self._fine
    return self._rows_cache

  def rows(self, window_s: Optional[float] = None,
           now: Optional[float] = None) -> List[dict]:
    """All retained rows oldest-first (coarse tiers then fine). A window
    restricts by the MONOTONIC clock, so spool-restored rows (mono: None,
    a dead process's clock) only appear in the unwindowed record."""
    rows = self._all_rows()
    if window_s is None:
      return list(rows)
    now = time.monotonic() if now is None else now
    return [r for r in rows
            if r.get("mono") is not None and r["mono"] >= now - window_s]

  def window_mean(self, metric: str, lo_s: float, hi_s: float = 0.0,
                  now: Optional[float] = None) -> Tuple[Optional[float], int]:
    """(duration-weighted mean, sample count) of `metric` over the window
    [now - lo_s, now - hi_s]; (None, 0) when no sample carries it."""
    now = time.monotonic() if now is None else now
    acc = w_acc = 0.0
    n = 0
    for r in self._all_rows():
      mono = r.get("mono")
      if mono is None or not (now - lo_s <= mono <= now - hi_s):
        continue
      v = (r.get("gauges") or {}).get(metric)
      if v is None:
        continue
      w = float(r.get("dur_s") or 1.0)
      acc += float(v) * w
      w_acc += w
      n += int(r.get("samples") or 1)
    if w_acc <= 0:
      return None, 0
    return acc / w_acc, n

  def trailing(self, now: Optional[float] = None) -> Dict[str, float]:
    """Trailing-window mean per watched gauge — what the compact exports
    and what peer-median comparisons consume."""
    return self.trailing_with_counts(now=now)[0]

  def trailing_with_counts(self, now: Optional[float] = None
                           ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """(means, sample counts) per watched gauge over the trailing window.
    The counts ride the compact so a peer-median comparison can demand a
    minimum evidence depth — one cold-start sample is not a trend."""
    means, counts = {}, {}
    for rule in DRIFT_RULES:
      v, n = self.window_mean(rule.metric, self.trailing_s, 0.0, now=now)
      if v is not None and n > 0:
        means[rule.metric] = round(v, 6)
        counts[rule.metric] = n
    return means, counts

  def metrics_seen(self) -> List[str]:
    seen = set()
    for r in self._all_rows():
      seen.update((r.get("gauges") or {}).keys())
    return sorted(seen)

  def diff(self, window_s: float, now: Optional[float] = None) -> Dict[str, Any]:
    """"Which metric moved": each watched gauge's mean over the last
    `window_s` vs the window before it, direction-aware, sorted by
    worsening. `moved` names the worst offender — the one-line answer
    `?diff=` exists for."""
    rows = []
    for rule in DRIFT_RULES:
      after, n_after = self.window_mean(rule.metric, window_s, 0.0, now=now)
      before, n_before = self.window_mean(rule.metric, 2 * window_s, window_s, now=now)
      if after is None or before is None:
        continue
      dev = worse_by(after, before, rule.worse)
      rows.append({
        "metric": rule.metric, "worse": rule.worse,
        "before": round(before, 6), "after": round(after, 6),
        "delta": round(after - before, 6),
        "worse_by": round(dev, 4),
        "samples": [n_before, n_after],
      })
    rows.sort(key=lambda r: r["worse_by"], reverse=True)
    moved = rows[0]["metric"] if rows and rows[0]["worse_by"] > 0 else None
    return {"window_s": window_s, "moved": moved, "rows": rows}

  # ----------------------------------------------------------------- exports

  def compact(self, now: Optional[float] = None) -> dict:
    """Small rollup for the status bus and the router poll: trailing means
    plus enough bookkeeping to judge freshness and evidence depth. Only
    rides the wire while enabled — defaults-off adds no keys."""
    means, counts = self.trailing_with_counts(now=now)
    return {
      "window_s": self.trailing_s,
      "samples": self.samples_total,
      "restarts": self.restarts,
      "trailing": means,
      "trailing_n": counts,
      "ts": time.time(),
    }

  def status(self, window_s: Optional[float] = None,
             metric: Optional[str] = None) -> dict:
    """The local half of /v1/history: the retained record (optionally
    windowed / restricted to one metric) plus tier occupancy."""
    rows = self.rows(window_s)
    if metric:
      rows = [{**{k: r[k] for k in ("ts", "dur_s", "samples", "restart")
                  if k in r},
               "value": (r.get("gauges") or {}).get(metric)}
              for r in rows if metric in (r.get("gauges") or {})]
    return {
      "enabled": self.enabled,
      "sample_s": self.sample_s,
      "samples_total": self.samples_total,
      "restarts": self.restarts,
      "tiers": {"fine": len(self._fine), "mid": len(self._mid),
                "old": len(self._old)},
      "metrics": self.metrics_seen(),
      "trailing": self.trailing(),
      "spool": str(self._spool_file()) if self.spool_dir else None,
      "rows": rows,
    }


class DriftSentinel:
  """perf_drift: the chronic-degradation alert class. Owned by the node's
  `AlertEngine` and stepped from its evaluate() tick, so drift rides the
  same cadence, flight recorder, compact rollup, and router drain loop as
  the burn-rate rules — with its own windows and hysteresis, because rot
  is measured in minutes, not seconds."""

  def __init__(self, node):
    self.node = node
    self.enabled = (knobs.get_bool("XOT_DRIFT") and knobs.get_bool("XOT_HISTORY")
                    and knobs.get_bool("XOT_ALERT"))
    self.window_s = max(1.0, knobs.get_float("XOT_DRIFT_WINDOW_S"))
    self.baseline_s = max(self.window_s, knobs.get_float("XOT_DRIFT_BASELINE_S"))
    self.ratio = max(0.01, knobs.get_float("XOT_DRIFT_RATIO"))
    self.peer_ratio = max(0.01, knobs.get_float("XOT_DRIFT_PEER_RATIO"))
    self.min_samples = max(1, knobs.get_int("XOT_DRIFT_MIN_SAMPLES"))
    self.pending_s = max(0.0, knobs.get_float("XOT_DRIFT_PENDING_S"))
    self.resolve_s = max(0.0, knobs.get_float("XOT_DRIFT_RESOLVE_S"))
    self._states: Dict[str, Dict[str, Any]] = {
      rule.metric: {"rule": f"perf_drift:{rule.metric}", "family": rule.metric,
                    "class": "perf_drift", "state": "inactive", "since": None,
                    "fired_at": None, "last_true": None}
      for rule in DRIFT_RULES
    }
    self._recent: List[dict] = []

  def _peer_median(self, metric: str) -> Tuple[Optional[float], int]:
    """Median of non-stale ring peers' trailing means for `metric` (their
    history compacts ride the status bus next to the alert compacts)."""
    vals = []
    for nid, summary in getattr(self.node, "peer_metrics", {}).items():
      if not isinstance(summary, dict) or self.node.peer_metrics_stale(nid):
        continue
      hist = summary.get("history")
      v = (hist.get("trailing") or {}).get(metric) if isinstance(hist, dict) else None
      if v is not None:
        vals.append(float(v))
    return median(vals), len(vals)

  def _condition(self, rule: DriftRule, now: float) -> Optional[dict]:
    """The rule's live evidence row, or None when the condition does not
    hold. Baseline and peer-median checks both require the minimum sample
    count and the absolute floor — thin or microscopic evidence never
    pages."""
    history = getattr(self.node, "history", None)
    if history is None or not history.enabled:
      return None
    cur, n_cur = history.window_mean(rule.metric, self.window_s, 0.0, now=now)
    if cur is None or n_cur < self.min_samples:
      return None
    via = []
    evidence: Dict[str, Any] = {"metric": rule.metric, "current": round(cur, 6)}
    base, n_base = history.window_mean(
      rule.metric, self.baseline_s + self.window_s, self.window_s, now=now)
    if base is not None and n_base >= self.min_samples:
      dev = worse_by(cur, base, rule.worse)
      evidence["baseline"] = round(base, 6)
      evidence["baseline_worse_by"] = round(dev, 4)
      if dev >= self.ratio and abs(cur - base) >= rule.floor:
        via.append("baseline")
    peer_med, n_peers = (self._peer_median(rule.metric) if rule.differential
                         else (None, 0))
    if peer_med is not None:
      dev = worse_by(cur, peer_med, rule.worse)
      evidence["peer_median"] = round(peer_med, 6)
      evidence["peers"] = n_peers
      evidence["peer_worse_by"] = round(dev, 4)
      if dev >= self.peer_ratio and abs(cur - peer_med) >= rule.floor:
        via.append("peer_median")
    if not via:
      return None
    evidence["via"] = via
    return evidence

  def evaluate(self, now: float, wall: float) -> List[dict]:
    """One sentinel tick: step every drift rule's pending/firing/resolved
    machine. Mirrors AlertEngine.evaluate's two clocks: `now` (monotonic)
    drives durations, `wall` stamps fired_at/resolved_at."""
    if not self.enabled:
      return []
    transitions: List[dict] = []
    flight = getattr(self.node, "flight", None)
    for rule in DRIFT_RULES:
      st = self._states[rule.metric]
      evidence = self._condition(rule, now)
      if evidence is not None:
        st["last_true"] = now
        st["evidence"] = evidence
        if st["state"] == "inactive":
          st["state"], st["since"] = "pending", now
          if flight is not None:
            flight.record("drift.pending", None, rule=st["rule"],
                          metric=rule.metric, via=",".join(evidence["via"]))
          transitions.append({"rule": st["rule"], "to": "pending", "at": now})
        if st["state"] == "pending" and now - st["since"] >= self.pending_s:
          st["state"], st["fired_at"] = "firing", wall
          if flight is not None:
            flight.record("drift.firing", None, rule=st["rule"],
                          metric=rule.metric, via=",".join(evidence["via"]),
                          current=evidence["current"],
                          baseline=evidence.get("baseline"),
                          peer_median=evidence.get("peer_median"))
            flight.freeze(None, reason=f"drift_firing:{rule.metric}")
          transitions.append({"rule": st["rule"], "to": "firing", "at": now})
      else:
        if st["state"] == "pending":
          st.update(state="inactive", since=None)
          st.pop("evidence", None)
          if flight is not None:
            flight.record("drift.cancelled", None, rule=st["rule"], metric=rule.metric)
          transitions.append({"rule": st["rule"], "to": "cancelled", "at": now})
        elif st["state"] == "firing" and st["last_true"] is not None \
            and now - st["last_true"] >= self.resolve_s:
          if flight is not None:
            flight.record("drift.resolved", None, rule=st["rule"], metric=rule.metric)
          self._recent.append({
            "rule": st["rule"], "family": st["family"], "class": "perf_drift",
            "fired_at": st["fired_at"], "resolved_at": wall,
            "evidence": st.get("evidence"),
          })
          self._recent = self._recent[-64:]
          st.update(state="inactive", since=None, fired_at=None, last_true=None)
          st.pop("evidence", None)
          transitions.append({"rule": st["rule"], "to": "resolved", "at": now})
    return transitions

  # ----------------------------------------------------------------- exports

  def _row(self, st: dict) -> dict:
    row = {k: st[k] for k in ("rule", "family", "class", "state", "since",
                              "fired_at")}
    if st.get("evidence") is not None:
      row["evidence"] = st["evidence"]
    return row

  def active(self) -> List[dict]:
    return [self._row(st) for st in self._states.values()
            if st["state"] != "inactive"]

  def recent(self) -> List[dict]:
    return list(self._recent)

  def firing_count(self) -> int:
    return sum(1 for st in self._states.values() if st["state"] == "firing")

  def status(self) -> dict:
    return {
      "enabled": self.enabled,
      "windows": {"window_s": self.window_s, "baseline_s": self.baseline_s,
                  "ratio": self.ratio, "peer_ratio": self.peer_ratio,
                  "min_samples": self.min_samples,
                  "pending_s": self.pending_s, "resolve_s": self.resolve_s},
      "rules": {m: self._row(st) for m, st in self._states.items()},
      "active": self.active(),
      "recent": self.recent(),
    }
