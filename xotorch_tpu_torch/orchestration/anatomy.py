"""Critical-path latency anatomy: skew-corrected "where did the time go".

The port's copy of xotorch_tpu/orchestration/anatomy.py.

The stack collects everything — ring-assembled traces, per-dispatch perf
attribution, soak percentiles, burn-rate alerts with a `suspect` peer — but
nothing DECOMPOSES a request's end-to-end latency: spans are stamped with
each host's own wall clock, so cross-node durations are incomparable, and
the alert localization is an EWMA-level hint, not per-request evidence.
This module turns the assembled trace into per-request evidence:

- **Clock-skew estimation** (`ClockSkew`): every hop send carries the
  sender's wall-clock ns (optional `clock` field on SendPrompt/SendTensor,
  on the wire only when `XOT_ANATOMY` is on) and
  each receiver keeps a bounded window of one-way deltas
  `recv_wall - send_wall = transit + (theta_recv - theta_send)` per peer.
  The MIN of the window is the NTP-style estimate (best-case transit);
  windows ride `metrics_summary()` over the status bus, so the origin
  holds every node's view and `ring_offsets` can solve the ring:
  paired opposite-direction deltas cancel transit exactly
  (`theta = (d_ab - d_ba) / 2`, uncertainty = measured transit sum / 2);
  a one-way-only edge falls back to `delta - rtt/2` with the existing
  hop-RTT EWMA bounding the uncertainty. Offsets compose along the ring
  (Dijkstra by cumulative uncertainty), so every peer gets an offset
  relative to the origin even when no direct pair exists.
- **Critical-path extraction** (`extract_breakdown`): re-base all of a
  trace's spans onto the origin's clock via the estimated offsets, then
  sweep the request window attributing every elementary interval to the
  highest-priority covering span (prefill > decode > dispatch > admission);
  a gap whose neighbors live on DIFFERENT nodes is hop transit toward the
  next node (`hop:<node>`), any other uncovered time is the explicit
  `unattributed` residual. The sweep PARTITIONS the window, so stages sum
  to e2e by construction; cross-node stages carry the offset-uncertainty
  bound of the clocks they straddle.
- **Aggregation + regression diff** (`AnatomyStore`): a bounded reservoir
  of recent breakdowns serving per-stage contribution percentiles
  (`/v1/anatomy`), one request's full breakdown (`?request_id=`), and a
  "which stage grew" two-window diff (`?diff=<seconds>`). Firing
  `slo_ttft`/`slo_e2e` alerts attach the current stage summary next to
  `suspect`, turning the advisory localization into per-stage evidence.

Everything here reads host wall clocks and span dicts — zero device work,
so anatomy can never add a sync to the decode hot path.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from xotorch_tpu_torch.utils import knobs

# Wire field on SendPrompt/SendTensor carrying the sender's stamp:
# {"from": <sender node id>, "ns": <sender wall-clock ns>}. Omitted
# entirely (no bytes) when XOT_ANATOMY=0.
CLOCK_KEY = "clock"

# Span-name -> (stage, priority) classification for the timeline sweep.
# Priorities >= _WORK_PRIO are WORK spans (a node actively computing: they
# carve time out of whatever contains them — engine prefill runs INSIDE a
# process_tensor hop span, and the inner attribution is the honest one).
# Lower priorities are CONTAINERS: the sampler's token-group spans cover
# the whole decode period INCLUDING ring waits, and the origin's root span
# covers admission — time under a container that sits BETWEEN two work
# spans on different nodes is hop transit, not container work.
_STAGE_PRIORITY = (
  # Fleet-wide KV fabric transfer (engine._fabric_consult): runs INSIDE
  # the prefill path, so it must outrank "prefill" to carve the transfer
  # out as its own TTFT stage — the disaggregated mode's honesty bar.
  ("engine.fabric_fetch", "kv_transfer", 5),
  ("engine.prefill", "prefill", 4),
  ("process_tensor", "dispatch", 3),
  ("process_prompt.forwarded", "dispatch", 3),
  ("tokens[", "decode", 2),
  ("process_prompt", "admission", 1),
)
_WORK_PRIO = 3

# Fallback transit uncertainty (ns) for a one-way clock edge with no hop-RTT
# EWMA to bound it (first hop before any RTT sample landed).
_DEFAULT_EDGE_UNC_NS = 5_000_000


class ClockSkew:
  """Per-node clock-delta collector: bounded windows of one-way
  `recv_wall - send_wall` samples per sending peer.

  Thread-safe (gRPC handlers and the event loop both note deltas). The MIN
  of a window is the NTP-style delta estimate: retried deliveries carry
  their ORIGINAL stamp (the frame is encoded once), so backoff-inflated
  samples exist and a min filter discards them for free.

  `skew_ns` adds an artificial offset to THIS node's anatomy wall clock
  (stamps sent AND receive timestamps) — the injection point the xproc
  harness and tests use to prove offset recovery (`XOT_ANATOMY_SKEW_NS`).
  """

  def __init__(self, node_id: str = ""):
    self.node_id = node_id
    self.enabled = knobs.get_bool("XOT_ANATOMY")
    self.skew_ns = knobs.get_int("XOT_ANATOMY_SKEW_NS")
    self.window = max(4, knobs.get_int("XOT_ANATOMY_CLOCK_WINDOW"))
    self._deltas: "OrderedDict[str, deque]" = OrderedDict()
    self._lock = threading.Lock()

  def wall_ns(self) -> int:
    return time.time_ns() + self.skew_ns

  def stamp(self) -> Optional[dict]:
    """The hop-send clock field, or None (key stays off the wire) when
    anatomy is disabled."""
    if not self.enabled:
      return None
    return {"from": self.node_id, "ns": self.wall_ns()}

  def note(self, stamp: Optional[dict]) -> None:
    """Record one received hop's one-way delta against the sender."""
    if not self.enabled or not isinstance(stamp, dict):
      return
    sender = stamp.get("from")
    try:
      sent_ns = int(stamp.get("ns"))
    except (TypeError, ValueError):
      return
    if not sender or sender == self.node_id:
      return
    delta = self.wall_ns() - sent_ns
    with self._lock:
      window = self._deltas.get(sender)
      if window is None:
        window = self._deltas[sender] = deque(maxlen=self.window)
        while len(self._deltas) > 64:
          self._deltas.popitem(last=False)
      self._deltas.move_to_end(sender)
      window.append(delta)

  def deltas(self) -> Dict[str, dict]:
    """{sender: {"min_ns", "n"}} — what rides metrics_summary()."""
    with self._lock:
      return {peer: {"min_ns": min(w), "n": len(w)}
              for peer, w in self._deltas.items() if w}


def pair_offset(d_ab_ns: float, d_ba_ns: float) -> Tuple[float, float]:
  """Offset of B relative to A (clock_B - clock_A) from the two one-way
  deltas d_ab (measured AT B for A->B sends) and d_ba (at A for B->A):
  transit cancels under symmetry, and the summed deltas ARE the round-trip
  transit — the honest uncertainty bound."""
  offset = (d_ab_ns - d_ba_ns) / 2.0
  unc = max(0.0, (d_ab_ns + d_ba_ns) / 2.0)
  return offset, unc


def ring_offsets(origin_id: str, clocks: Dict[str, dict],
                 hop_rtts: Optional[Dict[str, Dict[str, float]]] = None
                 ) -> Dict[str, dict]:
  """Solve every node's clock offset relative to `origin_id`.

  `clocks` maps node -> {sender: {"min_ns": ...}} (each node's received
  one-way deltas; the origin's own collector plus every peer's `clock`
  summary off the status bus). `hop_rtts` maps sender -> {receiver: rtt_s}
  (the alert layer's hop EWMAs, same bus) and bounds one-way edges.

  Returns {node: {"offset_ns", "uncertainty_ns", "via"}} for every node
  reachable through the delta graph; the origin maps to offset 0. Paired
  (bidirectional) edges are preferred — Dijkstra minimizes cumulative
  uncertainty, so a paired 2-hop path beats a one-way direct edge when the
  transit bound says so."""
  # Directed one-way deltas: (sender, receiver) -> min_ns.
  one_way: Dict[Tuple[str, str], float] = {}
  for receiver, rows in (clocks or {}).items():
    for sender, entry in (rows or {}).items():
      if isinstance(entry, dict) and entry.get("min_ns") is not None:
        one_way[(sender, receiver)] = float(entry["min_ns"])

  def rtt_ns(sender: str, receiver: str) -> Optional[float]:
    row = (hop_rtts or {}).get(sender) or {}
    v = row.get(receiver)
    return float(v) * 1e9 if v is not None else None

  # Undirected edge list: (a, b, offset_b_minus_a, uncertainty, via).
  edges: Dict[Tuple[str, str], Tuple[float, float, str]] = {}
  seen_pairs = set()
  for (s, r), d_sr in one_way.items():
    key = (min(s, r), max(s, r))
    if key in seen_pairs:
      continue
    d_rs = one_way.get((r, s))
    if d_rs is not None:
      seen_pairs.add(key)
      off, unc = pair_offset(d_sr, d_rs)  # theta_r - theta_s
      a, b = s, r
      edges[(a, b)] = (off, unc, "paired")
    else:
      rtt = rtt_ns(s, r)
      unc = (rtt / 2.0) if rtt is not None else _DEFAULT_EDGE_UNC_NS
      transit = (rtt / 2.0) if rtt is not None else 0.0
      prev = edges.get((s, r))
      if prev is None or unc < prev[1]:
        edges[(s, r)] = (d_sr - transit, max(unc, 1.0), "one_way")

  # Adjacency with both directions.
  adj: Dict[str, List[Tuple[str, float, float, str]]] = {}
  for (a, b), (off, unc, via) in edges.items():
    adj.setdefault(a, []).append((b, off, unc, via))
    adj.setdefault(b, []).append((a, -off, unc, via))

  # Dijkstra from the origin minimizing cumulative uncertainty.
  out: Dict[str, dict] = {origin_id: {"offset_ns": 0.0, "uncertainty_ns": 0.0,
                                      "via": "origin"}}
  frontier: List[Tuple[float, str, float, str]] = [(0.0, origin_id, 0.0, "origin")]
  best_unc: Dict[str, float] = {origin_id: 0.0}
  while frontier:
    frontier.sort()
    unc, node, offset, via = frontier.pop(0)
    if unc > best_unc.get(node, float("inf")):
      continue
    out[node] = {"offset_ns": offset, "uncertainty_ns": unc, "via": via}
    for nxt, e_off, e_unc, e_via in adj.get(node, ()):
      cand = unc + e_unc
      if cand < best_unc.get(nxt, float("inf")):
        best_unc[nxt] = cand
        frontier.append((cand, nxt, offset + e_off, e_via))
  return out


def _span_times(span: dict) -> Optional[Tuple[int, int]]:
  try:
    start = int(span.get("startTimeUnixNano") or 0)
    end = int(span.get("endTimeUnixNano") or 0)
  except (TypeError, ValueError):
    return None
  if start <= 0 or end <= start:
    return None
  return start, end


def _span_node(span: dict) -> str:
  for attr in span.get("attributes") or ():
    if isinstance(attr, dict) and attr.get("key") == "node.id":
      return str(attr.get("value") or "")
  return ""


def _classify(name: str) -> Optional[Tuple[str, int]]:
  for prefix, stage, prio in _STAGE_PRIORITY:
    if name == prefix or name.startswith(prefix):
      return stage, prio
  return None


def extract_breakdown(spans: Iterable[dict], offsets: Dict[str, dict],
                      request_id: Optional[str] = None,
                      trace_id: Optional[str] = None) -> Optional[dict]:
  """One request's stage-attributed latency breakdown from its assembled
  (possibly multi-node) span list.

  Every span is re-based onto the origin's clock (`ts - offset_ns[node]`),
  then the request window [min start, max end] is swept: each elementary
  interval goes to the highest-priority covering span's stage (per-node
  keys for dispatch/hop so "which partition" survives aggregation), a gap
  whose neighbors sit on different nodes becomes `hop:<next node>`, and
  everything else uncovered is `unattributed`. The partition property makes
  `sum(stages) == e2e` exact. Returns None when the trace has no usable
  spans."""
  rows = []
  for span in spans:
    if trace_id is not None and span.get("traceId") != trace_id:
      continue
    times = _span_times(span)
    cls = _classify(str(span.get("name") or ""))
    if times is None or cls is None:
      continue
    node = _span_node(span)
    off = (offsets.get(node) or {}) if node else {}
    shift = float(off.get("offset_ns") or 0.0)
    unc = float(off.get("uncertainty_ns") or 0.0)
    stage, prio = cls
    rows.append({"start": times[0] - shift, "end": times[1] - shift,
                 "stage": stage, "prio": prio, "node": node, "unc_ns": unc})
  if not rows:
    return None
  t0 = min(r["start"] for r in rows)
  t1 = max(r["end"] for r in rows)
  if t1 <= t0:
    return None

  bounds = sorted({r["start"] for r in rows} | {r["end"] for r in rows})
  stages: Dict[str, dict] = {}

  def credit(key: str, ns: float, unc_ns: float = 0.0) -> None:
    entry = stages.setdefault(key, {"secs": 0.0, "uncertainty_s": 0.0})
    entry["secs"] += ns / 1e9
    entry["uncertainty_s"] = max(entry["uncertainty_s"], unc_ns / 1e9)

  # Work spans sorted by start: the between-work rule needs, for any
  # instant, the last work span that ENDED before it and the next one that
  # STARTS after it — cross-node silence between them is hop transit.
  work = sorted((r for r in rows if r["prio"] >= _WORK_PRIO),
                key=lambda r: r["start"])

  def neighbors(lo: float, hi: float):
    prev = nxt = None
    for w in work:
      if w["end"] <= lo and (prev is None or w["end"] > prev["end"]):
        prev = w
      if w["start"] >= hi and (nxt is None or w["start"] < nxt["start"]):
        nxt = w
    return prev, nxt

  for lo, hi in zip(bounds, bounds[1:]):
    if hi <= lo:
      continue
    mid = (lo + hi) / 2.0
    covering = [r for r in rows if r["start"] <= mid < r["end"]]
    winner = (max(covering, key=lambda r: (r["prio"], -(r["end"] - r["start"])))
              if covering else None)
    if winner is not None and winner["prio"] >= _WORK_PRIO:
      stage = winner["stage"]
      key = f"{stage}:{winner['node']}" if stage == "dispatch" and winner["node"] else stage
      credit(key, hi - lo)
      continue
    # Container-covered or uncovered: is this instant ring transit?
    prev_w, next_w = neighbors(lo, hi)
    if (prev_w is not None and next_w is not None
        and prev_w["node"] and next_w["node"] and prev_w["node"] != next_w["node"]):
      # Cross-node silence between two work spans: the hop toward the node
      # that speaks next. The only stage whose duration straddles two
      # clocks — it carries both endpoints' offset-uncertainty bounds.
      credit(f"hop:{next_w['node']}", hi - lo, prev_w["unc_ns"] + next_w["unc_ns"])
    elif winner is not None:
      credit(winner["stage"], hi - lo)
    else:
      credit("unattributed", hi - lo)

  e2e_s = (t1 - t0) / 1e9
  stages.setdefault("unattributed", {"secs": 0.0, "uncertainty_s": 0.0})
  for entry in stages.values():
    entry["secs"] = round(entry["secs"], 6)
    entry["share"] = round(entry["secs"] / e2e_s, 4) if e2e_s > 0 else 0.0
    entry["uncertainty_s"] = round(entry["uncertainty_s"], 6)
  return {
    "request_id": request_id,
    "trace_id": trace_id,
    "e2e_s": round(e2e_s, 6),
    "stages": stages,
    "offsets": {node: {"offset_ns": round(o.get("offset_ns", 0.0)),
                       "uncertainty_ns": round(o.get("uncertainty_ns", 0.0)),
                       "via": o.get("via")}
                for node, o in (offsets or {}).items()},
    "computed_at": time.time(),
  }


class AnatomyStore:
  """Bounded reservoir of recent breakdowns + the query surface behind
  `/v1/anatomy` (percentiles, one request, two-window diff)."""

  def __init__(self):
    self.enabled = knobs.get_bool("XOT_ANATOMY")
    self._ring: deque = deque(maxlen=max(8, knobs.get_int("XOT_ANATOMY_RESERVOIR")))
    self._lock = threading.Lock()
    self.total = 0

  def add(self, breakdown: dict) -> None:
    if not self.enabled or not breakdown:
      return
    with self._lock:
      self._ring.append(breakdown)
      self.total += 1

  def get(self, request_id: str) -> Optional[dict]:
    with self._lock:
      for b in reversed(self._ring):
        if b.get("request_id") == request_id:
          return b
    return None

  def recent(self, n: int = 0) -> List[dict]:
    with self._lock:
      items = list(self._ring)
    return items[-n:] if n > 0 else items

  @staticmethod
  def _percentile(xs: List[float], q: float) -> Optional[float]:
    xs = sorted(xs)
    if not xs:
      return None
    rank = max(0.0, min(1.0, q)) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)

  def percentiles(self, quantiles=(0.5, 0.95)) -> Dict[str, dict]:
    """Per-stage contribution percentiles (seconds AND share of e2e) over
    the reservoir — the ring-wide 'where does the time go' view."""
    items = self.recent()
    by_stage: Dict[str, Dict[str, List[float]]] = {}
    for b in items:
      for stage, entry in (b.get("stages") or {}).items():
        row = by_stage.setdefault(stage, {"secs": [], "share": []})
        row["secs"].append(float(entry.get("secs", 0.0)))
        row["share"].append(float(entry.get("share", 0.0)))
    out: Dict[str, dict] = {}
    for stage, row in by_stage.items():
      entry: Dict[str, Any] = {"n": len(row["secs"])}
      for q in quantiles:
        tag = f"p{int(q * 100)}"
        entry[f"secs_{tag}"] = round(self._percentile(row["secs"], q) or 0.0, 6)
        entry[f"share_{tag}"] = round(self._percentile(row["share"], q) or 0.0, 4)
      entry["secs_mean"] = round(sum(row["secs"]) / len(row["secs"]), 6)
      entry["share_mean"] = round(sum(row["share"]) / len(row["share"]), 4)
      out[stage] = entry
    return out

  def stage_summary(self, n: int = 32) -> Dict[str, Any]:
    """Compact mean-share view of the last `n` breakdowns — what a firing
    latency alert attaches next to `suspect`."""
    items = self.recent(n)
    if not items:
      return {"breakdowns": 0, "stages": {}}
    totals: Dict[str, float] = {}
    for b in items:
      for stage, entry in (b.get("stages") or {}).items():
        totals[stage] = totals.get(stage, 0.0) + float(entry.get("secs", 0.0))
    grand = sum(totals.values()) or 1.0
    stages = {s: {"secs_mean": round(v / len(items), 6),
                  "share": round(v / grand, 4)}
              for s, v in sorted(totals.items(), key=lambda kv: -kv[1])}
    return {"breakdowns": len(items), "stages": stages}

  def diff(self, window_s: float, now: Optional[float] = None) -> Dict[str, Any]:
    """Which stage grew: mean per-stage seconds in [now-w, now] vs the
    window before it ([now-2w, now-w)). `grown` names the stage with the
    largest absolute increase (None when either window is empty)."""
    now = time.time() if now is None else now
    window_s = max(1e-3, float(window_s))
    recent_w: Dict[str, List[float]] = {}
    prev_w: Dict[str, List[float]] = {}
    n_recent = n_prev = 0
    for b in self.recent():
      at = float(b.get("computed_at") or 0.0)
      if now - window_s <= at <= now:
        bucket, count = recent_w, True
        n_recent += 1
      elif now - 2 * window_s <= at < now - window_s:
        bucket, count = prev_w, True
        n_prev += 1
      else:
        continue
      for stage, entry in (b.get("stages") or {}).items():
        bucket.setdefault(stage, []).append(float(entry.get("secs", 0.0)))

    def means(b: Dict[str, List[float]], n: int) -> Dict[str, float]:
      # Mean over the WINDOW's breakdowns (a stage absent from a breakdown
      # contributed 0 to it), so windows with different stage sets compare.
      return {s: round(sum(v) / max(1, n), 6) for s, v in b.items()}

    recent_m, prev_m = means(recent_w, n_recent), means(prev_w, n_prev)
    delta = {s: round(recent_m.get(s, 0.0) - prev_m.get(s, 0.0), 6)
             for s in set(recent_m) | set(prev_m)}
    grown = None
    if n_recent and n_prev:
      candidates = [(v, s) for s, v in delta.items() if v > 0]
      if candidates:
        grown = max(candidates)[1]
    return {"window_s": window_s, "recent": {"n": n_recent, "stages": recent_m},
            "previous": {"n": n_prev, "stages": prev_m},
            "delta": delta, "grown": grown}

  def gauge_stats(self) -> Dict[str, float]:
    """/metrics gauge values. Keys are the exposition table's row keys."""
    items = self.recent(64)
    shares = [float((b.get("stages") or {}).get("unattributed", {}).get("share", 0.0))
              for b in items]
    return {
      "breakdowns": float(len(self.recent())),
      "unattributed_share": round(sum(shares) / len(shares), 4) if shares else 0.0,
    }


# --------------------------------------------------------- chrome export

def chrome_trace(spans: Iterable[dict], offsets: Optional[Dict[str, dict]] = None
                 ) -> List[dict]:
  """Chrome trace-event JSON (Perfetto-loadable) from OTLP-style span
  dicts, with timestamps re-based onto the origin's clock when `offsets`
  are known. One Chrome 'process' per ring node; span attributes ride as
  event args."""
  pids: Dict[str, int] = {}
  events: List[dict] = []
  for span in spans:
    times = _span_times(span)
    if times is None:
      continue
    node = _span_node(span) or "?"
    if node not in pids:
      pids[node] = len(pids) + 1
      events.append({"ph": "M", "name": "process_name", "pid": pids[node],
                     "tid": 0, "args": {"name": node}})
    shift = float(((offsets or {}).get(node) or {}).get("offset_ns") or 0.0)
    attrs = {a["key"]: a.get("value") for a in span.get("attributes") or ()
             if isinstance(a, dict) and "key" in a}
    events.append({
      "ph": "X",
      "name": str(span.get("name") or ""),
      "pid": pids[node],
      "tid": 1,
      "ts": (times[0] - shift) / 1e3,   # trace-event ts/dur are microseconds
      "dur": (times[1] - times[0]) / 1e3,
      "cat": "xot",
      "args": {**attrs, "trace_id": span.get("traceId"),
               "span_id": span.get("spanId"), "status": span.get("status")},
    })
  return events
