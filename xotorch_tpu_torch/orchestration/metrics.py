"""Prometheus metrics for a Node, on the standard library.

The port's copy of xotorch_tpu/orchestration/metrics.py: the same metric families,
names, labels, buckets and summary, with the text exposition written here instead of
by `prometheus_client` (the port imports no client library). Each Node owns its
registry (no process-global state, so several nodes in one process do not collide)
and the API serves it at `/metrics`.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

# Histogram keys a NodeMetrics.summary() may carry (counters ride alongside);
# the cluster rollup aggregates exactly these families across peers.
HISTOGRAM_KEYS = (
  "ttft_seconds", "request_seconds", "queue_wait_decode_seconds",
  "queue_wait_prefill_seconds", "token_seconds", "hop_seconds",
)


def _le_value(le) -> float:
  return float("inf") if le in ("+Inf", "inf") else float(le)


def quantile_from_buckets(buckets: Iterable, q: float) -> Optional[float]:
  """PromQL-style histogram_quantile over CUMULATIVE bucket rows
  [[le, cumulative_count], ...] (le ascending, '+Inf' JSON-safe as the last
  bound). Linear interpolation inside the containing bucket; a quantile
  landing in the +Inf bucket reports the highest finite bound (the honest
  answer bucketed data can give). None for an empty histogram."""
  rows = [(_le_value(le), float(c)) for le, c in buckets]
  if not rows or rows[-1][1] <= 0:
    return None
  total = rows[-1][1]
  rank = max(0.0, min(1.0, q)) * total
  prev_le, prev_c = 0.0, 0.0
  for le, c in rows:
    if c >= rank:
      if le == float("inf"):
        return prev_le  # beyond the last finite bound: report that bound
      if c == prev_c:
        return le
      frac = (rank - prev_c) / (c - prev_c)
      return prev_le + (le - prev_le) * frac
    prev_le, prev_c = le, c
  return rows[-1][0] if rows[-1][0] != float("inf") else prev_le


def quantile_bucket_span(buckets: Iterable, q: float) -> Optional[float]:
  """Width of the bucket quantile `q` lands in — the bound on how far the
  interpolated `quantile_from_buckets` value can sit from the true sample
  quantile. 0.0 when the quantile lands in the +Inf bucket: the reported
  value is already truncated DOWN to the last finite bound, so it cannot
  over-state. None for an empty histogram."""
  rows = [(_le_value(le), float(c)) for le, c in buckets]
  if not rows or rows[-1][1] <= 0:
    return None
  rank = max(0.0, min(1.0, q)) * rows[-1][1]
  prev_le, prev_c = 0.0, 0.0
  for le, c in rows:
    if c >= rank:
      return 0.0 if le == float("inf") else le - prev_le
    prev_le, prev_c = le, c
  return 0.0


def merge_bucket_rows(rows_per_node: Iterable[Iterable]) -> List[list]:
  """Sum cumulative bucket rows across nodes (all NodeMetrics share one
  bucket layout per family; a node reporting a different layout is summed
  by bound, missing bounds contribute nothing)."""
  acc: Dict[float, float] = {}
  labels: Dict[float, object] = {}
  for rows in rows_per_node:
    for le, c in rows:
      v = _le_value(le)
      acc[v] = acc.get(v, 0.0) + float(c)
      labels.setdefault(v, le)
  return [[labels[v], acc[v]] for v in sorted(acc)]


def aggregate_histograms(summaries: Iterable[dict],
                         quantiles=(0.5, 0.95, 0.99)) -> Dict[str, dict]:
  """Ring-wide percentile view over per-node metric summaries (the
  /v1/cluster/metrics rollup): bucket counts merged per histogram family,
  then p50/p95/p99 computed from the merged distribution. Families absent
  from every summary (old peers that predate bucket export) are omitted —
  their sum/count rows still appear per node."""
  out: Dict[str, dict] = {}
  for key in HISTOGRAM_KEYS:
    rows_per_node, total_sum, total_count = [], 0.0, 0.0
    for s in summaries:
      h = s.get(key) if isinstance(s, dict) else None
      if not isinstance(h, dict):
        continue
      total_sum += float(h.get("sum", 0.0))
      total_count += float(h.get("count", 0.0))
      if h.get("buckets"):
        rows_per_node.append(h["buckets"])
    if not rows_per_node:
      continue
    merged = merge_bucket_rows(rows_per_node)
    entry = {"count": total_count, "sum": total_sum}
    for q in quantiles:
      entry[f"p{int(q * 100)}"] = quantile_from_buckets(merged, q)
    out[key] = entry
  return out


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def format_value(d: float) -> str:
  """A sample value as Prometheus' Go text format writes it (`prometheus_client`'s
  floatToGoString): repr, +Inf/-Inf/NaN, and an exponent past six integer digits."""
  d = float(d)
  if d == float("inf"):
    return "+Inf"
  if d == float("-inf"):
    return "-Inf"
  if math.isnan(d):
    return "NaN"
  s = repr(d)
  dot = s.find(".")
  if d > 0 and dot > 6:
    mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
    return f"{mantissa}e+0{dot - 1}"
  return s


def _labels(labels: Dict[str, str]) -> str:
  return "{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())) + "}"


class _Cell:
  """One labelled counter or gauge value. Thread-safe: the engine's executor thread
  and the event loop both update cells."""

  def __init__(self, labels: Dict[str, str]):
    self.labels = labels
    self.created = time.time()
    self._value = 0.0
    self._fn = None
    self._lock = threading.Lock()

  def inc(self, amount: float = 1.0) -> None:
    with self._lock:
      self._value += amount

  def set(self, value: float) -> None:
    with self._lock:
      self._value = float(value)

  def set_function(self, fn) -> None:
    self._fn = fn

  def get(self) -> float:
    if self._fn is not None:
      return float(self._fn())
    with self._lock:
      return self._value


class _HistogramCell:
  """One labelled histogram: per-bucket (non-cumulative) counts and the sum."""

  def __init__(self, labels: Dict[str, str], buckets):
    self.labels = labels
    self.created = time.time()
    self.upper_bounds = tuple(float(b) for b in buckets) + (float("inf"),)
    self._counts = [0.0] * len(self.upper_bounds)
    self._sum = 0.0
    self._lock = threading.Lock()

  def observe(self, amount: float) -> None:
    with self._lock:
      self._sum += amount
      for i, bound in enumerate(self.upper_bounds):
        if amount <= bound:
          self._counts[i] += 1
          break

  def counts(self) -> List[float]:
    with self._lock:
      return list(self._counts)

  def sum(self) -> float:
    with self._lock:
      return self._sum


class _Family:
  """A metric family of `kind` (counter, gauge, histogram) with its labelled cells."""

  def __init__(self, registry: List["_Family"], kind: str, name: str, doc: str,
               buckets=None):
    self.kind, self.name, self.doc, self.buckets = kind, name, doc, buckets
    self.cells: List[Any] = []
    registry.append(self)

  def labels(self, **labels):
    cell = (_HistogramCell(labels, self.buckets) if self.kind == "histogram"
            else _Cell(labels))
    self.cells.append(cell)
    return cell

  def exposition(self) -> str:
    """The family in the text format, with the `_created` gauge `prometheus_client`
    writes beside each counter and histogram."""
    base = self.name[:-len("_total")] if self.kind == "counter" else self.name
    out = [f"# HELP {self.name} {self.doc}\n# TYPE {self.name} {self.kind}\n"]
    for c in self.cells:
      if self.kind != "histogram":
        out.append(f"{self.name}{_labels(c.labels)} {format_value(c.get())}\n")
        continue
      acc = 0.0
      for bound, n in zip(c.upper_bounds, c.counts()):
        acc += n
        out.append(f"{self.name}_bucket{_labels({**c.labels, 'le': format_value(bound)})} "
                   f"{format_value(acc)}\n")
      out.append(f"{self.name}_count{_labels(c.labels)} {format_value(acc)}\n")
      out.append(f"{self.name}_sum{_labels(c.labels)} {format_value(c.sum())}\n")
    if self.kind != "gauge":
      out.append(f"# HELP {base}_created {self.doc}\n# TYPE {base}_created gauge\n")
      out.extend(f"{base}_created{_labels(c.labels)} {format_value(c.created)}\n"
                 for c in self.cells)
    return "".join(out)


class NodeMetrics:
  def __init__(self, node_id: str = ""):
    self.registry: List[_Family] = []
    labels = {"node_id": node_id}

    def metric(kind: str, name: str, doc: str, buckets=None):
      return _Family(self.registry, kind, name, doc, buckets).labels(**labels)

    # Process birth stamps: wall for humans, monotonic for arithmetic. The
    # uptime gauge lets history samplers and soak verdicts tell a
    # restart-induced counter reset (uptime collapsed) from a genuine drop.
    self.started_at = time.time()
    self._started_mono = time.monotonic()
    self.uptime = metric("gauge", "xot_uptime_seconds", "Seconds since this node process started")
    self.uptime.set_function(self.uptime_s)
    self.requests_total = metric("counter", "xot_requests_total", "Prompts accepted by this node")
    self.tokens_total = metric("counter", "xot_tokens_total",
                               "Tokens sampled by this node (last-layer only)")
    self.tensor_hops_total = metric("counter", "xot_tensor_hops_total",
                                    "Tensor hops processed (ring receives)")
    self.active_requests = metric("gauge", "xot_active_requests",
                                  "Requests currently in flight on this node")
    self.peers = metric("gauge", "xot_peers", "Connected peers")
    hop_buckets = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)
    self.token_latency = metric("histogram", "xot_token_seconds",
                                "Per-token wall time at the sampler", hop_buckets)
    self.hop_latency = metric("histogram", "xot_hop_seconds",
                              "Per-hop processing time (infer_tensor)", hop_buckets)
    # SLO histograms: TTFT and whole-request latency are observed by whichever node
    # samples/finishes (per-node view, labeled); queue wait is observed by the engine's
    # decode batcher, split by lane (decode chunk vs co-scheduled prefill slice).
    self.ttft = metric("histogram", "xot_ttft_seconds",
                       "Time from prompt acceptance to the first sampled token",
                       (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
    self.request_latency = metric(
      "histogram", "xot_request_seconds",
      "Whole-request wall time (first touch to finish, any outcome)",
      (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0))
    queue_wait = _Family(
      self.registry, "histogram", "xot_queue_wait_seconds",
      "Time a decode chunk or prefill slice waited in the engine batcher before dispatch",
      (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5))
    self.queue_wait_decode = queue_wait.labels(node_id=node_id, lane="decode")
    self.queue_wait_prefill = queue_wait.labels(node_id=node_id, lane="prefill")
    # Request-survivability counters: watchdog aborts, health-driven evictions, API-side
    # transparent restarts and retried hop deliveries dropped by receiver-side dedup
    # (Node._watchdog_loop, Node._evict_peer, the API's _restart_request,
    # Node.note_hop_delivery).
    self.watchdog_aborts_total = metric("counter", "xot_watchdog_aborts_total",
                                        "Requests aborted by the deadline/stall watchdog")
    self.peer_evictions_total = metric("counter", "xot_peer_evictions_total",
                                       "Peers evicted after failed health checks")
    self.request_restarts_total = metric(
      "counter", "xot_request_restarts_total",
      "Requests transparently restarted by the API after a ring failure")
    self.dedup_drops_total = metric("counter", "xot_dedup_drops_total",
                                    "Retried hop deliveries dropped by receiver-side dedup")
    # Terminal request failures (any abort): the numerator of the error-rate SLO rule.
    self.requests_failed_total = metric(
      "counter", "xot_requests_failed_total",
      "Requests that ended in an abort on this node (any cause)")
    # Admission control (XOT_MAX_INFLIGHT / XOT_ADMIT_QUEUE_DEPTH): requests shed as
    # 429s at the front door, and the live bounded-queue depth.
    self.admission_rejections_total = metric(
      "counter", "xot_admission_rejections_total",
      "Requests rejected 429 at the admission gate (bounded queue full)")
    self.admit_queue_depth = metric("gauge", "xot_admit_queue_depth",
                                    "Requests currently waiting in the admission queue")

  def uptime_s(self) -> float:
    return time.monotonic() - self._started_mono

  def exposition(self) -> bytes:
    body = "".join(f.exposition() for f in self.registry)
    # Transport-layer survivability counters are process-wide (peer handles have no
    # Node back-reference, so no per-node registry can own them); appended as plain
    # exposition lines, like the engine counters the API appends.
    from xotorch_tpu_torch.networking.faults import COUNTERS
    extra = []
    for key, name, help_text in (
      ("hop_retries", "xot_hop_retries_total",
       "Transient hop failures retried by peer handles (XOT_HOP_RETRIES)"),
      ("health_check_failures", "xot_health_check_failures_total",
       "Peer health checks that failed (health monitor sweeps)"),
    ):
      extra.append(f"# HELP {name} {help_text}\n# TYPE {name} counter\n{name} {COUNTERS.get(key, 0)}\n")
    return (body + "".join(extra)).encode()

  def exposition_with_content_type(self) -> tuple:
    return self.exposition(), CONTENT_TYPE

  def summary(self) -> dict:
    """Compact JSON-safe summary for the cluster metrics rollup: counters as
    numbers, histograms as {sum, count, buckets}. Rides the opaque-status bus so one
    /v1/cluster/metrics scrape on any node sees every peer."""
    def hist(metric):
      # Bucket counts ship CUMULATIVE (Prometheus exposition semantics, '+Inf' spelled
      # JSON-safe) so the cluster rollup can merge peers' rows and answer percentile
      # questions (aggregate_histograms); the sum/count pair alone cannot.
      acc = 0.0
      rows = []
      for le, c in zip(metric.upper_bounds, metric.counts()):
        acc += c
        rows.append(["+Inf" if le == float("inf") else le, acc])
      return {"sum": metric.sum(), "count": acc, "buckets": rows}

    out = {}
    for key, metric in (
      ("requests", self.requests_total), ("tokens", self.tokens_total),
      ("tensor_hops", self.tensor_hops_total), ("active_requests", self.active_requests),
      ("peers", self.peers), ("watchdog_aborts", self.watchdog_aborts_total),
      ("peer_evictions", self.peer_evictions_total),
      ("request_restarts", self.request_restarts_total),
      ("dedup_drops", self.dedup_drops_total),
      ("requests_failed", self.requests_failed_total),
    ):
      out[key] = metric.get()
    for key, metric in (
      ("ttft_seconds", self.ttft), ("request_seconds", self.request_latency),
      ("queue_wait_decode_seconds", self.queue_wait_decode),
      ("queue_wait_prefill_seconds", self.queue_wait_prefill),
      ("token_seconds", self.token_latency), ("hop_seconds", self.hop_latency),
    ):
      out[key] = hist(metric)
    return out
