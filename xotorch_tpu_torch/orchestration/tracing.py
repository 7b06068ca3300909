"""Distributed request tracing: per-request spans and the device trace.

The port's copy of xotorch_tpu/orchestration/tracing.py. Spans are recorded into a
bounded in-process buffer and exported as JSON at the API's `/v1/traces`; the span
dict layout matches the OTLP JSON field names (traceId/spanId/parentSpanId/name/
startTimeUnixNano/endTimeUnixNano/attributes) so an external collector can ingest
the export unchanged. A request's W3C `traceparent` rides the side-channels that
already cross the wire (the `inference_state` dict on tensor hops, `send_prompt`'s
field, the opaque-status JSON bus), so one request has one trace id on every peer.
Every 10 sampled tokens make one group span.

Device traces: `start_device_trace`/`stop_device_trace` run one `torch.profiler`
session (CPU and CUDA activity) in place of the JAX package's `jax.profiler`, and
write it as a Chrome trace into the log directory when it stops, so a request trace
can be read beside the kernels the card ran.
"""
from __future__ import annotations

import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from xotorch_tpu_torch.utils import knobs

TRACEPARENT_KEY = "traceparent"
_TOKEN_GROUP_SIZE = 10


@dataclass
class TraceContext:
  """W3C trace-context carrier (traceparent version 00)."""
  trace_id: str  # 32 hex chars
  span_id: str  # 16 hex chars (the parent for anything created from this ctx)
  sampled: bool = True

  def traceparent(self) -> str:
    return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"

  @classmethod
  def from_traceparent(cls, header: Optional[str]) -> Optional["TraceContext"]:
    if not header:
      return None
    parts = header.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
      return None
    return cls(trace_id=parts[1], span_id=parts[2], sampled=parts[3] == "01")

  @classmethod
  def new(cls) -> "TraceContext":
    return cls(trace_id=secrets.token_hex(16), span_id=secrets.token_hex(8))


@dataclass
class Span:
  name: str
  trace_id: str
  span_id: str
  parent_span_id: Optional[str]
  start_ns: int
  end_ns: Optional[int] = None
  attributes: Dict[str, Any] = field(default_factory=dict)
  status: str = "OK"
  # W3C `sampled` flag, inherited from the parent context: an unsampled
  # trace's spans still flow through call sites unconditionally but are
  # never appended to the export buffer.
  sampled: bool = True

  def end(self, status: str = "OK", end_ns: Optional[int] = None) -> None:
    if self.end_ns is None:
      self.end_ns = end_ns if end_ns is not None else time.time_ns()
      self.status = status

  def set_attribute(self, key: str, value: Any) -> None:
    self.attributes[key] = value

  def context(self) -> TraceContext:
    # Children inherit the sampling decision (W3C trace-context semantics):
    # a span created under an unsampled parent must itself be unsampled.
    return TraceContext(trace_id=self.trace_id, span_id=self.span_id, sampled=self.sampled)

  def to_dict(self) -> dict:
    return {
      "traceId": self.trace_id,
      "spanId": self.span_id,
      "parentSpanId": self.parent_span_id or "",
      "name": self.name,
      "startTimeUnixNano": self.start_ns,
      "endTimeUnixNano": self.end_ns or 0,
      "attributes": [{"key": k, "value": v} for k, v in self.attributes.items()],
      "status": self.status,
    }

  @classmethod
  def from_dict(cls, d: dict) -> "Span":
    """Inverse of to_dict, for spans that arrive from ANOTHER node over the
    opaque-status bus (cluster trace rollup)."""
    return cls(
      name=str(d.get("name", "")),
      trace_id=str(d.get("traceId", "")),
      span_id=str(d.get("spanId", "")),
      parent_span_id=str(d.get("parentSpanId") or "") or None,
      start_ns=int(d.get("startTimeUnixNano") or 0),
      end_ns=int(d.get("endTimeUnixNano") or 0) or None,
      attributes={a["key"]: a.get("value") for a in d.get("attributes", ())
                  if isinstance(a, dict) and "key" in a},
      status=str(d.get("status", "OK")),
    )


class _SpanHandle:
  """Context manager that ends the span (ERROR on exception)."""

  def __init__(self, tracer: "Tracer", span: Span):
    self._tracer = tracer
    self.span = span

  def __enter__(self) -> Span:
    return self.span

  def __exit__(self, exc_type, exc, tb) -> None:
    self._tracer.end_span(self.span, status="ERROR" if exc_type else "OK")


class Tracer:
  """Thread-safe span recorder with a bounded buffer.

  Enabled by default; set XOT_TRACING=0 to turn span recording into no-ops
  (span objects are still returned so call sites stay unconditional)."""

  def __init__(self, node_id: str = "", max_spans: int = 4096):
    self.node_id = node_id
    self.enabled = knobs.get_bool("XOT_TRACING")
    # The wall clock spans are stamped with. The owning Node rebinds this
    # to its ClockSkew collector's wall_ns, so an injected artificial skew
    # (XOT_ANATOMY_SKEW_NS — the offset-recovery test harness) shifts THIS
    # node's spans and hop stamps together, exactly like a genuinely
    # skewed host clock would.
    self.now_ns = time.time_ns
    self._finished: deque = deque(maxlen=max_spans)
    self._lock = threading.Lock()
    self._token_groups: Dict[str, Span] = {}
    self._token_counts: Dict[str, int] = {}
    # span ids already adopted via ingest() (bounded): the status bus fans
    # out to every peer, so the same remote span can arrive more than once.
    self._ingested: "deque" = deque(maxlen=8192)
    self._ingested_set: set = set()

  # ----------------------------------------------------------------- spans

  def start_span(self, name: str, parent: Optional[TraceContext] = None,
                 attributes: Optional[Dict[str, Any]] = None) -> _SpanHandle:
    if parent is None:
      parent = TraceContext.new()
      parent_span_id = None
    else:
      parent_span_id = parent.span_id
    span = Span(
      name=name,
      trace_id=parent.trace_id,
      span_id=secrets.token_hex(8),
      parent_span_id=parent_span_id,
      start_ns=self.now_ns(),
      attributes={"node.id": self.node_id, **(attributes or {})},
      sampled=parent.sampled,
    )
    return _SpanHandle(self, span)

  def end_span(self, span: Span, status: str = "OK") -> None:
    span.end(status, end_ns=self.now_ns())
    # W3C `sampled` flag honored for real: an unsampled trace's spans are
    # never buffered (the caller still gets a live span object, so call
    # sites stay unconditional).
    if self.enabled and span.sampled:
      with self._lock:
        self._finished.append(span)

  # ----------------------------------------------- token group spans (10x)

  def record_token(self, request_id: str, ctx: Optional[TraceContext]) -> None:
    """Group every 10 sampled tokens into one span under the request trace
    (a span per token is too chatty)."""
    if not self.enabled or (ctx is not None and not ctx.sampled):
      return
    with self._lock:
      count = self._token_counts.get(request_id, 0)
      entry = self._token_groups.get(request_id)
      if entry is None:
        parent = ctx or TraceContext.new()
        group = Span(
          name=f"tokens[{count}..{count + _TOKEN_GROUP_SIZE - 1}]",
          trace_id=parent.trace_id,
          span_id=secrets.token_hex(8),
          parent_span_id=ctx.span_id if ctx else None,
          start_ns=self.now_ns(),
          attributes={"node.id": self.node_id, "request.id": request_id},
        )
        entry = (group, count)
        self._token_groups[request_id] = entry
      group, group_start = entry
      self._token_counts[request_id] = count + 1
      group.set_attribute("token.count", self._token_counts[request_id] - group_start)
      if self._token_counts[request_id] % _TOKEN_GROUP_SIZE == 0:
        group.end(end_ns=self.now_ns())
        self._finished.append(group)
        del self._token_groups[request_id]

  def finish_request(self, request_id: str) -> None:
    """Flush a partial token-group span when a request completes."""
    with self._lock:
      entry = self._token_groups.pop(request_id, None)
      self._token_counts.pop(request_id, None)
      if entry is not None and self.enabled:
        group, _ = entry
        group.end(end_ns=self.now_ns())
        self._finished.append(group)

  # ---------------------------------------------------------------- export

  def ingest(self, span_dicts: List[dict]) -> int:
    """Adopt finished spans exported by ANOTHER node (cluster trace rollup:
    peers flush a request's spans over the opaque-status bus at finish, so
    one /v1/traces call returns the whole ring's trace). Deduped by span id
    — the bus fans out, so redeliveries are expected. Returns spans added."""
    if not self.enabled:
      return 0
    added = 0
    with self._lock:
      for d in span_dicts:
        try:
          span = Span.from_dict(d)
        except Exception:
          continue  # malformed remote span: skip, never poison the buffer
        if not span.span_id or span.span_id in self._ingested_set:
          continue
        if len(self._ingested) == self._ingested.maxlen:
          self._ingested_set.discard(self._ingested[0])
        self._ingested.append(span.span_id)
        self._ingested_set.add(span.span_id)
        self._finished.append(span)
        added += 1
    return added

  def export(self, trace_id: Optional[str] = None, clear: bool = False,
             node_id: Optional[str] = None) -> List[dict]:
    """Finished spans as OTLP-style dicts. `trace_id` filters one trace;
    `node_id` filters by the span's `node.id` attribute (used by the rollup
    flush to send only THIS node's shard of a trace, never re-broadcasting
    spans it ingested from peers)."""
    with self._lock:
      spans = [s.to_dict() for s in self._finished
               if (trace_id is None or s.trace_id == trace_id)
               and (node_id is None or s.attributes.get("node.id") == node_id)]
      if clear:
        if trace_id is None:
          self._finished.clear()
        else:
          # Drain only the requested trace; other traces stay readable and
          # the buffer keeps its max_spans bound.
          self._finished = deque(
            (s for s in self._finished if s.trace_id != trace_id),
            maxlen=self._finished.maxlen,
          )
    return spans


# --------------------------------------------------------- device traces

DEFAULT_TRACE_DIR = "/tmp/xot_torch_trace"


class _DeviceTrace:
  """The process's one torch.profiler session. The lock is held ACROSS the profiler
  calls, so of two racing starts the loser sees the winner's session and returns
  False. Each session gets an auto-stop timer (XOT_DEVICE_TRACE_MAX_S), so a
  forgotten start cannot profile forever (the profiler's buffers grow without
  bound); the generation check makes a timer stop only its own session. The profiler
  is started and stopped on one thread of its own: stopping it on another thread than
  the one that started it crashes the process."""

  def __init__(self):
    self.lock = threading.Lock()
    self.prof = None
    self.logdir: Optional[str] = None
    self.gen = 0
    self.timer: Optional[threading.Timer] = None
    self.last_file: Optional[str] = None
    self._thread = None  # a one-worker executor, made at the first start

  def on_thread(self, fn):
    """Run `fn` on the profiler's own thread and return its result."""
    if self._thread is None:
      from concurrent.futures import ThreadPoolExecutor
      self._thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="device-trace")
    return self._thread.submit(fn).result()

  def _stop_locked(self) -> None:
    import os
    try:
      self.on_thread(self.prof.stop)
      os.makedirs(self.logdir, exist_ok=True)
      path = os.path.join(self.logdir, f"xot_device_trace_{time.strftime('%Y%m%d-%H%M%S')}_{self.gen}.json")
      self.prof.export_chrome_trace(path)
      self.last_file = path
    finally:
      self.prof = None


DEVICE_TRACE = _DeviceTrace()


def _auto_stop_device_trace(gen: int) -> None:
  from xotorch_tpu_torch.models.graphs import CAPTURE_LOCK
  dt = DEVICE_TRACE
  with dt.lock:
    if dt.prof is None or gen != dt.gen:
      return  # manually stopped (and possibly restarted) before the cap hit
    with CAPTURE_LOCK:
      dt._stop_locked()


def start_device_trace(logdir: str = DEFAULT_TRACE_DIR) -> bool:
  """Start a torch.profiler session (CPU, and CUDA where a card is present) beside
  the span trace. Returns False if one is already running. No capture of a CUDA
  graph may run while the profiler starts or stops (a profiler session that starts
  inside a capture breaks it): both take `graphs.CAPTURE_LOCK`, which every capture
  holds. Auto-stops after XOT_DEVICE_TRACE_MAX_S seconds (0 disables the cap)."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  from xotorch_tpu_torch.models.graphs import CAPTURE_LOCK
  dt = DEVICE_TRACE
  with dt.lock:
    if dt.prof is not None:
      return False
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
      activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    with CAPTURE_LOCK:
      dt.on_thread(prof.start)
    dt.prof, dt.logdir = prof, logdir
    dt.gen += 1
    max_s = knobs.get_float("XOT_DEVICE_TRACE_MAX_S")
    if max_s and max_s > 0:
      dt.timer = threading.Timer(max_s, _auto_stop_device_trace, args=(dt.gen,))
      dt.timer.daemon = True
      dt.timer.start()
    return True


def stop_device_trace() -> bool:
  """Stop the session and write its Chrome trace into the start's log directory
  (`DEVICE_TRACE.last_file` names it). False when no session runs."""
  from xotorch_tpu_torch.models.graphs import CAPTURE_LOCK
  dt = DEVICE_TRACE
  with dt.lock:
    if dt.timer is not None:
      dt.timer.cancel()
      dt.timer = None
    if dt.prof is None:
      return False
    with CAPTURE_LOCK:
      dt._stop_locked()
    return True
