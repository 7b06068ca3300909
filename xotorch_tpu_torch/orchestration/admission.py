"""Bounded admission control at the origin node — overload becomes 429s.

The port's copy of xotorch_tpu/orchestration/admission.py. Open-loop load above ring
capacity grows an unbounded queue until requests time out inside the ring. This gate
closes that gap at the only place that knows a request exists before the ring does:
the origin node's API front door.

- `XOT_MAX_INFLIGHT` (default 0 = off, byte-identical to today): at most
  this many requests are admitted into the ring concurrently.
- `XOT_ADMIT_QUEUE_DEPTH`: over-limit arrivals wait in a bounded FIFO;
  beyond it they are REJECTED — the API answers HTTP 429 with `Retry-After`
  and the queue position, never a watchdog abort.
- Estimated wait is derived from the cost model's observed per-request
  tok/s (engine EWMA decode throughput x the node's average completion
  length), falling back to the request-latency histogram mean — so the
  router can place by measured load, not guesswork.

The queue is the lookahead the PRESERVE-style anticipatory KV prefetch
(arXiv 2501.08192) has been waiting on: the API fires the engine's
host-to-HBM prefix restore the moment a request QUEUES, so by admission its
warm prefix is already resident (see `Node.prefetch_prompt`).

Pure asyncio, single event loop, no locks: admit/release/grant all run on
the node's loop, so counter updates are atomic by cooperative scheduling.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Optional, Tuple

from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG


class AdmissionRejected(Exception):
  """The admission queue is full: the caller must answer 429, never block.
  Carries what the client needs to come back intelligently."""

  def __init__(self, queued: int, limit: int, retry_after_s: float):
    super().__init__(f"admission queue full ({queued}/{limit})")
    self.queued = queued
    self.limit = limit
    self.retry_after_s = retry_after_s


class AdmissionGate:
  """Per-node bounded admission: max_inflight slots + a FIFO wait queue.

  Disabled (max_inflight == 0, the shipped default) every method is a
  no-op returning "admitted" — zero new state, zero new wire bytes, the
  defaults-off parity the fault suite proves byte-identical."""

  def __init__(self, node):
    self.node = node
    self.max_inflight = max(0, knobs.get_int("XOT_MAX_INFLIGHT"))
    self.queue_limit = max(0, knobs.get_int("XOT_ADMIT_QUEUE_DEPTH"))
    self.enabled = self.max_inflight > 0
    self.inflight = 0
    self._queue: deque = deque()  # (future, request_id) FIFO
    self.admitted_total = 0
    self.queued_total = 0
    self.rejected_total = 0
    # Queue-depth marks for the trailing high-water view: the fleet
    # controller's scale-up signal polls /v1/queue on a cadence, and a
    # burst that queued and drained BETWEEN two polls must still be
    # visible — the instantaneous depth alone under-reports exactly the
    # surges elasticity exists for. Time-windowed (not reset-on-read): the
    # status-bus rollup and the router poll both read compact(), and a
    # read-reset would let one consumer steal the other's burst.
    self._hwm_marks: deque = deque()  # (monotonic ts, depth after append)
    self.hwm_window_s = 30.0

  # -------------------------------------------------------------- admission

  def admit(self, request_id: str) -> Tuple[str, Optional[asyncio.Future]]:
    """("admitted", None) when a slot is free, ("queued", future) when the
    request must wait (await the future; it resolves at its turn), raises
    AdmissionRejected when the bounded queue is full."""
    if not self.enabled:
      return "admitted", None
    if self.inflight < self.max_inflight and not self._queue:
      self.inflight += 1
      self.admitted_total += 1
      return "admitted", None
    if len(self._queue) >= self.queue_limit:
      self.rejected_total += 1
      self.node.metrics.admission_rejections_total.inc()
      retry = self.estimate_wait_s(len(self._queue) + self.inflight)
      self.node.flight.record("admission.rejected", request_id,
                              queued=len(self._queue), limit=self.queue_limit,
                              retry_after_s=round(retry, 2))
      if DEBUG >= 1:
        print(f"[{request_id}] admission rejected: queue {len(self._queue)}/{self.queue_limit}")
      raise AdmissionRejected(len(self._queue), self.queue_limit, retry)
    fut: asyncio.Future = asyncio.get_running_loop().create_future()
    self._queue.append((fut, request_id))
    self.queued_total += 1
    self._hwm_marks.append((time.monotonic(), len(self._queue)))
    self.node.metrics.admit_queue_depth.set(len(self._queue))
    self.node.flight.record("admission.queued", request_id,
                            position=len(self._queue), inflight=self.inflight)
    return "queued", fut

  async def acquire(self, request_id: str, on_queued=None) -> bool:
    """Admit, waiting in the queue if needed. Returns True when a slot is
    HELD (the caller must release()); a cancelled wait (client gone,
    timeout middleware) cleans itself out of the queue and holds nothing.
    Raises AdmissionRejected when the queue is full. `on_queued` fires
    (once, synchronously) only when the request actually waits — the
    anticipatory-prefetch hook's queue-lookahead signal."""
    state, fut = self.admit(request_id)
    if fut is None:
      return self.enabled
    if on_queued is not None:
      try:
        on_queued()
      except Exception as e:
        if DEBUG >= 1:
          print(f"[{request_id}] admission on_queued hook failed: {e!r}")
    try:
      await fut
      return True
    except asyncio.CancelledError:
      if fut.done() and not fut.cancelled():
        # Granted in the same tick the waiter died: the slot is ours to
        # give back, or it leaks forever.
        self.release()
      else:
        try:
          self._queue.remove((fut, request_id))
        except ValueError:
          pass
        self.node.metrics.admit_queue_depth.set(len(self._queue))
      raise

  def release(self) -> None:
    """Return a held slot and hand it to the oldest live waiter."""
    if not self.enabled:
      return
    self.inflight = max(0, self.inflight - 1)
    while self._queue and self.inflight < self.max_inflight:
      fut, _rid = self._queue.popleft()
      if fut.cancelled():
        continue
      self.inflight += 1
      self.admitted_total += 1
      fut.set_result(None)
    self.node.metrics.admit_queue_depth.set(len(self._queue))

  # ------------------------------------------------------------- estimation

  def service_time_s(self) -> float:
    """Estimated seconds one admitted request occupies a slot. First choice
    is the cost-model-backed view: the engine's EWMA decode tok/s (perf
    attribution) against this node's observed tokens-per-request;
    falls back to the request-latency histogram mean, then to 1 s (a fresh
    node has no evidence either way)."""
    metrics = self.node.metrics
    requests = metrics.requests_total.get()
    tokens = metrics.tokens_total.get()
    perf_fn = getattr(self.node.inference_engine, "perf_stats", None)
    perf = perf_fn() if callable(perf_fn) else None
    tok_s = float((perf or {}).get("decode_tok_s") or 0.0)
    if tok_s > 1e-6 and requests >= 1 and tokens >= 1:
      return max(1e-3, (tokens / requests) / tok_s)
    hsum = metrics.request_latency.sum()
    hcount = sum(metrics.request_latency.counts())
    if hcount >= 1:
      return max(1e-3, hsum / hcount)
    return 1.0

  def estimate_wait_s(self, requests_ahead: Optional[int] = None) -> float:
    """Expected queue wait with `requests_ahead` requests to serve before
    ours (default: the current inflight + queued population). The gate
    serves max_inflight requests concurrently, so the wait is waves of
    service time, not a serial sum."""
    if not self.enabled:
      return 0.0
    if requests_ahead is None:
      requests_ahead = self.inflight + len(self._queue)
    waves = requests_ahead / max(1, self.max_inflight)
    return round(waves * self.service_time_s(), 3)

  # ---------------------------------------------------------------- exports

  def queued_hwm(self, now: Optional[float] = None) -> int:
    """Deepest the queue has been over the trailing `hwm_window_s` seconds
    (never less than the live depth). Idempotent — every reader sees the
    same trailing burst."""
    now = time.monotonic() if now is None else now
    while self._hwm_marks and now - self._hwm_marks[0][0] > self.hwm_window_s:
      self._hwm_marks.popleft()
    peak = max((depth for _, depth in self._hwm_marks), default=0)
    return max(peak, len(self._queue))

  def compact(self) -> dict:
    """The /v1/queue body's local half; also rides `metrics_summary()` over
    the status bus (only while enabled — defaults-off adds no wire bytes)
    so the router and peers can place by load."""
    return {
      "max_inflight": self.max_inflight,
      "queue_limit": self.queue_limit,
      "inflight": self.inflight,
      "queued": len(self._queue),
      "queued_hwm": self.queued_hwm(),
      "admitted_total": self.admitted_total,
      "queued_total": self.queued_total,
      "rejected_total": self.rejected_total,
      "est_wait_s": self.estimate_wait_s(),
      "ts": time.time(),
    }
