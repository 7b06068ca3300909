"""PeerHandle ABC: one peer's view of another peer.

The port's copy of xotorch_tpu/networking/peer_handle.py, with JAX's methods. The
tensor methods take numpy arrays or CPU torch tensors (bf16 hidden states); the
orchestration layer never sees transport details. A handle carries the owning
node's observability hooks (`flight`, `clock`) and its own hop send RTT average
(`hop_rtt`, read by the alert engine's ring decomposition).
"""
from __future__ import annotations

import math
import time
from abc import ABC, abstractmethod
from typing import Optional, Tuple

from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities
from xotorch_tpu_torch.topology.topology import Topology
from xotorch_tpu_torch.utils import knobs


class HopRttEwma:
  """Irregular-interval EWMA of hop send round-trip seconds for ONE peer.

  The gray-failure signal: a peer that answers health checks but silently adds latency
  to every hop moves this number and nothing else. Fed from wall timestamps the
  handles already take around their send awaits (host clock only, no device work, no
  extra RPCs); exported as `xot_peer_hop_seconds{peer=...}`."""

  def __init__(self, tau_s: float = 30.0):
    self.tau_s = max(1e-3, float(tau_s))
    self._value: Optional[float] = None
    self._at: Optional[float] = None
    self.count = 0

  def observe(self, secs: float, now: Optional[float] = None) -> None:
    now = time.monotonic() if now is None else now
    if self._value is None:
      self._value = float(secs)
    else:
      alpha = 1.0 - math.exp(-max(1e-6, now - self._at) / self.tau_s)
      self._value += alpha * (float(secs) - self._value)
    self._at = now
    self.count += 1

  def value(self) -> Optional[float]:
    return self._value


class PeerHandle(ABC):
  # The owning node's FlightRecorder (attached when the node adopts the handle): hop
  # sends record `hop.send` events, with their dedup seq ids, in the SENDER's timeline.
  flight = None
  # This peer's hop send RTT EWMA, created at the first timed send.
  hop_rtt: Optional[HopRttEwma] = None
  # The owning node's ClockSkew collector: hop sends stamp the sender's wall-clock ns
  # into the optional `clock` field so receivers can estimate clock offsets
  # (orchestration/anatomy.py). None for a handle no node adopted: no stamps.
  clock = None

  def note_hop_rtt(self, secs: float) -> None:
    if self.hop_rtt is None:
      self.hop_rtt = HopRttEwma(knobs.get_float("XOT_ALERT_RTT_TAU_S"))
    self.hop_rtt.observe(secs)

  def hop_clock_stamp(self) -> Optional[dict]:
    """The sender's wall-clock stamp for this hop, or None (the field stays off the
    wire: XOT_ANATOMY=0 adds no bytes)."""
    return self.clock.stamp() if self.clock is not None else None

  @abstractmethod
  def id(self) -> str:
    ...

  @abstractmethod
  def addr(self) -> str:
    ...

  @abstractmethod
  def description(self) -> str:
    ...

  @abstractmethod
  def device_capabilities(self) -> DeviceCapabilities:
    ...

  @abstractmethod
  async def connect(self) -> None:
    ...

  @abstractmethod
  async def is_connected(self) -> bool:
    ...

  @abstractmethod
  async def disconnect(self, grace: Optional[float] = None) -> None:
    ...

  @abstractmethod
  async def health_check(self) -> bool:
    ...

  @abstractmethod
  async def send_prompt(self, shard: Shard, prompt: str, request_id: Optional[str] = None,
                        traceparent: Optional[str] = None, max_tokens: Optional[int] = None,
                        images: Optional[list] = None, temperature: Optional[float] = None,
                        top_p: Optional[float] = None, ring_map: Optional[list] = None,
                        deadline: Optional[float] = None) -> None:
    """`deadline` is the request's remaining end-to-end budget in seconds at send
    time: the receiving Node derives its own absolute deadline from it, and its
    watchdog aborts the request there when it passes."""
    ...

  @abstractmethod
  async def send_tensor(self, shard: Shard, tensor, request_id: Optional[str] = None,
                        inference_state: Optional[dict] = None) -> None:
    ...

  @abstractmethod
  async def send_example(self, shard: Shard, example, target, length, train: bool,
                         request_id: Optional[str] = None,
                         ring_map: Optional[list] = None) -> Optional[Tuple[float, object]]:
    """One training or evaluation example to the peer's partition, answered when the
    peer's slice and everything downstream of it have run: (loss, the gradient of the
    example's input, or None for an evaluation). Not retried: a step is not
    idempotent."""
    ...

  @abstractmethod
  async def send_result(self, request_id: str, result, is_finished: bool,
                        error: Optional[str] = None,
                        total_len: Optional[int] = None) -> Optional[dict]:
    """Deliver sampled tokens. With `total_len` (the sender's whole buffered length)
    `result` is a delta, the newly sampled tokens, and the receiver can detect a gap
    and ask for the full list through the returned ack ({"applied": bool, "have":
    int}); without it `result` is the full list."""
    ...

  @abstractmethod
  async def send_opaque_status(self, request_id: str, status: str) -> None:
    ...

  @abstractmethod
  async def collect_topology(self, visited: set, max_depth: int) -> Topology:
    ...
