"""PeerHandle ABC: one peer's view of another peer.

The port's copy of xotorch_tpu/networking/peer_handle.py, with JAX's methods. The
tensor methods take numpy arrays or CPU torch tensors (bf16 hidden states); the
orchestration layer never sees transport details. (The JAX package's per-peer hop RTT
average feeds its alert engine, which the port does not have yet.)
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities
from xotorch_tpu_torch.topology.topology import Topology


class PeerHandle(ABC):
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
    time (carried for the JAX package's watchdog; the port does not enforce it yet)."""
    ...

  @abstractmethod
  async def send_tensor(self, shard: Shard, tensor, request_id: Optional[str] = None,
                        inference_state: Optional[dict] = None) -> None:
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
