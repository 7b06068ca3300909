"""In-process peer handle, for tests and for partitions that share one process.

The port of xotorch_tpu/networking/inprocess.py: the hop hands the tensor straight to
the target Node, with no framing and no socket. Prompt and tensor hops run detached,
as the TCP server acks and processes in the background, so a hop never holds the
sender's coroutine chain. Every RPC passes the fault injector's tap (faults.apply), as
the TCP handle's do, so injected faults exercise the same retry, dedup and watchdog
machinery in one process: a lost ack after a delivered hop, a sink that acks and
drops, and a killed peer that fails every RPC and its health check.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.networking import faults
from xotorch_tpu_torch.networking.peer_handle import PeerHandle
from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities
from xotorch_tpu_torch.topology.topology import Topology
from xotorch_tpu_torch.utils.helpers import spawn_detached


class InProcessPeerHandle(PeerHandle):
  def __init__(self, node):
    self.node = node
    self._tasks: set = set()  # strong refs: the loop holds tasks only weakly

  def id(self) -> str:
    return self.node.id

  def addr(self) -> str:
    return "inprocess"

  def description(self) -> str:
    return "in-process"

  def device_capabilities(self) -> DeviceCapabilities:
    return self.node.device_capabilities

  async def connect(self) -> None:
    pass

  async def is_connected(self) -> bool:
    return True

  async def disconnect(self, grace: Optional[float] = None) -> None:
    pass

  async def health_check(self) -> bool:
    # The transport cannot fail in one process; only an injected kill can.
    return not faults.peer_killed(self.node.id)

  async def send_prompt(self, shard: Shard, prompt: str, request_id: Optional[str] = None,
                        traceparent: Optional[str] = None, max_tokens: Optional[int] = None,
                        images: Optional[list] = None, temperature: Optional[float] = None,
                        top_p: Optional[float] = None, ring_map: Optional[list] = None,
                        deadline: Optional[float] = None) -> None:
    await self._hop("SendPrompt", request_id, lambda: self.node.process_prompt(
      shard, prompt, request_id, traceparent=traceparent, max_tokens=max_tokens, images=images,
      temperature=temperature, top_p=top_p, ring_map=ring_map, deadline=deadline))

  async def send_tensor(self, shard: Shard, tensor, request_id: Optional[str] = None,
                        inference_state: Optional[dict] = None) -> None:
    await self._hop("SendTensor", request_id,
                    lambda: self.node.process_tensor(shard, tensor, request_id, inference_state))

  async def send_example(self, shard: Shard, example, target, length, train: bool,
                         request_id: Optional[str] = None,
                         ring_map: Optional[list] = None) -> Optional[Tuple[float, object]]:
    await faults.apply("SendExample", self.node.id)  # a killed peer fails training hops too
    loss, grads = await self.node.process_example(shard, example, target, length, train, request_id,
                                                  ring_map=ring_map)
    return (loss, grads) if loss is not None else None

  async def _hop(self, rpc: str, request_id: Optional[str], work) -> None:
    """One prompt or tensor hop: the sender's `hop.send` flight event, then each
    attempt through the injector's tap, the sender's clock stamp delivered to the
    target's skew estimator and the work spawned unless the target already has this
    hop's sequence id, with the retries and the RTT of the TCP handle."""
    seq = faults.hop_seq()
    if self.flight is not None:
      self.flight.record("hop.send", request_id, rpc=rpc, peer=self.node.id, seq=seq)
    # Stamped once, as the TCP frame is: a retried delivery carries the same stamp.
    clk = self.hop_clock_stamp()

    async def attempt():
      flags = await faults.apply(rpc, self.node.id)
      if not flags["sink"]:
        # A sunk delivery feeds nothing to the receiver, its skew estimator included.
        clock = getattr(self.node, "clock", None)
        if clk is not None and clock is not None:
          clock.note(clk)
        if self.node.note_hop_delivery(request_id, seq):
          spawn_detached(work(), self._tasks)
      if flags["lost_ack"]:
        raise faults.TransientHopError(f"injected lost ack on {rpc} to {self.node.id}")

    t0 = time.monotonic()
    await faults.with_hop_retries(attempt)
    self.note_hop_rtt(time.monotonic() - t0)

  async def send_result(self, request_id: str, result, is_finished: bool,
                        error: Optional[str] = None,
                        total_len: Optional[int] = None) -> Optional[dict]:
    async def attempt():
      flags = await faults.apply("SendResult", self.node.id)
      if flags["sink"]:
        return {"ok": True}
      tokens = [int(t) for t in np.asarray(result).reshape(-1)]
      applied, have = await self.node.ingest_remote_result(request_id, tokens, total_len, is_finished,
                                                           error=error)
      if flags["lost_ack"]:
        # A redelivery is idempotent here: the ingest ignores what it already holds.
        raise faults.TransientHopError(f"injected lost ack on SendResult to {self.node.id}")
      return {"ok": True, "applied": applied, "have": have}

    return await faults.with_hop_retries(attempt)

  async def send_opaque_status(self, request_id: str, status: str) -> None:
    await faults.apply("SendOpaqueStatus", self.node.id)
    self.node.on_opaque_status.trigger_all(request_id, status)

  async def collect_topology(self, visited: set, max_depth: int) -> Topology:
    await faults.apply("CollectTopology", self.node.id)
    return await self.node.collect_topology(set(visited), max_depth)
