"""In-process peer handle, for tests and for partitions that share one process.

The port of xotorch_tpu/networking/inprocess.py: the hop hands the tensor straight to
the target Node, with no framing and no socket. Prompt and tensor hops run detached,
as the TCP server acks and processes in the background, so a hop never holds the
sender's coroutine chain. (The JAX handle's fault-injection hooks wait for the port
of the fault injector.)
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from xotorch_tpu_torch.inference.shard import Shard
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
    return True

  async def send_prompt(self, shard: Shard, prompt: str, request_id: Optional[str] = None,
                        traceparent: Optional[str] = None, max_tokens: Optional[int] = None,
                        images: Optional[list] = None, temperature: Optional[float] = None,
                        top_p: Optional[float] = None, ring_map: Optional[list] = None,
                        deadline: Optional[float] = None) -> None:
    spawn_detached(self.node.process_prompt(
      shard, prompt, request_id, traceparent=traceparent, max_tokens=max_tokens, images=images,
      temperature=temperature, top_p=top_p, ring_map=ring_map, deadline=deadline), self._tasks)

  async def send_tensor(self, shard: Shard, tensor, request_id: Optional[str] = None,
                        inference_state: Optional[dict] = None) -> None:
    spawn_detached(self.node.process_tensor(shard, tensor, request_id, inference_state), self._tasks)

  async def send_result(self, request_id: str, result, is_finished: bool,
                        error: Optional[str] = None,
                        total_len: Optional[int] = None) -> Optional[dict]:
    tokens = [int(t) for t in np.asarray(result).reshape(-1)]
    applied, have = await self.node.ingest_remote_result(request_id, tokens, total_len, is_finished,
                                                         error=error)
    return {"ok": True, "applied": applied, "have": have}

  async def send_opaque_status(self, request_id: str, status: str) -> None:
    self.node.on_opaque_status.trigger_all(request_id, status)

  async def collect_topology(self, visited: set, max_depth: int) -> Topology:
    return await self.node.collect_topology(set(visited), max_depth)
