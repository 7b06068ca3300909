"""TCP peer handle: the client side of every RPC.

The standard-library twin of xotorch_tpu/networking/grpc/peer_handle.py: lazy
connect with a 10 s timeout, 5 s health checks, XOT1 frames (bf16 stays bf16 on the
wire), and each call retried on transient failures per XOT_HOP_RETRIES with the same
frame, so the receiver can drop a redelivered hop by its sequence id. A call takes an
idle connection from a small pool or opens one, so concurrent calls to one peer never
queue behind each other; a connection whose call failed or timed out is closed, never
reused. `wire` counts, per method, the calls that reached the wire and their bytes.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.networking.codec import decode_message, encode_message
from xotorch_tpu_torch.networking.faults import hop_seq, with_hop_retries
from xotorch_tpu_torch.networking.peer_handle import PeerHandle
from xotorch_tpu_torch.networking.tcp.service import RPC_FIELD, read_frame, set_nodelay, write_frame
from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities
from xotorch_tpu_torch.topology.topology import Topology
from xotorch_tpu_torch.utils.helpers import DEBUG

_Conn = Tuple[asyncio.StreamReader, asyncio.StreamWriter]


class RemoteError(RuntimeError):
  """The peer answered the call with an error."""


class TCPPeerHandle(PeerHandle):
  max_idle = 4  # pooled connections kept open between calls

  def __init__(self, _id: str, address: str, desc: str, device_capabilities: DeviceCapabilities):
    self._id = _id
    self.address = address
    self.desc = desc
    self._device_capabilities = device_capabilities
    host, _, port = address.rpartition(":")
    self._host, self._port = host.strip("[]") or "localhost", int(port)
    self._idle: List[_Conn] = []
    # method -> [calls, bytes sent, bytes received], over attempts that reached the wire.
    self.wire: Dict[str, List[int]] = {}
    # Sends of hops ("SendPrompt", "SendTensor"): (method, seconds to the ack).
    self.hop_seconds: "deque[Tuple[str, float]]" = deque(maxlen=4096)

  def id(self) -> str:
    return self._id

  def addr(self) -> str:
    return self.address

  def description(self) -> str:
    return self.desc

  def device_capabilities(self) -> DeviceCapabilities:
    return self._device_capabilities

  # ------------------------------------------------------------ connections

  async def _open(self) -> _Conn:
    try:
      reader, writer = await asyncio.wait_for(asyncio.open_connection(self._host, self._port), 10.0)
    except OSError as e:
      raise ConnectionError(f"cannot connect to {self._id}@{self.address}: {e!r}") from e
    set_nodelay(writer)
    return reader, writer

  async def _checkout(self) -> _Conn:
    while self._idle:
      reader, writer = self._idle.pop()
      if not writer.is_closing() and not reader.at_eof():
        return reader, writer
      writer.close()
    return await self._open()

  def _checkin(self, conn: _Conn) -> None:
    if len(self._idle) < self.max_idle:
      self._idle.append(conn)
    else:
      conn[1].close()

  async def connect(self) -> None:
    if not self._idle:
      self._idle.append(await self._open())

  async def is_connected(self) -> bool:
    return any(not w.is_closing() for _, w in self._idle)

  async def disconnect(self, grace: Optional[float] = None) -> None:
    """Close the idle connections. A call in flight keeps its own connection to its
    end (so a replaced handle never cuts a hop short, with or without `grace`)."""
    idle, self._idle = self._idle, []
    for _, writer in idle:
      writer.close()

  # ----------------------------------------------------------------- calls

  async def _call(self, method: str, fields: dict, tensors: Optional[dict] = None,
                  timeout: float = 15.0, retriable: bool = True):
    """One RPC; the frame is encoded once, so every retry carries the same bytes."""
    frame = encode_message({RPC_FIELD: method, **fields}, tensors)

    async def attempt():
      reader, writer = await self._checkout()
      try:
        sent = write_frame(writer, frame)
        counts = self.wire.setdefault(method, [0, 0, 0])
        counts[0] += 1
        counts[1] += sent

        async def exchange() -> bytes:
          await writer.drain()
          return await read_frame(reader)
        reply = await asyncio.wait_for(exchange(), timeout)
        counts[2] += 4 + len(reply)
      except BaseException:
        writer.close()  # the stream's state is unknown: never reuse it
        raise
      self._checkin((reader, writer))
      out_fields, out_tensors = decode_message(reply)
      if "error" in out_fields:
        raise RemoteError(f"{method} to {self._id}: {out_fields['error']}")
      return out_fields, out_tensors

    return await with_hop_retries(attempt, retriable=retriable)

  async def health_check(self) -> bool:
    try:
      fields, _ = await asyncio.wait_for(self._call("HealthCheck", {}, retriable=False), timeout=5.0)
      return bool(fields.get("is_healthy"))
    except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError, RemoteError) as e:
      if DEBUG >= 4:
        print(f"Health check failed for {self._id}@{self.address}: {e!r}")
      return False

  async def _hop(self, method: str, fields: dict, tensors: Optional[dict]) -> None:
    t0 = time.perf_counter()
    await self._call(method, fields, tensors)
    self.hop_seconds.append((method, time.perf_counter() - t0))

  async def send_prompt(self, shard: Shard, prompt: str, request_id: Optional[str] = None,
                        traceparent: Optional[str] = None, max_tokens: Optional[int] = None,
                        images: Optional[list] = None, temperature: Optional[float] = None,
                        top_p: Optional[float] = None, ring_map: Optional[list] = None,
                        deadline: Optional[float] = None) -> None:
    tensors = {f"image_{i}": np.ascontiguousarray(img) for i, img in enumerate(images or [])}
    fields = {
      "shard": shard.to_dict(), "prompt": prompt, "request_id": request_id, "traceparent": traceparent,
      "max_tokens": max_tokens, "n_images": len(tensors) or None, "temperature": temperature,
      "top_p": top_p, "ring_map": ring_map, "deadline": deadline, "hop_seq": hop_seq(),
    }
    await self._hop("SendPrompt", fields, tensors or None)

  async def send_tensor(self, shard: Shard, tensor, request_id: Optional[str] = None,
                        inference_state: Optional[dict] = None) -> None:
    fields = {"shard": shard.to_dict(), "request_id": request_id,
              "inference_state": inference_state, "hop_seq": hop_seq()}
    await self._hop("SendTensor", fields, {"tensor": tensor})

  async def send_result(self, request_id: str, result, is_finished: bool,
                        error: Optional[str] = None,
                        total_len: Optional[int] = None) -> Optional[dict]:
    fields = {"request_id": request_id, "is_finished": is_finished, "error": error,
              "total_len": total_len}
    if isinstance(result, np.ndarray):
      ack, _ = await self._call("SendResult", fields, {"result": result})
    else:
      ack, _ = await self._call("SendResult", {**fields, "result": [int(t) for t in result]})
    return ack

  async def send_opaque_status(self, request_id: str, status: str) -> None:
    await self._call("SendOpaqueStatus", {"request_id": request_id, "status": status})

  async def collect_topology(self, visited: set, max_depth: int) -> Topology:
    fields, _ = await self._call("CollectTopology", {"visited": list(visited), "max_depth": max_depth},
                                 timeout=10.0)
    return Topology.from_json(fields["topology"])
