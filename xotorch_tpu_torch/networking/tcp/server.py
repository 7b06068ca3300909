"""TCP server: the process-boundary face of a Node.

The standard-library twin of xotorch_tpu/networking/grpc/server.py. Each connection
carries one call at a time (service.py); every RPC decodes its XOT1 frame and calls the
local Node. SendPrompt and SendTensor drop a redelivered hop (by its sequence id),
spawn the Node's work detached and answer at once, so two peers that send to each
other never wait on each other's work. SendExample answers that training is not
served: the port's ring serves inference only.
"""
from __future__ import annotations

import asyncio
from typing import Dict, Optional

from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.networking.codec import decode_message, encode_message
from xotorch_tpu_torch.networking.server import Server
from xotorch_tpu_torch.networking.tcp.service import RPC_FIELD, read_frame, set_nodelay, write_frame
from xotorch_tpu_torch.utils.helpers import DEBUG, spawn_detached


class TCPServer(Server):
  def __init__(self, node, host: str, port: int):
    self.node = node
    self.host = host
    self.port = port
    self.server: Optional[asyncio.AbstractServer] = None
    self._connections: set = set()
    self._detached: set = set()  # strong refs to spawned hop work
    self._handlers: Dict[str, object] = {
      "SendPrompt": self._rpc_send_prompt,
      "SendTensor": self._rpc_send_tensor,
      "SendExample": self._rpc_send_example,
      "CollectTopology": self._rpc_collect_topology,
      "SendResult": self._rpc_send_result,
      "SendOpaqueStatus": self._rpc_send_opaque_status,
      "HealthCheck": self._rpc_health_check,
    }

  async def start(self) -> None:
    self.server = await asyncio.start_server(self._serve_connection, self.host, self.port)
    if DEBUG >= 1:
      print(f"TCP server listening on {self.host}:{self.port}")

  async def stop(self) -> None:
    if self.server is None:
      return
    self.server.close()
    for writer in list(self._connections):
      writer.close()
    await self.server.wait_closed()
    self.server = None
    if DEBUG >= 1:
      print("TCP server stopped")

  async def _serve_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
    self._connections.add(writer)
    set_nodelay(writer)
    try:
      while True:
        try:
          frame = await read_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
          return  # the client closed the connection
        except ValueError as e:  # over the cap: the stream cannot be resynchronised
          if DEBUG >= 1:
            print(f"TCP server: {e}; closing the connection")
          return
        write_frame(writer, await self._answer(frame))
        await writer.drain()
    except ConnectionError:
      return
    finally:
      self._connections.discard(writer)
      writer.close()

  async def _answer(self, frame: bytes) -> bytes:
    try:
      fields, tensors = decode_message(frame)
    except (ValueError, KeyError) as e:
      return encode_message({"error": f"bad frame: {e}"})
    method = fields.pop(RPC_FIELD, None)
    handler = self._handlers.get(method)
    if handler is None:
      return encode_message({"error": f"unknown method {method!r}"})
    try:
      return await handler(fields, tensors)
    except Exception as e:  # the RPC boundary: the caller gets the error, the server lives on
      if DEBUG >= 1:
        print(f"TCP server: {method} failed: {e!r}")
      return encode_message({"error": f"{method} failed on {self.node.id}: {e!r}"})

  def _is_duplicate_hop(self, fields: dict) -> bool:
    """A retried delivery after a lost ack: the work is already queued. The check runs
    before the spawn, so a redelivery is a pure ack."""
    seq = fields.get("hop_seq")
    return seq is not None and not self.node.note_hop_delivery(fields.get("request_id"), seq)

  async def _rpc_send_prompt(self, fields: dict, tensors: dict) -> bytes:
    if self._is_duplicate_hop(fields):
      return encode_message({"ok": True, "dup": True})
    images = [tensors[f"image_{i}"] for i in range(fields.get("n_images") or 0)] or None
    spawn_detached(self.node.process_prompt(
      Shard.from_dict(fields["shard"]), fields["prompt"], fields.get("request_id"),
      traceparent=fields.get("traceparent"), max_tokens=fields.get("max_tokens"), images=images,
      temperature=fields.get("temperature"), top_p=fields.get("top_p"),
      ring_map=fields.get("ring_map"), deadline=fields.get("deadline"),
    ), self._detached)
    return encode_message({"ok": True})

  async def _rpc_send_tensor(self, fields: dict, tensors: dict) -> bytes:
    if self._is_duplicate_hop(fields):
      return encode_message({"ok": True, "dup": True})
    spawn_detached(self.node.process_tensor(
      Shard.from_dict(fields["shard"]), tensors["tensor"], fields.get("request_id"),
      fields.get("inference_state"),
    ), self._detached)
    return encode_message({"ok": True})

  async def _rpc_send_example(self, fields: dict, tensors: dict) -> bytes:
    return encode_message({"error": "SendExample is not served: training over the ring is not "
                                    "ported to xotorch_tpu_torch yet"})

  async def _rpc_collect_topology(self, fields: dict, tensors: dict) -> bytes:
    topology = await self.node.collect_topology(set(fields.get("visited", [])), fields.get("max_depth", 4))
    return encode_message({"topology": topology.to_json()})

  async def _rpc_send_result(self, fields: dict, tensors: dict) -> bytes:
    result = tensors["result"] if "result" in tensors else fields.get("result", [])
    applied, have = await self.node.ingest_remote_result(
      fields["request_id"], [int(t) for t in result], fields.get("total_len"),
      fields["is_finished"], error=fields.get("error"),
    )
    return encode_message({"ok": True, "applied": applied, "have": have})

  async def _rpc_send_opaque_status(self, fields: dict, tensors: dict) -> bytes:
    self.node.on_opaque_status.trigger_all(fields["request_id"], fields["status"])
    return encode_message({"ok": True})

  async def _rpc_health_check(self, fields: dict, tensors: dict) -> bytes:
    return encode_message({"is_healthy": True})
