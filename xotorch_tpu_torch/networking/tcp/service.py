"""Wire schema of the TCP transport, the standard-library twin of
xotorch_tpu/networking/grpc/service.py.

The JAX package carries XOT1 frames (networking/codec.py) over gRPC; the port, whose
card has no grpcio, carries the same frames over asyncio TCP streams. A call is one
frame, `u32 length | XOT1 message`, whose fields name the method under `rpc`; the
answer is one frame back on the same connection. The RPC surface is the gRPC
service's: SendPrompt, SendTensor, SendExample, CollectTopology, SendResult,
SendOpaqueStatus, HealthCheck. A frame is capped at 256 MB, as the gRPC channel's
messages are, and sockets set TCP_NODELAY.
"""
from __future__ import annotations

import asyncio
import socket
import struct

METHODS = (
  "SendPrompt",
  "SendTensor",
  "SendExample",
  "CollectTopology",
  "SendResult",
  "SendOpaqueStatus",
  "HealthCheck",
)

RPC_FIELD = "rpc"
MAX_FRAME_BYTES = 256 * 1024 * 1024
_LEN = struct.Struct(">I")


async def read_frame(reader: asyncio.StreamReader) -> bytes:
  """One length-prefixed frame. Raises asyncio.IncompleteReadError when the peer
  closes, ValueError on a frame over the cap."""
  (n,) = _LEN.unpack(await reader.readexactly(_LEN.size))
  if n > MAX_FRAME_BYTES:
    raise ValueError(f"frame of {n} bytes exceeds the {MAX_FRAME_BYTES}-byte cap")
  return await reader.readexactly(n)


def write_frame(writer: asyncio.StreamWriter, frame: bytes) -> int:
  """Queue one frame; returns the bytes it puts on the wire."""
  if len(frame) > MAX_FRAME_BYTES:
    raise ValueError(f"frame of {len(frame)} bytes exceeds the {MAX_FRAME_BYTES}-byte cap")
  prefix = _LEN.pack(len(frame))
  if len(frame) < 1 << 16:
    writer.write(prefix + frame)  # a per-token hop: one segment on the wire
  else:
    writer.write(prefix)  # a prefill hop: no copy of megabytes for 4 bytes
    writer.write(frame)
  return _LEN.size + len(frame)


def set_nodelay(writer: asyncio.StreamWriter) -> None:
  sock = writer.get_extra_info("socket")
  if sock is not None and sock.family in (socket.AF_INET, socket.AF_INET6):
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
