"""The port's networking layer on the CPU: the XOT1 codec against the JAX package's,
the manual config against the JAX package's validation, manual and UDP discovery, and
the TCP transport (the standard-library twin of the JAX package's gRPC one) against a
stand-in Node, all in one process on localhost.
"""
import asyncio
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from xotorch_tpu.networking import codec as j_codec
from xotorch_tpu.networking.manual.network_topology_config import NetworkTopology as JNetworkTopology
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.networking import codec
from xotorch_tpu_torch.networking.manual.discovery import ManualDiscovery
from xotorch_tpu_torch.networking.manual.network_topology_config import NetworkTopology
from xotorch_tpu_torch.networking.tcp import TCPPeerHandle, TCPServer, service
from xotorch_tpu_torch.networking.tcp.peer_handle import RemoteError
from xotorch_tpu_torch.networking.udp.discovery import UDPDiscovery
from xotorch_tpu_torch.topology.device_capabilities import (UNKNOWN_DEVICE_CAPABILITIES,
                                                            DeviceCapabilities, DeviceFlops)
from xotorch_tpu_torch.topology.topology import Topology
from xotorch_tpu_torch.utils.helpers import AsyncCallbackSystem, find_available_port


def _bf16_pair(shape, seed=0):
  """The same bf16 values as an ml_dtypes array (the JAX package's) and a torch tensor
  (the port's)."""
  x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
  return x.astype(ml_dtypes.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _bits(t):
  return (t.view(torch.int16).numpy() if isinstance(t, torch.Tensor) else t.view(np.int16))


# ------------------------------------------------------------------- codec

def test_codec_roundtrip():
  fields = {"request_id": "r1", "nested": {"a": [1, 2, 3]}, "flag": True, "none": None}
  _, hidden = _bf16_pair((1, 3, 8))
  tensors = {"hidden": hidden, "f32": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
             "tokens": np.array([[1, 2, 3]], dtype=np.int64), "empty": torch.empty(0, 4, dtype=torch.bfloat16)}
  out_fields, out = codec.decode_message(codec.encode_message(fields, tensors))
  assert out_fields == fields
  assert out["hidden"].dtype == torch.bfloat16 and torch.equal(out["hidden"], hidden)
  np.testing.assert_array_equal(out["f32"], tensors["f32"])
  np.testing.assert_array_equal(out["tokens"], tensors["tokens"])
  assert out["empty"].shape == (0, 4) and out["empty"].dtype == torch.bfloat16


@pytest.mark.parametrize("frame", [b"NOPE" + b"\x00" * 16, b"XOT", b"XOT1\x00\x00\x00\x05{nope",
                                   codec.encode_message({}, {"x": np.ones(8, np.float32)})[:-4]])
def test_codec_rejects_garbage(frame):
  with pytest.raises(ValueError):
    codec.decode_message(frame)
  if frame[:4] != b"XOT1":
    with pytest.raises(ValueError):
      j_codec.decode_message(frame)


def test_codec_bf16_is_2_bytes_per_element():
  _, t = _bf16_pair((3, 100))
  frame = codec.encode_message({}, {"x": t})
  header_len = int.from_bytes(frame[4:8], "big")
  desc = json.loads(frame[8:8 + header_len])["tensors"]["x"]
  assert desc == {"shape": [3, 100], "dtype": "bfloat16", "offset": 0, "nbytes": 600}
  assert len(frame) == 8 + header_len + 600


@pytest.mark.parametrize("shape", [(1, 1, 2048), (1, 37, 64), (2, 5, 3)])
def test_codec_frames_cross_between_the_packages_bit_for_bit(shape):
  jx, px = _bf16_pair(shape, seed=sum(shape))
  fields = {"request_id": "r", "inference_state": {"xot_temperature": 0.0}, "hop_seq": "abc"}
  ints = np.arange(6, dtype=np.int64).reshape(1, 6)
  # Byte-identical frames from the same values.
  assert codec.encode_message(fields, {"t": px, "i": ints}) == j_codec.encode_message(fields, {"t": jx, "i": ints})
  # JAX's frame in the port: the same bits, as a torch bf16 tensor.
  f, t = codec.decode_message(j_codec.encode_message(fields, {"t": jx, "i": ints}))
  assert f == fields and t["t"].dtype == torch.bfloat16
  np.testing.assert_array_equal(_bits(t["t"]), _bits(jx))
  np.testing.assert_array_equal(t["i"], ints)
  # The port's frame in JAX: the same bits, as an ml_dtypes bf16 array.
  f, t = j_codec.decode_message(codec.encode_message(fields, {"t": px, "i": ints}))
  assert f == fields and t["t"].dtype == np.dtype(ml_dtypes.bfloat16)
  np.testing.assert_array_equal(_bits(t["t"]), _bits(px))


# ---------------------------------------------------------- manual config

CAPS = {"model": "m", "chip": "c", "memory": 1024, "flops": {"fp32": 1, "fp16": 2, "int8": 4}}
PEER = {"address": "1.2.3.4", "port": 1, "device_capabilities": CAPS}


def _with(**kw):
  return {"peers": {"x": {**PEER, **kw}}}


INVALID = {
  "missing port and caps": {"peers": {"x": {"address": "1.2.3.4"}}},
  "no peers": {},
  "peers a list": {"peers": []},
  "config a list": [],
  "peer a string": {"peers": {"x": "1.2.3.4:1"}},
  "port not a number": _with(port="one"),
  "port fractional": _with(port=1.5),
  "port null": _with(port=None),
  "address a number": _with(address=5),
  "caps null": _with(device_capabilities=None),
  "memory a word": _with(device_capabilities={**CAPS, "memory": "lots"}),
  "memory fractional": _with(device_capabilities={**CAPS, "memory": 1.5}),
  "flops incomplete": _with(device_capabilities={**CAPS, "flops": {"fp32": 1}}),
  "model missing": _with(device_capabilities={k: v for k, v in CAPS.items() if k != "model"}),
}
VALID = {
  "plain": {"peers": {"x": PEER}},
  "numeric string port": _with(port="1"),
  "integral float port": _with(port=1.0),
  "numeric string flops": _with(device_capabilities={**CAPS, "flops": {"fp32": "1", "fp16": 2, "int8": 4}}),
  "unknown keys": _with(extra=1),
  "no peers listed": {"peers": {}},
}


@pytest.mark.parametrize("case", list(INVALID))
def test_manual_config_invalid_raises_in_both(case, tmp_path):
  path = tmp_path / "bad.json"
  path.write_text(json.dumps(INVALID[case]))
  with pytest.raises(ValueError):
    JNetworkTopology.from_path(str(path))
  with pytest.raises(ValueError, match=str(path)):
    NetworkTopology.from_path(str(path))


@pytest.mark.parametrize("case", list(VALID))
def test_manual_config_valid_parses_as_in_jax(case, tmp_path):
  path = tmp_path / "good.json"
  path.write_text(json.dumps(VALID[case]))
  want = {k: (v.address, v.port, v.device_capabilities.to_caps().to_dict())
          for k, v in JNetworkTopology.from_path(str(path)).peers.items()}
  got = {k: (v.address, v.port, v.device_capabilities.to_dict())
         for k, v in NetworkTopology.from_path(str(path)).peers.items()}
  assert got == want


def test_manual_config_not_json_or_missing(tmp_path):
  notjson = tmp_path / "notjson.json"
  notjson.write_text("{nope")
  for cls in (JNetworkTopology, NetworkTopology):
    with pytest.raises(ValueError):
      cls.from_path(str(notjson))
    with pytest.raises(FileNotFoundError):
      cls.from_path(str(tmp_path / "missing.json"))


# ------------------------------------------------------- a stand-in Node

class StubNode:
  """What the TCP server calls on a Node, recording the calls."""

  def __init__(self, node_id="stub"):
    self.id = node_id
    self.prompts, self.tensors, self.results = [], [], []
    self.on_opaque_status = AsyncCallbackSystem()
    self._seen = set()

  def note_hop_delivery(self, request_id, seq):
    if seq is None:
      return True
    if (request_id, seq) in self._seen:
      return False
    self._seen.add((request_id, seq))
    return True

  async def process_prompt(self, shard, prompt, request_id=None, **kw):
    self.prompts.append((shard, prompt, request_id, kw))

  async def process_tensor(self, shard, tensor, request_id=None, inference_state=None):
    self.tensors.append((shard, tensor, request_id, inference_state))

  async def collect_topology(self, visited, max_depth):
    topo = Topology()
    topo.update_node(self.id, DeviceCapabilities("m", "c", 4096, DeviceFlops(1, 2, 4)))
    topo.add_edge(self.id, "other", "tcp")
    return topo

  async def ingest_remote_result(self, request_id, tokens, total_len, is_finished, error=None):
    self.results.append((request_id, tokens, total_len, is_finished, error))
    return True, len(tokens)


async def _served(node=None):
  node = node or StubNode()
  port = find_available_port()
  server = TCPServer(node, "127.0.0.1", port)
  await server.start()
  return node, server, TCPPeerHandle(node.id, f"127.0.0.1:{port}", "test", UNKNOWN_DEVICE_CAPABILITIES)


async def _settle():
  for _ in range(5):
    await asyncio.sleep(0)


# ---------------------------------------------------------------- TCP twin

async def test_tcp_every_rpc_round_trips():
  node, server, peer = await _served()
  try:
    assert await peer.health_check()
    shard = Shard("synthetic-tiny", 2, 3, 4)
    await peer.send_prompt(shard, "hello", "r1", max_tokens=7, temperature=0.0, top_p=0.5,
                           ring_map=[["a", 0, 1], ["stub", 2, 3]])
    _, hidden = _bf16_pair((1, 5, 64))
    state = {"xot_temperature": 0.0, "xot_ring_map": [["a", 0, 1], ["stub", 2, 3]]}
    await peer.send_tensor(shard, hidden, "r1", state)
    await peer.send_tensor(shard, np.array([[42]], dtype=np.int64), "r1", state)
    await _settle()
    assert node.prompts == [(shard, "hello", "r1", {
      "traceparent": None, "max_tokens": 7, "images": None, "temperature": 0.0, "top_p": 0.5,
      "ring_map": [["a", 0, 1], ["stub", 2, 3]], "deadline": None})]
    (s0, t0, r0, st0), (_, t1, _, _) = node.tensors
    assert (s0, r0, st0) == (shard, "r1", state)
    assert t0.dtype == torch.bfloat16 and torch.equal(t0, hidden)
    np.testing.assert_array_equal(t1, [[42]])
    ack = await peer.send_result("r1", [5, 6], False, total_len=3)
    assert ack == {"ok": True, "applied": True, "have": 2}
    await peer.send_result("r1", np.array([7], dtype=np.int64), True, error="boom")
    assert node.results == [("r1", [5, 6], 3, False, None), ("r1", [7], None, True, "boom")]
    statuses = []
    node.on_opaque_status.register("t").on_next(lambda rid, status: statuses.append((rid, status)))
    await peer.send_opaque_status("r1", '{"type": "x"}')
    assert statuses == [("r1", '{"type": "x"}')]
    topo = await peer.collect_topology({"a"}, 2)
    assert topo.get_node("stub").memory == 4096 and topo.get_neighbors("stub") == {"other"}
    with pytest.raises(RemoteError, match="not served"):
      await peer._call("SendExample", {"shard": shard.to_dict(), "train": True, "request_id": "t"},
                       {"example": np.ones((1, 4), np.int64)}, retriable=False)
    assert set(peer.wire) == set(service.METHODS)
    calls, sent, received = peer.wire["SendTensor"]
    assert calls == 2 and sent > 2 * 5 * 64 and received > 0
  finally:
    await peer.disconnect()
    await server.stop()


async def test_tcp_concurrent_calls_do_not_queue_on_one_connection():
  node, server, peer = await _served()
  try:
    shard = Shard("m", 0, 0, 1)
    await asyncio.gather(*(peer.send_tensor(shard, np.array([[i]]), f"r{i}") for i in range(12)))
    await _settle()
    assert sorted(r for _, _, r, _ in node.tensors) == sorted(f"r{i}" for i in range(12))
    assert len(peer._idle) <= TCPPeerHandle.max_idle
  finally:
    await peer.disconnect()
    await server.stop()


async def test_tcp_health_check_fails_after_stop():
  node, server, peer = await _served()
  assert await peer.health_check()
  await server.stop()
  assert not await peer.health_check()
  assert not await peer.health_check()
  await peer.disconnect()


async def test_tcp_refuses_a_frame_over_the_cap(monkeypatch):
  node, server, peer = await _served()
  try:
    monkeypatch.setattr(service, "MAX_FRAME_BYTES", 1024)
    with pytest.raises(ValueError, match="cap"):
      await peer.send_tensor(Shard("m", 0, 0, 1), np.zeros(1024, np.float32), "r")
    assert node.tensors == []
  finally:
    await peer.disconnect()
    await server.stop()


def _lose_first_ack(server, method):
  """The first `method` call is processed but its answer never leaves: the server
  closes the connection instead of replying."""
  answer = server._answer
  lost = []

  async def flaky(frame):
    reply = await answer(frame)
    fields, _ = codec.decode_message(frame)
    if fields.get("rpc") == method and not lost:
      lost.append(fields.get("hop_seq"))
      raise ConnectionResetError("ack lost")
    return reply
  server._answer = flaky
  return lost


async def test_tcp_hop_whose_first_ack_is_lost_is_delivered_once(monkeypatch):
  monkeypatch.setenv("XOT_HOP_BACKOFF_S", "0.01")
  node, server, peer = await _served()
  lost = _lose_first_ack(server, "SendTensor")
  try:
    await peer.send_tensor(Shard("m", 0, 0, 1), np.array([[3]]), "r1")
    await _settle()
    assert lost and lost[0] is not None  # the retry carried the first attempt's sequence id
    assert peer.wire["SendTensor"][0] == 2  # two attempts reached the wire
    assert len(node.tensors) == 1  # ... and the receiver ran the hop once
  finally:
    await peer.disconnect()
    await server.stop()


async def test_tcp_no_retries_fail_fast(monkeypatch):
  monkeypatch.setenv("XOT_HOP_RETRIES", "0")
  node, server, peer = await _served()
  lost = _lose_first_ack(server, "SendTensor")
  try:
    with pytest.raises((ConnectionError, asyncio.IncompleteReadError)):
      await peer.send_tensor(Shard("m", 0, 0, 1), np.array([[3]]), "r1")
    assert lost == [None]  # no sequence id when no redelivery can happen
    assert peer.wire["SendTensor"][0] == 1
    await _settle()
    assert len(node.tensors) == 1
  finally:
    await peer.disconnect()
    await server.stop()


# ----------------------------------------------------------------- discovery

def _write_config(path, peers):
  path.write_text(json.dumps({"peers": {
    peer_id: {"address": "127.0.0.1", "port": port, "device_capabilities": CAPS}
    for peer_id, port in peers.items()}}))


async def test_manual_discovery_finds_healthy_tcp_peers_and_keeps_the_last_good_config(tmp_path):
  _, server_b, _ = await _served(StubNode("node-b"))
  dead_port = find_available_port()  # nothing listens here
  path = tmp_path / "topology.json"
  _write_config(path, {"node-a": find_available_port(), "node-b": server_b.port, "node-c": dead_port})
  d = ManualDiscovery(str(path), "node-a", TCPPeerHandle, poll_interval=0.05)
  await d.start()
  try:
    peers = await asyncio.wait_for(d.discover_peers(wait_for_peers=1), timeout=10)
    # node-a is this node; node-c does not answer its health check.
    assert [p.id() for p in peers] == ["node-b"]
    assert isinstance(peers[0], TCPPeerHandle) and peers[0].device_capabilities().memory == 1024
    path.write_text("{broken")
    await asyncio.sleep(0.3)
    assert [p.id() for p in await d.discover_peers()] == ["node-b"]
    _write_config(path, {"node-a": 1})
    for _ in range(100):
      if not await d.discover_peers():
        break
      await asyncio.sleep(0.05)
    assert await d.discover_peers() == []  # dropped from the file: dropped
  finally:
    await d.stop()
    await server_b.stop()


async def test_udp_discovery_two_instances_find_each_other():
  caps = DeviceCapabilities("test", "chip", 1024, DeviceFlops(1, 2, 4))
  _, server1, _ = await _served(StubNode("node1"))
  _, server2, _ = await _served(StubNode("node2"))
  port1, port2 = find_available_port(), find_available_port()
  # Crossed listen/broadcast ports, as the JAX package's test does.
  d1 = UDPDiscovery("node1", server1.port, port1, port2, TCPPeerHandle, broadcast_interval=0.2,
                    device_capabilities=caps)
  d2 = UDPDiscovery("node2", server2.port, port2, port1, TCPPeerHandle, broadcast_interval=0.2,
                    device_capabilities=caps)
  await d1.start()
  await d2.start()
  try:
    peers1 = await asyncio.wait_for(d1.discover_peers(wait_for_peers=1), timeout=10)
    peers2 = await asyncio.wait_for(d2.discover_peers(wait_for_peers=1), timeout=10)
    assert peers1[0].id() == "node2" and peers2[0].id() == "node1"
    assert peers1[0].addr().endswith(f":{server2.port}")
    assert await peers1[0].health_check()
  finally:
    await d1.stop()
    await d2.stop()
    for d in (d1, d2):
      for handle, *_ in d.known_peers.values():
        await handle.disconnect()
    await server1.stop()
    await server2.stop()
