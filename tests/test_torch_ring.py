"""The port's token ring on the CPU, against the JAX package's.

Port Nodes (orchestration/node.py) built through the port's entry point
(main.build_node), each with its own TorchShardInferenceEngine, find each other
through manual discovery and pass hidden states over the TCP transport. On
synthetic-tiny in fp32 and on the JAX engine's weights (carried across as in
test_torch_engine.py), the port's two- and three-node rings must give the greedy
tokens of JAX's two-node gRPC ring and of the port's solo node, wherever the prompt
enters. Then the ring's behaviour: the request's settings reach the sampler peer, a
hop error aborts the request on every peer with its error at the API node, every
engine frees a finished request, the second node's API streams, and a hidden-state
hop crosses in bf16 when the engines run bf16.
"""
import asyncio
import json
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models.transformer import init_random_params as j_init_random_params
from xotorch_tpu.networking import codec as j_codec
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine import engine as engine_mod
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models.weights import params_from_jax
from xotorch_tpu_torch.networking import codec
from xotorch_tpu_torch.networking.tcp import peer_handle as tcp_peer_handle
from xotorch_tpu_torch.topology.device_capabilities import device_capabilities_sync
from xotorch_tpu_torch.utils.helpers import find_available_port

torch.set_num_threads(2)

MODEL = "synthetic-tiny"  # 4 layers, hidden 64
PROMPT = "hello world test prompt for the ring"
GEN = 8
CONFIG_CAPS = {"model": "cpu", "chip": "cpu", "memory": 1024, "flops": {"fp32": 1, "fp16": 2, "int8": 4}}


@pytest.fixture()
def jax_weights(monkeypatch):
  """The port's synthetic init replaced by the JAX engine's draw (PRNGKey(0),
  per-layer key folding), carried across with params_from_jax."""
  def init(cfg, n, first, last, seed=0, dtype=torch.float32, device="cpu", start_layer=0, **_):
    from xotorch_tpu.models.config import config_from_hf_dict
    from xotorch_tpu.models.registry import get_model_card
    jcfg = config_from_hf_dict(get_model_card(MODEL)["synthetic_config"])
    jp = j_init_random_params(jcfg, n, first, last, jax.random.PRNGKey(seed),
                              dtype=jnp.float32, start_layer=start_layer)
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device=device, dtype=dtype)
  monkeypatch.setattr(engine_mod, "init_random_params", init)
  monkeypatch.setenv("XOT_DTYPE", "float32")


class Ring:
  """n port peers on 127.0.0.1, built by main.build_node with manual discovery over one
  config naming them all. Equal memories: the ring's order is the ids, descending.
  The config's capabilities (1024 MB) are unlike what each peer probes, as a config
  written by hand may be: every peer's view must come to hold what the others report
  of themselves, whichever crawl lands last."""

  def __init__(self, tmp_path, ids, extra=()):
    self.ports = {i: find_available_port() for i in ids}
    path = tmp_path / "peers.json"
    path.write_text(json.dumps({"peers": {
      i: {"address": "127.0.0.1", "port": p, "device_capabilities": CONFIG_CAPS} for i, p in self.ports.items()}}))
    self.nodes, self.engines = {}, {}
    for i in ids:
      args = port_main.build_parser().parse_args(
        ["--device", "cpu", "--node-id", i, "--node-host", "127.0.0.1", "--node-port", str(self.ports[i]),
         "--discovery-module", "manual", "--discovery-config-path", str(path),
         "--default-temp", "0", "--max-generate-tokens", str(GEN), *extra])
      node, engine, self.classname, _ = port_main.build_node(args)
      node.discovery.poll_interval = 0.05
      self.nodes[i], self.engines[i] = node, engine

  async def start(self):
    n = len(self.nodes)
    await asyncio.gather(*(node.start(wait_for_peers=n - 1) for node in self.nodes.values()))
    # Every peer derives the same table.
    tables = {tuple(p.node_id for p in node.partitioning_strategy.partition(node.topology))
              for node in self.nodes.values()}
    assert tables == {tuple(sorted(self.nodes, reverse=True))}
    return self

  async def stop(self):
    for node, engine in zip(self.nodes.values(), self.engines.values()):
      await node.stop()
      engine.executor.shutdown(wait=True)


async def _generate(node, request_id, prompt=PROMPT, timeout=120, **kw):
  """Send a prompt to `node`; the finished token list (and error, if any) as seen by
  `node`."""
  done = asyncio.Event()
  out = {}

  def on_token(rid, tokens, finished):
    if rid == request_id:
      out["tokens"] = list(tokens)
      if finished:
        done.set()
  node.on_token.register(f"test-{request_id}").on_next(on_token)
  await node.process_prompt(Shard(MODEL, 0, 0, 4), prompt, request_id, **kw)
  await asyncio.wait_for(done.wait(), timeout)
  node.on_token.deregister(f"test-{request_id}")
  return out["tokens"], node.request_errors.pop(request_id, None)


async def _wait_idle(ring):
  """Until every engine holds no request state and every node no outstanding request
  (a peer's cleanup may finish after the API node reports the end)."""
  for _ in range(200):
    if (all(e._ctx is None or not e._ctx.states for e in ring.engines.values())
        and not any(n.outstanding_requests for n in ring.nodes.values())):
      return
    await asyncio.sleep(0.02)


async def _jax_ring_tokens():
  """JAX's two-node ring over gRPC (tests/test_orchestration.py's recipe)."""
  from xotorch_tpu.networking.discovery import Discovery
  from xotorch_tpu.networking.grpc.peer_handle import GRPCPeerHandle
  from xotorch_tpu.networking.grpc.server import GRPCServer
  from xotorch_tpu.orchestration.node import Node as JNode
  from xotorch_tpu.topology.device_capabilities import DeviceCapabilities, DeviceFlops
  from xotorch_tpu.topology.partitioning import RingMemoryWeightedPartitioningStrategy

  class StaticDiscovery(Discovery):
    def __init__(self, peers):
      self.peers = peers

    async def start(self):
      pass

    async def stop(self):
      pass

    async def discover_peers(self, wait_for_peers=0):
      return list(self.peers)

  caps = DeviceCapabilities("test", "chip", 1024, DeviceFlops(1, 2, 4))
  ports = {i: find_available_port() for i in ("node-a", "node-b")}
  nodes = {}
  for i, other in (("node-a", "node-b"), ("node-b", "node-a")):
    peer = GRPCPeerHandle(other, f"localhost:{ports[other]}", "test", caps)
    node = JNode(i, None, JAXShardInferenceEngine(dtype="float32"), StaticDiscovery([peer]), None,
                 RingMemoryWeightedPartitioningStrategy(), max_generate_tokens=GEN,
                 default_sample_temp=0.0)
    node.server = GRPCServer(node, "localhost", ports[i])
    node.device_capabilities = caps
    nodes[i] = node
  try:
    for node in nodes.values():
      await node.server.start()
    for node in nodes.values():
      await node.update_peers()
      await node.collect_topology(set())
    done = asyncio.Event()
    out = {}

    def on_token(rid, tokens, finished):
      out["tokens"] = list(tokens)
      if finished:
        done.set()
    nodes["node-a"].on_token.register("t").on_next(on_token)
    with jax.default_matmul_precision("highest"):
      await nodes["node-a"].process_prompt(JShard(MODEL, 0, 0, 4), PROMPT, "jax-ring")
      await asyncio.wait_for(done.wait(), timeout=120)
    return out["tokens"]
  finally:
    for node in nodes.values():
      await node.server.stop()


async def _solo_tokens():
  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-temp", "0", "--max-generate-tokens", str(GEN)])
  node, engine, _, _ = port_main.build_node(args)
  try:
    tokens, error = await _generate(node, "solo")
  finally:
    await node.stop()
    engine.executor.shutdown(wait=True)
  assert error is None
  return tokens


async def test_two_and_three_node_rings_match_jax_ring_and_solo(jax_weights, tmp_path):
  want = await _jax_ring_tokens()
  assert len(want) == GEN
  assert await _solo_tokens() == want
  ring = await Ring(tmp_path, ["node-b", "node-a"]).start()
  try:
    first, second = ring.nodes["node-b"], ring.nodes["node-a"]
    assert first.get_current_shard(Shard(MODEL, 0, 0, 4)) == Shard(MODEL, 0, 1, 4)
    assert (await _generate(first, "two")) == (want, None)
    # Into the peer that holds layers 2-3: the prompt is forwarded to layer 0's owner.
    assert (await _generate(second, "two-forwarded")) == (want, None)
  finally:
    await ring.stop()
  ring = await Ring(tmp_path, ["n2", "n1", "n0"]).start()
  try:
    mid = ring.nodes["n1"]
    assert mid.get_current_shard(Shard(MODEL, 0, 0, 4)) == Shard(MODEL, 1, 2, 4)
    for entry in ("n2", "n1", "n0"):  # the prompt enters at each peer in turn
      assert (await _generate(ring.nodes[entry], f"three-{entry}")) == (want, None)
  finally:
    await ring.stop()


async def test_peers_agree_on_the_ring_whichever_crawl_lands_last(tmp_path):
  """node-a answers CollectTopology late, so its own crawl (node-b answers at once)
  lands before the crawl node-b started reaches it; that late crawl skips node-b, which
  started it. node-a's view must still hold what node-b reported of itself, not the
  config's 1024 MB: every peer holds every peer's probed capabilities, and one table."""
  ring = Ring(tmp_path, ["node-b", "node-a"])
  server = ring.nodes["node-a"].server
  answer = server._handlers["CollectTopology"]

  async def late(fields, tensors):
    await asyncio.sleep(0.5)
    return await answer(fields, tensors)
  server._handlers["CollectTopology"] = late
  await ring.start()
  try:
    probed = device_capabilities_sync().to_dict()
    assert probed["memory"] != CONFIG_CAPS["memory"]
    for node in ring.nodes.values():
      assert {i: c.to_dict() for i, c in node.topology.nodes.items()} == {
        i: probed for i in ring.nodes}
  finally:
    await ring.stop()


async def test_an_in_process_ring_matches_the_tcp_ring(jax_weights, tmp_path):
  """InProcessPeerHandle: the same ring with the hop handed straight to the peer Node."""
  from xotorch_tpu_torch.networking.discovery import Discovery
  from xotorch_tpu_torch.networking.inprocess import InProcessPeerHandle
  from xotorch_tpu_torch.orchestration.node import Node
  from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities, DeviceFlops
  from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy

  class StaticDiscovery(Discovery):
    def __init__(self):
      self.peers = []

    async def start(self):
      pass

    async def stop(self):
      pass

    async def discover_peers(self, wait_for_peers=0):
      return list(self.peers)

  ring = await Ring(tmp_path, ["node-b", "node-a"]).start()
  try:
    want, error = await _generate(ring.nodes["node-a"], "tcp")
    assert error is None
  finally:
    await ring.stop()
  caps = DeviceCapabilities("cpu", "cpu", 1024, DeviceFlops(1, 2, 4))
  nodes = {i: Node(i, None, TorchShardInferenceEngine(device="cpu", seed=0), StaticDiscovery(),
                   RingMemoryWeightedPartitioningStrategy(), max_generate_tokens=GEN,
                   default_sample_temp=0.0) for i in ("node-b", "node-a")}
  try:
    for i, node in nodes.items():
      node.discovery.peers = [InProcessPeerHandle(n) for j, n in nodes.items() if j != i]
      node.device_capabilities = caps
    for node in nodes.values():
      await node.update_peers()
      await node.collect_topology(set())
    assert (await _generate(nodes["node-a"], "inprocess")) == (want, None)
  finally:
    for node in nodes.values():
      await node.stop()
      node.inference_engine.executor.shutdown(wait=True)


async def test_request_settings_ride_to_the_sampler_and_every_peer_frees_the_request(jax_weights, tmp_path):
  ring = await Ring(tmp_path, ["node-b", "node-a"], extra=["--default-temp", "0.9"]).start()
  sampler_engine = ring.engines["node-a"]
  seen = []
  real = sampler_engine.infer_sample_tensor

  async def spy(request_id, shard, x, temp=0.6, top_k=35, inference_state=None, top_p=0.0):
    seen.append((request_id, temp, top_p, shard))
    return await real(request_id, shard, x, temp=temp, top_k=top_k, inference_state=inference_state,
                      top_p=top_p)
  sampler_engine.infer_sample_tensor = spy
  try:
    tokens, error = await _generate(ring.nodes["node-b"], "settings", max_tokens=3, temperature=0.0,
                                    top_p=0.5)
    assert error is None and len(tokens) == 3
    # Every token was sampled on node-a with the request's settings, not its defaults.
    assert [s[1:] for s in seen] == [(0.0, 0.5, Shard(MODEL, 2, 3, 4))] * 3
    # Both peers saw the whole stream (node-b through the delta broadcasts) ...
    assert ring.nodes["node-a"].buffered_token_output.get("settings") is None
    # ... and both engines, and both nodes' bookkeeping, dropped the request.
    await _wait_idle(ring)
    for i in ring.nodes:
      assert not ring.engines[i]._ctx.states, i
      assert "settings" not in ring.nodes[i].outstanding_requests
      assert "settings" not in ring.nodes[i]._request_ring_map
  finally:
    await ring.stop()


async def test_a_hop_error_aborts_the_request_on_every_peer(jax_weights, tmp_path):
  ring = await Ring(tmp_path, ["node-b", "node-a"]).start()

  async def boom(*a, **kw):
    raise RuntimeError("sampler exploded")
  ring.engines["node-a"].infer_sample_tensor = boom
  try:
    # The API node is node-b (layers 0-1); the error happens on node-a.
    tokens, error = await _generate(ring.nodes["node-b"], "doomed")
    assert tokens == []
    assert error is not None and "sampler exploded" in error and "node-a" in error
    await _wait_idle(ring)
    assert not ring.engines["node-b"]._ctx.states  # node-b's KV for layers 0-1 is freed
    for node in ring.nodes.values():
      assert "doomed" not in node.outstanding_requests
    # A late hop for the aborted request is dropped, not served from a fresh cache.
    await ring.nodes["node-b"].process_tensor(Shard(MODEL, 0, 0, 4), np.array([[5]]), "doomed")
    assert not ring.engines["node-b"]._ctx.states
  finally:
    await ring.stop()


def _http_stream(url, body):
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  events = []
  with urllib.request.urlopen(req, timeout=120) as resp:
    for raw in resp:
      line = raw.decode().strip()
      if line.startswith("data: ") and line != "data: [DONE]":
        events.append(json.loads(line[len("data: "):]))
  return events


async def test_the_second_nodes_api_streams_a_chat_completion(jax_weights, tmp_path):
  ring = await Ring(tmp_path, ["node-b", "node-a"]).start()
  node = ring.nodes["node-a"]
  from xotorch_tpu_torch.api.chatgpt_api import ChatGPTAPI
  api = ChatGPTAPI(node, ring.classname, default_model=MODEL)
  server = await api.start("127.0.0.1", 0)
  url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/v1/chat/completions"
  try:
    body = {"model": MODEL, "temperature": 0, "max_tokens": 6, "stream": True,
            "stream_options": {"include_usage": True},
            "messages": [{"role": "user", "content": "one two three"}]}
    events = await asyncio.get_running_loop().run_in_executor(None, _http_stream, url, body)
    finishes = [c["finish_reason"] for e in events for c in e["choices"] if c["finish_reason"]]
    assert finishes == ["length"]
    assert events[-1]["usage"]["completion_tokens"] == 6
    content = "".join(c["delta"].get("content", "") for e in events for c in e["choices"])
    assert content.count("dummy") == 6
  finally:
    server.close()
    await server.wait_closed()
    await ring.stop()


async def test_hidden_state_hop_is_bf16_and_matches_jax(jax_weights, monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "bfloat16")
  tokens = np.random.default_rng(3).integers(3, 256, size=(1, 9))
  jeng = JAXShardInferenceEngine(dtype="bfloat16")
  want, _ = await jeng.infer_tensor("r", JShard(MODEL, 0, 1, 4), tokens)
  assert want.dtype == np.dtype(ml_dtypes.bfloat16)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  try:
    got, _ = await eng.infer_tensor("r", Shard(MODEL, 0, 1, 4), tokens)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16 and got.shape == (1, 9, 64)
    frame = codec.encode_message({}, {"tensor": got})
    header_len = int.from_bytes(frame[4:8], "big")
    desc = json.loads(frame[8:8 + header_len])["tensors"]["tensor"]
    assert desc["dtype"] == "bfloat16" and desc["nbytes"] == 2 * 9 * 64
    # The frame as the JAX package reads it, against JAX's own hop output: both sides
    # compute in bf16 (XLA's CPU kernels and torch's sum in their own orders), so the
    # values agree to bf16's rounding, 2^-8 relative, over |x| of order 1.
    _, jt = j_codec.decode_message(frame)
    np.testing.assert_allclose(jt["tensor"].astype(np.float32), want.astype(np.float32),
                               rtol=2 ** -7, atol=2 ** -7)
    # Logits from the last shard stay fp32 numpy.
    logits, _ = await eng.infer_tensor("r", Shard(MODEL, 2, 3, 4), got)
    assert isinstance(logits, np.ndarray) and logits.dtype == np.float32
  finally:
    eng.executor.shutdown(wait=True)


async def test_every_ring_hop_is_bf16_on_a_bf16_ring(jax_weights, tmp_path, monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "bfloat16")
  sent = []
  real = tcp_peer_handle.encode_message

  def recording(fields, tensors=None):
    if fields.get("rpc") == "SendTensor":
      t = tensors["tensor"]
      sent.append((str(t.dtype), tuple(t.shape)))
    return real(fields, tensors)
  monkeypatch.setattr(tcp_peer_handle, "encode_message", recording)
  ring = await Ring(tmp_path, ["node-b", "node-a"]).start()
  try:
    tokens, error = await _generate(ring.nodes["node-b"], "bf16", max_tokens=4)
    assert error is None and len(tokens) == 4
  finally:
    await ring.stop()
  prompt_len = len(PROMPT.split())
  hidden = [s for s in sent if len(s[1]) == 3]
  assert hidden == [("torch.bfloat16", (1, prompt_len, 64))] + [("torch.bfloat16", (1, 1, 64))] * 3
  assert [s for s in sent if len(s[1]) == 2] == [("int64", (1, 1))] * 3
