"""Device-resident hops between co-located partitions on the port (the engine's
keep_on_device, the Node's _keep_on_device_kwargs and forward_tensor,
InProcessPeerHandle.accepts_device_arrays) against the JAX package, on the CPU.

The twins of tests/test_device_hops.py. A two-partition ring in one process, per-token
(decode chunk 1): every hidden-state hop crosses as the engine's tensor, no hidden
state is copied to the host (the engines' `host_hop_bytes` stay 0 and `device_hops`
count every hop), and the greedy stream equals a solo Node's and JAX's in-process
ring's. A hop to a peer that takes no device tensors comes to the host at the send, as
numpy (fp32) or a bf16 CPU tensor (the codec's bf16 frame). The in-process ring equals
the TCP ring. Tokens are compared exactly.
"""
import asyncio

import numpy as np
import pytest
import torch

from tests.test_device_hops import _generate as j_generate
from tests.test_device_hops import _inprocess_ring as j_inprocess_ring
from tests.test_model_equivalence import TINY_LLAMA_CFG, make_hf_checkpoint
from tests.test_torch_ring import GEN, MODEL, PROMPT, Ring, jax_weights  # noqa: F401 (fixture)
from tests.test_torch_ring import _generate as ring_generate
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.networking.inprocess import InProcessPeerHandle
from xotorch_tpu_torch.orchestration.node import Node
from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities, DeviceFlops
from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy

torch.set_num_threads(2)

N = TINY_LLAMA_CFG["num_hidden_layers"]


@pytest.fixture()
def tiny_model_dir(tmp_path):
  return make_hf_checkpoint(tmp_path, TINY_LLAMA_CFG, seed=3)


def _caps():
  return DeviceCapabilities("test", "chip", 1024, DeviceFlops(1, 2, 4))


def _engine(model_dir=None):
  downloader = LocalShardDownloader({"m": model_dir}) if model_dir is not None else None
  return TorchShardInferenceEngine(downloader, device="cpu", seed=0)


def _node(name, engine, max_tokens):
  node = Node(name, None, engine, None, RingMemoryWeightedPartitioningStrategy(),
              max_generate_tokens=max_tokens, default_sample_temp=0.0, decode_chunk_size=1)
  node.device_capabilities = _caps()
  return node


def _inprocess_ring(max_tokens, model_dir=None, names=("ring-a", "ring-b")):
  nodes = [_node(n, _engine(model_dir), max_tokens) for n in names]
  for node in nodes:
    node.peers = [InProcessPeerHandle(o) for o in nodes if o is not node]
    for other in nodes:
      node.topology.update_node(other.id, _caps())
  return nodes


def _shutdown(nodes):
  for n in nodes:
    n.inference_engine.executor.shutdown(wait=True)


async def _generate(node, prompt, max_tokens, watch=(), model="m", n_layers=N):
  done = asyncio.Event()
  out = {}

  def on_token(rid, tokens, is_finished):
    out["tokens"] = list(tokens)
    if is_finished:
      done.set()

  for n in (node, *watch):
    n.on_token.register(f"t-{n.id}").on_next(on_token)
  await node.process_prompt(Shard(model, 0, n_layers - 1, n_layers), prompt, f"req-{node.id}")
  await asyncio.wait_for(done.wait(), timeout=120)
  return out["tokens"]


async def test_two_partition_inprocess_ring_keeps_hidden_on_device(tiny_model_dir, monkeypatch):
  """A whole per-token generation on a two-partition ring in one process: no hidden
  state reaches the host (0 hop bytes copied, every hop a tensor handed over), and the
  stream equals a solo Node's and JAX's in-process ring's."""
  monkeypatch.setenv("XOT_DTYPE", "float32")
  max_tokens = 8
  solo = _node("solo", _engine(tiny_model_dir), max_tokens)
  solo.topology.update_node("solo", _caps())
  want = await _generate(solo, "hello device hops", max_tokens)
  _shutdown([solo])
  ja, jb = await j_inprocess_ring(tiny_model_dir, max_tokens)
  assert await j_generate(ja, N, "hello device hops", max_tokens, watch=(jb,)) == want

  node_a, node_b = _inprocess_ring(max_tokens, tiny_model_dir)
  hops = []
  for node in (node_a, node_b):
    orig = node.process_tensor

    async def spy(base_shard, tensor, request_id=None, inference_state=None, _orig=orig):
      if getattr(tensor, "ndim", 0) == 3:
        hops.append(type(tensor))
      return await _orig(base_shard, tensor, request_id, inference_state)
    node.process_tensor = spy
  try:
    got = await _generate(node_a, "hello device hops", max_tokens, watch=(node_b,))
  finally:
    _shutdown([node_a, node_b])
  assert got == want and len(got) == max_tokens
  engines = [node_a.inference_engine, node_b.inference_engine]
  assert sum(e.host_hop_bytes for e in engines) == 0
  assert hops and all(t is torch.Tensor for t in hops), hops
  assert sum(e.device_hops for e in engines) == len(hops) == max_tokens


@pytest.mark.parametrize("dtype,want", [("float32", np.ndarray), ("bfloat16", torch.Tensor)])
async def test_cross_host_hop_still_materialises(tiny_model_dir, monkeypatch, dtype, want):
  """A hop to a peer that takes no device tensors is copied to the host at the send and
  only there: numpy for fp32, a bf16 CPU tensor (the codec's raw bf16 frame) for bf16.
  The engine is made to keep its output on the device whatever the peer (as when the
  peer changed between the forward and the send), so forward_tensor's copy is what
  the wire path sees; the ring still completes."""
  monkeypatch.setenv("XOT_DTYPE", dtype)
  nodes = _inprocess_ring(4, tiny_model_dir)
  sent = []

  class HostOnlyPeer(InProcessPeerHandle):
    accepts_device_arrays = False

    async def send_tensor(self, shard, tensor, request_id=None, inference_state=None):
      sent.append((type(tensor), getattr(tensor, "dtype", None)))
      await super().send_tensor(shard, tensor, request_id, inference_state)

  for node in nodes:
    node.peers = [HostOnlyPeer(o) for o in nodes if o is not node]
    monkeypatch.setattr(node, "_keep_on_device_kwargs", lambda shard, rid=None: {"keep_on_device": True})
  try:
    got = await _generate(nodes[0], "hello wire", 4, watch=nodes[1:])
  finally:
    _shutdown(nodes)
  assert len(got) == 4
  hidden = [(t, d) for t, d in sent if d not in (np.int64, np.dtype(np.int64))]
  assert hidden and all(t is want for t, _ in hidden), sent
  if want is torch.Tensor:
    assert all(d == torch.bfloat16 for _, d in hidden)
  assert sum(n.inference_engine.device_hops for n in nodes) == len(hidden) == 4


async def test_inprocess_ring_matches_tcp_ring(jax_weights, tmp_path):
  """The in-process transport is an optimisation only: the per-token stream with the
  hops on the device equals the TCP ring's, whose hops cross as frames."""
  ring = await Ring(tmp_path, ["node-b", "node-a"]).start()
  try:
    want, error = await ring_generate(ring.nodes["node-a"], "tcp")
    assert error is None
    assert sum(e.device_hops for e in ring.engines.values()) == 0
    assert sum(e.host_hop_bytes for e in ring.engines.values()) > 0
  finally:
    await ring.stop()
  nodes = _inprocess_ring(GEN, names=("node-b", "node-a"))
  try:
    got = await _generate(nodes[1], PROMPT, GEN, watch=(nodes[0],), model=MODEL, n_layers=4)
  finally:
    _shutdown(nodes)
  assert got == want
  assert sum(n.inference_engine.host_hop_bytes for n in nodes) == 0
  assert sum(n.inference_engine.device_hops for n in nodes) == GEN
