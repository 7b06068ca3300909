"""Training over the port's ring (Node.enqueue_example / process_example, SendExample
in process and over the TCP twin, coordinate_save / coordinate_resume) against the JAX
package's and against one peer, on the CPU.

- JAX's two-node training ring (tests/test_orchestration.py) with the dummy engine, on
  both packages and the port's two transports: the loss comes back through the chain;
- two torch engines on synthetic-tiny in fp32, split 2/2, trained from the peer that
  does not hold layer 0: the losses of three steps equal the single peer's within
  1e-5 and every updated parameter within 1e-3 x lr a step of it (train/step.py's
  AdamW tolerance; the same batches, the same seeded weights);
- SendExample's fault tap: a killed peer fails the training hop, once, without a
  retry (a step is not idempotent);
- coordinate_save saves every peer's shard and coordinate_resume restores every
  peer's range.
"""
import asyncio

import numpy as np
import pytest
import torch

from tests.test_torch_survivability import Kit
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.networking import faults
from xotorch_tpu_torch.networking.tcp.peer_handle import TCPPeerHandle
from xotorch_tpu_torch.train import step

torch.set_num_threads(2)

MODEL = "synthetic-tiny"  # 4 layers
LR = 1e-2


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  for name in ("XOT_LORA_RANK", "XOT_QUANTIZE", "XOT_SAVE_OPT_STATE"):
    monkeypatch.delenv(name, raising=False)
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_LR", str(LR))
  monkeypatch.setenv("XOT_SEED", "7")
  yield
  faults.install(None)


def _batch(seed):
  rng = np.random.default_rng(seed)
  x = rng.integers(3, 256, (2, 13))
  return x[:, :-1], x[:, 1:], np.array([12, 9])


def _origin_without_layer_0(a, b, base):
  return a if a.get_current_shard(base).start_layer else b


@pytest.mark.parametrize("transport", [("grpc", "inprocess"), ("grpc", "tcp")])
async def test_two_node_training_ring_with_the_dummy_engine(transport):
  """JAX's test: the loss comes back from the last shard through the chain, on both
  packages."""
  out = {}
  for kit in (Kit("jax", transport[0]), Kit("port", transport[1])):
    a, b = await kit.ring(kit.Dummy(), kit.Dummy())
    try:
      example = np.ones((1, 4), dtype=np.int64)
      for train in (True, False):
        loss, grads = await a.enqueue_example(kit.Shard("dummy", 0, 0, 8), example, example,
                                              np.array([4], dtype=np.int64), train=train)
        out.setdefault(kit.pkg, []).append((loss, grads is None))
      assert not a._request_ring_map and not b._request_ring_map  # dropped when it returns
    finally:
      await kit.stop(a, b)
  assert out["port"] == out["jax"] == [(0.42, False), (0.42, True)]


async def _trained_single(batches):
  eng = TorchShardInferenceEngine(device="cpu", seed=7)
  shard = Shard(MODEL, 0, 3, 4)
  losses = [(await eng.train_example(f"s{i}", shard, *b))[0] for i, b in enumerate(batches)]
  evals = await eng.evaluate_example("se", shard, *_batch(9))
  params = {p: t.clone() for p, t in step.leaf_paths(eng._ctx.params)}
  eng.executor.shutdown(wait=True)
  return losses, evals, params


@pytest.mark.parametrize("transport", ["inprocess", "tcp"])
async def test_torch_ring_training_matches_the_single_peer(transport):
  batches = [_batch(s) for s in range(3)]
  want_losses, want_eval, want = await _trained_single(batches)
  kit = Kit("port", transport)
  engines = [TorchShardInferenceEngine(device="cpu", seed=7) for _ in range(2)]
  a, b = await kit.ring(*engines)
  base = Shard(MODEL, 0, 0, 4)
  try:
    origin = _origin_without_layer_0(a, b, base)
    losses = [(await origin.enqueue_example(base, *bt, train=True))[0] for bt in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    loss, grads = await origin.enqueue_example(base, *_batch(9), train=False)
    assert grads is None
    np.testing.assert_allclose(loss, want_eval, rtol=1e-5)
    for node in (a, b):
      shard = node.get_current_shard(base)
      ctx = node.inference_engine._contexts[shard]
      for path, t in step.leaf_paths(ctx.params):
        ref = want[path]
        if path[0] == "layers":
          ref = ref[shard.start_layer:shard.end_layer + 1]
        np.testing.assert_allclose(t.numpy(), ref.numpy(), rtol=0, atol=1e-3 * LR * len(batches),
                                   err_msg=f"{node.id} {'/'.join(path)}")
      assert not node._request_ring_map
    if transport == "tcp":
      wire = {n.id: n.peers[0].wire.get("SendExample", [0, 0, 0]) for n in (a, b)}
      # Each training step: one hop from the origin to layer 0's owner, one back down.
      assert sorted(c[0] for c in wire.values()) == [4, 4], wire
  finally:
    await kit.stop(a, b)
    for e in engines:
      e.executor.shutdown(wait=True)


@pytest.mark.parametrize("transport", ["inprocess", "tcp"])
async def test_a_killed_peer_fails_the_training_hop_without_a_retry(transport, monkeypatch):
  monkeypatch.setenv("XOT_HOP_RETRIES", "2")
  kit = Kit("port", transport)
  a, b = await kit.ring(kit.Dummy(), kit.Dummy())
  base = kit.Shard("dummy", 0, 0, 8)
  try:
    origin = _origin_without_layer_0(a, b, base)
    target = b if origin is a else a
    faults.install(faults.FaultInjector([{"rpc": "SendExample", "peer": target.id, "action": "kill"}]))
    example = np.ones((1, 4), dtype=np.int64)
    with pytest.raises(faults.TransientHopError, match="killed"):
      await origin.enqueue_example(base, example, example, np.array([4]), train=True)
    assert not origin._request_ring_map
    if transport == "tcp":
      assert "SendExample" not in origin.peers[0].wire  # failed at the tap, never sent
    faults.install(faults.FaultInjector([{"rpc": "SendExample", "nth": 1, "action": "error"}]))
    with pytest.raises(faults.TransientHopError):
      await origin.enqueue_example(base, example, example, np.array([4]), train=True)
    # One attempt: the second call, the rule spent, goes through.
    assert (await origin.enqueue_example(base, example, example, np.array([4]), train=True))[0] == 0.42
  finally:
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", ["inprocess", "tcp"])
async def test_coordinate_save_and_resume_reach_every_peer(transport, tmp_path, monkeypatch):
  monkeypatch.setenv("XOT_LORA_RANK", "2")
  kit = Kit("port", transport)
  engines = [TorchShardInferenceEngine(device="cpu", seed=7) for _ in range(2)]
  a, b = await kit.ring(*engines)
  base = Shard(MODEL, 0, 0, 4)
  prompt = np.array([[1, 5, 9, 2]], dtype=np.int64)
  try:
    origin = _origin_without_layer_0(a, b, base)
    first = b if origin is a else a
    for i in range(2):
      await origin.enqueue_example(base, *_batch(i), train=True)
    await origin.coordinate_save(base, 2, str(tmp_path))
    want_files = ["0-1-2-opt.safetensors", "0-1-2.safetensors", "2-3-2-opt.safetensors",
                  "2-3-2.safetensors"]
    for _ in range(100):  # the peer saves when the status arrives
      if sorted(p.name for p in (tmp_path / MODEL).glob("*")) == want_files:
        break
      await asyncio.sleep(0.05)
    assert sorted(p.name for p in (tmp_path / MODEL).glob("*")) == want_files
    assert {n.id: n.checkpoints for n in (a, b)} == {
      first.id: {MODEL: {"0-1": 2}}, origin.id: {MODEL: {"2-3": 2}}}
    hidden, _ = await first.inference_engine.infer_tensor("c", first.get_current_shard(base), prompt)
    want, _ = await origin.inference_engine.infer_tensor("c", origin.get_current_shard(base), hidden)
  finally:
    await kit.stop(a, b)
    for e in engines:
      e.executor.shutdown(wait=True)
  fresh = [TorchShardInferenceEngine(device="cpu", seed=7) for _ in range(2)]
  a, b = await kit.ring(*fresh)
  try:
    origin = _origin_without_layer_0(a, b, base)
    first = b if origin is a else a
    await origin.coordinate_resume(base, str(tmp_path / MODEL))
    for _ in range(100):
      ctx = first.inference_engine._contexts.get(first.get_current_shard(base))
      if ctx is not None and ctx.optimizer is not None:
        break
      await asyncio.sleep(0.05)
    hidden, _ = await first.inference_engine.infer_tensor("c", first.get_current_shard(base), prompt)
    got, _ = await origin.inference_engine.infer_tensor("c", origin.get_current_shard(base), hidden)
    np.testing.assert_allclose(got, want, atol=1e-6)
    for node in (a, b):  # each peer took its own save, and the moments beside it
      assert node.inference_engine._contexts[node.get_current_shard(base)].optimizer is not None
  finally:
    await kit.stop(a, b)
    for e in fresh:
      e.executor.shutdown(wait=True)


def test_tcp_send_example_is_one_attempt_with_a_long_timeout(monkeypatch):
  seen = {}

  async def call(self, method, fields, tensors=None, timeout=15.0, retriable=True):
    seen.update(method=method, timeout=timeout, retriable=retriable, tensors=sorted(tensors))
    return {"loss": 1.5}, {"grads": np.zeros(2)}
  monkeypatch.setattr(TCPPeerHandle, "_call", call)
  peer = TCPPeerHandle("p", "127.0.0.1:1", "test", None)
  loss, grads = asyncio.run(peer.send_example(Shard(MODEL, 0, 1, 4), np.ones((1, 2)), np.ones((1, 2)),
                                              np.array([2]), True, "r"))
  assert (loss, grads.shape) == (1.5, (2,))
  assert seen == {"method": "SendExample", "timeout": 600.0, "retriable": False,
                  "tensors": ["example", "length", "target"]}
