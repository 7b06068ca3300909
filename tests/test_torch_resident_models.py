"""Two resident models on one port engine (XOT_MAX_RESIDENT_MODELS, the JAX engine's
LRU of model contexts), against the JAX engine, on the CPU.

The twins of tests/test_fused_decode.py's model-switch scenarios run the same steps
on the JAX engine and on the port's, both serving the same transformers-written
checkpoints in fp32: a request on model A survives model B's load, prefill and decode
and resumes to the stream A alone gives; a third model evicts the idle context, not the
busy one, or, when both are busy, the oldest, whose request then fails loudly; each
model's EOS ids come from its own context whatever is active. Then the port's own:
the ROADMAP's interleaving on synthetic cards (A on synthetic-tiny, B on
synthetic-tiny-gemma2, A continues) streams A as A alone does, an evicted context's
graphs are cleared explicitly, and OOM recovery drops every context but the active
one, reporting the count as JAX's does. Greedy streams are compared exactly.
"""
import asyncio

import jax
import numpy as np
import pytest
import torch

from tests.test_model_equivalence import TINY_LLAMA_CFG, make_hf_checkpoint
from tests.test_speculative import _NoDiscovery, _NullServer
from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.orchestration.node import Node as JNode
from xotorch_tpu.topology.device_capabilities import DeviceCapabilities as JCaps
from xotorch_tpu.topology.device_capabilities import DeviceFlops as JFlops
from xotorch_tpu.topology.partitioning import RingMemoryWeightedPartitioningStrategy as JStrategy
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.engine import RequestStateLost
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import registry
from xotorch_tpu_torch.orchestration.node import Node
from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy

torch.set_num_threads(2)

N = TINY_LLAMA_CFG["num_hidden_layers"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_SEED", "7")
  with jax.default_matmul_precision("highest"):
    yield


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
  """Three checkpoints of the tiny llama, seeds 3, 11 and 17."""
  root = tmp_path_factory.mktemp("resident")
  return {m: make_hf_checkpoint(root / m, TINY_LLAMA_CFG, seed=seed)
          for m, seed in (("a", 3), ("b", 11), ("c", 17))}


def _engines(dirs, models=("a", "b", "c")):
  mapping = {m: dirs[m] for m in models}
  return (TorchShardInferenceEngine(LocalShardDownloader(mapping), device="cpu", seed=0),
          JAXShardInferenceEngine(JLocalShardDownloader(mapping), dtype="float32"))


def _shards(m):
  return Shard(m, 0, N - 1, N), JShard(m, 0, N - 1, N)


def _shutdown(*engines):
  for e in engines:
    e.executor.shutdown(wait=True)


async def _prefill(eng, shard, rid, prompt):
  logits, _ = await eng.infer_tensor(rid, shard, prompt)
  return int(np.argmax(np.asarray(logits)[0, -1])), np.asarray(logits)


async def _switch_run(eng, sa, sb):
  """test_fused_decode.py:292's interleaving: A prefills, B loads, prefills and decodes,
  then A decodes 6. Returns (A's stream, B's chunk, A's and B's last logits)."""
  prompt = np.array([[1, 5, 9, 2]], dtype=np.int64)
  tok_a, logits_a = await _prefill(eng, sa, "ra", prompt)
  tok_b, logits_b = await _prefill(eng, sb, "rb", np.array([[7, 3]], dtype=np.int64))
  toks_b = [int(t) for t in await eng.generate_chunk("rb", sb, tok_b, 4, temp=0.0)]
  got = [tok_a] + [int(t) for t in await eng.generate_chunk("ra", sa, tok_a, 6, temp=0.0)]
  return got, toks_b, logits_a[:, -1], logits_b[:, -1]


async def test_model_switch_preserves_inflight_request(dirs):
  """A request on model A continues uncorrupted after model B loads, prefills and decodes
  on the same engine: its stream equals an A-only run's and the JAX engine's, both
  contexts stay resident with their own states, and B's weights really served."""
  (sa, jsa), (sb, jsb) = _shards("a"), _shards("b")
  ref, _ = _engines(dirs, ("a",))
  tok, _ = await _prefill(ref, sa, "r", np.array([[1, 5, 9, 2]], dtype=np.int64))
  expect = [tok] + [int(t) for t in await ref.generate_chunk("r", sa, tok, 6, temp=0.0)]

  port, jeng = _engines(dirs, ("a", "b"))
  got, toks_b, la, lb = await _switch_run(port, sa, sb)
  jgot, jtoks_b, _, _ = await _switch_run(jeng, jsa, jsb)
  assert got == expect == jgot
  assert toks_b == jtoks_b and len(toks_b) == 4
  assert len(port._contexts) == 2 == len(jeng._contexts)
  assert "ra" in port._contexts[sa].states and "rb" in port._contexts[sb].states
  assert not np.allclose(la, lb)
  _shutdown(ref, port, jeng)


async def test_context_eviction_mid_generation_fails_loudly(dirs):
  """With A and B both holding a request, loading C evicts the oldest busy one (A), and
  A's next chunk raises RequestStateLost on both engines: never a silent restart."""
  port, jeng = _engines(dirs)
  for eng, sh in ((port, lambda m: _shards(m)[0]), (jeng, lambda m: _shards(m)[1])):
    tok, _ = await _prefill(eng, sh("a"), "victim", np.array([[1, 5, 9]], dtype=np.int64))
    await eng.infer_tensor("other", sh("b"), np.array([[2, 7]], dtype=np.int64))
    await eng.ensure_shard(sh("c"))
    assert sh("a") not in eng._contexts and sh("b") in eng._contexts
    with pytest.raises(Exception) as err:
      await eng.generate_chunk("victim", sh("a"), tok, 4, temp=0.0)
    assert type(err.value).__name__ == "RequestStateLost"
  with pytest.raises(RequestStateLost):
    await port.verify_draft("victim", _shards("a")[0], 1, [2, 3])
  _shutdown(port, jeng)


async def test_busy_context_survives_eviction_preference(dirs):
  """Eviction prefers a context with no request states: a busy A outlives an idle B
  loaded after it, on both engines, and A's request still decodes."""
  port, jeng = _engines(dirs)
  for eng, sh in ((port, lambda m: _shards(m)[0]), (jeng, lambda m: _shards(m)[1])):
    await eng.infer_tensor("busy", sh("a"), np.array([[1, 5]], dtype=np.int64))
    await eng.ensure_shard(sh("b"))
    await eng.ensure_shard(sh("c"))
    assert list(eng._contexts) == [sh("a"), sh("c")]
  assert len(await port.generate_chunk("busy", _shards("a")[0], 3, 2, temp=0.0)) == 2
  _shutdown(port, jeng)


def _port_node(eng, **kw):
  return Node("eos-node", None, eng, None, RingMemoryWeightedPartitioningStrategy(), **kw)


async def test_eos_check_uses_request_model_not_active_model(dirs, tmp_path):
  """Each model's EOS ids come from its own context, whatever context is active, in
  the engine and in the Node's per-request check, as in JAX."""
  dir_a = make_hf_checkpoint(tmp_path / "a", dict(TINY_LLAMA_CFG, eos_token_id=7), seed=3)
  dir_b = make_hf_checkpoint(tmp_path / "b", dict(TINY_LLAMA_CFG, eos_token_id=99), seed=11)
  mapping = {"a": dir_a, "b": dir_b}
  port = TorchShardInferenceEngine(LocalShardDownloader(mapping), device="cpu", seed=0)
  jeng = JAXShardInferenceEngine(JLocalShardDownloader(mapping), dtype="float32")
  (sa, jsa), (sb, jsb) = _shards("a"), _shards("b")
  for eng, a, b in ((port, sa, sb), (jeng, jsa, jsb)):
    await eng.ensure_shard(a)
    await eng.ensure_shard(b)  # B is now the active context
  assert set(port.eos_token_ids_for(sa)) == set(jeng.eos_token_ids_for(jsa))
  assert set(port.eos_token_ids_for(sb)) == set(jeng.eos_token_ids_for(jsb))
  assert 7 in port.eos_token_ids_for(sa) and 99 not in port.eos_token_ids_for(sa)
  assert 99 in port.eos_token_ids_for(sb)
  node = _port_node(port, max_generate_tokens=50)
  jnode = JNode("eos-node", _NullServer(), jeng, _NoDiscovery(), None, JStrategy(),
                max_generate_tokens=50)
  jnode.device_capabilities = JCaps("test", "chip", 1024, JFlops(1, 2, 4))
  jnode.topology.update_node(jnode.id, jnode.device_capabilities)
  assert 7 in node._eos_token_ids(sa) and 99 not in node._eos_token_ids(sa)
  assert set(node._eos_token_ids(sa)) == set(jnode._eos_token_ids(jsa))
  await node.stop()
  _shutdown(port, jeng)


async def test_oom_recovery_drops_every_context_but_the_active_one(dirs):
  """OOM recovery frees every context's states and drops every context but the active
  one, reporting them in `freed` as JAX's does; the dropped model's request then fails
  loudly and the active one takes new requests."""
  port, jeng = _engines(dirs, ("a", "b"))
  freed = []
  for eng, sh in ((port, lambda m: _shards(m)[0]), (jeng, lambda m: _shards(m)[1])):
    await eng.infer_tensor("ra", sh("a"), np.array([[1, 5, 9]], dtype=np.int64))
    await eng.infer_tensor("rb", sh("b"), np.array([[2, 7]], dtype=np.int64))
    freed.append(eng._free_device_memory())
    assert list(eng._contexts) == [sh("b")]
  assert freed[0] == freed[1] == "0 prefix snapshots (0 spilled to host tier), 2 request states, " \
                                 "1 model contexts"
  with pytest.raises(RequestStateLost):
    await port.generate_chunk("ra", _shards("a")[0], 1, 2, temp=0.0)
  tok, _ = await _prefill(port, _shards("b")[0], "fresh", np.array([[4, 4]], dtype=np.int64))
  assert len(await port.generate_chunk("fresh", _shards("b")[0], tok, 2, temp=0.0)) == 2
  _shutdown(port, jeng)


class _Graphs:
  """A stand-in GraphCache that records its clear()."""

  def __init__(self):
    self.cleared = 0
    self.programs, self.pool_bytes, self.slab_bytes, self.captures = {}, 0, 0, 0

  def clear(self):
    self.cleared += 1


async def test_synthetic_interleaving_and_explicit_graph_teardown(monkeypatch):
  """The ROADMAP's F5 interleaving on the synthetic cards: A decodes on synthetic-tiny,
  B prefills on synthetic-tiny-gemma2, A continues, and A streams what A alone streams.
  A third model then evicts the idle context, whose graphs are cleared explicitly, and
  /v1/perf lists the resident contexts."""
  # A third card: synthetic-tiny's config under another id.
  monkeypatch.setitem(registry.model_cards, "synthetic-tiny-c",
                      dict(registry.model_cards["synthetic-tiny"]))
  a, b, c = (Shard(m, 0, 3, 4) for m in ("synthetic-tiny", "synthetic-tiny-gemma2",
                                          "synthetic-tiny-c"))
  prompt = np.array([[1, 5, 9, 200, 17, 3]], dtype=np.int64)

  async def stream(eng, interleave):
    tok, _ = await eng.infer_sample_tensor("A", a, prompt, temp=0.0, top_k=0)
    out = [int(tok)]
    out += [int(t) for t in await eng.generate_chunk("A", a, out[-1], 4, temp=0.0, top_k=0)]
    if interleave:
      await eng.infer_sample_tensor("B", b, np.array([[3, 4, 5]], dtype=np.int64), temp=0.0, top_k=0)
    out += [int(t) for t in await eng.generate_chunk("A", a, out[-1], 8, temp=0.0, top_k=0)]
    return out

  alone = await stream(TorchShardInferenceEngine(device="cpu", seed=0), False)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  assert await stream(eng, True) == alone
  ctx_b = eng._contexts[b]
  ctx_b.graphs = _Graphs()
  await eng.clear_request("B")  # B idle: the eviction's first choice
  await eng.ensure_shard(c)
  assert list(eng._contexts) == [a, c] and ctx_b.graphs.cleared == 1
  report = eng.perf_report()
  assert [(r["model_id"], r["active"]) for r in report["contexts"]] == [
    ("synthetic-tiny", False), ("synthetic-tiny-c", True)]
  eng.executor.shutdown(wait=True)
