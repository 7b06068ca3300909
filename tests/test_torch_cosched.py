"""Co-scheduled prefill (XOT_PREFILL_COSCHED, XOT_PREFILL_CHUNK_BUDGET) in the port's
engine against the JAX engine's, on the CPU.

synthetic-tiny in fp32 on the JAX engine's weights, page 16, XOT_PREFILL_CHUNK=24 (so
segment edges fall mid-page). A 157-token prompt prefills while a short request
decodes: with co-scheduling on, off, and on the JAX engine, both streams are the same
(the CPU runs one row width at a time, so here they are equal), and the prompt's
slices run between the decode dispatches. Then the lane's failure contracts: a
request evicted between its slices raises RequestStateLost instead of restarting at
position 0, pool exhaustion mid-prefill fails only that request and gives its pages
back at once, and an idle engine keeps the one-call prefill.
"""
import asyncio

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_weights  # noqa: F401 (fixture)
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu_torch.inference.engine import CacheExhausted, RequestStateLost
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.orchestration.flight import FlightRecorder

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
SHARD, JSHARD = Shard(MODEL, 0, 3, 4), JShard(MODEL, 0, 3, 4)
LONG = np.array([np.arange(6 * 24 + 13) % 250 + 1], dtype=np.int64)  # 6 whole segments + 13
SHORT = np.array([[7, 3, 11, 2]], dtype=np.int64)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  for name, value in (("XOT_DTYPE", "float32"), ("XOT_SEED", "7"), ("XOT_CACHE_LEN", "16"),
                      ("XOT_KV_PAGE", "16"), ("XOT_PREFILL_CHUNK", "24"),
                      ("XOT_KV_POOL_TOKENS", "1024")):
    monkeypatch.setenv(name, value)
  with jax.default_matmul_precision("highest"):
    yield


def _set(monkeypatch, **env):
  for name, value in env.items():
    monkeypatch.setenv(name, str(value))


async def _generate(eng, shard, rid, prompt, chunks=3, size=8):
  tok, _ = await eng.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
  toks = [int(tok)]
  for _ in range(chunks):
    out = await eng.generate_chunk(rid, shard, toks[-1], size, temp=0.0, top_k=0)
    toks.extend(int(t) for t in np.asarray(out).reshape(-1))
  return toks


async def _concurrent(eng, shard, marks=None):
  """A short request decodes six 4-token chunks while LONG prefills and decodes two:
  (short stream, long stream). `marks` collects, at each fill slice, how many decode
  chunks of the short request had resolved."""
  done = {"n": 0}
  if marks is not None:
    real = eng._prefill_fill_sync

    def marking(ctx, rid, sl, paged_native, *rest):
      marks.append(done["n"])
      return real(ctx, rid, sl, paged_native, *rest)
    eng._prefill_fill_sync = marking
  tok, _ = await eng.infer_sample_tensor("a", shard, SHORT, temp=0.0, top_k=0)
  toks_a = [int(tok)]

  async def decode_a():
    for _ in range(6):
      out = await eng.generate_chunk("a", shard, toks_a[-1], 4, temp=0.0, top_k=0)
      toks_a.extend(int(t) for t in np.asarray(out).reshape(-1))
      done["n"] += 1

  _, toks_b = await asyncio.gather(decode_a(), _generate(eng, shard, "b", LONG, chunks=2, size=4))
  return toks_a, toks_b


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_cosched_streams_equal_off_and_jax(paged, jax_weights, monkeypatch):
  """Both streams with co-scheduling on equal those with it off and the JAX engine's;
  the long prompt went through the lane (six one-segment fill slices), decode chunks
  resolved between its slices, and the paged run copied and grew nothing."""
  _set(monkeypatch, XOT_PAGED_KV=paged)
  jeng = JAXShardInferenceEngine(dtype="float32")
  want = await _concurrent(jeng, JSHARD)
  marks = []
  on = TorchShardInferenceEngine(device="cpu", seed=0)
  got = await _concurrent(on, SHARD, marks)
  _set(monkeypatch, XOT_PREFILL_COSCHED=0)
  off = TorchShardInferenceEngine(device="cpu", seed=0)
  off_marks = []
  got_off = await _concurrent(off, SHARD, off_marks)
  assert got == got_off == want
  assert len(marks) == 6 and marks[-1] > marks[0], marks
  assert on._ctx.batcher.slices == 8  # the prologue, six fills, the sampled tail
  assert len(off_marks) == 1 and off._ctx.batcher.slices == 0
  if paged == "1":
    assert on._commit_copy_bytes == 0 and on._grow_copies == 0
  for e in (jeng, on, off):
    e.executor.shutdown(wait=True)


async def test_slices_interleave_with_decode_dispatches(monkeypatch):
  """The flight recorder's order: each drain cycle dispatches decode first, then one
  prefill slice, so decode dispatches fall between the prompt's slices; the slices are
  observed as prefill dispatches and booked by the prefill lane's queue wait."""
  _set(monkeypatch, XOT_PAGED_KV=1)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  eng.flight = FlightRecorder(node_id="n", capacity=4096)
  await _concurrent(eng, SHARD)
  kinds = [e["event"] for e in eng.flight.tail() if e["event"].startswith("batcher.")]
  slices = [i for i, k in enumerate(kinds) if k == "batcher.prefill_slice"]
  assert len(slices) == 8
  between = [kinds[a + 1:b].count("batcher.dispatch") for a, b in zip(slices, slices[1:])]
  assert sum(between) >= 3 and max(between) <= 1, kinds
  lanes = eng.perf.lanes()
  assert lanes["prefill"]["tokens"] == SHORT.shape[1] + LONG.shape[1]
  eng.executor.shutdown(wait=True)


async def test_eviction_between_slices_raises_state_lost(monkeypatch):
  """A request evicted between two of its slices (here by hand, as an LRU burst would)
  fails its next slice with RequestStateLost: it is never recreated at position 0."""
  _set(monkeypatch, XOT_PAGED_KV=1)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  real = eng._prefill_fill_sync
  calls = []

  def evicting(ctx, rid, sl, paged_native, *rest):
    calls.append(rest[0])  # expected_pos
    if len(calls) == 3:
      eng._drop_state(ctx, rid)
    return real(ctx, rid, sl, paged_native, *rest)
  eng._prefill_fill_sync = evicting
  tok, _ = await eng.infer_sample_tensor("a", SHARD, SHORT, temp=0.0, top_k=0)

  async def decode_a():
    for _ in range(4):
      await eng.generate_chunk("a", SHARD, int(tok), 4, temp=0.0, top_k=0)
  with pytest.raises(RequestStateLost, match="evicted mid-co-scheduled prefill"):
    await asyncio.gather(decode_a(), eng.infer_sample_tensor("b", SHARD, LONG, temp=0.0, top_k=0))
  assert calls[:3] == [None, 24, 48]
  assert "b" not in eng._ctx.states
  eng.executor.shutdown(wait=True)


async def test_pool_exhaustion_mid_prefill_spares_decode_streams(jax_weights, monkeypatch):
  """Eight usable pages: two short streams hold two each, and a 100-token prompt's
  slices run out of pages. CacheExhausted fails that request only; its partial pages
  go back at the failure; the two streams go on as the JAX engine's do."""
  _set(monkeypatch, XOT_PAGED_KV=1, XOT_KV_POOL_TOKENS=128, XOT_PREFIX_CACHE=0)
  s1 = np.array([[7, 3, 11, 2, 9]], dtype=np.int64)
  s2 = np.array([[42, 17, 5, 9, 1, 13]], dtype=np.int64)
  big = np.array([np.arange(100) % 250 + 1], dtype=np.int64)
  out = {}
  for name, eng, shard in (("jax", JAXShardInferenceEngine(dtype="float32"), JSHARD),
                           ("port", TorchShardInferenceEngine(device="cpu", seed=0), SHARD)):
    t1, _ = await eng.infer_sample_tensor("s1", shard, s1, temp=0.0, top_k=0)
    t2, _ = await eng.infer_sample_tensor("s2", shard, s2, temp=0.0, top_k=0)
    toks = {"s1": [int(t1)], "s2": [int(t2)]}

    async def decode_some():
      outs = await asyncio.gather(*(eng.generate_chunk(r, shard, toks[r][-1], 8, temp=0.0, top_k=0)
                                    for r in ("s1", "s2")))
      for r, o in zip(("s1", "s2"), outs):
        toks[r].extend(int(t) for t in np.asarray(o).reshape(-1))
    await decode_some()
    fail = CacheExhausted if name == "port" else Exception
    with pytest.raises(fail):
      await asyncio.gather(decode_some(), eng.infer_sample_tensor("big", shard, big, temp=0.0,
                                                                  top_k=0))
    await decode_some()
    out[name] = toks
    if name == "port":
      ctx = eng._ctx
      assert "big" not in ctx.states and ctx.batcher.slices >= 2
      held = ctx.page_pool.pages_in_use
      assert held == sum(len(ctx.states[r].pages) for r in ("s1", "s2"))
      for r in ("s1", "s2"):
        await eng.clear_request(r)
      assert ctx.page_pool.pages_in_use == 0
    eng.executor.shutdown(wait=True)
  assert out["port"] == out["jax"]


@pytest.mark.parametrize("cosched", ["1", "0"], ids=["on-idle", "off-busy"])
async def test_one_call_prefill_when_idle_or_off(cosched, monkeypatch):
  """An idle engine (nothing else active) and XOT_PREFILL_COSCHED=0 under load both keep
  the one-call prefill: _prefill_fill_sync runs once, inside the executor call, and
  the batcher's lane never sees a slice."""
  _set(monkeypatch, XOT_PAGED_KV=1, XOT_PREFILL_COSCHED=cosched)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  called = []
  real = eng._prefill_fill_sync
  eng._prefill_fill_sync = lambda *a: (called.append(1), real(*a))[1]
  if cosched == "1":
    await eng.infer_sample_tensor("b", SHARD, LONG, temp=0.0, top_k=0)
  else:
    await _concurrent(eng, SHARD)
  assert called == [1]
  assert eng._ctx.batcher is None or eng._ctx.batcher.slices == 0
  eng.executor.shutdown(wait=True)
