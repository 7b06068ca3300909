"""Continuous batching and the paged engine paths of the port, on the CPU.

`decode_chunk_batched` must pick JAX's greedy tokens for rows at different positions
with a pad row. `TorchShardInferenceEngine` serves synthetic-tiny in fp32 on the JAX
engine's weights (carried across by params_from_jax) and must produce the JAX
engine's greedy streams for eight concurrent requests: through the batcher on the
page pool (XOT_PAGED_KV=1, page 16, a 512-token pool), on stacked contiguous caches
(XOT_PAGED_KV=0) and one request at a time (XOT_DECODE_BATCH=1). Then the pool's
contracts: it drains when requests clear, exhaustion fails only the incoming request,
an idle defrag pass moves pages under live requests without changing their streams,
and the least recently used state goes at XOT_MAX_RESIDENT_REQUESTS.
"""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_weights  # noqa: F401 (fixture)
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import generate as j_generate
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.models.registry import get_model_card as j_get_model_card
from xotorch_tpu_torch.inference.engine import CacheExhausted, RequestStateLost
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import generate, transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
SHARD = Shard(MODEL, 0, 3, 4)
CHUNK, CHUNKS = 4, 3  # each stream: the prefill's token + 3 chunks of 4
PROMPTS = {f"r{i}": np.random.default_rng(100 + i).integers(3, 256, size=(1, n))
           for i, n in enumerate((3, 5, 7, 9, 11, 13, 14, 15))}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_CACHE_LEN", "16")
  monkeypatch.setenv("XOT_KV_PAGE", "16")
  monkeypatch.setenv("XOT_KV_POOL_TOKENS", "512")
  with jax.default_matmul_precision("highest"):
    yield


def test_decode_chunk_batched_matches_jax():
  jcfg = j_config_from_hf_dict(j_get_model_card(MODEL)["synthetic_config"])
  cfg = config_from_hf_dict(get_model_card(MODEL)["synthetic_config"])
  jp = j_transformer.init_random_params(jcfg, 4, True, True, jax.random.PRNGKey(0), dtype=jnp.float32)
  params = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
  rng = np.random.default_rng(7)
  S, K = 32, 6
  prompts = [rng.integers(3, 256, size=(1, n)).astype(np.int32) for n in (4, 11, 17)]
  jcaches, caches, last = [], [], []
  for toks in prompts:
    jl, jc = j_transformer.forward_shard(jp, jnp.asarray(toks), j_transformer.init_kv_cache(
      jcfg, 4, 1, S, jnp.float32), jnp.int32(0), jcfg, True, True)
    _, c = transformer.forward_shard(params, torch.from_numpy(toks).long(),
                                     transformer.init_kv_cache(cfg, 4, 1, S, torch.float32), 0, cfg,
                                     True, True)
    jcaches.append(jc)
    caches.append(c)
    last.append(int(np.argmax(np.asarray(jl)[0, -1])))
  pos = np.array([p.shape[1] for p in prompts], np.int32)
  jtoks, jsplit = j_generate.decode_chunk_batched(
    jp, tuple(jcaches), jnp.asarray(np.array(last, np.int32)[:, None]), jnp.asarray(pos),
    jax.random.PRNGKey(0), jcfg, K, jnp.zeros(3, jnp.float32), 0, pad_rows=1)
  toks, split = generate.decode_chunk_batched(
    params, caches, torch.tensor(last)[:, None], torch.from_numpy(pos), cfg, K, torch.zeros(3), 0,
    pad_rows=1)
  np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
  assert len(split) == 3
  for c, jc in zip(split, jsplit):
    assert tuple(c["k"].shape) == (4, 1, S, cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]), atol=1e-4)


async def _stream(engine, shard, rid, prompt, temp=0.0):
  tok, _ = await engine.infer_sample_tensor(rid, shard, prompt, temp=temp, top_k=0)
  out = [int(tok)]
  for _ in range(CHUNKS):
    chunk = await engine.generate_chunk(rid, shard, out[-1], CHUNK, temp=temp, top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
  return out


async def _port_streams(monkeypatch, concurrent=True, **env):
  for name, value in env.items():
    monkeypatch.setenv(name, value)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  if concurrent:
    outs = await asyncio.gather(*(_stream(eng, SHARD, rid, p) for rid, p in PROMPTS.items()))
  else:
    outs = [await _stream(eng, SHARD, rid, p) for rid, p in PROMPTS.items()]
  return eng, dict(zip(PROMPTS, outs))


async def test_concurrent_streams_match_jax_paged_contiguous_and_unbatched(jax_weights, monkeypatch):
  jeng = JAXShardInferenceEngine(dtype="float32")
  want = {rid: await _stream(jeng, JShard(MODEL, 0, 3, 4), rid, p) for rid, p in PROMPTS.items()}

  paged, got = await _port_streams(monkeypatch, XOT_PAGED_KV="1")
  assert got == want
  ctx, batcher = paged._ctx, paged._ctx.batcher
  pool = ctx.page_pool
  assert batcher.rows / batcher.dispatches > 1  # concurrent chunks shared dispatches
  for rid in PROMPTS:
    st = ctx.states[rid]
    assert st.cache is None and len(st.pages) == pool.pages_for(st.pos)
  assert pool.peak_pages_in_use >= len(PROMPTS)
  for rid in PROMPTS:
    await paged.clear_request(rid)
  assert pool.pages_in_use == 0 and not ctx.states

  contiguous, got = await _port_streams(monkeypatch, XOT_PAGED_KV="0")
  assert got == want
  assert contiguous._ctx.page_pool is None
  assert contiguous._ctx.batcher.rows / contiguous._ctx.batcher.dispatches > 1

  single, got = await _port_streams(monkeypatch, concurrent=False, XOT_PAGED_KV="1",
                                    XOT_DECODE_BATCH="1")
  assert got == want and single._ctx.batcher is None
  for eng in (jeng, paged, contiguous, single):
    eng.executor.shutdown(wait=True)


async def test_long_prompt_prefills_page_native_through_k4(jax_weights, monkeypatch):
  """A 40-token prompt at XOT_PREFILL_CHUNK=16 prefills in three paged segments (at 0,
  16 and 32, each through K4's wrapper once per layer) and decodes through K3's: the
  stream is the JAX engine's."""
  monkeypatch.setenv("XOT_PREFILL_CHUNK", "16")
  prompt = np.random.default_rng(40).integers(3, 256, size=(1, 40))
  want = await _stream(JAXShardInferenceEngine(dtype="float32"), JShard(MODEL, 0, 3, 4), "r", prompt)
  calls = {"k3": 0, "k4": 0}
  for name, key in (("paged_decode_attention", "k3"), ("paged_prefill_attention", "k4")):
    real = getattr(transformer, name)

    def counted(*a, _real=real, _key=key, **kw):
      calls[_key] += 1
      return _real(*a, **kw)
    monkeypatch.setattr(transformer, name, counted)
  monkeypatch.setenv("XOT_PAGED_KV", "1")
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  assert await _stream(eng, SHARD, "r", prompt) == want
  assert calls == {"k4": 4 * 3, "k3": 4 * CHUNK * CHUNKS}
  eng.executor.shutdown(wait=True)


async def test_paged_prefill_off_commits_at_first_decode(jax_weights, monkeypatch):
  """XOT_PAGED_PREFILL=0: the prompt prefills into a contiguous buffer (K1/K2), and
  the first decode chunk commits it to pool pages; the stream is unchanged."""
  rid, prompt = "r5", PROMPTS["r5"]
  monkeypatch.setenv("XOT_PAGED_KV", "1")
  want = await _stream(TorchShardInferenceEngine(device="cpu", seed=0), SHARD, rid, prompt)
  monkeypatch.setenv("XOT_PAGED_PREFILL", "0")
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  tok, _ = await eng.infer_sample_tensor(rid, SHARD, prompt, temp=0.0, top_k=0)
  st = eng._ctx.states[rid]
  assert st.cache is not None and st.pages is None and eng._ctx.page_pool is None
  out = [int(tok)]
  for _ in range(CHUNKS):
    out.extend(int(t) for t in await eng.generate_chunk(rid, SHARD, out[-1], CHUNK, temp=0.0, top_k=0))
  assert out == want and st.cache is None and len(st.pages) == eng._ctx.page_pool.pages_for(st.pos)
  eng.executor.shutdown(wait=True)


async def test_pool_exhaustion_fails_only_the_incoming_request(monkeypatch):
  # 4 usable pages of 16: A (20 tokens, bucket 32) takes 2; B (40 tokens, bucket 64)
  # needs 4 and must fail without touching A.
  monkeypatch.setenv("XOT_PAGED_KV", "1")
  monkeypatch.setenv("XOT_KV_POOL_TOKENS", "64")
  prompt_a = np.arange(3, 23).reshape(1, -1)
  want = await _stream(TorchShardInferenceEngine(device="cpu", seed=0), SHARD, "a", prompt_a)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  tok, _ = await eng.infer_sample_tensor("a", SHARD, prompt_a, temp=0.0, top_k=0)
  pool = eng._ctx.page_pool
  held = pool.pages_in_use
  with pytest.raises(CacheExhausted):
    await eng.infer_sample_tensor("b", SHARD, np.arange(3, 43).reshape(1, -1), temp=0.0)
  assert "b" not in eng._ctx.states and pool.pages_in_use == held
  out = [int(tok)]
  for _ in range(CHUNKS):
    out.extend(int(t) for t in await eng.generate_chunk("a", SHARD, out[-1], CHUNK, temp=0.0, top_k=0))
  assert out == want
  await eng.clear_request("a")
  assert pool.pages_in_use == 0
  eng.executor.shutdown(wait=True)


@pytest.mark.parametrize("window_ms,one_dispatch", [(150, True), (0, False)])
async def test_batch_window_coalesces_staggered_submitters(window_ms, one_dispatch, monkeypatch):
  """With XOT_BATCH_WINDOW_MS=150 three submitters 20 ms apart share one dispatch;
  with no window the first goes alone."""
  monkeypatch.setenv("XOT_BATCH_WINDOW_MS", str(window_ms))
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  firsts = {}
  for rid in ("r0", "r1", "r2"):
    firsts[rid], _ = await eng.infer_sample_tensor(rid, SHARD, PROMPTS[rid], temp=0.0, top_k=0)

  async def late(i, rid):
    await asyncio.sleep(0.02 * i)
    return await eng.generate_chunk(rid, SHARD, firsts[rid], CHUNK, temp=0.0, top_k=0)

  outs = await asyncio.gather(*(late(i, rid) for i, rid in enumerate(firsts)))
  assert all(len(o) == CHUNK for o in outs)
  batcher = eng._ctx.batcher
  assert batcher.rows == 3 and (batcher.dispatches == 1) == one_dispatch
  eng.executor.shutdown(wait=True)


async def test_idle_defrag_moves_pages_under_live_requests(monkeypatch):
  monkeypatch.setenv("XOT_PAGED_KV", "1")
  ref = TorchShardInferenceEngine(device="cpu", seed=0)
  want = {rid: await _stream(ref, SHARD, rid, PROMPTS[rid]) for rid in ("r5", "r6")}
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  firsts = {}
  # A 60-token request takes the four lowest pages; once it clears (and the prefix entry
  # its prompt left is dropped), the others' next pages fill two of its holes and leave
  # two below them.
  prompts = {"long": np.arange(3, 63).reshape(1, -1), "r5": PROMPTS["r5"], "r6": PROMPTS["r6"]}
  for rid, prompt in prompts.items():
    firsts[rid], _ = await eng.infer_sample_tensor(rid, SHARD, prompt, temp=0.0, top_k=0)
  await eng.clear_request("long")
  eng._clear_prefix_cache(eng._ctx)
  pool = eng._ctx.page_pool
  assert pool.fragmentation() > 0
  got = {rid: [int(t)] for rid, t in firsts.items() if rid != "long"}
  for _ in range(CHUNKS):
    chunks = await asyncio.gather(*(eng.generate_chunk(rid, SHARD, got[rid][-1], CHUNK, temp=0.0,
                                                       top_k=0) for rid in got))
    for rid, c in zip(got, chunks):
      got[rid].extend(int(t) for t in c)
    await eng._ctx.batcher._drain_task  # the idle pass runs once the queue drains
    assert pool.fragmentation() == 0
  assert eng.defrag_moves > 0 and got == want
  stats = eng.page_pool_stats()
  assert stats["defrag_moves"] == eng.defrag_moves and stats["pages_in_use"] == pool.pages_in_use
  for eng_ in (ref, eng):
    eng_.executor.shutdown(wait=True)


@pytest.mark.parametrize("paged", ["0", "1"])
async def test_max_resident_requests_evicts_least_recently_used(paged, monkeypatch):
  monkeypatch.setenv("XOT_MAX_RESIDENT_REQUESTS", "2")
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  firsts = {}
  for rid in ("r0", "r1"):
    firsts[rid], _ = await eng.infer_sample_tensor(rid, SHARD, PROMPTS[rid], temp=0.0, top_k=0)
  await eng.generate_chunk("r0", SHARD, firsts["r0"], CHUNK, temp=0.0, top_k=0)  # r1 is now oldest
  await eng.infer_sample_tensor("r2", SHARD, PROMPTS["r2"], temp=0.0, top_k=0)
  assert list(eng._ctx.states) == ["r0", "r2"]
  with pytest.raises(RequestStateLost):
    await eng.generate_chunk("r1", SHARD, firsts["r1"], CHUNK, temp=0.0, top_k=0)
  if paged == "1":
    pool = eng._ctx.page_pool
    assert pool.pages_in_use == sum(len(st.pages) for st in eng._ctx.states.values())
  eng.executor.shutdown(wait=True)
