"""The port's prefix cache (engine._prefix_reuse / _prefix_store) against the JAX
engine's, on the CPU.

Both engines serve synthetic-tiny in fp32 on the JAX engine's weights (carried across
by params_from_jax) at page 16, with the knobs set before either engine is built.
The same requests go through both: a repeated prompt, a multi-turn prompt that
extends it, heads that meet XOT_PREFIX_CACHE_MIN or miss it by one token, LRU order
at one and two entries, and XOT_PREFIX_CACHE=0. Greedy streams must be the JAX
engine's (and a cold engine's), and the hits, the tokens saved, the entries' order and
a paged entry's page refcounts must equal the JAX engine's. Then the port's own
contracts: an int8 KV cache's snapshots carry their scales, a windowed model whose
window released its head pages stores nothing, a seeded warm stream equals its cold
twin, and a snapshot stays intact while its source request decodes on (a torch slice
is a view of the live cache).
"""
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_weights  # noqa: F401 (fixture)
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import registry

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
SHARD, JSHARD = Shard(MODEL, 0, 3, 4), JShard(MODEL, 0, 3, 4)
PROMPT = np.arange(40, dtype=np.int64)[None, :] % 250 + 1
LONGER = np.concatenate([PROMPT, np.arange(12, dtype=np.int64)[None, :] % 97 + 3], axis=1)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  for name, value in (("XOT_DTYPE", "float32"), ("XOT_SEED", "7"), ("XOT_CACHE_LEN", "16"),
                      ("XOT_KV_PAGE", "16"), ("XOT_KV_POOL_TOKENS", "512"),
                      ("XOT_PREFIX_CACHE_MIN", "8")):
    monkeypatch.setenv(name, value)
  with jax.default_matmul_precision("highest"):
    yield


def _set(monkeypatch, **env):
  for name, value in env.items():
    monkeypatch.setenv(name, str(value))


def _engines():
  return TorchShardInferenceEngine(device="cpu", seed=0), JAXShardInferenceEngine(dtype="float32")


async def _stream(engine, shard, rid, prompt, chunks=2, size=8, **kw):
  tok, _ = await engine.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0, **kw)
  out = [int(tok)]
  for _ in range(chunks):
    chunk = await engine.generate_chunk(rid, shard, out[-1], size, temp=0.0, top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
  return out


async def _both(port, jeng, rid, prompt, **kw):
  return await _stream(port, SHARD, rid, prompt, **kw), await _stream(jeng, JSHARD, rid, prompt, **kw)


def _counts(eng):
  return eng._prefix_hits, eng._prefix_tokens_saved, eng._prefix_evictions


def _entries(cache):
  """A prefix cache's entries, oldest first: (tokens, pages or covered length)."""
  return [(tuple(int(t) for t in toks), list(e["pages"]) if "pages" in e else int(e["k"].shape[2]))
          for toks, e in cache.values()]


def _shutdown(*engines):
  for e in engines:
    e.executor.shutdown(wait=True)


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_warm_streams_counts_and_refcounts_match_jax(paged, jax_weights, monkeypatch):
  """Cold, a repeated prompt, then a longer turn over the same history: every stream
  the JAX engine's and a cold engine's, hits / tokens saved / entries equal to JAX's
  after each request, and a paged entry's pages shared with the warm request at the
  JAX pool's refcounts."""
  _set(monkeypatch, XOT_PAGED_KV=paged, XOT_PREFIX_CACHE=0)
  cold, jcold = _engines()
  want = [await _both(cold, jcold, f"c{i}", p) for i, p in enumerate((PROMPT, PROMPT, LONGER))]
  assert cold._ctx.prefix_cache == {} and _counts(cold) == (0, 0, 0)
  _set(monkeypatch, XOT_PREFIX_CACHE=2)
  port, jeng = _engines()
  jctx = None
  for i, (p, (w, jw)) in enumerate(zip((PROMPT, PROMPT, LONGER), want)):
    got, jgot = await _both(port, jeng, f"r{i}", p)
    assert got == jgot == w == jw, i
    jctx = jeng._contexts[JSHARD]
    assert _counts(port) == _counts(jeng), i
    assert _entries(port._ctx.prefix_cache) == _entries(jctx.prefix_cache), i
  # The repeated prompt reused all but its last token (whole pages when paged), the
  # longer turn the first prompt's history.
  page = 16 if paged == "1" else 1
  assert port._prefix_hits == 2
  T = PROMPT.shape[1]
  assert port._prefix_tokens_saved == (T - 1) // page * page + T // page * page
  if paged == "1":
    pool, jpool = port._ctx.page_pool, jctx.page_pool
    for rid in ("r0", "r1", "r2"):
      assert list(port._ctx.states[rid].pages) == list(jctx.states[rid].pages)
    shared = port._ctx.states["r1"].pages.blocks[:2]
    assert [pool.refcount(p) for p in shared] == [jpool.refcount(p) for p in shared]
    # Holders: r0, r1 and r2's tables and the two entries.
    assert [pool.refcount(p) for p in shared] == [5, 5]
    assert port._commit_copy_bytes == 0 and port._grow_copies == 0
  _shutdown(cold, jcold, port, jeng)


@pytest.mark.parametrize("paged,common,hit", [("0", 16, 16), ("0", 15, 0), ("1", 31, 16),
                                              ("1", 15, 0)],
                         ids=["contiguous-at-min", "contiguous-below-min", "paged-one-page",
                              "paged-below-min"])
async def test_prefix_cache_min_boundary_matches_jax(paged, common, hit, jax_weights, monkeypatch):
  """XOT_PREFIX_CACHE_MIN=16: a head of exactly 16 shared tokens is reused, 15 is not; a
  paged hit rounds down to whole pages first. Streams and counts as JAX's."""
  _set(monkeypatch, XOT_PAGED_KV=paged, XOT_PREFIX_CACHE_MIN=16)
  port, jeng = _engines()
  await _both(port, jeng, "a", PROMPT, chunks=1)
  other = PROMPT.copy()
  other[0, common:] = (other[0, common:] + 50) % 250 + 1
  got, jgot = await _both(port, jeng, "b", other)
  assert got == jgot
  assert _counts(port) == _counts(jeng) == ((1 if hit else 0), hit, 0)
  _shutdown(port, jeng)


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
@pytest.mark.parametrize("entries", [1, 2])
async def test_lru_order_matches_jax(entries, paged, jax_weights, monkeypatch):
  """Three prompts with distinct heads fill an XOT_PREFIX_CACHE of 1 or 2 entries: the
  oldest go first (spilled to the host tier, the same bytes as JAX's), and a warm hit
  moves its entry to the young end, in the JAX engine's order."""
  _set(monkeypatch, XOT_PAGED_KV=paged, XOT_PREFIX_CACHE=entries)
  port, jeng = _engines()
  prompts = [(np.arange(24, dtype=np.int64)[None, :] * (b + 2)) % 250 + 1 for b in range(3)]
  for i, p in enumerate(prompts):
    await _both(port, jeng, f"fill-{i}", p, chunks=1)
    assert _entries(port._ctx.prefix_cache) == _entries(jeng._contexts[JSHARD].prefix_cache)
  assert len(port._ctx.prefix_cache) == entries
  assert port._prefix_evictions == 3 - entries == jeng._prefix_evictions
  assert port._host_spill_bytes == jeng._host_spill_bytes > 0
  # A warm hit on the oldest resident entry refreshes it.
  oldest = np.asarray(next(iter(port._ctx.prefix_cache.values()))[0])[None, :]
  warm = np.concatenate([oldest, [[5, 6]]], axis=1)
  got, jgot = await _both(port, jeng, "warm", warm, chunks=1)
  assert got == jgot
  assert _entries(port._ctx.prefix_cache) == _entries(jeng._contexts[JSHARD].prefix_cache)
  assert _counts(port) == _counts(jeng)
  _shutdown(port, jeng)


async def test_prefix_cache_off_is_the_cold_engine(jax_weights, monkeypatch):
  """XOT_PREFIX_CACHE=0 stores nothing and reuses nothing, on both engines, with the
  same streams as an engine that caches."""
  _set(monkeypatch, XOT_PREFIX_CACHE=0)
  port, jeng = _engines()
  off = [await _both(port, jeng, f"r{i}", PROMPT) for i in range(2)]
  assert port._ctx.prefix_cache == {} and jeng._contexts[JSHARD].prefix_cache == {}
  assert _counts(port) == _counts(jeng) == (0, 0, 0)
  assert port._host_kv is None
  _set(monkeypatch, XOT_PREFIX_CACHE=2)
  on = TorchShardInferenceEngine(device="cpu", seed=0)
  for i, (got, jgot) in enumerate(off):
    assert got == jgot == await _stream(on, SHARD, f"r{i}", PROMPT)
  assert on._prefix_hits == 1
  _shutdown(port, jeng, on)


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_int8_kv_snapshots_carry_scales(paged, jax_weights, monkeypatch):
  """Under an int8 KV cache a snapshot holds K and V as int8 and their scales, a paged
  entry's pages carry the scale pages, and the warm stream is the cold one's and the
  JAX int8 engine's."""
  _set(monkeypatch, XOT_PAGED_KV=paged, XOT_KV_QUANT="int8", XOT_PREFIX_CACHE=0)
  cold = TorchShardInferenceEngine(device="cpu", seed=0)
  want = await _stream(cold, SHARD, "c", LONGER)
  _set(monkeypatch, XOT_PREFIX_CACHE=2)
  port, jeng = _engines()
  await _both(port, jeng, "a", PROMPT, chunks=1)
  got, jgot = await _both(port, jeng, "b", LONGER)
  assert got == jgot == want
  assert _counts(port) == _counts(jeng)
  (_, entry), = list(port._ctx.prefix_cache.values())[:1]
  if paged == "1":
    arena = port._ctx.page_pool.arena
    assert set(arena) == {"k", "v", "k_scale", "v_scale"}
    assert arena["k_scale"][:, entry["pages"]].abs().sum() > 0
  else:
    assert set(entry) == {"k", "v", "k_scale", "v_scale"}
    assert entry["k"].dtype == torch.int8 and entry["k_scale"].dtype == torch.float32
    assert entry["k_scale"].shape[:3] == entry["k"].shape[:3]
  _shutdown(cold, port, jeng)


async def test_windowed_model_stores_nothing_after_its_window_released(monkeypatch):
  """A paged mistral whose every layer slides (window 16) releases the prompt's head
  pages during its prefill: `prefix_ids` is None and no entry is stored. Without the
  window the same prompt stores one."""
  base = dict(registry.get_model_card(MODEL)["synthetic_config"])
  monkeypatch.setitem(registry.model_cards, "synthetic-tiny-window", {
    **registry.model_cards[MODEL], "synthetic_config": {**base, "model_type": "mistral",
                                                        "sliding_window": 16}})
  _set(monkeypatch, XOT_PAGED_KV=1, XOT_PREFILL_CHUNK=16)
  for model, stored in (("synthetic-tiny-window", 0), (MODEL, 1)):
    eng = TorchShardInferenceEngine(device="cpu", seed=0)
    shard = Shard(model, 0, 3, 4)
    await _stream(eng, shard, "r", PROMPT, chunks=1)
    assert (eng._ctx.states["r"].pages.base > 0) == (stored == 0)
    assert len(eng._ctx.prefix_cache) == stored
    await eng.clear_request("r")
    assert eng._ctx.page_pool.pages_in_use == (PROMPT.shape[1] // 16 if stored else 0)
    _shutdown(eng)


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_seeded_warm_stream_equals_cold(paged, monkeypatch):
  """A seeded request draws from (seed, absolute position, choice), so a warm replay
  that prefills only its suffix samples the cold stream at temperature 1."""
  _set(monkeypatch, XOT_PAGED_KV=paged)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)

  async def seeded(rid):
    tok, _ = await eng.infer_sample_tensor(rid, SHARD, PROMPT, temp=1.0, top_k=0,
                                           sampling={"seed": 11})
    out = [int(tok)]
    for _ in range(2):
      out.extend(int(t) for t in await eng.generate_chunk(rid, SHARD, out[-1], 8, temp=1.0, top_k=0))
    return out
  cold = await seeded("cold")
  warm = await seeded("warm")
  assert eng._prefix_hits == 1 and warm == cold
  _shutdown(eng)


async def test_snapshot_survives_its_source_decoding(monkeypatch):
  """A contiguous entry is a clone: the request that stored it decodes on into the same
  cache (and a decode step writes positions past the prompt in place), and the entry's
  bytes stay those of the prefill."""
  _set(monkeypatch, XOT_PAGED_KV=0)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  tok, _ = await eng.infer_sample_tensor("r", SHARD, PROMPT, temp=0.0, top_k=0)
  (_, entry), = eng._ctx.prefix_cache.values()
  before = {name: t.clone() for name, t in entry.items()}
  live = eng._ctx.states["r"].cache
  assert all(entry[n].data_ptr() != live[n].data_ptr() for n in entry)
  # Overwrite the live cache's prompt positions too: the entry must not see it.
  await eng.generate_chunk("r", SHARD, int(tok), 16, temp=0.0, top_k=0)
  with torch.inference_mode():
    for buf in eng._ctx.states["r"].cache.values():
      buf[:, :, :PROMPT.shape[1]] = 0
  for name, t in entry.items():
    assert torch.equal(t, before[name])
  _shutdown(eng)
