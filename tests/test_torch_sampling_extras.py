"""OpenAI's sampling extras in the port (seed, logit_bias, presence/frequency penalties,
min_p, logprobs, stop, n, tools), against the JAX package on the CPU.

The port of tests/test_sampling_extras.py and tests/test_logprobs.py (not their
prefix-cache test: no prefix cache is ported yet), plus the port's own paths: the
decode graphs' static extras buffers (played eagerly by the tests' graph cache), the
batcher, the Node's ring and the API.

Synthetic-tiny in fp32 on the JAX engine's weights (carried across with
params_from_jax). Greedy streams and penalty counts are compared exactly; a sampled
stream exactly with JAX's Gumbel noise injected into the port's functions; logprobs
within 1e-5 (fp32 log-softmax over logits that agree to ~1e-6), with the same top ids.
A seeded stream is compared with itself only: the port draws from torch.Generator,
JAX from its own PRNG.
"""
import asyncio
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_weights  # noqa: F401 (fixture)
from tests.test_torch_graphs import EagerGraphCache
from tests.test_torch_paged import _shuffled_table
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import generate as j_generate
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.models.registry import get_model_card as j_get_model_card
from xotorch_tpu.ops import sampling as j_sampling
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import generate, graphs, transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import params_from_jax
from xotorch_tpu_torch.ops import sampling

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
SHARD, JSHARD = Shard(MODEL, 0, 3, 4), JShard(MODEL, 0, 3, 4)
PROMPT = np.array([[1, 5, 9, 200, 17]], dtype=np.int64)
LADDER = (4, 3)  # decode chunks after the prefill's token
LP_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _env(monkeypatch, jax_weights):  # noqa: F811
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_CACHE_LEN", "16")
  monkeypatch.setenv("XOT_KV_PAGE", "16")
  monkeypatch.setenv("XOT_KV_POOL_TOKENS", "512")
  with jax.default_matmul_precision("highest"):
    yield


def _port():
  return TorchShardInferenceEngine(device="cpu", seed=0)


async def _stream(eng, shard, rid, sampling=None, temp=0.0, ladder=LADDER, prompt=PROMPT):
  """The prefill's token, then each ladder size's tokens in chunks (the chunks carry the
  request's extras from its state; a coalesced batch may return fewer than asked)."""
  kw = {} if sampling is None else {"sampling": sampling}
  tok, _ = await eng.infer_sample_tensor(rid, shard, prompt, temp=temp, top_k=0, **kw)
  out = [int(tok)]
  for size in ladder:
    end = len(out) + size
    while len(out) < end:
      chunk = await eng.generate_chunk(rid, shard, out[-1], end - len(out), temp=temp, top_k=0)
      out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
  return out


async def _logits_oracle(n, penalties=(0.0, 0.0)):
  """Greedy host oracle over the JAX engine's logits: OpenAI's penalty formula over the
  GENERATED tokens only. Returns (tokens, each step's adjusted logits)."""
  ref = JAXShardInferenceEngine(dtype="float32")
  pres, freq = penalties
  seen, rows, toks = [], [], []
  logits, _ = await ref.infer_tensor("o", JSHARD, PROMPT)
  for _ in range(n):
    row = np.array(logits[0, -1], dtype=np.float64)
    counts = np.bincount(seen, minlength=row.shape[0])[:row.shape[0]] if seen else np.zeros(row.shape[0])
    row = row - pres * (counts > 0) - freq * counts
    nxt = int(np.argmax(row))
    rows.append(row)
    toks.append(nxt)
    seen.append(nxt)
    logits, _ = await ref.infer_tensor("o", JSHARD, np.array([[nxt]], dtype=np.int64))
  return toks, rows


def _log_softmax(row):
  return row - np.log(np.exp(row - row.max()).sum()) - row.max()


# ------------------------------------------------------------------ ops

def test_penalty_and_bias_math_matches_jax():
  """OpenAI's formula logits - presence*(count>0) - frequency*count + bias, greedy, as
  JAX's sampler computes it; per-row tensors (a captured step's static buffers) as the
  Python numbers."""
  logits = np.asarray([[5.0, 4.5, 4.0, 1.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
  counts = np.asarray([[3, 1, 0, 0, 0, 0, 0, 0]], np.int32)
  bias = np.zeros((1, 8), np.float32)
  bias[0, 0], bias[0, 3] = -100.0, 4.1
  key = jax.random.PRNGKey(0)
  t = torch.from_numpy
  cases = [({}, 0), ({"counts": counts, "presence": 0.1, "frequency": 0.5}, 2), ({"bias": bias}, 3)]
  for kw, want in cases:
    jtok = j_sampling.sample_logits(jnp.asarray(logits), key, temp=0.0, top_k=0,
                                    **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                       for k, v in kw.items()})
    tkw = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    assert int(sampling.sample_logits(t(logits), temp=0.0, top_k=0, **tkw)[0]) == int(jtok[0]) == want
    rows = {k: torch.full((1,), v) if isinstance(v, float) else v for k, v in tkw.items()}
    assert int(sampling.sample_logits(t(logits), temp=0.0, top_k=0, **rows)[0]) == want


def test_min_p_mask_math():
  """min_p 1 leaves only the argmax at any temperature; 0.5 keeps {0, 1}; a per-row
  tensor floor masks as the number does; with JAX's noise injected the draws are JAX's."""
  logits = torch.tensor([[2.0, 1.9, 0.0, -3.0]])
  seen, seen_row = set(), set()
  for seed in range(64):
    key = jax.random.PRNGKey(seed)
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, (1, 4), jnp.float32)))
    jtok = int(j_sampling.sample_logits(jnp.asarray(logits.numpy()), key, temp=1.0, top_k=0,
                                        min_p=0.5)[0])
    tok = int(sampling.sample_logits(logits, temp=1.0, top_k=0, min_p=0.5, gumbel=noise)[0])
    row = int(sampling.sample_logits(logits, temp=1.0, top_k=0, min_p=torch.tensor([0.5]),
                                     gumbel=noise)[0])
    assert tok == jtok == row
    seen.add(tok)
    seen_row.add(row)
    assert int(sampling.sample_logits(logits, temp=1.0, top_k=0, min_p=1.0, gumbel=noise)[0]) == 0
  assert seen == seen_row == {0, 1}


# ------------------------------------------------------------------ functions and graphs

def _model():
  jcfg = j_config_from_hf_dict(j_get_model_card(MODEL)["synthetic_config"])
  cfg = config_from_hf_dict(get_model_card(MODEL)["synthetic_config"])
  jp = j_transformer.init_random_params(jcfg, 4, True, True, jax.random.PRNGKey(0), dtype=jnp.float32)
  return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
@pytest.mark.parametrize("via", ["eager", "graph cache"])
def test_injected_noise_stream_with_extras_matches_jax(kind, via):
  """Temperature 0.9 with JAX's Gumbel noise injected: the prefill's sample
  (forward_sample) and a K-step chunk with bias, presence and frequency penalties,
  min-p and 3 logprobs give JAX's tokens, counts and top ids exactly and its logprobs
  within 1e-5: the eager chunk (decode_chunk_batched / decode_chunk_paged) and the
  decode graph over its static extras buffers (models/graphs)."""
  jcfg, cfg, jp, params = _model()
  V, L, K, S, temp, top_k = cfg.vocab_size, 4, 6, 32, 0.9, 0
  toks = np.random.default_rng(4).integers(3, 256, size=(1, 9)).astype(np.int32)
  bias = np.zeros((1, V), np.float32)
  bias[0, [7, 11]] = (3.0, -2.0)
  ex = dict(presence=0.4, frequency=0.8, min_p=0.05)
  key = jax.random.PRNGKey(3)
  paged = kind == "paged"
  if paged:
    table = _shuffled_table(np.random.default_rng(5), 12, [9 + K], 16, 2)
    shape = (L, 12, 16, cfg.num_kv_heads, cfg.head_dim)
    jcache = {n: jnp.zeros(shape, jnp.float32) for n in ("k", "v")}
    cache = {n: torch.zeros(shape) for n in ("k", "v")}
    pkw, jpkw = {"page_table": torch.from_numpy(table)}, {"page_table": jnp.asarray(table)}
  else:
    jcache = j_transformer.init_kv_cache(jcfg, L, 1, S, jnp.float32)
    cache = transformer.init_kv_cache(cfg, L, 1, S, torch.float32)
    pkw = jpkw = {}
  counts0 = np.zeros((1, V), np.int32)
  (jtok, jlp, jids, jlps), jcache = j_generate.forward_sample(
    jp, jnp.asarray(toks), jcache, jnp.int32(0), jnp.int32(8), key, jcfg, True, temp, top_k,
    bias=jnp.asarray(bias), counts=jnp.asarray(counts0), top_lp=3, **ex, **jpkw)
  noise0 = torch.from_numpy(np.asarray(jax.random.gumbel(key, (1, V), jnp.float32)))
  (tok, lp, ids, lps), cache = generate.forward_sample(
    params, torch.from_numpy(toks).long(), cache, 0, 8, cfg, True, temp, top_k,
    bias=torch.from_numpy(bias), counts=torch.from_numpy(counts0), top_lp=3, gumbel=noise0,
    **ex, **pkw)
  assert int(tok[0]) == int(jtok[0])
  np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=LP_ATOL)
  np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
  counts = counts0.copy()
  counts[0, int(tok[0])] += 1

  dkey = jax.random.PRNGKey(12)
  temps = np.full((1,), temp, np.float32)
  jargs = dict(bias=jnp.asarray(bias), counts=jnp.asarray(counts), top_lp=3, **ex)
  if paged:
    jtoks, _, jcounts, (jlp, jids, jlps) = j_generate.decode_chunk_paged(
      jp, jcache, jnp.asarray(table), jnp.asarray(jtok)[:, None], jnp.asarray([9], jnp.int32), dkey,
      jcfg, K, jnp.asarray(temps), top_k, **jargs)
  else:
    jtoks, _, jcounts, (jlp, jids, jlps) = j_generate.decode_chunk(
      jp, jnp.asarray(jtok)[:, None], jcache, jnp.int32(9), dkey, jcfg, K, temp, top_k, **jargs)
  noise, k = [], dkey
  for _ in range(K):  # the key splits of JAX's decode scan
    k, sub = jax.random.split(k)
    noise.append(np.asarray(jax.random.gumbel(sub, (1, V), jnp.float32)))
  noise = torch.from_numpy(np.stack(noise))
  toks_in, pos, temps_t = tok[:, None], torch.tensor([9], dtype=torch.int32), torch.from_numpy(temps)
  tcounts = torch.from_numpy(counts)
  if via == "eager":
    kw = dict(gumbel=noise, bias=torch.from_numpy(bias), counts=tcounts, top_lp=3, **ex)
    if paged:
      got, _, got_counts, (lp, ids, lps) = generate.decode_chunk_paged(
        params, cache, torch.from_numpy(table), toks_in, pos, cfg, K, temps_t, top_k, **kw)
    else:
      got, _, got_counts, (lp, ids, lps) = generate.decode_chunk_batched(
        params, [cache], toks_in, pos, cfg, K, temps_t, top_k, use_flash_decode=True, **kw)
  else:
    row = lambda v: torch.full((1,), v)
    ex_t = graphs.SamplerExtras(bias=torch.from_numpy(bias), counts=tcounts.clone(),
                                presence=row(ex["presence"]), frequency=row(ex["frequency"]),
                                min_p=row(ex["min_p"]), top_lp=3)
    gc = EagerGraphCache("cpu")
    if paged:
      got, (lp, ids, lps) = graphs.decode_paged(gc, params, cache, torch.from_numpy(table), toks_in,
                                                pos, cfg, K, temps_t, top_k, gumbel=noise, extras=ex_t)
    else:
      got, (lp, ids, lps) = graphs.decode_contiguous(gc, params, [cache], toks_in, pos, cfg, K,
                                                     temps_t, top_k, gumbel=noise, extras=ex_t)
    got_counts = ex_t.counts
    # The plain request's graph on the same cache is another program: its key holds
    # which extras it has, never their values.
    assert gc.programs and all(k[-4:] == (True, True, 3, True) for k in gc.programs)
  np.testing.assert_array_equal(got.numpy(), np.asarray(jtoks))
  np.testing.assert_array_equal(got_counts.numpy(), np.asarray(jcounts))
  np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
  np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=LP_ATOL)
  np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), atol=LP_ATOL)


def test_graph_keys_hold_which_extras_not_their_values():
  """Two requests with other bias, penalty and min-p values replay one program; the
  counts survive across chunks exactly as the eager chunk's."""
  _, cfg, _, params = _model()
  V, K = cfg.vocab_size, 4
  gc = EagerGraphCache("cpu")
  prompt = torch.from_numpy(np.random.default_rng(8).integers(3, 256, size=(1, 7))).long()
  results = []
  for pres, lb in ((0.5, 3.0), (1.5, -4.0)):
    cache = transformer.init_kv_cache(cfg, 4, 1, 32, torch.float32)
    logits, _ = transformer.forward_shard(params, prompt, cache, 0, cfg, True, True)
    tok = logits[:, -1].argmax(-1)[:, None]
    bias = torch.zeros((1, V))
    bias[0, 9] = lb
    ex = graphs.SamplerExtras(bias=bias, counts=torch.zeros((1, V), dtype=torch.int32),
                              presence=torch.full((1,), pres), frequency=torch.full((1,), 1.0),
                              min_p=torch.full((1,), 0.2))
    eager = [tok, {n: t.clone() for n, t in cache.items()}, torch.zeros((1, V), dtype=torch.int32)]
    got, pos = [], 7
    for _ in range(2):  # two chunks: the counts carry across
      toks, _ = graphs.decode_contiguous(gc, params, [cache], tok, torch.tensor([pos], dtype=torch.int32),
                                         cfg, K, torch.zeros(1), 0, extras=ex)
      etoks, split, eager[2] = generate.decode_chunk_batched(
        params, [eager[1]], eager[0], torch.tensor([pos], dtype=torch.int32), cfg, K, torch.zeros(1), 0,
        use_flash_decode=True, bias=bias, counts=eager[2], presence=pres, frequency=1.0, min_p=0.2)
      eager[1] = split[0]
      assert torch.equal(toks, etoks)
      tok, eager[0], pos = toks[:, -1:], etoks[:, -1:], pos + K
      got.append(toks)
    assert torch.equal(ex.counts, eager[2]) and int(ex.counts.sum()) == 2 * K
    results.append(torch.cat(got, dim=1))
  assert len(gc.programs) == 1 and gc.captures == 1


# ------------------------------------------------------------------ the engine

async def test_logit_bias_bans_the_greedy_token_and_gives_jax_stream():
  ref = JAXShardInferenceEngine(dtype="float32")
  logits, _ = await ref.infer_tensor("r", JSHARD, PROMPT)
  banned = int(np.argmax(logits[0, -1]))
  runner_up = int(np.argsort(logits[0, -1])[-2])
  s = {"logit_bias": {str(banned): -100.0}}
  want = await _stream(JAXShardInferenceEngine(dtype="float32"), JSHARD, "b", s)
  got = await _stream(_port(), SHARD, "b", s)
  assert got == want and got[0] == runner_up and banned not in got


async def test_out_of_vocab_logit_bias_is_dropped():
  """A bias id past the vocabulary is ignored, never wrapped: V + greedy would ban the
  greedy token itself."""
  V = get_model_card(MODEL)["synthetic_config"]["vocab_size"]
  plain = await _stream(_port(), SHARD, "p")
  got = await _stream(_port(), SHARD, "b", {"logit_bias": {str(V + plain[0]): -100.0}})
  assert got == plain


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_penalties_exact_over_fused_chunks_and_the_ladder(paged, monkeypatch):
  """Greedy with presence and frequency penalties through the prefill and the chunk
  ladder: JAX's engine's tokens and the host oracle's (counts over the SAMPLED tokens
  only), within a chunk and across chunks; the penalties bite (the plain stream
  differs)."""
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  s = {"presence_penalty": 0.3, "frequency_penalty": 0.9}
  ladder = (4, 3, 8)
  want = await _stream(JAXShardInferenceEngine(dtype="float32"), JSHARD, "p", s, ladder=ladder)
  eng = _port()
  got = await _stream(eng, SHARD, "p", s, ladder=ladder)
  oracle, _ = await _logits_oracle(len(got), penalties=(0.3, 0.9))
  assert got == want == oracle
  counts = eng._ctx.states["p"].extras.counts
  assert int(counts.sum()) == len(got)
  assert (eng._ctx.states["p"].pages is not None) == (paged == "1")
  assert eng._ctx.batcher is None  # an extras request never enters the batcher
  assert await _stream(_port(), SHARD, "q", ladder=ladder) != got


async def test_min_p_one_matches_greedy_through_api():
  """min_p 1 at temperature 1 is the greedy stream: per token through the engine (the
  ring's calls), through the chunks, and through the API."""
  eng = _port()
  greedy = await _stream(eng, SHARD, "g")
  got = []
  for i in range(len(greedy)):
    x = PROMPT if i == 0 else np.asarray([[got[-1]]])
    tok, _ = await eng.infer_sample_tensor("m", SHARD, x, temp=1.0, top_k=0, sampling={"min_p": 1.0})
    got.append(int(tok))
  assert got == greedy
  assert await _stream(eng, SHARD, "c", {"min_p": 1.0}, temp=1.0) == greedy
  async with _api() as (post, _, streams):
    body = {"model": MODEL, "max_tokens": 12, "messages": [{"role": "user", "content": "a b c"}]}
    plain = await post({**body, "temperature": 0})
    minp = await post({**body, "temperature": 1.0, "min_p": 1})
    assert streams[_rid(minp)] == streams[_rid(plain)]


async def test_seed_reproduces_itself_and_seeded_siblings_differ(monkeypatch):
  """The same seed at temperature 1 gives the same stream on fresh engines (its stream
  derives from (seed, position, choice), not the engine's history), another seed
  another; `n` siblings "r#0" and "r#1" draw distinct streams, each reproducible; an
  unseeded request follows XOT_SEED."""
  async def run(rid, seed, eng=None):
    return await _stream(eng or _port(), SHARD, rid, {"seed": seed}, temp=1.0, ladder=(8,))
  a = await run("s", 42)
  noisy = _port()
  await _stream(noisy, SHARD, "other", temp=1.0)  # the engine-global stream moves
  assert await run("s", 42, noisy) == a
  assert await run("s", 7) != a
  assert await run("r#0", 42) != await run("r#1", 42)
  assert await run("r#1", 42) == await run("r#1", 42)
  monkeypatch.setenv("XOT_SEED", "5")
  first = await _stream(TorchShardInferenceEngine(device="cpu"), SHARD, "u", temp=1.0)
  assert await _stream(TorchShardInferenceEngine(device="cpu"), SHARD, "u", temp=1.0) == first
  monkeypatch.setenv("XOT_SEED", "6")
  assert await _stream(TorchShardInferenceEngine(device="cpu"), SHARD, "u", temp=1.0) != first


async def test_an_extras_request_never_shares_a_batcher_dispatch(monkeypatch):
  """Concurrent streams: the plain ones (n siblings too) coalesce in the batcher, the
  extras one decodes in chunks of its own and keeps JAX's greedy stream."""
  monkeypatch.setenv("XOT_DECODE_BATCH", "8")
  eng = _port()
  seen = []
  real = eng._decode_batch_sync

  def spy(ctx, items, *a):
    seen.append([it.request_id for it in items])
    return real(ctx, items, *a)
  eng._decode_batch_sync = spy
  s = {"frequency_penalty": 1.0, "logit_bias": {"4": 1.5}}
  rids = ["plain#0", "plain#1", "plain#2", "extras"]
  outs = await asyncio.gather(*(_stream(eng, SHARD, r, s if r == "extras" else None) for r in rids))
  assert ["extras"] in seen and all(len(g) == 1 for g in seen if "extras" in g)
  assert max(len(g) for g in seen) == 3  # the siblings shared dispatches
  assert eng._ctx.batcher.rows / eng._ctx.batcher.dispatches > 1
  want = await _stream(JAXShardInferenceEngine(dtype="float32"), JSHARD, "extras", s)
  assert outs[-1] == want
  assert outs[0] == outs[1] == outs[2]  # greedy siblings


# ------------------------------------------------------------------ logprobs

async def test_logprobs_match_jax_and_host_log_softmax():
  """Greedy with 3 logprobs through the prefill and two chunks: the port's entries
  against JAX's (within 1e-5, the same top ids) and the host oracle's log-softmax."""
  s = {"logprobs": 3}
  jeng, eng = JAXShardInferenceEngine(dtype="float32"), _port()
  want = await _stream(jeng, JSHARD, "r", s)
  got = await _stream(eng, SHARD, "r", s)
  assert got == want
  jentries, entries = jeng.pop_logprobs("r"), eng.pop_logprobs("r")
  assert len(entries) == len(jentries) == len(got)
  _, rows = await _logits_oracle(len(got))
  for tok, ent, jent, row in zip(got, entries, jentries, rows):
    logp = _log_softmax(row)
    np.testing.assert_allclose(ent["logprob"], jent["logprob"], atol=LP_ATOL)
    np.testing.assert_allclose(ent["logprob"], logp[tok], atol=1e-4)
    assert [t for t, _ in ent["top"]] == [t for t, _ in jent["top"]] == list(np.argsort(-logp)[:3])
    np.testing.assert_allclose([p for _, p in ent["top"]], [p for _, p in jent["top"]], atol=LP_ATOL)
  assert eng.pop_logprobs("r") is None  # drained


async def test_logprobs_reflect_logit_bias():
  """Logprobs report the biased distribution: the banned greedy token leaves the top
  alternatives, the sampled one leads them; JAX's numbers within 1e-5."""
  ref = JAXShardInferenceEngine(dtype="float32")
  logits, _ = await ref.infer_tensor("o", JSHARD, PROMPT)
  banned = int(np.argmax(logits[0, -1]))
  s = {"logprobs": 3, "logit_bias": {str(banned): -100.0}}
  jtok, _ = await ref.infer_sample_tensor("b", JSHARD, PROMPT, temp=0.0, top_k=0, sampling=s)
  eng = _port()
  tok, _ = await eng.infer_sample_tensor("b", SHARD, PROMPT, temp=0.0, top_k=0, sampling=s)
  [entry], [jentry] = eng.pop_logprobs("b"), ref.pop_logprobs("b")
  assert int(tok) == int(jtok) != banned
  assert banned not in [t for t, _ in entry["top"]] and entry["top"][0][0] == int(tok)
  assert [t for t, _ in entry["top"]] == [t for t, _ in jentry["top"]]
  np.testing.assert_allclose(entry["logprob"], jentry["logprob"], atol=LP_ATOL)


async def test_logprobs_zero_top():
  eng = _port()
  await eng.infer_sample_tensor("z", SHARD, PROMPT, temp=0.0, top_k=0, sampling={"logprobs": 0})
  [entry] = eng.pop_logprobs("z")
  assert entry["top"] == [] and entry["logprob"] <= 0.0


# ------------------------------------------------------------------ the ring

async def test_a_tcp_ring_carries_the_extras_and_streams_the_solo_nodes_tokens(tmp_path):
  """Two peers over TCP: the request's extras ride every hop to the sampler peer in
  SAMPLING_KEY, whose engine keeps the penalty counts across its per-token calls; the
  ring streams the solo node's tokens. Logprobs stay where the sampler is: the API's
  node (layers 0-1 here) reports none."""
  from tests.test_torch_ring import Ring, _generate
  from xotorch_tpu_torch.orchestration.node import SAMPLING_KEY
  s = {"frequency_penalty": 1.2, "logit_bias": {"9": 2.0}, "logprobs": 2}
  solo_args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-temp", "0", "--max-generate-tokens", "8"])
  solo, solo_engine, _, _ = port_main.build_node(solo_args)
  try:
    want, error = await _generate(solo, "solo", sampling=s)
    assert error is None and len(want) == 8
    # One entry a sampled token: the last chunk may pass the cap (its surplus tokens
    # dropped, as in JAX), and the API zips entries with the tokens it keeps.
    assert len(solo.pop_request_logprobs("solo")) >= 8
  finally:
    await solo.stop()
    solo_engine.executor.shutdown(wait=True)
  ring = await Ring(tmp_path, ["node-b", "node-a"]).start()
  sampler = ring.engines["node-a"]
  states = []
  real = sampler.infer_sample_tensor

  async def spy(request_id, shard, x, inference_state=None, **kw):
    states.append((dict(inference_state or {}).get(SAMPLING_KEY), kw.get("sampling")))
    return await real(request_id, shard, x, inference_state=inference_state, **kw)
  sampler.infer_sample_tensor = spy
  try:
    got, error = await _generate(ring.nodes["node-b"], "ring", sampling=s)
    assert error is None and got == want
    assert len(states) == 8 and all(a == b == s for a, b in states[1:]) and states[0][1] == s
    assert ring.nodes["node-b"].pop_request_logprobs("ring") is None
  finally:
    await ring.stop()


# ------------------------------------------------------------------ the API

class WordTokenizer:
  """Token i decodes to a word of its own (some with two-byte characters), so stop
  strings can span tokens; the template renders the tools it is handed."""
  eos_token_id = 2

  def encode(self, text):
    return [3 + (len(w) % 200) for w in text.split()] or [3]

  def decode(self, ids):
    return "".join(f" w{i}é" if i % 3 == 0 else f" w{i}" for i in ids)

  def apply_chat_template(self, chat, tokenize=False, add_generation_prompt=True, tools=None):
    text = " ".join(f"{m['role']}: {m['content']}" for m in chat)
    return text + (f" tools: {json.dumps(tools)}" if tools else "") + " assistant:"


def _post(url, body):
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as resp:
    return json.loads(resp.read())


def _post_stream(url, body):
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  events = []
  with urllib.request.urlopen(req, timeout=120) as resp:
    for raw in resp:
      line = raw.decode().strip()
      if line.startswith("data: ") and line != "data: [DONE]":
        events.append(json.loads(line[len("data: "):]))
  return events


def _rid(resp):
  return resp["id"][len("chatcmpl-"):]


class _api:
  """The port's node and API on synthetic-tiny; yields (post, post_stream, the token
  lists the node streamed by request id)."""

  def __init__(self, tokenizer=None, system_prompt=None):
    self.tokenizer, self.system_prompt = tokenizer, system_prompt

  async def __aenter__(self):
    args = port_main.build_parser().parse_args(
      ["--device", "cpu", "--default-model", MODEL, "--chatgpt-api-port", "0"]
      + (["--system-prompt", self.system_prompt] if self.system_prompt else []))
    self.node, self.engine, _, self.api = port_main.build_node(args)
    if self.tokenizer is not None:
      self.api._tokenizers[MODEL] = self.tokenizer
    self.streams = {}
    self.node.on_token.register("extras-test").on_next(
      lambda rid, toks, finished: self.streams.__setitem__(rid, list(toks)))
    self.server = await self.api.start("127.0.0.1", 0)
    self.base = f"http://127.0.0.1:{self.server.sockets[0].getsockname()[1]}"
    loop = asyncio.get_running_loop()
    url = self.base + "/v1/chat/completions"
    post = lambda body, path=url: loop.run_in_executor(None, _post, path, body)
    stream = lambda body: loop.run_in_executor(None, _post_stream, url, body)
    return post, stream, self.streams

  async def __aexit__(self, *exc):
    self.server.close()
    await self.server.wait_closed()
    await self.node.stop()
    self.engine.executor.shutdown(wait=True)


async def test_api_logprobs_full_response():
  """choices[i].logprobs.content: one OpenAI item a completion token (text, logprob,
  bytes, top_logprobs of the asked width, the sampled token first); null without the
  flag, and nothing left in the engine's store."""
  served = _api()
  async with served as (post, _, _):
    body = {"model": MODEL, "max_tokens": 6, "temperature": 0,
            "messages": [{"role": "user", "content": "hello there"}]}
    data = await post({**body, "logprobs": True, "top_logprobs": 2})
    content = data["choices"][0]["logprobs"]["content"]
    assert len(content) == data["usage"]["completion_tokens"] == 6
    for item in content:
      assert item["logprob"] <= 0.0 and item["bytes"] == list(item["token"].encode("utf-8"))
      assert len(item["top_logprobs"]) == 2
      assert item["top_logprobs"][0]["logprob"] >= item["top_logprobs"][1]["logprob"]
      assert item["top_logprobs"][0]["logprob"] == item["logprob"]
    plain = await post(body)
    assert plain["choices"][0]["logprobs"] is None
    assert not served.engine._logprob_store


async def test_api_logprobs_streaming_aligned():
  """SSE chunks carry logprobs aligned with each delta; together one item a token."""
  async with _api() as (_, stream, _):
    events = await stream({"model": MODEL, "max_tokens": 9, "temperature": 0, "stream": True,
                           "logprobs": True, "top_logprobs": 1,
                           "messages": [{"role": "user", "content": "stream me"}]})
    items, finish = [], None
    for e in events:
      ch = e["choices"][0]
      if ch.get("logprobs"):
        items.extend(ch["logprobs"]["content"])
      finish = ch["finish_reason"] or finish
    assert finish == "length" and len(items) == 9
    assert all(i["logprob"] <= 0.0 and len(i["top_logprobs"]) == 1 for i in items)


async def test_api_logprobs_validation():
  """JAX's invalid logprobs requests, each answered 400 (invalid_request_error) over
  HTTP, before the node sees it."""
  import urllib.error
  async with _api() as (post, _, streams):
    base = {"model": MODEL, "messages": [{"role": "user", "content": "x"}]}
    for bad in ({"logprobs": "yes"}, {"logprobs": True, "top_logprobs": 21},
                {"logprobs": True, "top_logprobs": -1}, {"top_logprobs": 3},
                {"logprobs": False, "top_logprobs": 3}):
      with pytest.raises(urllib.error.HTTPError) as err:
        await post({**base, **bad})
      assert err.value.code == 400, bad
      assert json.loads(err.value.read())["error"]["type"] == "invalid_request_error"
    assert not streams


async def test_api_stop_n_and_tools():
  """stop: the answer is cut before the first occurrence (here across two tokens and
  after a two-byte character), finish "stop", the request cancelled well before its
  cap, streamed without ever sending part of the stop string; n: n choices, seeded
  siblings distinct; tools reach the chat template; /v1/chat/token/encode answers as
  the JAX package's handler for the same messages, tools and system prompt."""
  tok = WordTokenizer()
  served = _api(tok, system_prompt="be brief")
  async with served as (post, stream, streams):
    body = {"model": MODEL, "temperature": 0, "max_tokens": 40,
            "messages": [{"role": "user", "content": "one two three four"}]}
    plain = await post(body)
    text = plain["choices"][0]["message"]["content"]
    ids = streams[_rid(plain)]
    words = tok.decode(ids[4:6])
    stop = words[2:-1]  # spans tokens 4 and 5
    cut = text.index(stop)
    got = await post({**body, "stop": [stop, "never"]})
    choice = got["choices"][0]
    assert choice["message"]["content"] == text[:cut] and choice["finish_reason"] == "stop"
    assert len(streams[_rid(got)]) < 40  # cancelled, not decoded to the cap
    events = await stream({**body, "stop": stop, "stream": True})
    chunks = [c["delta"].get("content", "") for e in events for c in e["choices"]]
    assert "".join(chunks) == text[:cut]
    assert events[-1]["choices"][0]["finish_reason"] == "stop"

    many = await post({**body, "temperature": 1.0, "n": 3, "seed": 11, "max_tokens": 8})
    assert [c["index"] for c in many["choices"]] == [0, 1, 2]
    rid = _rid(many)
    sub = [streams[f"{rid}#{i}"] for i in range(3)]
    assert len({tuple(t) for t in sub}) == 3

    tools = [{"type": "function", "function": {"name": "get_time", "parameters": {}}}]
    messages = [{"role": "user", "content": "what time is it"}]
    enc = await post({"model": MODEL, "messages": messages, "tools": tools},
                     path=served.base + "/v1/chat/token/encode")
    assert '"get_time"' in enc["encoded_prompt"] and enc["encoded_prompt"].startswith("system: be brief")
    assert enc == await _jax_token_encode(tok, messages, tools, "be brief")
    with_tools = await post({"model": MODEL, "messages": messages, "tools": tools, "max_tokens": 2})
    assert with_tools["usage"]["prompt_tokens"] == enc["num_tokens"]


async def _jax_token_encode(tokenizer, messages, tools, system_prompt):
  from xotorch_tpu.api.chatgpt_api import ChatGPTAPI as JChatGPTAPI
  from xotorch_tpu.inference.dummy import DummyInferenceEngine
  from xotorch_tpu.orchestration.node import Node as JNode
  from xotorch_tpu.topology.partitioning import RingMemoryWeightedPartitioningStrategy

  class Request:
    async def json(self):
      return {"model": MODEL, "messages": messages, "tools": tools}

  node = JNode("jax-api", None, DummyInferenceEngine(), None, None,
               RingMemoryWeightedPartitioningStrategy())
  api = JChatGPTAPI(node, "JAXShardInferenceEngine", system_prompt=system_prompt)

  async def tokenizer_for(model, shard):
    return tokenizer
  api._tokenizer_for = tokenizer_for
  resp = await api.handle_post_chat_token_encode(Request())
  return json.loads(resp.body)
