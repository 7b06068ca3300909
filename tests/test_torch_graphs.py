"""The fused device programs of the port (models/generate.decode_step, scan_groups,
prefill_scan; models/graphs.py) against the JAX package, on the CPU.

On the card a decode chunk is one captured step replayed K times and a scan-prefill
group one captured graph; here the same bodies run eagerly, either called directly or
through `EagerGraphCache`, the graph cache with its CUDA parts played eagerly (a
"capture" records that the program exists, a "replay" runs its body over the static
buffers), so the slab, the static buffers, the pad rows and the token record are
exercised as the card runs them.

Tolerances: tokens are compared exactly (fp32, greedy, or JAX's Gumbel noise
injected); hidden states and caches of the scan prefill within atol 1e-4 / rtol 1e-3
and 1e-5 / 1e-4 (fp32 sums in another order than XLA's, the JAX package's own
tolerance for prefill_scan against its per-segment forward); the slab's copies and the
B=1 tensor-position path bit for bit.
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model_equivalence import make_hf_checkpoint
from tests.test_torch_engine import jax_weights  # noqa: F401 (fixture)
from tests.test_torch_families import WINDOWED_MISTRAL_CFG
from tests.test_torch_paged import _shuffled_table
from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import generate as j_generate
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.models.registry import get_model_card as j_get_model_card
from xotorch_tpu_torch.api.chatgpt_api import ChatGPTAPI
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine import engine as engine_mod
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import generate, graphs, transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict, load_model_config
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
K = 6  # decode steps of a chunk
TOP_K = 20
TEMP = 0.8


class EagerGraphCache(graphs.GraphCache):
  """models/graphs.GraphCache with its CUDA parts played eagerly on the CPU."""

  def on_stream(self):
    return contextlib.nullcontext()

  def _capture(self, prog):
    prog.graph = types.SimpleNamespace(reset=lambda: None)  # a "captured" graph
    self.captures += 1

  def _replay(self, prog):
    prog.output = prog.body()
    self.replays += 1


@pytest.fixture(autouse=True)
def _highest_precision():
  with jax.default_matmul_precision("highest"):
    yield


def _cfgs():
  return (j_config_from_hf_dict(j_get_model_card(MODEL)["synthetic_config"]),
          config_from_hf_dict(get_model_card(MODEL)["synthetic_config"]))


def _params(jcfg, cfg):
  jp = j_transformer.init_random_params(jcfg, jcfg.num_layers, True, True, jax.random.PRNGKey(0),
                                        dtype=jnp.float32)
  return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _jax_noise(key, rows: int, vocab: int, steps: int = K) -> np.ndarray:
  """The Gumbel noise JAX's decode scan draws: one key split a step."""
  noise = []
  for _ in range(steps):
    key, sub = jax.random.split(key)
    noise.append(np.asarray(jax.random.gumbel(sub, (rows, vocab), jnp.float32)))
  return np.stack(noise)


# ------------------------------------------------------------------ decode

def test_scan_groups_match_jax():
  for n in range(1, 65):
    groups = list(generate.scan_groups(n))
    assert groups == list(j_generate.scan_groups(n))
    assert sum(g for _, g in groups) == n and all(g & (g - 1) == 0 for _, g in groups)


def _body_steps(params, cfg, toks, cache, pos, temps, noise, table=None):
  """decode_step run K times over its buffers, as models/graphs replays it."""
  B = toks.shape[0]
  tok = toks.clone()
  pos = pos.clone()
  out = torch.zeros((K, B), dtype=torch.int64)
  step = torch.zeros((1,), dtype=torch.int64)
  for _ in range(K):
    generate.decode_step(params, tok, cache, pos, cfg, temps, TOP_K, use_flash_decode=True,
                         gumbel=noise, page_table=table, out=out, step=step)
  return out.t()


@pytest.mark.parametrize("via", ["body", "graph cache"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "gumbel"])
@pytest.mark.parametrize("kind", ["single", "batched", "paged"])
def test_decode_matches_jax(kind, sampled, via):
  """JAX's decode_chunk (B=1), decode_chunk_batched (B=3 padded to 4) and
  decode_chunk_paged (B=3 padded to 4) against the step body run K times, directly or
  through the graph cache: identical tokens, greedy or with JAX's noise injected."""
  jcfg, cfg = _cfgs()
  jp, params = _params(jcfg, cfg)
  rng = np.random.default_rng(3)
  V, L, S, page, P, maxp = cfg.vocab_size, cfg.num_layers, 64, 16, 24, 4
  lens = (9,) if kind == "single" else (4, 11, 17)
  B = len(lens)
  Bb = 1 if B == 1 else 4
  prompts = [rng.integers(3, 256, size=(1, n)).astype(np.int32) for n in lens]
  temp = TEMP if sampled else 0.0
  key = jax.random.PRNGKey(5)
  noise = torch.from_numpy(_jax_noise(key, Bb, V)) if sampled else None
  pos = np.array(lens, np.int32)
  if kind == "paged":
    table = _shuffled_table(rng, P, [n + K for n in lens], page, maxp)
    shape = (L, P, page, cfg.num_kv_heads, cfg.head_dim)
    jarena = {n: jnp.zeros(shape, jnp.float32) for n in ("k", "v")}
    arena = {n: torch.zeros(shape) for n in ("k", "v")}
    last = []
    for b, toks in enumerate(prompts):
      jl, jarena = j_generate.forward_paged(jp, jnp.asarray(toks), jarena,
                                            jnp.asarray(table[b:b + 1]), jnp.int32(0), jcfg)
      transformer.forward_shard(params, torch.from_numpy(toks).long(), arena, 0, cfg, True, True,
                                page_table=torch.from_numpy(table[b:b + 1]))
      last.append(int(np.argmax(np.asarray(jl)[0, -1])))
    jtoks, _ = j_generate.decode_chunk_paged(
      jp, jarena, jnp.asarray(table), jnp.asarray(np.array(last, np.int32)[:, None]),
      jnp.asarray(pos), key, jcfg, K, jnp.full((B,), temp, jnp.float32), TOP_K, pad_rows=1)
    toks_in = torch.tensor(last)[:, None]
    temps = torch.full((B,), temp)
    if via == "body":
      full = torch.zeros((Bb, maxp), dtype=torch.int32)
      full[:B] = torch.from_numpy(table)
      got = _body_steps(params, cfg, torch.cat([toks_in, toks_in[:1]]), arena,
                        torch.tensor(list(lens) + [0], dtype=torch.int32),
                        torch.cat([temps, temps[:1]]), noise, table=full)[:B]
    else:
      got, _ = graphs.decode_paged(EagerGraphCache("cpu"), params, arena, torch.from_numpy(table),
                                   toks_in, torch.from_numpy(pos), cfg, K, temps, TOP_K,
                                   gumbel=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtoks))
    return
  jcaches, caches, last = [], [], []
  for toks in prompts:
    jl, jc = j_transformer.forward_shard(jp, jnp.asarray(toks), j_transformer.init_kv_cache(
      jcfg, L, 1, S, jnp.float32), jnp.int32(0), jcfg, True, True)
    _, c = transformer.forward_shard(params, torch.from_numpy(toks).long(),
                                     transformer.init_kv_cache(cfg, L, 1, S, torch.float32), 0, cfg,
                                     True, True)
    jcaches.append(jc)
    caches.append(c)
    last.append(int(np.argmax(np.asarray(jl)[0, -1])))
  toks_in = torch.tensor(last)[:, None]
  temps = torch.full((B,), temp)
  if kind == "single":
    jtoks, jcache = j_generate.decode_chunk(jp, jnp.asarray(np.array(last, np.int32)[:, None]),
                                            jcaches[0], jnp.int32(lens[0]), key, jcfg, K, temp,
                                            TOP_K)
    jcaches = [jcache]
  else:
    jtoks, jcaches = j_generate.decode_chunk_batched(
      jp, tuple(jcaches), jnp.asarray(np.array(last, np.int32)[:, None]), jnp.asarray(pos), key,
      jcfg, K, jnp.full((B,), temp, jnp.float32), TOP_K, pad_rows=Bb - B)
  if via == "body":
    stacked = {n: torch.cat([c[n] for c in caches] + [torch.zeros_like(caches[0][n])] * (Bb - B),
                            dim=1) for n in caches[0]}
    got = _body_steps(params, cfg, torch.cat([toks_in] + [toks_in[:1]] * (Bb - B)), stacked,
                      torch.tensor(list(lens) + [lens[0]] * (Bb - B), dtype=torch.int32),
                      torch.cat([temps] + [temps[:1]] * (Bb - B)), noise)[:B]
    caches = [{n: t[:, i:i + 1] for n, t in stacked.items()} for i in range(B)]
  else:
    got, _ = graphs.decode_contiguous(EagerGraphCache("cpu"), params, caches, toks_in,
                                      torch.from_numpy(pos), cfg, K, temps, TOP_K, gumbel=noise)
  np.testing.assert_array_equal(got.numpy(), np.asarray(jtoks))
  for c, jc in zip(caches, jcaches):
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]), atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_tensor_positions_match_the_int_path_bitwise(dtype):
  """B=1 through the per-row tensor path (a captured step's positions) gives the
  int path's logits and cache bit for bit."""
  _, cfg = _cfgs()
  params = transformer.init_random_params(cfg, cfg.num_layers, True, True, seed=1, dtype=dtype)
  prompt = torch.from_numpy(np.random.default_rng(1).integers(3, 256, size=(1, 13))).long()
  caches = []
  for _ in range(2):
    cache = transformer.init_kv_cache(cfg, cfg.num_layers, 1, 32, dtype)
    transformer.forward_shard(params, prompt, cache, 0, cfg, True, True)
    caches.append(cache)
  tok = torch.tensor([[7]])
  a, _ = transformer.forward_shard(params, tok, caches[0], 13, cfg, True, True,
                                   use_flash_decode=True)
  b, _ = transformer.forward_shard(params, tok, caches[1], torch.tensor([13], dtype=torch.int32),
                                   cfg, True, True, use_flash_decode=True)
  assert torch.equal(a, b)
  for name in caches[0]:
    assert torch.equal(caches[0][name], caches[1][name])


# ------------------------------------------------------------------ prefill

@pytest.mark.parametrize("via", ["scan", "graph cache"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_prefill_scan_matches_jax(paged, via):
  """Three segments of 16 (groups of 2 and 1 through the graph cache) from position 5:
  the last-layer hidden states of every position and the cache (or the arena) within
  tolerance of JAX's prefill_scan, whose cached-attention and paged kernels run in
  interpret mode, as its own tests run them."""
  jcfg, cfg = _cfgs()
  jp, params = _params(jcfg, cfg)
  rng = np.random.default_rng(9)
  L, seg, n_segs, start = cfg.num_layers, 16, 3, 5
  T = seg * n_segs
  head = rng.integers(3, 256, size=(1, start)).astype(np.int32)
  toks = rng.integers(3, 256, size=(1, T)).astype(np.int32)
  if paged:
    page, P = 16, 12
    table = _shuffled_table(rng, P, [start + T], page, 4)
    shape = (L, P, page, cfg.num_kv_heads, cfg.head_dim)
    jcache = {n: jnp.zeros(shape, jnp.float32) for n in ("k", "v")}
    cache = {n: torch.zeros(shape) for n in ("k", "v")}
    jkw = dict(page_table=jnp.asarray(table), paged_kernel=True)
    kw = dict(page_table=torch.from_numpy(table))
  else:
    jcache = j_transformer.init_kv_cache(jcfg, L, 1, 64, jnp.float32)
    cache = transformer.init_kv_cache(cfg, L, 1, 64, torch.float32)
    jkw, kw = {}, {}
  _, jcache = j_transformer.forward_shard(jp, jnp.asarray(head), jcache, jnp.int32(0), jcfg, True,
                                          False, **jkw)
  transformer.forward_shard(params, torch.from_numpy(head).long(), cache, 0, cfg, True, False, **kw)
  jh, jcache = j_generate.prefill_scan(jp, jnp.asarray(toks), jcache, jnp.int32(start), jcfg,
                                       n_segs, **jkw)
  x = torch.from_numpy(toks).long()
  if via == "scan":
    h, _ = generate.prefill_scan(params, x, cache, start, cfg, n_segs, **kw)
  else:
    gc = EagerGraphCache("cpu")
    h = graphs.prefill(gc, params, x, cache, start, cfg, seg, want_hidden=True, **kw)
    assert [p.key[0] for p in gc.programs.values()] == ["prefill", "prefill"]
  np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-3)
  for name in ("k", "v"):
    np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), atol=1e-5, rtol=1e-4)


# ------------------------------------------------------------------ engine

async def _greedy(engine, shard, rid, prompt, n, graph_cache=False):
  tok, _ = await engine.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
  out, size = [int(tok)], 2
  while len(out) < n:
    chunk = await engine.generate_chunk(rid, shard, out[-1], min(size, n - len(out)), temp=0.0,
                                        top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
    size *= 2
  return out[:n]


def _port_engine(graph_cache: bool, seed: int = 0) -> TorchShardInferenceEngine:
  eng = TorchShardInferenceEngine(device="cpu", seed=seed)
  if graph_cache:
    load = eng._load_shard

    def load_with_cache(*a):
      ctx = load(*a)
      ctx.graphs = EagerGraphCache("cpu")
      return ctx
    eng._load_shard = load_with_cache
  return eng


@pytest.mark.parametrize("graph_cache", [False, True], ids=["eager", "graph cache"])
@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_engine_scan_prefill_streams_match_jax(jax_weights, monkeypatch, paged, graph_cache):
  """XOT_SCAN_PREFILL=1, XOT_PREFILL_CHUNK=8, a prompt of 5 whole chunks and 3 tokens:
  the leading 40 tokens go through prefill_scan (groups of 4 and 1), all through the
  cached wrapper (K2's) or on the arena the paged one (K4's), the tail through
  forward_sample; the greedy stream equals the JAX engine's with its scan on."""
  for name, value in (("XOT_DTYPE", "float32"), ("XOT_PREFILL_CHUNK", "8"),
                      ("XOT_SCAN_PREFILL", "1"), ("XOT_CACHE_LEN", "16"), ("XOT_KV_PAGE", "16"),
                      ("XOT_KV_POOL_TOKENS", "512"), ("XOT_FLASH_DECODE", "1"),
                      ("XOT_FLASH_DECODE_MIN", "0")):
    monkeypatch.setenv(name, value)
  prompt = np.random.default_rng(43).integers(3, 256, size=(1, 43))
  jeng = JAXShardInferenceEngine(dtype="float32")
  want = await _greedy(jeng, JShard(MODEL, 0, 3, 4), "r", prompt, 12)
  jeng.executor.shutdown(wait=True)
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  scans, calls = [], {"flash": 0}
  real_scan, real_flash = engine_mod.prefill_scan, transformer.flash_attention

  def scan(params, x, *a, **kw):
    scans.append(x.shape[1])
    return real_scan(params, x, *a, **kw)

  def flash(*a, **kw):
    calls["flash"] += 1
    return real_flash(*a, **kw)
  monkeypatch.setattr(engine_mod, "prefill_scan", scan)
  monkeypatch.setattr(graphs, "prefill_scan", scan)
  monkeypatch.setattr(transformer, "flash_attention", flash)
  eng = _port_engine(graph_cache)
  got = await _greedy(eng, Shard(MODEL, 0, 3, 4), "r", prompt, 12)
  eng.executor.shutdown(wait=True)
  assert got == want
  assert scans == [32, 8] and calls["flash"] == 0
  if graph_cache:
    keys = [p.key[:2] for p in eng._ctx.graphs.programs.values()]
    assert keys.count(("prefill", "paged" if paged == "1" else "contiguous")) == 2
    assert ("decode", "paged" if paged == "1" else "contiguous") in keys


async def _sampled(engine, rid, prompt):
  tok, _ = await engine.infer_sample_tensor(rid, Shard(MODEL, 0, 3, 4), prompt, temp=TEMP, top_k=0)
  out = [int(tok)]
  for _ in range(3):
    chunk = await engine.generate_chunk(rid, Shard(MODEL, 0, 3, 4), out[-1], 4, temp=TEMP, top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
  return out


@pytest.mark.parametrize("graph_cache", [False, True], ids=["eager", "graph cache"])
@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_fresh_engines_with_one_seed_sample_one_stream(monkeypatch, paged, graph_cache):
  """Two fresh engines seeded alike sample the same stream at temperature 0.8, each
  step drawing fresh noise from the engine's generator; another seed samples another."""
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  monkeypatch.setenv("XOT_KV_PAGE", "16")
  monkeypatch.setenv("XOT_KV_POOL_TOKENS", "512")
  prompt = np.random.default_rng(8).integers(3, 256, size=(1, 9))
  streams = []
  for seed in (7, 7, 8):
    eng = _port_engine(graph_cache, seed=seed)
    streams.append(await _sampled(eng, "r", prompt))
    eng.executor.shutdown(wait=True)
  assert streams[0] == streams[1] and streams[0] != streams[2]


async def test_paged_fill_releases_window_pages_as_jax(tmp_path, monkeypatch):
  """A windowed mistral (window 16, pages of 16) prefills 5 whole chunks of 8 into its
  pages through the scan: right after the prefill, before any decode, the pages its
  window slid past are released as JAX's engine releases them."""
  for name, value in (("XOT_DTYPE", "float32"), ("XOT_PREFILL_CHUNK", "8"), ("XOT_PAGED_KV", "1"),
                      ("XOT_KV_PAGE", "16"), ("XOT_KV_POOL_TOKENS", "512")):
    monkeypatch.setenv(name, value)
  model_dir = make_hf_checkpoint(tmp_path / "mistral-window", WINDOWED_MISTRAL_CFG, seed=9)
  layers = load_model_config(model_dir).num_layers
  prompt = np.random.default_rng(5).integers(3, 256, size=(1, 43))
  jeng = JAXShardInferenceEngine(JLocalShardDownloader({"m": model_dir}), dtype="float32")
  eng = TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu", seed=0)
  try:
    jtok, _ = await jeng.infer_sample_tensor("r", JShard("m", 0, layers - 1, layers), prompt,
                                             temp=0.0, top_k=0)
    tok, _ = await eng.infer_sample_tensor("r", Shard("m", 0, layers - 1, layers), prompt,
                                           temp=0.0, top_k=0)
  finally:
    for e in (jeng, eng):
      e.executor.shutdown(wait=True)
  jstate = next(iter(jeng._contexts.values())).states["r"]
  state = eng._ctx.states["r"]
  assert int(tok) == int(jtok)
  assert (state.pages.base, len(state.pages.live())) == (jstate.pages.base,
                                                         len(jstate.pages.live()))
  assert state.pages.base > 0


# ------------------------------------------------------------------ the slab and the keys

@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_slab_round_trip_is_bit_exact(kv_quant):
  """Three caches (int8 codes and their scales too) copied into the slab's rows of a
  [L, 4, S, ...] view and back: every member bit for bit, the pad row zeroed; a
  bigger stack grows the slab and drops the programs captured over the old one, and
  the pool goes with the last graph."""
  _, cfg = _cfgs()
  gen = torch.Generator().manual_seed(0)
  caches = []
  for _ in range(3):
    c = transformer.init_kv_cache(cfg, cfg.num_layers, 1, 32, torch.bfloat16, kv_quant=kv_quant)
    for name, t in c.items():
      if t.dtype == torch.int8:
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8))
      else:
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    caches.append(c)
  want = [{n: t.clone() for n, t in c.items()} for c in caches]
  gc = EagerGraphCache("cpu")
  slab = gc.slab_views(graphs.slab_leaves(caches[0], 4))
  for t in slab.values():
    t.fill_(1)
  graphs.stack_into(slab, caches)
  for name, t in slab.items():
    assert t.shape[1] == 4 and t.is_contiguous() and t.dtype == caches[0][name].dtype
    for i in range(3):
      assert torch.equal(t[:, i:i + 1], want[i][name])
    assert not t[:, 3].any()
  for c in caches:
    for t in c.values():
      t.zero_()
  graphs.split_from(slab, caches)
  for c, w in zip(caches, want):
    assert c.keys() == w.keys() and all(torch.equal(c[n], w[n]) for n in c)
  for key, uses_slab in ((("slab user",), True), (("arena user",), False)):
    gc.run(gc.program(key, dict, lambda st: (lambda: None), uses_slab=uses_slab))
  gc._pool = "the shared pool"
  size = gc.slab.numel()
  gc.slab_views(graphs.slab_leaves(caches[0], 8))
  assert gc.slab.numel() > size and list(gc.programs) == [("arena user",)]
  assert gc._pool == "the shared pool"  # a graph still uses it
  gc.slab_views(graphs.slab_leaves(caches[0], 16))
  gc._drop(("arena user",))
  assert not gc.programs and gc._pool is None  # no graph left: the next capture takes a new one


def test_key_set_stays_bounded_under_the_snapped_top_p_grid():
  """Clients' top_p values, snapped as the API snaps them, key at most the grid's 20
  values plus off: one decode program each, however many values the clients send;
  and the cache never holds more than its capacity."""
  _, cfg = _cfgs()
  params = transformer.init_random_params(cfg, cfg.num_layers, True, True, seed=0)
  cache = transformer.init_kv_cache(cfg, cfg.num_layers, 1, 16, torch.float32)
  gc = EagerGraphCache("cpu", capacity=64)
  rng = np.random.default_rng(0)
  sent = list(rng.uniform(0.001, 1.0, size=200)) + [1.0, 0.999, 0.0001]
  snapped = set()
  for top_p in sent:
    p = ChatGPTAPI._parse_sampling({"top_p": float(top_p)})[2]
    snapped.add(p)
    graphs.decode_contiguous(gc, params, [cache], torch.tensor([[5]]),
                             torch.tensor([0], dtype=torch.int32), cfg, 1, torch.tensor([0.7]),
                             TOP_K, p or 0.0)
  assert len(snapped) <= 21 and None in snapped
  assert len(gc.programs) == len(snapped)
  small = EagerGraphCache("cpu", capacity=4)
  for p in sorted(x for x in snapped if x):
    graphs.decode_contiguous(small, params, [cache], torch.tensor([[5]]),
                             torch.tensor([0], dtype=torch.int32), cfg, 1, torch.tensor([0.7]),
                             TOP_K, p)
  assert len(small.programs) == 4


def test_token_record_is_read_past_its_rows(monkeypatch):
  """A chunk longer than the graph's token record (OUT_ROWS) reads it every OUT_ROWS
  steps: the tokens equal the eager decode_chunk's."""
  monkeypatch.setattr(graphs, "OUT_ROWS", 4)
  _, cfg = _cfgs()
  params = transformer.init_random_params(cfg, cfg.num_layers, True, True, seed=2)
  caches = [transformer.init_kv_cache(cfg, cfg.num_layers, 1, 32, torch.float32) for _ in range(2)]
  want, _ = generate.decode_chunk(params, torch.tensor([[9]]), caches[0], 0, cfg, 11, 0.0, 0,
                                  use_flash_decode=True)
  gc = EagerGraphCache("cpu")
  got, _ = graphs.decode_contiguous(gc, params, [caches[1]], torch.tensor([[9]]),
                                    torch.tensor([0], dtype=torch.int32), cfg, 11,
                                    torch.tensor([0.0]), 0)
  assert torch.equal(got, want)
  assert gc.captures == 1 and gc.replays == 10
  for name in caches[0]:
    assert torch.equal(caches[0][name], caches[1][name])


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_guard_keeps_the_collector_off(enabled):
  """No collection starts inside `capture_guard`, however many objects the capture
  allocates (a dead graph destroyed there would invalidate the capture); the collector's
  state is restored after it, also when the capture raises, and a dead cycle left over
  is collected after it when the collector is on."""
  import gc as python_gc

  finalized = []

  class Dead:
    def __del__(self):
      finalized.append(python_gc.isenabled())

  was, thresholds = python_gc.isenabled(), python_gc.get_threshold()
  (python_gc.enable if enabled else python_gc.disable)()
  try:
    with graphs.capture_guard(torch.device("cpu")):
      assert not python_gc.isenabled()
      python_gc.set_threshold(1)  # any allocation would start a collection
      d = Dead()
      d.me = d
      del d
      junk = [[i] for i in range(1000)]
      assert not finalized and junk
    assert python_gc.isenabled() == enabled
    [[i] for i in range(1000)]
    assert finalized == ([True] if enabled else [])
    with pytest.raises(RuntimeError, match="inside"):
      with graphs.capture_guard(torch.device("cpu")):
        raise RuntimeError("inside")
    assert python_gc.isenabled() == enabled
  finally:
    python_gc.set_threshold(*thresholds)
    (python_gc.enable if was else python_gc.disable)()
    python_gc.collect()
