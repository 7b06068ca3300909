"""The dense families on the port, from HF checkpoints on disk, against the JAX package
and HF transformers.

Tiny checkpoints of llama (llama3 rope scaling), qwen2 (q/k/v biases, tied
embeddings), phi3 (fused projections), mistral (an explicit head_dim), qwen3
(qk-norm) and gemma2 (the (1 + w) norm, sandwich norms, gelu-tanh, the embedding
scale, query_pre_attn_scalar, both softcaps and an alternating window of 4) are
written by `transformers` (tests/test_model_equivalence.py). On each, in fp32 on the
CPU: the port's logits against JAX's on the same checkpoint and against HF's
(atol 2e-4, rtol 2e-3, the tolerance JAX holds against HF), through the plain
attention and through the kernels' routes (their plain versions here); the port's
engine, given the checkpoint by a LocalShardDownloader, streams JAX's engine's greedy
tokens over 16 tokens; gemma2 split at an odd layer; and under XOT_PAGED_KV=1 (page
16) a windowed mistral releases the pages JAX's engine releases, gemma2 (global
layers between the windowed ones) none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model_equivalence import (TINY_GEMMA2_CFG, TINY_LLAMA_CFG, TINY_MISTRAL_CFG,
                                          TINY_PHI3_CFG, TINY_QWEN2_CFG, TINY_QWEN3_CFG, hf_logits,
                                          make_hf_checkpoint)
from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.inference.jax_engine import vkv as j_vkv
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models import weights as j_weights
from xotorch_tpu.models.config import load_model_config as j_load_model_config
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine import vkv
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import transformer, weights
from xotorch_tpu_torch.models.config import load_model_config

torch.set_num_threads(2)

FAMILIES = {
  "llama3-scaled-rope": TINY_LLAMA_CFG, "qwen2-bias-tied": TINY_QWEN2_CFG,
  "phi3-fused-proj": TINY_PHI3_CFG, "mistral-headdim": TINY_MISTRAL_CFG,
  "qwen3-qk-norm": TINY_QWEN3_CFG, "gemma2-sandwich-window": TINY_GEMMA2_CFG,
}
# mistral with a window: every layer slides, so a paged request's old pages free.
WINDOWED_MISTRAL_CFG = {**TINY_MISTRAL_CFG, "sliding_window": 16}
TOKENS = np.array([[1, 5, 9, 200, 17, 3, 42, 7, 99, 150, 23, 8]], dtype=np.int64)
TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
  """family id -> the directory of its tiny HF checkpoint."""
  root = tmp_path_factory.mktemp("families")
  dirs = {fid: make_hf_checkpoint(root / fid, cfg, seed=i)
          for i, (fid, cfg) in enumerate(FAMILIES.items())}
  dirs["mistral-window"] = make_hf_checkpoint(root / "mistral-window", WINDOWED_MISTRAL_CFG, seed=9)
  return dirs


@pytest.fixture(autouse=True)
def _highest_precision():
  with jax.default_matmul_precision("highest"):
    yield


def _port_logits(model_dir, tokens, use_flash=False, shards=None):
  """The port's logits over `tokens` from position 0; `shards` splits the layers."""
  cfg = load_model_config(model_dir)
  n = cfg.num_layers
  h = torch.from_numpy(tokens)
  for start, end in shards or [(0, n - 1)]:
    params = weights.load_shard_params(model_dir, cfg, Shard("m", start, end, n), dtype=torch.float32)
    cache = transformer.init_kv_cache(cfg, end - start + 1, 1, 32, torch.float32)
    h, _ = transformer.forward_shard(params, h, cache, 0, cfg, is_first=start == 0,
                                     is_last=end == n - 1, use_flash=use_flash, start_layer=start)
  return h.numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_jax_on_the_same_checkpoint(checkpoints, family):
  model_dir = checkpoints[family]
  jcfg = j_load_model_config(model_dir)
  n = jcfg.num_layers
  jparams = j_weights.load_shard_params(model_dir, jcfg, JShard("m", 0, n - 1, n), dtype=jnp.float32)
  cache = j_transformer.init_kv_cache(jcfg, n, 1, 32, jnp.float32)
  want, _ = j_transformer.forward_shard(jparams, jnp.asarray(TOKENS, jnp.int32), cache, jnp.int32(0),
                                        jcfg, True, True)
  for use_flash in (False, True):  # the plain attention, then K1's route
    np.testing.assert_allclose(_port_logits(model_dir, TOKENS, use_flash), np.asarray(want), **TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_transformers(checkpoints, family):
  model_dir = checkpoints[family]
  expected = hf_logits(model_dir, TOKENS.astype(np.int32))
  np.testing.assert_allclose(_port_logits(model_dir, TOKENS), expected, **TOL)


def test_gemma2_split_at_an_odd_layer_windows_by_absolute_layer(checkpoints):
  """The second shard starts at layer 1 (global, then windowed): counted from zero it
  would window the wrong layers and part from the whole model and from HF."""
  model_dir = checkpoints["gemma2-sandwich-window"]
  n = load_model_config(model_dir).num_layers
  full = _port_logits(model_dir, TOKENS)
  split = _port_logits(model_dir, TOKENS, shards=[(0, 0), (1, n - 1)])
  np.testing.assert_allclose(split, full, atol=1e-4, rtol=1e-3)
  np.testing.assert_allclose(full, hf_logits(model_dir, TOKENS.astype(np.int32)), **TOL)


async def test_gemma2_split_engines_chain_to_the_full_engine(checkpoints):
  model_dir = checkpoints["gemma2-sandwich-window"]
  n = load_model_config(model_dir).num_layers
  engines = [TorchShardInferenceEngine(LocalShardDownloader({"g": model_dir}), device="cpu",
                                       dtype="float32", seed=0) for _ in range(3)]
  full, first, second = engines
  try:
    want, _ = await full.infer_tensor("r", Shard("g", 0, n - 1, n), TOKENS)
    hidden, _ = await first.infer_tensor("r", Shard("g", 0, 0, n), TOKENS)
    got, _ = await second.infer_tensor("r", Shard("g", 1, n - 1, n), hidden)
  finally:
    for e in engines:
      e.executor.shutdown(wait=True)
  np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


async def _greedy(engine, shard, rid, prompt, n, pages=None):
  """n greedy tokens; with `pages` (a function of the engine and request id), what it
  returns after the prefill and after each decode chunk."""
  seen = []
  tok, _ = await engine.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
  out, size = [int(tok)], 2
  if pages:
    seen.append(pages(engine, rid))
  while len(out) < n:
    chunk = await engine.generate_chunk(rid, shard, out[-1], min(size, n - len(out)), temp=0.0,
                                        top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
    size *= 2
    if pages:
      seen.append(pages(engine, rid))
  await engine.clear_request(rid)
  return out[:n], seen


async def _both_streams(model_dir, n, pages=None):
  prompt = np.random.default_rng(5).integers(3, 256, size=(1, 30))
  layers = load_model_config(model_dir).num_layers
  jeng = JAXShardInferenceEngine(JLocalShardDownloader({"m": model_dir}), dtype="float32")
  eng = TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu", seed=0)
  try:
    want = await _greedy(jeng, JShard("m", 0, layers - 1, layers), "r", prompt, n, pages)
    got = await _greedy(eng, Shard("m", 0, layers - 1, layers), "r", prompt, n, pages)
  finally:
    for e in (jeng, eng):
      e.executor.shutdown(wait=True)
  return got, want, eng


@pytest.mark.parametrize("family", FAMILIES)
async def test_greedy_engine_stream_matches_jax_engine(checkpoints, family, monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_PREFILL_CHUNK", "16")  # 30 tokens: segments at 0 and 16
  got, want, eng = await _both_streams(checkpoints[family], 16)
  assert got == want
  assert eng.tokenizer.eos_token_id == 2  # no tokenizer file: the config's eos on the fake


def _vkv_state(engine, rid):
  """(released leading pages, live pages) of a paged request on either engine."""
  if hasattr(engine, "_contexts"):
    state = next(iter(engine._contexts.values())).states[rid]
  else:
    state = engine._ctx.states[rid]
  return state.pages.base, len(state.pages.live())


@pytest.mark.parametrize("family,frees", [("mistral-window", True),
                                          ("gemma2-sandwich-window", False)])
async def test_paged_window_release_matches_jax(checkpoints, family, frees, monkeypatch):
  for name, value in (("XOT_DTYPE", "float32"), ("XOT_PREFILL_CHUNK", "16"), ("XOT_PAGED_KV", "1"),
                      ("XOT_KV_PAGE", "16"), ("XOT_KV_POOL_TOKENS", "512")):
    monkeypatch.setenv(name, value)
  (got, got_pages), (want, want_pages), eng = await _both_streams(checkpoints[family], 40,
                                                                  pages=_vkv_state)
  assert got == want
  assert got_pages == want_pages
  assert (got_pages[-1][0] > 0) == frees, got_pages
  assert eng._ctx.page_pool.pages_in_use == 0


def test_freeable_window_matches_jax(checkpoints):
  for fid in ("mistral-window", "gemma2-sandwich-window", "llama3-scaled-rope"):
    cfg, jcfg = load_model_config(checkpoints[fid]), j_load_model_config(checkpoints[fid])
    n = cfg.num_layers
    for start, count in ((0, n), (1, n - 1), (1, 1), (0, 1)):
      assert vkv.freeable_window(cfg, start, count) == j_vkv.freeable_window(jcfg, start, count)
