"""The port's MoE (qwen3_moe) against the JAX package's, on the CPU.

synthetic-tiny-moe (4 layers, 4 experts, top 2, norm_topk_prob) runs on the JAX
package's own random weights, carried across by `params_from_jax`: the forward's
logits within 1e-4 absolute in fp32 (JAX's matmul precision pinned to 'highest'; what
remains is the order of fp32 sums), the routed gather equal to the dense combine in
both packages, int8 experts with JAX's byte-identical scales, greedy engine streams
identical on contiguous and paged KV, through speculative verify, on an int8 KV cache
and through the prefix cache, a checkpoint written by JAX's `save_shard_params` loaded
by the port, and the engine's cost model equal to JAX's.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import generate as j_generate
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.models.quantize import quantize_params as j_quantize_params
from xotorch_tpu.models.registry import get_model_card as j_get_model_card
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models import generate, transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.quantize import quantize_params
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import load_shard_params, params_from_jax

torch.set_num_threads(2)

MODEL = "synthetic-tiny-moe"
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision():
  with jax.default_matmul_precision("highest"):
    yield


def _cfgs():
  return (j_config_from_hf_dict(j_get_model_card(MODEL)["synthetic_config"]),
          config_from_hf_dict(get_model_card(MODEL)["synthetic_config"]))


def _jax_params(jcfg, seed=7):
  return j_transformer.init_random_params(jcfg, jcfg.num_layers, True, True,
                                          jax.random.PRNGKey(seed), dtype=jnp.float32)


def _np(tree):
  return jax.tree.map(np.asarray, tree)


def _tokens(n, seed=0, vocab=256):
  return np.random.default_rng(seed).integers(3, vocab, size=(1, n)).astype(np.int64)


def _port_forward(params, cfg, toks, pos=0, cache=None):
  if cache is None:
    cache = transformer.init_kv_cache(cfg, cfg.num_layers, toks.shape[0], 64, torch.float32)
  out, cache = transformer.forward_shard(params, torch.as_tensor(toks), cache, pos, cfg, True, True)
  return out.numpy(), cache


def _jax_forward(jparams, jcfg, toks, pos=0, cache=None, moe_routed=True):
  if cache is None:
    cache = j_transformer.init_kv_cache(jcfg, jcfg.num_layers, toks.shape[0], 64, jnp.float32)
  out, cache = j_transformer.forward_shard(jparams, jnp.asarray(toks, jnp.int32), cache,
                                           jnp.int32(pos), jcfg, True, True, moe_routed=moe_routed)
  return np.asarray(out), cache


def test_config_and_random_init_carry_moe_slots():
  """The card parses as JAX's does, and the port's seeded init has JAX's slots and
  shapes (router [L, H, E], experts [L, E, in, out]); a shard's layers equal the same
  layers of a full init."""
  jcfg, cfg = _cfgs()
  assert cfg == dataclasses.replace(cfg, **{f.name: getattr(jcfg, f.name)
                                            for f in dataclasses.fields(jcfg)})
  assert cfg.is_moe and cfg.num_experts == 4 and cfg.num_experts_per_tok == 2
  params = transformer.init_random_params(cfg, 4, True, True, seed=3)
  jparams = _jax_params(jcfg)
  assert ({k: tuple(v.shape) for k, v in params["layers"].items()}
          == {k: tuple(v.shape) for k, v in jparams["layers"].items()})
  tail = transformer.init_random_params(cfg, 2, False, True, seed=3, start_layer=2)
  for name, w in tail["layers"].items():
    torch.testing.assert_close(w, params["layers"][name][2:], rtol=0, atol=0)


@pytest.mark.parametrize("T", [1, 5, 8, 16, 23], ids=lambda t: f"T{t}")
def test_forward_logits_match_jax(T):
  """Prefill logits from position 0: T <= 8 takes the routed gather in both packages,
  larger T the dense combine."""
  jcfg, cfg = _cfgs()
  jparams = _jax_params(jcfg)
  params = params_from_jax(_np(jparams), cfg)
  toks = _tokens(T, seed=T)
  want, _ = _jax_forward(jparams, jcfg, toks)
  got, _ = _port_forward(params, cfg, toks)
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_decode_steps_and_batched_rows_match_jax():
  """Three rows at their own depths (per-row positions): a prefill per row, then four
  decode steps of B=3 (B*T = 3: the routed gather), logits against JAX's."""
  jcfg, cfg = _cfgs()
  jparams = _jax_params(jcfg)
  params = params_from_jax(_np(jparams), cfg)
  B = 3
  jcache = j_transformer.init_kv_cache(jcfg, jcfg.num_layers, B, 64, jnp.float32)
  cache = transformer.init_kv_cache(cfg, cfg.num_layers, B, 64, torch.float32)
  lens = [5, 11, 2]
  toks = np.zeros((B, 16), np.int64)
  for b, n in enumerate(lens):
    toks[b, :n] = _tokens(n, seed=40 + b)[0]
  _, jcache = _jax_forward(jparams, jcfg, toks, 0, jcache)
  _, cache = _port_forward(params, cfg, toks, 0, cache)
  step = np.array([[7], [9], [200]], np.int64)
  pos = np.array(lens, np.int32)
  for _ in range(4):
    want, jcache = j_transformer.forward_shard(jparams, jnp.asarray(step, jnp.int32), jcache,
                                               jnp.asarray(pos), jcfg, True, True)
    got, cache = transformer.forward_shard(params, torch.as_tensor(step), cache,
                                           torch.as_tensor(pos), cfg, True, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    step = np.asarray(want)[:, -1].argmax(-1)[:, None].astype(np.int64)
    pos = pos + 1


@pytest.mark.parametrize("B", [1, 3])
def test_routed_decode_equals_dense_combine(B):
  """The routed gather is the dense combine's math (the E - k unchosen terms are zero
  there): at B*T <= 8 the port's routed MLP equals its dense one to fp32 rounding, and
  a greedy decode chunk streams JAX's dense-combine chunk (tests/test_moe_ep.py's
  routed-against-dense check, across the packages)."""
  jcfg, cfg = _cfgs()
  jparams = _jax_params(jcfg)
  params = params_from_jax(_np(jparams), cfg)
  layer = {k: v[1] for k, v in params["layers"].items()}
  h = torch.from_numpy(np.random.default_rng(B).standard_normal((B, 1, cfg.hidden_size))
                       .astype(np.float32))
  vals, idx = transformer._moe_route(layer, h, cfg)
  routed = transformer._moe_mlp_routed(layer, h, vals, idx)
  dense = transformer._moe_mlp(layer, h.repeat(1, 16, 1), cfg)[:, :1]  # B*T >= 16: dense
  torch.testing.assert_close(routed, dense, atol=1e-6, rtol=1e-5)

  start = np.array([[3], [9], [200]][:B], np.int64)
  key = jax.random.PRNGKey(0)
  jcache = j_transformer.init_kv_cache(jcfg, jcfg.num_layers, B, 64, jnp.float32)
  jpos = jnp.zeros((B,), jnp.int32) if B > 1 else jnp.int32(0)
  jtoks, _ = j_generate.decode_chunk(jparams, jnp.asarray(start, jnp.int32), jcache, jpos, key,
                                     jcfg, 8, 0.0, 0, moe_routed=False)
  cache = transformer.init_kv_cache(cfg, cfg.num_layers, B, 64, torch.float32)
  pos = torch.zeros(B, dtype=torch.int32) if B > 1 else 0
  toks, _ = generate.decode_chunk(params, torch.as_tensor(start), cache, pos, cfg, 8, 0.0, 0)
  np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks).reshape(B, -1))


def test_route_breaks_ties_to_the_lower_index_like_jax():
  """Equal router probabilities: the port's stable descending sort takes the lower
  expert index first, as jax.lax.top_k does."""
  _, cfg = _cfgs()
  E = cfg.num_experts
  router = torch.zeros(cfg.hidden_size, E)
  router[0, 1] = router[0, 3] = 1.0  # experts 1 and 3 tie at the top
  h = torch.zeros(1, 1, cfg.hidden_size)
  h[0, 0, 0] = 2.0
  _, idx = transformer._moe_route({"router": router}, h, cfg)
  probs = jax.nn.softmax(jnp.asarray(h.numpy()) @ jnp.asarray(router.numpy()), axis=-1)
  _, jidx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
  assert idx.reshape(-1).tolist() == np.asarray(jidx).reshape(-1).tolist() == [1, 3]


def test_int8_experts_match_jax_byte_for_byte():
  """int8 quantization keeps each expert's per-(expert, out) scales exactly as JAX
  stores them, and the quantized forward (routed and dense) matches JAX's quantized
  forward; int4 keeps the experts at int8, as JAX does."""
  jcfg, cfg = _cfgs()
  jparams = _jax_params(jcfg)
  jq = j_quantize_params(jparams, scale_dtype=jnp.float32)
  q = quantize_params(params_from_jax(_np(jparams), cfg), scale_dtype=torch.float32)
  for slot in ("we_gate", "we_up", "we_down"):
    assert q["layers"][slot].dtype == torch.int8
    np.testing.assert_array_equal(q["layers"][slot].numpy(), np.asarray(jq["layers"][slot]))
    np.testing.assert_array_equal(q["layers"][slot + "_scale"].numpy(),
                                  np.asarray(jq["layers"][slot + "_scale"]))
  assert "router_scale" not in q["layers"]
  for T in (4, 16):
    toks = _tokens(T, seed=T + 100)
    want, _ = _jax_forward(jq, jcfg, toks)
    got, _ = _port_forward(q, cfg, toks)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
  q4 = quantize_params(params_from_jax(_np(jparams), cfg), "int4", scale_dtype=torch.float32)
  assert q4["layers"]["we_up"].dtype == torch.int8 and "we_up_scale" in q4["layers"]
  assert q4["layers"]["wq"].dtype == torch.uint8 and "wq_gscale" in q4["layers"]


def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path):
  """A tiny qwen3_moe checkpoint written by JAX's save_shard_params: the port's loader
  stacks the experts into JAX's layout bit for bit, and the port's writer writes the
  same tensors back."""
  from xotorch_tpu.models.weights import save_shard_params as j_save
  from xotorch_tpu_torch.models.weights import _read_header, save_shard_params
  import json
  jcfg, cfg = _cfgs()
  jparams = _jax_params(jcfg)
  n = jcfg.num_layers
  j_save(jparams, jcfg, JShard(MODEL, 0, n - 1, n), tmp_path / "model.safetensors")
  (tmp_path / "config.json").write_text(json.dumps(j_get_model_card(MODEL)["synthetic_config"]))
  params = load_shard_params(tmp_path, cfg, Shard(MODEL, 0, n - 1, n), dtype=torch.float32)
  want = _np(jparams)
  for name, w in params["layers"].items():
    np.testing.assert_array_equal(w.numpy(), want["layers"][name], err_msg=name)
  np.testing.assert_array_equal(params["lm_head"].numpy(), want["lm_head"])
  out = tmp_path / "port" / "model.safetensors"
  save_shard_params(params, cfg, Shard(MODEL, 0, n - 1, n), out)
  assert (set(_read_header(out)[0]) == set(_read_header(tmp_path / "model.safetensors")[0]))
  again = load_shard_params(out.parent, cfg, Shard(MODEL, 0, n - 1, n), dtype=torch.float32)
  for name, w in again["layers"].items():
    torch.testing.assert_close(w, params["layers"][name], rtol=0, atol=0)


# ------------------------------------------------------------------ the engine

SHARD = Shard(MODEL, 0, 3, 4)
JSHARD = JShard(MODEL, 0, 3, 4)


@pytest.fixture()
def moe_engine_env(monkeypatch):
  """fp32 engines on the JAX engine's synthetic draw (PRNGKey(0)), carried across with
  params_from_jax; page 16 and a 512-token pool for the paged runs."""
  from xotorch_tpu_torch.inference.torch_engine import engine as engine_mod

  def init(cfg, n, first, last, seed=0, dtype=torch.float32, device="cpu", start_layer=0, **_):
    jcfg, _ = _cfgs()
    jp = j_transformer.init_random_params(jcfg, n, first, last, jax.random.PRNGKey(seed),
                                          dtype=jnp.float32, start_layer=start_layer)
    return params_from_jax(_np(jp), cfg, device=device, dtype=dtype)
  monkeypatch.setattr(engine_mod, "init_random_params", init)
  for name, value in (("XOT_DTYPE", "float32"), ("XOT_CACHE_LEN", "16"), ("XOT_KV_PAGE", "16"),
                      ("XOT_KV_POOL_TOKENS", "512"), ("XOT_PREFILL_CHUNK", "16")):
    monkeypatch.setenv(name, value)


async def _greedy_stream(engine, shard, rid, prompt, n=20):
  tok, _ = await engine.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
  out = [int(tok)]
  size = 2
  while len(out) < n:
    chunk = await engine.generate_chunk(rid, shard, out[-1], min(size, n - len(out)), temp=0.0,
                                        top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
    size *= 2
  return out[:n]


PROMPTS = {f"r{i}": _tokens(n, seed=60 + i) for i, n in enumerate((5, 40, 9))}


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_engine_greedy_streams_match_jax(paged, moe_engine_env, monkeypatch):
  """Three prompts (5, 40 and 9 tokens; 40 prefills in segments at 0, 16 and 32)
  decoded concurrently through the batcher (the routed gather at B up to 3): the port's
  streams are the JAX engine's, on stacked contiguous caches and on the page pool."""
  from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  jeng = JAXShardInferenceEngine(dtype="float32")
  want = {rid: await _greedy_stream(jeng, JSHARD, rid, p) for rid, p in PROMPTS.items()}
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  got = await asyncio.gather(*(_greedy_stream(eng, SHARD, rid, p) for rid, p in PROMPTS.items()))
  assert dict(zip(PROMPTS, got)) == want
  assert (eng._ctx.page_pool is not None) == (paged == "1")
  for e in (jeng, eng):
    e.executor.shutdown(wait=True)


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_speculative_verify_matches_jax(paged, moe_engine_env, monkeypatch):
  """verify_draft at T = 16 (the dense combine): a perfect draft, a wrong tail and a
  wrong draft accept what the JAX engine's verify accepts, and the tokens are the
  greedy stream's."""
  from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  prompt = _tokens(7, seed=77)
  jeng = JAXShardInferenceEngine(dtype="float32")
  ref = await _greedy_stream(jeng, JSHARD, "ref", prompt, 10)
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)

  async def rounds(e, shard):
    tok, _ = await e.infer_sample_tensor("spec", shard, prompt, temp=0.0, top_k=0)
    got = [int(tok)]
    outs = []
    for draft in (ref[1:4], [ref[5], (ref[6] + 1) % 250, (ref[6] + 2) % 250],
                  [(ref[7] + 9) % 250, 1, 2]):
      outs.append([int(t) for t in await e.verify_draft("spec", shard, got[-1], draft)])
      got.extend(outs[-1])
    return outs, got

  jout, _ = await rounds(jeng, JSHARD)
  out, got = await rounds(eng, SHARD)
  assert out == jout == [ref[1:5], ref[5:7], [ref[7]]]
  assert got == ref[:8]
  for e in (jeng, eng):
    e.executor.shutdown(wait=True)


async def test_engine_cost_model_matches_jax(moe_engine_env):
  """The engine's cost model for the MoE card (bound at load) books JAX's bytes and
  FLOPs: only the top-k experts' weights for a decode step and a prefill token."""
  from xotorch_tpu.inference.jax_engine.costmodel import CostModel as JCostModel
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  await eng.ensure_shard(SHARD)
  cm = eng._ctx.costmodel
  jcfg, _ = _cfgs()
  jcm = JCostModel(jcfg, 4, True, True, dtype_bytes=4)
  for depth in (0, 17, 300):
    assert cm.decode_flops_per_token(depth) == jcm.decode_flops_per_token(depth)
  for tokens, start in ((16, 0), (40, 16)):
    assert cm.prefill_flops(tokens, start) == jcm.prefill_flops(tokens, start)
  assert cm.n_params() == jcm.n_params()
  E, k = jcfg.num_experts, jcfg.num_experts_per_tok
  routed = sum(w.numel() for name, w in eng._ctx.params["layers"].items() if name.startswith("we_"))
  assert cm.decode_flops_per_token(0) < 2 * routed  # k of E experts' FLOPs, not all
  assert routed // E * k * 2 <= cm.decode_flops_per_token(0)
  eng.executor.shutdown(wait=True)


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_int8_kv_greedy_stream_matches_jax(paged, moe_engine_env, monkeypatch):
  """An int8 KV cache (K2q / K3q / K4q's plain versions) under MoE: a 30-token prompt
  (segments at 0 and 16) and 16 greedy tokens, the JAX engine's stream (its first
  segment through its flash kernel, XOT_FLASH_ATTENTION=1, which attends the fresh K/V
  as the port's K1 path does)."""
  from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  monkeypatch.setenv("XOT_KV_QUANT", "int8")
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  prompt = _tokens(30, seed=8)
  monkeypatch.setenv("XOT_FLASH_ATTENTION", "1")
  jeng = JAXShardInferenceEngine(dtype="float32")
  want = await _greedy_stream(jeng, JSHARD, "r", prompt, 16)
  monkeypatch.delenv("XOT_FLASH_ATTENTION")
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  assert eng.kv_quant == "int8"
  assert await _greedy_stream(eng, SHARD, "r", prompt, 16) == want
  for e in (jeng, eng):
    e.executor.shutdown(wait=True)


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_prefix_cache_warm_streams_match_jax(paged, moe_engine_env, monkeypatch):
  """The prefix cache under MoE (XOT_PREFIX_CACHE 2): a 48-token prompt cold, the same
  prompt again and a longer turn over it warm; each stream the JAX engine's, with JAX's
  hits and tokens saved."""
  from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  monkeypatch.setenv("XOT_PREFIX_CACHE", "2")
  prompt = _tokens(48, seed=9)
  longer = np.concatenate([prompt, _tokens(20, seed=10)], axis=1)
  jeng = JAXShardInferenceEngine(dtype="float32")
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  for i, p in enumerate((prompt, prompt, longer)):
    want = await _greedy_stream(jeng, JSHARD, f"r{i}", p, 8)
    assert await _greedy_stream(eng, SHARD, f"r{i}", p, 8) == want, i
    await jeng.clear_request(f"r{i}")
    await eng.clear_request(f"r{i}")
  assert eng._prefix_hits == jeng._prefix_hits == 2
  assert eng._prefix_tokens_saved == jeng._prefix_tokens_saved > 0
  for e in (jeng, eng):
    e.executor.shutdown(wait=True)
