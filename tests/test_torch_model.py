"""The port's model (xotorch_tpu_torch.models) against the JAX package's, on the CPU.

Both run synthetic-tiny on the JAX package's own random weights, carried across by
`params_from_jax`. Logits agree to 1e-4 absolute (fp32 on both sides, JAX's matmul
precision pinned to 'highest'; what remains is the order of fp32 sums over four
layers, on logits of magnitude ~0.1). Token streams must be identical: greedy
picks are argmaxes of those logits, and sampled picks use JAX's own Gumbel noise,
drawn from the same key splits as its `decode_chunk`.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xotorch_tpu.models import generate as j_generate
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.models.registry import get_model_card as j_get_model_card
from xotorch_tpu_torch.models import generate, transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision():
  with jax.default_matmul_precision("highest"):
    yield


def _cfgs():
  return (j_config_from_hf_dict(j_get_model_card(MODEL)["synthetic_config"]),
          config_from_hf_dict(get_model_card(MODEL)["synthetic_config"]))


def _jax_params(jcfg, start=0, n=None, first=True, last=True, dtype=jnp.float32):
  n = jcfg.num_layers if n is None else n
  return j_transformer.init_random_params(jcfg, n, first, last, jax.random.PRNGKey(0),
                                          dtype=dtype, start_layer=start)


def _numpy_tree(tree):
  return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _flat(v, f"{prefix}{k}/")
    else:
      yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips(dtype):
  jcfg, cfg = _cfgs()
  np_params = _numpy_tree(_jax_params(jcfg, dtype=getattr(jnp, dtype)))
  params = params_from_jax(np_params, cfg)
  want = dict(_flat(np_params))
  got = dict(_flat(params))
  assert sorted(got) == sorted(want)
  for name, arr in want.items():
    t = got[name]
    assert t.dtype == getattr(torch, dtype), name
    assert tuple(t.shape) == arr.shape, name
    if dtype == "bfloat16":
      back = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    else:
      back = t.numpy()
    np.testing.assert_array_equal(back, arr, err_msg=name)
  # A dtype cast on the way across: bf16 arrays into fp32 tensors, exactly.
  if dtype == "bfloat16":
    wide = params_from_jax(np_params, cfg, dtype=torch.float32)
    for name, arr in want.items():
      np.testing.assert_array_equal(dict(_flat(wide))[name].numpy(), arr.astype(np.float32))


def _prompt(T=11, seed=0, vocab=256):
  return np.random.default_rng(seed).integers(3, vocab, size=(1, T)).astype(np.int32)


def test_forward_shard_logits_match_jax_prefill_then_decode():
  jcfg, cfg = _cfgs()
  jp = _jax_params(jcfg)
  params = params_from_jax(_numpy_tree(jp), cfg)
  L, S = cfg.num_layers, 32
  jcache = j_transformer.init_kv_cache(jcfg, L, 1, S, jnp.float32)
  cache = transformer.init_kv_cache(cfg, L, 1, S, torch.float32)
  toks = _prompt()
  jl, jcache = j_transformer.forward_shard(jp, jnp.asarray(toks), jcache, jnp.int32(0), jcfg,
                                           True, True)
  tl, cache = transformer.forward_shard(params, torch.from_numpy(toks).long(), cache, 0, cfg,
                                        True, True)
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
  pos = toks.shape[1]
  for step in range(5):
    nxt = np.array([[int(np.argmax(np.asarray(jl)[0, -1]))]], np.int32)
    jl, jcache = j_transformer.forward_shard(jp, jnp.asarray(nxt), jcache, jnp.int32(pos), jcfg,
                                             True, True)
    tl, cache = transformer.forward_shard(params, torch.from_numpy(nxt).long(), cache, pos, cfg,
                                          True, True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {step}")
    pos += 1
  np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL)
  np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]), atol=ATOL)


def test_split_shard_equals_full_model():
  jcfg, cfg = _cfgs()
  L, half = cfg.num_layers, cfg.num_layers // 2
  full = params_from_jax(_numpy_tree(_jax_params(jcfg)), cfg)
  first = params_from_jax(_numpy_tree(_jax_params(jcfg, 0, half, True, False)), cfg)
  second = params_from_jax(_numpy_tree(_jax_params(jcfg, half, L - half, False, True)), cfg)
  x = torch.from_numpy(_prompt(9, seed=1)).long()
  want, _ = transformer.forward_shard(full, x, transformer.init_kv_cache(cfg, L, 1, 16, torch.float32),
                                      0, cfg, True, True)
  h, _ = transformer.forward_shard(first, x, transformer.init_kv_cache(cfg, half, 1, 16, torch.float32),
                                   0, cfg, True, False)
  assert h.shape == (1, 9, cfg.hidden_size)
  got, _ = transformer.forward_shard(second, h,
                                     transformer.init_kv_cache(cfg, L - half, 1, 16, torch.float32),
                                     0, cfg, False, True, start_layer=half)
  np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_random_init_is_shard_consistent():
  """The port's own seeded init: a shard's layers equal the same layers of a
  full-model init, as the JAX package's key folding guarantees."""
  _, cfg = _cfgs()
  full = transformer.init_random_params(cfg, 4, True, True, seed=3)
  tail = transformer.init_random_params(cfg, 2, False, True, seed=3, start_layer=2)
  for name, w in tail["layers"].items():
    torch.testing.assert_close(w, full["layers"][name][2:], rtol=0, atol=0)
  torch.testing.assert_close(tail["lm_head"], full["lm_head"], rtol=0, atol=0)


def _moe_init():
  base = dict(get_model_card(MODEL)["synthetic_config"])
  cfg = config_from_hf_dict({**base, "model_type": "qwen3_moe", "num_experts": 4,
                             "num_experts_per_tok": 2})
  transformer.init_random_params(cfg, 1, True, True)


def _llava_config():
  base = dict(get_model_card(MODEL)["synthetic_config"])
  config_from_hf_dict({"model_type": "llava", "text_config": base,
                       "vision_config": {"model_type": "clip_vision_model"}})


def _lora_forward():
  _, cfg = _cfgs()
  params = transformer.init_random_params(cfg, 1, True, True)
  params["layers"]["lora_wq_a"] = torch.zeros(1, cfg.hidden_size, 4)
  cache = transformer.init_kv_cache(cfg, 1, 1, 8, torch.float32)
  transformer.forward_shard(params, torch.ones(1, 2, dtype=torch.int64), cache, 0, cfg, True, True)


# gemma2 and qwen3 (qk-norm) are served now (tests/test_torch_families.py); what the
# port still refuses: MoE, multimodal configs and LoRA slots.
@pytest.mark.parametrize("unsupported", [_moe_init, _llava_config, _lora_forward],
                         ids=["moe", "llava-multimodal", "lora-slot"])
def test_unported_config_features_raise(unsupported):
  with pytest.raises(NotImplementedError):
    unsupported()


def _bucketed(toks, bucket):
  out = np.zeros((1, bucket), np.int32)
  out[:, :toks.shape[1]] = toks
  return out


@pytest.mark.parametrize("temp,top_k,top_p", [(0.0, 0, 0.0), (0.9, 20, 0.0), (1.1, 0, 0.8)])
def test_forward_sample_and_decode_chunk_stream_matches_jax(temp, top_k, top_p):
  """Prefill a bucket-padded prompt and sample (forward_sample), then decode a
  chunk: the port's stream equals the JAX functions' token for token."""
  jcfg, cfg = _cfgs()
  jp = _jax_params(jcfg)
  params = params_from_jax(_numpy_tree(jp), cfg)
  L, S, K = cfg.num_layers, 64, 12
  toks = _prompt(13, seed=2)
  x = _bucketed(toks, 16)
  key = jax.random.PRNGKey(11)
  jtok, jcache = j_generate.forward_sample(
    jp, jnp.asarray(x), j_transformer.init_kv_cache(jcfg, L, 1, S, jnp.float32), jnp.int32(0),
    jnp.int32(12), key, jcfg, True, temp, top_k, top_p)
  noise0 = np.asarray(jax.random.gumbel(key, (1, cfg.vocab_size), jnp.float32))
  tok, cache = generate.forward_sample(
    params, torch.from_numpy(x).long(), transformer.init_kv_cache(cfg, L, 1, S, torch.float32), 0,
    12, cfg, True, temp, top_k, top_p, gumbel=torch.from_numpy(noise0))
  assert int(tok[0]) == int(jtok[0])

  dkey = jax.random.PRNGKey(12)
  jtoks, _ = j_generate.decode_chunk(jp, jnp.asarray(jtok)[:, None], jcache, jnp.int32(13), dkey,
                                     jcfg, K, temp, top_k, top_p)
  noise, k = [], dkey
  for _ in range(K):  # the key splits of JAX's decode_chunk scan
    k, sub = jax.random.split(k)
    noise.append(np.asarray(jax.random.gumbel(sub, (1, cfg.vocab_size), jnp.float32)))
  toks_t, _ = generate.decode_chunk(params, tok[:, None], cache, 13, cfg, K, temp, top_k, top_p,
                                    gumbel=torch.from_numpy(np.stack(noise)))
  np.testing.assert_array_equal(toks_t.numpy(), np.asarray(jtoks))


def test_decode_chunk_penalties_and_logprobs_match_jax():
  """Counts ride the loop (token i + 1 sees token i's penalty) and logprobs stack
  per step, as in the JAX scan."""
  jcfg, cfg = _cfgs()
  jp = _jax_params(jcfg)
  params = params_from_jax(_numpy_tree(jp), cfg)
  L, S, K = cfg.num_layers, 32, 6
  toks = _prompt(8, seed=4)
  jcache = j_transformer.init_kv_cache(jcfg, L, 1, S, jnp.float32)
  cache = transformer.init_kv_cache(cfg, L, 1, S, torch.float32)
  _, jcache = j_transformer.forward_shard(jp, jnp.asarray(toks[:, :-1]), jcache, jnp.int32(0),
                                          jcfg, True, False)
  _, cache = transformer.forward_shard(params, torch.from_numpy(toks[:, :-1]).long(), cache, 0,
                                       cfg, True, False)
  counts = np.zeros((1, cfg.vocab_size), np.int32)
  bias = np.zeros((1, cfg.vocab_size), np.float32)
  bias[0, 7] = 0.5
  last = toks[:, -1:]
  jtoks, _, jcounts, (jlp, jids, jlps) = j_generate.decode_chunk(
    jp, jnp.asarray(last), jcache, jnp.int32(7), jax.random.PRNGKey(0), jcfg, K, 0.0, 0,
    bias=jnp.asarray(bias), counts=jnp.asarray(counts), presence=0.5, frequency=2.0, top_lp=3)
  ttoks, _, tcounts, (tlp, tids, tlps) = generate.decode_chunk(
    params, torch.from_numpy(last).long(), cache, 7, cfg, K, 0.0, 0, bias=torch.from_numpy(bias),
    counts=torch.from_numpy(counts), presence=0.5, frequency=2.0, top_lp=3)
  np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
  np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
  np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
  np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=ATOL)
  np.testing.assert_allclose(tlps.numpy(), np.asarray(jlps), atol=ATOL)


def test_cached_segment_matches_one_prefill():
  """A prompt prefilled in two segments (the second at pos > 0, the cached-kernel
  path) gives the logits of one whole prefill."""
  _, cfg = _cfgs()
  params = transformer.init_random_params(cfg, cfg.num_layers, True, True, seed=1)
  toks = torch.from_numpy(_prompt(24, seed=5)).long()
  L = cfg.num_layers
  whole, _ = transformer.forward_shard(params, toks, transformer.init_kv_cache(cfg, L, 1, 32, torch.float32),
                                       0, cfg, True, True, use_flash=True)
  cache = transformer.init_kv_cache(cfg, L, 1, 32, torch.float32)
  _, cache = transformer.forward_shard(params, toks[:, :16], cache, 0, cfg, True, True, use_flash=True)
  tail, _ = transformer.forward_shard(params, toks[:, 16:], cache, 16, cfg, True, True,
                                      use_flash_decode=True)
  np.testing.assert_allclose(tail.numpy(), whole[:, 16:].numpy(), atol=1e-5)
