"""The port's int8 KV cache (`kv_quant`, K2q, K3q, K4q) against the JAX package's, on
the CPU.

- `_quantize_kv` gives byte-identical codes and scales; `init_kv_cache` and `PagePool`
  build the same four leaves; `commit_pages`, `gather_pages` and `migrate_pages` carry
  the scale pages as JAX's do.
- The kernels' plain versions (what the wrappers run on CPU tensors, and what
  chip_smoke.py holds the CUDA kernels against) agree with JAX's Pallas kernels run
  in interpret mode with the int8 operands: fp32 on both sides with JAX's matmul
  precision pinned to 'highest', so they differ only by the order of fp32 sums
  (atol 1e-5 on outputs of magnitude ~1).
- `forward_shard` logits with an int8 cache match JAX's at 1e-4 (fp32): contiguous,
  per-row positions, and the page arena. The two packages'
  fp32 K/V differ in the last bit (XLA and torch sum in another order), so a value
  within an ulp of a half-step of the int8 grid can take the neighbouring code on
  one side, moving the logits by ~1e-4; the token seeds here leave every code equal
  (the tests assert it), so 1e-4 holds the kernels' function.
- The engines, on the JAX engine's weights (fp32): `infer_tensor` logits over two
  segments within 1e-4 of the JAX engine's and more than 10x that away from the
  unquantized cache's; the resident int8 codes equal JAX's byte for byte; greedy
  streams identical, contiguous and paged, batched and one at a time.
- The CUDA wrappers refuse mismatched int8 operands (checked on meta tensors).
"""
import asyncio

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_weights  # noqa: F401 (fixture)
from xotorch_tpu.inference.jax_engine import paged_cache as j_paged_cache
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import generate as j_generate
from xotorch_tpu.models import quantize as jq
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.ops import flash_decode as j_flash_decode
from xotorch_tpu.ops import paged_attention as j_paged
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine import paged_cache
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import params_from_jax
from xotorch_tpu_torch.ops import flash_decode, paged_attention
from xotorch_tpu_torch.utils import knobs

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
# The narrow tied llama of test_torch_quantize.py: head_dim 64, 4 q / 2 kv heads.
NARROW = {"model_type": "llama", "hidden_size": 256, "intermediate_size": 512,
          "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
          "vocab_size": 256, "max_position_embeddings": 2048, "rope_theta": 10000.0,
          "tie_word_embeddings": True, "eos_token_id": 2}
ATOL = 1e-5
KNOB_ENV = ("XOT_KV_QUANT", "XOT_QUANTIZE", "XOT_PAGED_KV", "XOT_RAGGED_PREFILL",
            "XOT_FLASH_ATTENTION", "XOT_FLASH_DECODE", "XOT_PAGED_KERNEL")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
  for name in KNOB_ENV:
    monkeypatch.delenv(name, raising=False)
  with jax.default_matmul_precision("highest"):
    yield


def _np(x):
  return np.asarray(x)


def _same(got: torch.Tensor, want, name=""):
  """Equal dtype name, shape and bytes."""
  want = _np(want)
  if want.dtype == ml_dtypes.bfloat16:
    assert got.dtype == torch.bfloat16, name
    got_np = got.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
  else:
    got_np = got.numpy()
  assert got_np.dtype == want.dtype, (name, got_np.dtype, want.dtype)
  np.testing.assert_array_equal(got_np, want, err_msg=name)


def _cfgs(cfg_dict=None):
  d = cfg_dict or get_model_card(MODEL)["synthetic_config"]
  return j_config_from_hf_dict(d), config_from_hf_dict(d)


def _quantized(rng, shape):
  """Random K/V of `shape` [..., D] quantized per (..., head) with the JAX package's
  recipe: (int8 codes, fp32 scales [...]) as numpy. Each (position, head) row is
  scaled by its own 2^u, u uniform in [-6, 0], so the scales spread over 64x and a
  scale read from the wrong row or head moves the output."""
  x = rng.standard_normal(shape).astype(np.float32)
  x *= np.exp2(-6.0 * rng.random(shape[:-1] + (1,))).astype(np.float32)
  qx, sx = jq.quantize_tensor(jnp.asarray(x), axis=-1, scale_dtype=jnp.float32)
  return np.array(qx), np.array(sx)


# ------------------------------------------------------------------ layouts


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_byte_identical(scale_dtype):
  x = np.random.default_rng(1).standard_normal((2, 7, 3, 16)).astype(np.float32)
  x[1, 2, 0] = 0.0  # an all-zero (position, head) row takes the 1e-12 floor
  x[0, 3, 1, 5] = 40.0  # one outlier sets its row's scale
  jqk, jsk = j_transformer._quantize_kv(jnp.asarray(x), getattr(jnp, scale_dtype))
  tqk, tsk = transformer._quantize_kv(torch.from_numpy(x), getattr(torch, scale_dtype))
  assert tuple(tqk.shape) == x.shape and tuple(tsk.shape) == x.shape[:-1]
  _same(tqk, jqk, "codes")
  _same(tsk, jsk, "scales")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_kv_cache_and_page_pool_leaves_match_jax(dtype):
  jcfg, cfg = _cfgs()
  jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

  def leaves(tree):
    return {n: (tuple(a.shape), str(a.dtype).replace("torch.", "")) for n, a in tree.items()}

  for kv_quant in (True, False):
    want = leaves(j_transformer.init_kv_cache(jcfg, 3, 2, 40, jdt, kv_quant=kv_quant))
    got = leaves(transformer.init_kv_cache(cfg, 3, 2, 40, tdt, kv_quant=kv_quant))
    assert got == want, kv_quant
    jpool = j_paged_cache.PagePool(jcfg, 3, 9, 16, jdt, kv_quant=kv_quant)
    pool = paged_cache.PagePool(cfg, 3, 9, 16, tdt, kv_quant=kv_quant)
    assert leaves(pool.arena) == leaves(jpool.arena), kv_quant
  assert sorted(got) == ["k", "v"] and sorted(want) == ["k", "v"]


# ------------------------------------------------------- kernels' plain versions


# At S = 256 K2q's decode kernel cuts the cache into four 64-key splits (B <= 4, Hkv 2,
# a 132-SM card: flash_decode.split_plan).
@pytest.mark.parametrize("T,starts,window,softcap,S", [
  pytest.param(1, [37], 0, 0.0, 48, id="1-starts0-0-0.0"),  # a decode step
  pytest.param(6, [20], 0, 0.0, 48, id="6-starts1-0-0.0"),  # a segment at q_start > 0
  pytest.param(1, [0, 17, 41], 0, 0.0, 48, id="1-starts2-0-0.0"),  # per-row q_start
  pytest.param(5, [3, 30], 0, 0.0, 48, id="5-starts3-0-0.0"),  # per-row segments
  pytest.param(4, [12, 40], 9, 30.0, 48, id="4-starts4-9-30.0"),  # window and softcap
  # a split's last key, the next split's first and second, and S - 1
  pytest.param(1, [63, 64, 65, 255], 0, 0.0, 256, id="split-edges"),
  # windows that leave whole splits below them empty
  pytest.param(1, [127, 128, 200, 255], 20, 30.0, 256, id="windows-empty-splits"),
  pytest.param(3, [61, 190], 0, 0.0, 256, id="segments-across-edges"),
])
def test_flash_cached_int8_ref_matches_jax_kernel(T, starts, window, softcap, S):
  rng = np.random.default_rng(2)
  B, Hq, Hkv, D = len(starts), 4, 2, 16
  q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
  kq, ks = _quantized(rng, (B, S, Hkv, D))
  vq, vs = _quantized(rng, (B, S, Hkv, D))
  q_start = np.array(starts, np.int32)
  want = j_flash_decode.flash_cached_attention(
    jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(q_start), interpret=True,
    window=jnp.int32(window) if window else None, softcap=softcap, k_scale=jnp.asarray(ks),
    v_scale=jnp.asarray(vs))
  args = [torch.from_numpy(a) for a in (q, kq, vq, q_start)]
  got = flash_decode.flash_cached_attention(*args, window=window, softcap=softcap,
                                            k_scale=torch.from_numpy(ks),
                                            v_scale=torch.from_numpy(vs))
  np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
  # The K2q wrapper itself, and the plain version over the dequantized cache.
  direct = flash_decode.flash_cached_attention_int8(args[0], args[1], args[2], torch.from_numpy(ks),
                                                    torch.from_numpy(vs), args[3], window=window,
                                                    softcap=softcap)
  assert torch.equal(direct, got)
  k, v = flash_decode.dequantize_kv(args[1], args[2], torch.from_numpy(ks), torch.from_numpy(vs),
                                    torch.float32)
  dense = flash_decode.flash_cached_attention(args[0], k, v, args[3], window=window, softcap=softcap)
  assert torch.equal(dense, got)


def _arena_int8(rng, P, page, Hkv, D):
  # Page 0 (scratch) holds garbage too: every read of it must be masked.
  kq, ks = _quantized(rng, (P, page, Hkv, D))
  vq, vs = _quantized(rng, (P, page, Hkv, D))
  return kq, vq, ks, vs


def _shuffled_table(rng, P, lengths, page, maxp):
  """Each row's pages, distinct and shuffled, padded with the scratch page 0."""
  ids = rng.permutation(np.arange(1, P))
  table = np.zeros((len(lengths), maxp), np.int32)
  used = 0
  for b, n in enumerate(lengths):
    k = -(-n // page)
    table[b, :k] = ids[used:used + k]
    used += k
  return table


# A table of 16 pages of 16 (256 positions) at B = 3, Hkv 2: K3q's four 64-key splits.
@pytest.mark.parametrize("window,softcap,scale,lengths,maxp", [
  pytest.param(0, 0.0, None, [1, 37, 120], 8, id="0-0.0-None"),
  pytest.param(20, 0.0, None, [1, 37, 120], 8, id="20-0.0-None"),
  pytest.param(9, 20.0, 0.3, [1, 37, 120], 8, id="9-20.0-0.3"),
  pytest.param(0, 0.0, None, [64, 65, 256], 16, id="split-edges"),
  pytest.param(20, 0.0, None, [200, 129, 256], 16, id="windows-empty-splits"),
])
def test_paged_decode_int8_ref_matches_jax(window, softcap, scale, lengths, maxp):
  rng = np.random.default_rng(11)
  B, Hq, Hkv, D, page = 3, 4, 2, 16, 16
  P = 24 if maxp == 8 else 3 * maxp + 2
  lengths = np.array(lengths, np.int32)
  kq, vq, ks, vs = _arena_int8(rng, P, page, Hkv, D)
  table = _shuffled_table(rng, P, lengths, page, maxp)
  q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
  win = jnp.int32(window) if window else None
  jargs = [jnp.asarray(a) for a in (q, kq, vq, table, lengths)]
  jscales = dict(k_scale_pages=jnp.asarray(ks), v_scale_pages=jnp.asarray(vs))
  want_kernel = j_paged.paged_decode_attention(*jargs, softcap=softcap, scale=scale,
                                               use_kernel=True, interpret=True, window=win,
                                               **jscales)
  want_xla = j_paged.paged_decode_attention(*jargs, softcap=softcap, scale=scale, window=win,
                                            **jscales)
  got = paged_attention.paged_decode_attention(
    *(torch.from_numpy(a) for a in (q, kq, vq, table, lengths)), window=window, softcap=softcap,
    scale=scale, k_scale_pages=torch.from_numpy(ks), v_scale_pages=torch.from_numpy(vs))
  np.testing.assert_allclose(got.numpy(), _np(want_kernel), atol=ATOL)
  np.testing.assert_allclose(got.numpy(), _np(want_xla), atol=ATOL)


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("T,valid,window,softcap", [
  (16, [16, 16], 0, 0.0),  # a first segment, from position 0
  (12, [40, 100], 0, 0.0),  # segments over a resident prefix, ragged
  (12, [40, 100], 10, 25.0),  # ... under a window and a softcap
])
def test_paged_prefill_int8_ref_matches_jax(T, valid, window, softcap, D):
  rng = np.random.default_rng(12)
  Hq, Hkv, page, P, maxp = 4, 2, 16, 20, 8
  lengths = np.array(valid, np.int32)
  kq, vq, ks, vs = _arena_int8(rng, P, page, Hkv, D)
  table = _shuffled_table(rng, P, lengths, page, maxp)
  q = rng.standard_normal((len(valid), T, Hq, D)).astype(np.float32)
  q_pos = (lengths[:, None] - T + np.arange(T)[None, :]).astype(np.int32)
  win = jnp.int32(window) if window else None
  jargs = [jnp.asarray(a) for a in (q, kq, vq, table, q_pos, lengths)]
  jscales = dict(k_scale_pages=jnp.asarray(ks), v_scale_pages=jnp.asarray(vs))
  want_kernel = j_paged.paged_prefill_attention(*jargs, softcap=softcap, use_kernel=True,
                                                interpret=True, window=win, **jscales)
  want_xla = j_paged.paged_prefill_attention(*jargs, softcap=softcap, window=win, **jscales)
  targs = [torch.from_numpy(a) for a in (q, kq, vq, table, lengths)]
  tscales = torch.from_numpy(ks), torch.from_numpy(vs)
  got = paged_attention.paged_prefill_attention(*targs, window=window, softcap=softcap,
                                                k_scale_pages=tscales[0], v_scale_pages=tscales[1])
  np.testing.assert_allclose(got.numpy(), _np(want_kernel), atol=ATOL)
  np.testing.assert_allclose(got.numpy(), _np(want_xla), atol=ATOL)
  # The K4q wrapper itself, and K4's function over the dequantized arena.
  direct = paged_attention.paged_prefill_attention_int8(*targs[:3], *tscales, *targs[3:],
                                                        window=window, softcap=softcap)
  assert torch.equal(direct, got)
  k, v = flash_decode.dequantize_kv(targs[1], targs[2], *tscales, torch.float32)
  dense = paged_attention.paged_prefill_attention(targs[0], k, v, *targs[3:], window=window,
                                                  softcap=softcap)
  assert torch.equal(dense, got)


def test_gather_paged_view_dequantizes_as_jax():
  rng = np.random.default_rng(13)
  kq, vq, ks, vs = _arena_int8(rng, 6, 16, 2, 16)
  table = np.array([[3, 1, 0], [5, 2, 4]], np.int32)
  q = jnp.zeros((2, 1, 4, 16), jnp.float32)
  jk, jv = j_paged._gather_paged_view(q, *(jnp.asarray(a) for a in (kq, vq, table, ks, vs)))
  k, v = paged_attention.gather_paged_view(*(torch.from_numpy(a) for a in (kq, vq, table, ks, vs)),
                                           dtype=torch.float32)
  _same(k, jk, "k")
  _same(v, jv, "v")


def test_commit_gather_migrate_int8_match_jax():
  jcfg, cfg = _cfgs()
  rng = np.random.default_rng(14)
  L, page, P = 2, 16, 10
  jpool = j_paged_cache.PagePool(jcfg, L, P, page, jnp.float32, kv_quant=True)
  pool = paged_cache.PagePool(cfg, L, P, page, torch.float32, kv_quant=True)
  kq, ks = _quantized(rng, (L, 1, 40, cfg.num_kv_heads, cfg.head_dim))
  vq, vs = _quantized(rng, (L, 1, 40, cfg.num_kv_heads, cfg.head_dim))
  cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
  ids = [7, 2, 5]  # 40 tokens -> 3 pages; the third is partly past the buffer
  jpool.arena = j_paged_cache.commit_pages(jpool.arena, {n: jnp.asarray(a) for n, a in cache.items()},
                                           np.asarray(ids, np.int32), 0)
  paged_cache.commit_pages(pool.arena, {n: torch.from_numpy(a) for n, a in cache.items()}, ids, 0)
  assert sorted(pool.arena) == ["k", "k_scale", "v", "v_scale"]
  for n in pool.arena:
    _same(pool.arena[n], jpool.arena[n], n)
  back = paged_cache.gather_pages(pool.arena, ids[:2])
  jback = j_paged_cache.gather_pages(jpool.arena, np.asarray(ids[:2], np.int32))
  for n in back:
    _same(back[n], jback[n], n)
    np.testing.assert_array_equal(back[n].numpy(), cache[n][:, :, :32])
  jpool.arena = j_paged_cache.migrate_pages(jpool.arena, [7, 5], [1, 3])
  paged_cache.migrate_pages(pool.arena, [7, 5], [1, 3])
  for n in pool.arena:
    _same(pool.arena[n], jpool.arena[n], n)
  np.testing.assert_array_equal(pool.arena["k_scale"][:, 1].numpy(), ks[:, 0, :16])


# ------------------------------------------------------------------ the model


def _params(cfg_dict=None):
  jcfg, cfg = _cfgs(cfg_dict)
  jp = j_transformer.init_random_params(jcfg, jcfg.num_layers, True, True, jax.random.PRNGKey(0),
                                        dtype=jnp.float32)
  return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _toks(cfg, shape, seed):
  return np.random.default_rng(seed).integers(3, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel-flags"])
@pytest.mark.parametrize("cfg_dict", [None, NARROW], ids=["tiny", "narrow"])
def test_forward_shard_int8_cache_logits_match_jax(cfg_dict, kernels):
  """A 2-segment prefill (9 tokens from 0, 6 at pos 9) then 3 decode steps on an int8
  cache. `kernel-flags` sets use_flash / use_flash_decode on both sides: JAX's Pallas
  K1 and K2q in interpret mode against the port's K1 and K2q wrappers (plain
  versions on the CPU)."""
  jcfg, cfg, jp, params = _params(cfg_dict)
  L, S = cfg.num_layers, 32
  jcache = j_transformer.init_kv_cache(jcfg, L, 1, S, jnp.float32, kv_quant=True)
  cache = transformer.init_kv_cache(cfg, L, 1, S, torch.float32, kv_quant=True)
  segs = [_toks(cfg, (1, 9), 4), _toks(cfg, (1, 6), 5)]
  pos = 0
  for step in range(5):
    toks = segs[step] if step < 2 else np.array([[nxt]], np.int32)
    flags = dict(use_flash=kernels and pos == 0, use_flash_decode=kernels and pos > 0)
    jl, jcache = j_transformer.forward_shard(jp, jnp.asarray(toks), jcache, jnp.int32(pos), jcfg,
                                             True, True, **flags)
    tl, cache = transformer.forward_shard(params, torch.from_numpy(toks).long(), cache, pos, cfg,
                                          True, True, **flags)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, err_msg=f"step {step}")
    pos += toks.shape[1]
    nxt = int(np.argmax(_np(jl)[0, -1]))
  for n in ("k", "v"):
    np.testing.assert_array_equal(cache[n][:, :, :pos].numpy(), _np(jcache[n])[:, :, :pos])
  np.testing.assert_allclose(cache["k_scale"][:, :, :pos].numpy(), _np(jcache["k_scale"])[:, :, :pos],
                             rtol=1e-5)


def test_forward_shard_int8_cache_per_row_positions_match_jax():
  """B=2 rows on one int8 cache at their own depths ([B] start_pos): an 8-token
  prefill, then 3 decode steps with row 1 stepping back to position 5."""
  jcfg, cfg, jp, params = _params()
  L, S = cfg.num_layers, 32
  jcache = j_transformer.init_kv_cache(jcfg, L, 2, S, jnp.float32, kv_quant=True)
  cache = transformer.init_kv_cache(cfg, L, 2, S, torch.float32, kv_quant=True)
  toks = _toks(cfg, (2, 8), 7)
  jl, jcache = j_transformer.forward_shard(jp, jnp.asarray(toks), jcache, jnp.int32(0), jcfg, True,
                                           True)
  tl, cache = transformer.forward_shard(params, torch.from_numpy(toks).long(), cache, 0, cfg, True,
                                        True)
  np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
  pos = np.array([8, 5], np.int32)
  for i in range(3):
    step = np.argmax(_np(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    jl, jcache = j_transformer.forward_shard(jp, jnp.asarray(step), jcache, jnp.asarray(pos + i),
                                             jcfg, True, True, use_flash_decode=True)
    tl, cache = transformer.forward_shard(params, torch.from_numpy(step).long(), cache,
                                          torch.from_numpy(pos + i), cfg, True, True,
                                          use_flash_decode=True)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, err_msg=f"step {i}")
  for n in ("k", "v"):
    np.testing.assert_array_equal(cache[n][:, :, :8].numpy(), _np(jcache[n])[:, :, :8])


@pytest.mark.parametrize("cfg_dict", [None, NARROW], ids=["tiny", "narrow"])
def test_forward_paged_int8_arena_matches_jax(cfg_dict):
  """Three requests prefilled into one int8 arena through their own shuffled page
  tables (one paged segment each, K4q's function), then decoded together, B=3 at
  per-row positions with one pad row (K3q's): the logits of every segment equal JAX's
  forward_paged, the greedy tokens JAX's decode_chunk_paged, and the written pages
  (codes and scales) JAX's."""
  jcfg, cfg, jp, params = _params(cfg_dict)
  rng = np.random.default_rng(15)
  L, page, P, maxp, K = cfg.num_layers, 16, 24, 4, 6
  prompts = [_toks(cfg, (1, n), 20 + n) for n in (5, 20, 37)]
  table = _shuffled_table(rng, P, [len(p[0]) + K for p in prompts], page, maxp)
  jpool = j_paged_cache.PagePool(jcfg, L, P, page, jnp.float32, kv_quant=True)
  pool = paged_cache.PagePool(cfg, L, P, page, torch.float32, kv_quant=True)
  jarena, arena = jpool.arena, pool.arena
  last = []
  for b, toks in enumerate(prompts):
    jl, jarena = j_generate.forward_paged(jp, jnp.asarray(toks), jarena,
                                          jnp.asarray(table[b:b + 1]), jnp.int32(0), jcfg,
                                          use_kernel=True)
    tl, _ = transformer.forward_shard(params, torch.from_numpy(toks).long(), arena, 0, cfg, True,
                                      True, page_table=torch.from_numpy(table[b:b + 1]))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
    last.append(int(np.argmax(_np(jl)[0, -1])))
  pos = np.array([len(p[0]) for p in prompts], np.int32)
  jtoks, jarena = j_generate.decode_chunk_paged(
    jp, jarena, jnp.asarray(table), jnp.asarray(np.array(last, np.int32)[:, None]), jnp.asarray(pos),
    jax.random.PRNGKey(0), jcfg, K, jnp.zeros(3, jnp.float32), 0, pad_rows=1, use_kernel=True)
  from xotorch_tpu_torch.models import generate
  toks, _ = generate.decode_chunk_paged(
    params, arena, torch.from_numpy(table), torch.tensor(last)[:, None], torch.from_numpy(pos), cfg,
    K, torch.zeros(3), 0, pad_rows=1)
  np.testing.assert_array_equal(toks.numpy(), _np(jtoks))
  real = np.unique(table[table > 0])  # the scratch page holds pad-row garbage on both sides
  for n in ("k", "v"):
    np.testing.assert_array_equal(arena[n].numpy()[:, real], _np(jarena[n])[:, real])
    np.testing.assert_allclose(arena[n + "_scale"].numpy()[:, real],
                               _np(jarena[n + "_scale"])[:, real], rtol=1e-5)


def test_grow_cache_and_batched_stack_carry_the_scales(monkeypatch):
  """`_grow_cache` and `decode_chunk_batched` keep all four leaves: a grown int8
  cache holds the same codes and scales, and the batched step splits back caches
  with scales of the right shape and dtype."""
  from xotorch_tpu_torch.inference.torch_engine.engine import _RequestState
  from xotorch_tpu_torch.models import generate
  _, cfg, _, params = _params()
  cache = transformer.init_kv_cache(cfg, cfg.num_layers, 1, 16, torch.float32, kv_quant=True)
  transformer.forward_shard(params, torch.from_numpy(_toks(cfg, (1, 10), 7)).long(), cache, 0, cfg,
                            True, True)
  eng = TorchShardInferenceEngine(device="cpu", dtype="float32", seed=0)
  state = _RequestState(cache=cache, pos=10, last_used=0.0)
  eng._grow_cache(type("Ctx", (), {"max_cache_len": 64})(), state, 20)
  eng.executor.shutdown(wait=True)
  assert sorted(state.cache) == ["k", "k_scale", "v", "v_scale"]
  assert state.cache["k_scale"].shape == (cfg.num_layers, 1, 32, cfg.num_kv_heads)
  for n in cache:
    assert torch.equal(state.cache[n][:, :, :16], cache[n]) and not state.cache[n][:, :, 16:].any()
  _, split = generate.decode_chunk_batched(
    params, [state.cache, state.cache], torch.tensor([[5], [6]]), torch.tensor([10, 10]), cfg, 2,
    torch.zeros(2), 0, pad_rows=2)
  for c in split:
    assert {n: (tuple(t.shape), t.dtype) for n, t in c.items()} == {
      n: (tuple(t.shape), t.dtype) for n, t in state.cache.items()}
    assert c["k"][:, :, 10:12].any() and c["k_scale"][:, :, 10:12].all()


# ---------------------------------------------------------------- the engines


async def _two_segments(engine, shard, first, second):
  a, _ = await engine.infer_tensor("r", shard, first)
  b, _ = await engine.infer_tensor("r", shard, second)
  return a, b


async def test_engine_int8_logits_match_jax_and_move_off_the_plain_cache(jax_weights, monkeypatch):
  """A 7-token prompt, then a 5-token segment. The JAX engine runs its first segment
  through the flash kernel (XOT_FLASH_ATTENTION=1), which attends the fresh K/V as
  the port's K1 path does; the second reads the int8 cache on both sides."""
  monkeypatch.setenv("XOT_DTYPE", "float32")
  rng = np.random.default_rng(3)
  first, second = rng.integers(3, 256, size=(1, 7)), rng.integers(3, 256, size=(1, 5))
  got = {}
  for kv in ("int8", None):
    monkeypatch.setenv("XOT_FLASH_ATTENTION", "1")
    jeng = JAXShardInferenceEngine(dtype="float32", kv_quant=kv)
    want = await _two_segments(jeng, JShard(MODEL, 0, 3, 4), first, second)
    monkeypatch.delenv("XOT_FLASH_ATTENTION")
    eng = TorchShardInferenceEngine(device="cpu", seed=0, kv_quant=kv)
    got[kv] = await _two_segments(eng, Shard(MODEL, 0, 3, 4), first, second)
    for g, w in zip(got[kv], want):
      np.testing.assert_allclose(g, w, atol=1e-4, err_msg=str(kv))
    if kv:
      state, jstate = eng._ctx.states["r"], jeng.states["r"]
      assert state.pos == jstate.pos == 12
      assert sorted(state.cache) == sorted(jstate.cache) == ["k", "k_scale", "v", "v_scale"]
      for n in ("k", "v"):
        _same(state.cache[n][:, :, :12], _np(jstate.cache[n])[:, :, :12], n)
      for n in ("k_scale", "v_scale"):
        # fp32 scales are max|x| / 127 of K/V that XLA and torch sum in another order.
        np.testing.assert_allclose(state.cache[n][:, :, :12].numpy(),
                                   _np(jstate.cache[n])[:, :, :12], rtol=1e-6, atol=0)
    for e in (jeng, eng):
      e.executor.shutdown(wait=True)
  # The first segment attends the fresh K/V: the cache format cannot move it.
  np.testing.assert_array_equal(got["int8"][0], got[None][0])
  moved = np.abs(got["int8"][1] - got[None][1]).max()
  assert moved > 10 * 1e-4, moved


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_int8_greedy_stream_matches_jax_engine(paged, jax_weights, monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_KV_QUANT", "int8")
  monkeypatch.setenv("XOT_PREFILL_CHUNK", "16")  # 30 tokens: segments at 0 and 16
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  monkeypatch.setenv("XOT_KV_PAGE", "16")
  monkeypatch.setenv("XOT_KV_POOL_TOKENS", "512")
  prompt = np.random.default_rng(8).integers(3, 256, size=(1, 30))
  jeng = JAXShardInferenceEngine(dtype="float32")
  want = await _greedy(jeng, JShard(MODEL, 0, 3, 4), "r", prompt, 16)
  calls = {"k2": 0, "k3": 0, "k4": 0}
  for key, name in (("k2", "flash_cached_attention"), ("k3", "paged_decode_attention"),
                    ("k4", "paged_prefill_attention")):
    real = getattr(transformer, name)

    def counted(*a, _real=real, _key=key, **kw):
      assert kw.get("k_scale", kw.get("k_scale_pages")) is not None  # raw int8 + scales
      calls[_key] += 1
      return _real(*a, **kw)
    monkeypatch.setattr(transformer, name, counted)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  assert eng.kv_quant == "int8"
  got = await _greedy(eng, Shard(MODEL, 0, 3, 4), "r", prompt, 16)
  for e in (jeng, eng):
    e.executor.shutdown(wait=True)
  assert got == want
  # 4 layers: contiguous, the second segment and 15 decode steps through K2q;
  # paged, 2 segments through K4q and 15 steps through K3q.
  assert calls == ({"k2": 4 * 16, "k3": 0, "k4": 0} if paged == "0"
                   else {"k2": 0, "k3": 4 * 15, "k4": 4 * 2})


async def _greedy(engine, shard, rid, prompt, n=12):
  tok, _ = await engine.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
  out, size = [int(tok)], 2
  while len(out) < n:
    chunk = await engine.generate_chunk(rid, shard, out[-1], min(size, n - len(out)), temp=0.0,
                                        top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
    size *= 2
  await engine.clear_request(rid)
  return out[:n]


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_batched_int8_streams_match_one_at_a_time(paged, monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_KV_QUANT", "int8")
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  monkeypatch.setenv("XOT_KV_PAGE", "16")
  monkeypatch.setenv("XOT_KV_POOL_TOKENS", "512")
  prompts = {f"r{i}": np.random.default_rng(60 + i).integers(3, 256, size=(1, n))
             for i, n in enumerate((3, 9, 14, 20))}
  shard = Shard(MODEL, 0, 3, 4)
  batched = TorchShardInferenceEngine(device="cpu", seed=0)
  together = await asyncio.gather(*(_greedy(batched, shard, rid, p) for rid, p in prompts.items()))
  assert batched._ctx.batcher.rows > batched._ctx.batcher.dispatches  # rows coalesced
  if paged == "1":
    assert batched.page_pool_stats()["pages_in_use"] == 0
  alone_eng = TorchShardInferenceEngine(device="cpu", seed=0)
  alone = [await _greedy(alone_eng, shard, rid, p) for rid, p in prompts.items()]
  for e in (batched, alone_eng):
    e.executor.shutdown(wait=True)
  assert together == alone


@pytest.mark.parametrize("value", ["0", "false", "off"])
def test_ragged_prefill_off_is_refused(value, monkeypatch):
  """XOT_RAGGED_PREFILL is registered for parity with the JAX package, but only its
  default is served: the gathered paged view it would select is not ported, so the
  engine refuses to be built rather than serve another path. `1` builds."""
  monkeypatch.setenv("XOT_RAGGED_PREFILL", value)
  with pytest.raises(ValueError, match="XOT_RAGGED_PREFILL=0"):
    TorchShardInferenceEngine(device="cpu", seed=0)
  monkeypatch.setenv("XOT_RAGGED_PREFILL", "1")
  TorchShardInferenceEngine(device="cpu", seed=0).executor.shutdown(wait=True)


# ------------------------------------------------------------ knobs and CLI


def test_cli_kv_quantize_reaches_the_engine():
  """--kv-quantize reaches the engine as its argument and leaves XOT_KV_QUANT unset,
  so an engine built later in the process keeps a plain cache."""
  args = port_main.build_parser().parse_args(["--device", "cpu", "--kv-quantize", "int8"])
  node, engine, _, _ = port_main.build_node(args)
  later = TorchShardInferenceEngine(device="cpu")
  try:
    assert engine.kv_quant == "int8" and knobs.get_str("XOT_KV_QUANT") is None
    assert later.kv_quant is None
  finally:
    for e in (engine, later):
      e.executor.shutdown(wait=True)
  with pytest.raises(SystemExit):
    port_main.build_parser().parse_args(["--kv-quantize", "int4"])


def test_kv_knobs_are_registered_with_the_jax_defaults():
  from xotorch_tpu.utils import knobs as j_knobs
  for name in ("XOT_KV_QUANT", "XOT_RAGGED_PREFILL"):
    assert knobs.REGISTRY[name].default == j_knobs.REGISTRY[name].default, name
    assert knobs.REGISTRY[name].kind == j_knobs.REGISTRY[name].kind, name


# ------------------------------------------------------- the CUDA wrappers' checks


def _meta(shape, dtype):
  return torch.empty(shape, dtype=dtype, device="meta")


def _operands(kernel, kv_dtype, scale_dtype, with_scales=True):
  """Meta operands at synthetic-tiny's widths for `kernel`, a callable taking the
  int8-KV keywords."""
  bf, i32 = torch.bfloat16, torch.int32
  if kernel == "k2q":
    q, k, s = _meta((2, 1, 4, 16), bf), _meta((2, 32, 2, 16), kv_dtype), _meta((2, 32, 2), scale_dtype)
    rest = (_meta((2,), i32),)
    call = lambda ks, vs: flash_decode.flash_cached_attention(q, k, k, *rest, k_scale=ks, v_scale=vs)
  else:
    T = 1 if kernel == "k3q" else 4
    q, k, s = _meta((2, T, 4, 16), bf), _meta((8, 16, 2, 16), kv_dtype), _meta((8, 16, 2), scale_dtype)
    rest = (_meta((2, 4), i32), _meta((2,), i32))
    fn = (paged_attention.paged_decode_attention if kernel == "k3q"
          else paged_attention.paged_prefill_attention)
    call = lambda ks, vs: fn(q, k, k, *rest, k_scale_pages=ks, v_scale_pages=vs)
  return (lambda: call(s, s)) if with_scales else (lambda: call(None, None))


@pytest.mark.parametrize("kernel", ["k2q", "k3q", "k4q"])
def test_int8_wrappers_refuse_mismatched_operands(kernel):
  """Int8 K/V without scales, scales with a bf16 cache, scales not bf16 off the CPU:
  each raises ValueError before anything launches; consistent operands on a meta
  device reach the device check, which raises too."""
  counters = (flash_decode.flash_cached_attention_int8, paged_attention.paged_decode_attention_int8,
              paged_attention.paged_prefill_attention_int8)
  before = [c.launches for c in counters]
  with pytest.raises(ValueError, match="both scales"):
    _operands(kernel, torch.int8, torch.bfloat16, with_scales=False)()
  with pytest.raises(ValueError, match="both scales"):
    _operands(kernel, torch.bfloat16, torch.bfloat16)()
  with pytest.raises(ValueError, match="k_scale.* must be contiguous torch.bfloat16"):
    _operands(kernel, torch.int8, torch.float32)()
  with pytest.raises(ValueError, match="cuda or cpu"):
    _operands(kernel, torch.int8, torch.bfloat16)()
  assert [c.launches for c in counters] == before
