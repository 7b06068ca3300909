"""The attention kernels' plain versions at the head widths 256 (gemma-2's) for K1,
K2/K2q, K3/K3q and K4/K4q, and 32 for the paged K3/K3q and K4/K4q, with a window, a
softcap and gemma's query_pre_attn_scalar scale, against the JAX package's Pallas
kernels in interpret mode (and its XLA paths), on the same numpy inputs in fp32. The CUDA builds are held against these plain versions on the card by
chip_smoke.py; here the wrappers take the plain versions because the tensors lie on
the CPU. atol 1e-5 in fp32: the two sides sum in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_tpu.models import quantize as jq
from xotorch_tpu.ops import flash_attention as j_flash
from xotorch_tpu.ops import flash_decode as j_decode
from xotorch_tpu.ops import paged_attention as j_paged
from xotorch_tpu_torch.ops import flash_attention, flash_decode, paged_attention

torch.set_num_threads(2)
ATOL = 1e-5
GEMMA_SCALE = 256.0 ** -0.5  # query_pre_attn_scalar ** -0.5 at gemma-2-2b


@pytest.fixture(autouse=True)
def _highest_precision():
  with jax.default_matmul_precision("highest"):
    yield


def _randn(rng, *shape):
  return rng.standard_normal(shape).astype(np.float32)


def _quantized(rng, shape):
  """(int8 codes, fp32 scales) of random K/V, each (position, head) row scaled by its
  own 2^u, u in [-6, 0], quantized with the JAX package's recipe."""
  x = _randn(rng, *shape) * np.exp2(-6.0 * rng.random(shape[:-1] + (1,))).astype(np.float32)
  qx, sx = jq.quantize_tensor(jnp.asarray(x), axis=-1, scale_dtype=jnp.float32)
  return np.array(qx), np.array(sx)


def _t(*arrays):
  return [torch.from_numpy(np.array(a)) for a in arrays]


def _win(window):
  return jnp.int32(window) if window else None


@pytest.mark.parametrize("T,window,softcap,scale", [
  pytest.param(24, 0, 0.0, None, id="global"),
  pytest.param(40, 9, 50.0, GEMMA_SCALE, id="window-softcap-scale"),
])
def test_flash_attention_ref_d256_matches_jax_kernel(T, window, softcap, scale):
  rng = np.random.default_rng(21)
  q, k, v = _randn(rng, 1, T, 4, 256), _randn(rng, 1, T, 2, 256), _randn(rng, 1, T, 2, 256)
  want = j_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=8,
                                 block_k=8, interpret=True, window=_win(window), softcap=softcap,
                                 scale=scale)
  got = flash_attention.flash_attention(*_t(q, k, v), window=window, softcap=softcap, scale=scale)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-cache", "int8-cache"])
@pytest.mark.parametrize("T,starts,window,softcap,scale", [
  pytest.param(1, [5, 47], 0, 0.0, None, id="decode"),
  pytest.param(1, [30, 63], 12, 50.0, GEMMA_SCALE, id="decode-window-softcap-scale"),
  pytest.param(6, [20, 41], 9, 50.0, GEMMA_SCALE, id="segment-window-softcap-scale"),
])
def test_flash_cached_attention_ref_d256_matches_jax_kernel(T, starts, window, softcap, scale, int8):
  rng = np.random.default_rng(22)
  B, S, Hq, Hkv, D = len(starts), 64, 4, 2, 256
  q = _randn(rng, B, T, Hq, D)
  q_start = np.array(starts, np.int32)
  if int8:
    (kc, ks), (vc, vs) = _quantized(rng, (B, S, Hkv, D)), _quantized(rng, (B, S, Hkv, D))
    jscales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tscales = dict(zip(("k_scale", "v_scale"), _t(ks, vs)))
  else:
    kc, vc = _randn(rng, B, S, Hkv, D), _randn(rng, B, S, Hkv, D)
    jscales, tscales = {}, {}
  want = j_decode.flash_cached_attention(
    jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(q_start), block_q=8,
    block_k=16, interpret=True, window=_win(window), softcap=softcap, scale=scale, **jscales)
  got = flash_decode.flash_cached_attention(*_t(q, kc, vc, q_start), window=window,
                                            softcap=softcap, scale=scale, **tscales)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


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


def _paged_arena(rng, int8, P, page, Hkv, D):
  """(k, v, {jax scale pages}, {port scale pages}) of an arena whose scratch page 0
  holds garbage too."""
  if not int8:
    return _randn(rng, P, page, Hkv, D), _randn(rng, P, page, Hkv, D), {}, {}
  (kq, ks), (vq, vs) = _quantized(rng, (P, page, Hkv, D)), _quantized(rng, (P, page, Hkv, D))
  return (kq, vq, dict(k_scale_pages=jnp.asarray(ks), v_scale_pages=jnp.asarray(vs)),
          dict(zip(("k_scale_pages", "v_scale_pages"), _t(ks, vs))))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-arena", "int8-arena"])
@pytest.mark.parametrize("D", [32, 256])
@pytest.mark.parametrize("window,softcap,scale", [
  pytest.param(0, 0.0, None, id="global"),
  pytest.param(20, 50.0, GEMMA_SCALE, id="window-softcap-scale"),
])
def test_paged_decode_attention_ref_wide_and_narrow_match_jax(window, softcap, scale, D, int8):
  rng = np.random.default_rng(23)
  B, Hq, Hkv, page, maxp, P = 3, 4, 2, 16, 8, 24
  lengths = np.array([1, 37, 120], np.int32)
  kp, vp, jscales, tscales = _paged_arena(rng, int8, P, page, Hkv, D)
  table = _shuffled_table(rng, P, lengths, page, maxp)
  q = _randn(rng, B, 1, Hq, D)
  jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
  kw = dict(softcap=softcap, scale=scale, window=_win(window), **jscales)
  want_kernel = j_paged.paged_decode_attention(*jargs, use_kernel=True, interpret=True, **kw)
  want_xla = j_paged.paged_decode_attention(*jargs, **kw)
  got = paged_attention.paged_decode_attention(*_t(q, kp, vp, table, lengths), window=window,
                                               softcap=softcap, scale=scale, **tscales)
  np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL)
  np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=ATOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-arena", "int8-arena"])
@pytest.mark.parametrize("D", [32, 256])
@pytest.mark.parametrize("T,valid,window,softcap,scale", [
  pytest.param(16, [16, 16], 0, 0.0, None, id="from-0"),
  pytest.param(12, [40, 100], 10, 50.0, GEMMA_SCALE, id="resident-window-softcap-scale"),
])
def test_paged_prefill_attention_ref_wide_and_narrow_match_jax(T, valid, window, softcap, scale, D,
                                                               int8):
  rng = np.random.default_rng(24)
  Hq, Hkv, page, P, maxp = 4, 2, 16, 20, 8
  lengths = np.array(valid, np.int32)
  kp, vp, jscales, tscales = _paged_arena(rng, int8, P, page, Hkv, D)
  table = _shuffled_table(rng, P, lengths, page, maxp)
  q = _randn(rng, len(valid), T, Hq, D)
  q_pos = (lengths[:, None] - T + np.arange(T)[None, :]).astype(np.int32)
  jargs = [jnp.asarray(a) for a in (q, kp, vp, table, q_pos, lengths)]
  kw = dict(softcap=softcap, scale=scale, window=_win(window), **jscales)
  want_kernel = j_paged.paged_prefill_attention(*jargs, use_kernel=True, interpret=True, **kw)
  want_xla = j_paged.paged_prefill_attention(*jargs, **kw)
  got = paged_attention.paged_prefill_attention(*_t(q, kp, vp, table, lengths), window=window,
                                                softcap=softcap, scale=scale, **tscales)
  np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL)
  np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=ATOL)


def test_wrappers_take_the_new_head_dims():
  assert 256 in flash_attention.HEAD_DIMS and 256 in flash_decode.HEAD_DIMS
  assert {32, 256} <= set(paged_attention.HEAD_DIMS)
  assert flash_attention.WIDE_BLOCKS == (64, 64) and flash_decode.WIDE_BLOCK_Q == 64
