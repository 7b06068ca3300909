"""The port's ops (xotorch_tpu_torch.ops) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both. The JAX Pallas kernels
run in interpret mode (selected off-TPU, as tests/test_flash_attention.py runs
them); the port's wrappers take their plain PyTorch versions because the tensors
lie on the CPU. Everything is fp32 with JAX's matmul precision pinned to
'highest', so the two sides differ only by the order of fp32 sums: the attention
tolerance is 2e-5 absolute on outputs of magnitude ~1, rope's 1e-5 covers
cos/sin of the same fp32 angles from two libms. Sampling must pick the very same
tokens: greedy is an argmax of identical logits, and the random picks use JAX's
own Gumbel noise injected into the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_tpu.models.config import RopeScaling as JRopeScaling
from xotorch_tpu.ops import attention as j_attention
from xotorch_tpu.ops import flash_attention as j_flash
from xotorch_tpu.ops import flash_decode as j_decode
from xotorch_tpu.ops import rope as j_rope
from xotorch_tpu.ops import sampling as j_sampling
from xotorch_tpu_torch.models.config import RopeScaling
from xotorch_tpu_torch.ops import attention, flash_attention, flash_decode, rope, sampling

torch.set_num_threads(2)

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _highest_precision():
  with jax.default_matmul_precision("highest"):
    yield


def _randn(rng, *shape):
  return rng.standard_normal(shape).astype(np.float32)


def _t(a):
  return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("scaling", [None, "llama3"])
def test_rope_matches_jax(scaling):
  rng = np.random.default_rng(0)
  D, theta = 64, 500000.0
  sc = (dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
             original_max_position_embeddings=8192) if scaling else None)
  inv_j = np.asarray(j_rope.rope_frequencies(D, theta, JRopeScaling(**sc) if sc else None))
  inv_t = rope.rope_frequencies(D, theta, RopeScaling(**sc) if sc else None)
  np.testing.assert_allclose(inv_t.numpy(), inv_j, rtol=1e-6)
  x = _randn(rng, 2, 5, 4, D)
  pos = np.array([[0, 1, 2, 3, 4], [1000, 1001, 1002, 1003, 70000]], np.int32)
  out_j = np.asarray(j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv_j)))
  out_t = rope.apply_rope(_t(x), _t(pos), inv_t).numpy()
  np.testing.assert_allclose(out_t, out_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window,softcap,scale,valid", [
  (None, 0.0, None, None), (4, 0.0, None, [9, 6]), (0, 30.0, 0.2, None), (3, 20.0, None, [7, 9])])
def test_gqa_attention_matches_jax(window, softcap, scale, valid):
  rng = np.random.default_rng(1)
  B, T, S, Hq, Hkv, D = 2, 3, 9, 4, 2, 8
  q, k, v = _randn(rng, B, T, Hq, D), _randn(rng, B, S, Hkv, D), _randn(rng, B, S, Hkv, D)
  pos = np.array([[4, 5, 6], [6, 7, 8]], np.int32)
  kvl = None if valid is None else np.array(valid, np.int32)
  out_j = j_attention.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                    None if kvl is None else jnp.asarray(kvl), scale=scale,
                                    softcap=softcap, window=window)
  out_t = attention.gqa_attention(_t(q), _t(k), _t(v), _t(pos).long(),
                                  None if kvl is None else _t(kvl).long(), scale=scale,
                                  softcap=softcap, window=window)
  np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("Hq,Hkv,window,softcap,scale,T,block", [
  pytest.param(4, 2, 0, 0.0, None, 32, 16, id="4-2-0-0.0-None"),
  pytest.param(8, 2, 0, 0.0, None, 32, 16, id="8-2-0-0.0-None"),
  pytest.param(4, 4, 5, 0.0, None, 32, 16, id="4-4-5-0.0-None"),
  pytest.param(4, 2, 7, 50.0, 0.3, 32, 16, id="4-2-7-50.0-0.3"),
  # The edges of the card kernel's tiles: groups 8 (a 16-row mma tile holds two
  # positions), T off the 16-row tile, window edges inside a JAX block.
  pytest.param(16, 2, 0, 0.0, None, 32, 16, id="groups8"),
  pytest.param(16, 2, 11, 30.0, None, 32, 16, id="groups8-window-mid-block"),
  pytest.param(4, 2, 0, 0.0, None, 17, 17, id="T17"),
  pytest.param(4, 1, 9, 0.0, None, 24, 8, id="T24-window-mid-block"),
  pytest.param(8, 8, 3, 0.0, None, 15, 15, id="groups1-T15"),
])
def test_flash_attention_ref_matches_jax_kernel(Hq, Hkv, window, softcap, scale, T, block):
  rng = np.random.default_rng(2)
  B, D = 2, 16
  q, k, v = _randn(rng, B, T, Hq, D), _randn(rng, B, T, Hkv, D), _randn(rng, B, T, Hkv, D)
  out_j = j_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block,
                                  block_k=block, window=jnp.int32(window) if window else None,
                                  softcap=softcap, scale=scale)
  out_t = flash_attention.flash_attention(_t(q), _t(k), _t(v), window=window, softcap=softcap,
                                          scale=scale)
  np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=1e-5)


# Split edges of K2's decode kernel: at S = 256, B = 4, Hkv = 2 on a 132-SM card,
# split_plan cuts [0, 256) into four 64-key splits (test_split_plan_* below).
@pytest.mark.parametrize("T,starts,window,softcap,S", [
  pytest.param(1, [0, 17, 40, 63], 0, 0.0, 64, id="1-starts0-0-0.0"),  # decode steps, per-row q_start
  pytest.param(1, [5, 33, 48, 63], 6, 0.0, 64, id="1-starts1-6-0.0"),  # ... under a sliding window
  pytest.param(8, [9, 24, 40, 56], 0, 0.0, 64, id="8-starts2-0-0.0"),  # segments at q_start > 0
  pytest.param(8, [9, 24, 40, 56], 5, 30.0, 64, id="8-starts3-5-30.0"),  # ... window and softcap
  # a split's last key, the next split's first and second, and S - 1
  pytest.param(1, [63, 64, 65, 255], 0, 0.0, 256, id="split-edges"),
  # windows that leave whole splits below them empty (and one of length 1)
  pytest.param(1, [0, 127, 128, 200], 20, 0.0, 256, id="windows-empty-splits"),
  pytest.param(1, [191, 192, 193, 250], 64, 25.0, 256, id="window-of-one-split-softcap"),
  # segments that cross split and tile edges
  pytest.param(5, [60, 123, 187, 251], 0, 0.0, 256, id="segments-across-edges"),
])
def test_flash_cached_attention_ref_matches_jax_kernel(T, starts, window, softcap, S):
  rng = np.random.default_rng(3)
  B, Hq, Hkv, D = 4, 4, 2, 16
  q = _randn(rng, B, T, Hq, D)
  kc, vc = _randn(rng, B, S, Hkv, D), _randn(rng, B, S, Hkv, D)
  q_start = np.array(starts, np.int32)
  out_j = j_decode.flash_cached_attention(
    jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(q_start), block_q=8,
    block_k=16, window=jnp.int32(window) if window else None, softcap=softcap)
  out_t = flash_decode.flash_cached_attention(_t(q), _t(kc), _t(vc), _t(q_start),
                                              window=window, softcap=softcap)
  np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("B,Hkv,S,sm_count,max_keys", [
  (1, 8, 2048, 132, 256), (1, 8, 4096, 132, 256), (8, 8, 4096, 132, 256), (8, 8, 4096, 132, 64),
  (1, 8, 32768, 132, 256), (4, 2, 256, 132, 256), (3, 2, 200, 132, 256), (2, 8, 1000, 16, 4096),
  (1, 1, 1, 1, 64), (8, 8, 128, 132, 1024), (16, 8, 2048, 132, 4096)])
def test_split_plan_covers_the_cache_in_tile_aligned_ranges(B, Hkv, S, sm_count, max_keys):
  """Splits are whole 64-key tiles, at most max_keys each; together they cover [0, S)
  and none lies wholly past S (the kernels refuse a plan that does)."""
  splits, kps = flash_decode.split_plan(B, Hkv, S, sm_count, max_keys)
  assert kps % flash_decode.SPLIT_TILE == 0 and flash_decode.SPLIT_TILE <= kps <= max_keys
  assert (splits - 1) * kps < S <= splits * kps
  covered = [p for s in range(splits) for p in range(s * kps, min(S, (s + 1) * kps))]
  assert covered == list(range(S))
  # As few keys a split as fill SPLIT_BLOCKS_PER_SM blocks an SM, where the cap allows.
  if kps > flash_decode.SPLIT_TILE and kps < max_keys:
    fewer = -(-S // (kps - flash_decode.SPLIT_TILE))
    assert B * Hkv * fewer >= flash_decode.SPLIT_BLOCKS_PER_SM * sm_count


@pytest.mark.parametrize("S", [2048, 4096])
def test_split_plan_fills_the_card_at_batch_one(S):
  """A B = 1 decode step of Llama-3.2-1B (8 kv heads) spreads over more blocks than an
  H100 has SMs (132); before the split, 8 blocks ran."""
  splits, kps = flash_decode.split_plan(1, 8, S, 132)
  assert 8 * splits >= 132
  assert (splits, kps) == (S // 64, 64)


@pytest.mark.parametrize("block_q,block_k,groups,refusal", [
  (32, 256, 2, "XOT_FD_BLOCK_Q=32"), (96, 256, 2, "XOT_FD_BLOCK_Q=96"),
  (128, 100, 2, "XOT_FD_BLOCK_K=100"), (128, 0, 2, "XOT_FD_BLOCK_K=0"),
  (128, 256, 65, "65 q heads per kv head exceed 64"),
  # What the kernel takes passes these checks and stops at the device check.
  (64, 64, 2, "cuda or cpu"), (128, 256, 2, "cuda or cpu"), (128, 4096, 64, "cuda or cpu")])
def test_flash_cached_attention_refuses_blocks_it_cannot_launch(monkeypatch, block_q, block_k,
                                                                groups, refusal):
  """K2 takes 64 or 128 segment rows a block (XOT_FD_BLOCK_Q), decode splits of a
  positive multiple of 64 keys at most (XOT_FD_BLOCK_K) and up to 64 q heads per kv
  head: anything else raises ValueError in the wrapper before the device is looked at
  and before anything launches."""
  monkeypatch.setenv("XOT_FD_BLOCK_Q", str(block_q))
  monkeypatch.setenv("XOT_FD_BLOCK_K", str(block_k))
  q = torch.empty(1, 1, 2 * groups, 16, dtype=torch.bfloat16, device="meta")
  k = torch.empty(1, 64, 2, 16, dtype=torch.bfloat16, device="meta")
  q_start = torch.zeros(1, dtype=torch.int32, device="meta")
  with pytest.raises(ValueError, match=refusal):
    flash_decode.flash_cached_attention(q, k, k, q_start)
  assert flash_decode.flash_cached_attention.launches == 0


def test_flash_decode_attention_is_the_t1_case():
  rng = np.random.default_rng(4)
  q = _randn(rng, 2, 1, 4, 16)
  kc, vc = _randn(rng, 2, 32, 2, 16), _randn(rng, 2, 32, 2, 16)
  valid = np.array([3, 32], np.int32)
  out_j = j_decode.flash_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                          jnp.asarray(valid), block_k=16)
  out_t = flash_decode.flash_decode_attention(_t(q), _t(kc), _t(vc), _t(valid))
  np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=1e-5)


def _sampling_inputs(seed, B=4, V=512):
  rng = np.random.default_rng(seed)
  logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
  bias = np.zeros((B, V), np.float32)
  bias[:, rng.integers(0, V, 8)] = 5.0
  counts = rng.integers(0, 3, (B, V)).astype(np.int32)
  return logits, bias, counts


def test_sample_greedy_matches_jax():
  logits, bias, counts = _sampling_inputs(5)
  key = jax.random.PRNGKey(0)
  for kw in ({}, {"bias": bias}, {"counts": counts, "presence": 0.5, "frequency": 0.3}):
    want = np.asarray(j_sampling.sample_logits(jnp.asarray(logits), key, temp=0.0,
                                               **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                                  else v for k, v in kw.items()}))
    got = sampling.sample_logits(_t(logits), temp=0.0,
                                 **{k: _t(v) if isinstance(v, np.ndarray) else v
                                    for k, v in kw.items()})
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temp,top_k,top_p,min_p,extras", [
  (1.0, 0, 0.0, None, False),
  (0.7, 35, 0.0, None, False),
  (0.9, 0, 0.8, None, False),
  (1.2, 50, 0.9, 0.05, True),
  ([0.0, 0.5, 1.0, 1.5], 20, 0.0, None, True),  # per-row temperatures, one greedy row
])
def test_sample_with_injected_gumbel_matches_jax(temp, top_k, top_p, min_p, extras):
  logits, bias, counts = _sampling_inputs(6)
  picks_j, picks_t = [], []
  for step in range(8):
    key = jax.random.PRNGKey(step)
    noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    jkw = dict(bias=jnp.asarray(bias), counts=jnp.asarray(counts), presence=0.4,
               frequency=0.2) if extras else {}
    tkw = dict(bias=_t(bias), counts=_t(counts), presence=0.4, frequency=0.2) if extras else {}
    t_arg = temp if isinstance(temp, float) else np.array(temp, np.float32)
    picks_j.append(np.asarray(j_sampling.sample_logits(
      jnp.asarray(logits), key, temp=t_arg if isinstance(t_arg, float) else jnp.asarray(t_arg),
      top_k=top_k, top_p=top_p, min_p=min_p, **jkw)))
    picks_t.append(sampling.sample_logits(
      _t(logits), temp=t_arg if isinstance(t_arg, float) else _t(t_arg), top_k=top_k,
      top_p=top_p, min_p=min_p, gumbel=_t(noise), **tkw).numpy())
  np.testing.assert_array_equal(np.stack(picks_t), np.stack(picks_j))


def test_sample_logprobs_match_jax():
  logits, bias, counts = _sampling_inputs(7)
  key = jax.random.PRNGKey(3)
  noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
  tok_j, lp_j, ids_j, lps_j = j_sampling.sample_logits_logprobs(
    jnp.asarray(logits), key, temp=0.8, top_k=10, bias=jnp.asarray(bias),
    counts=jnp.asarray(counts), presence=0.3, frequency=0.1, top_lp=5)
  tok_t, lp_t, ids_t, lps_t = sampling.sample_logits_logprobs(
    _t(logits), temp=0.8, top_k=10, bias=_t(bias), counts=_t(counts), presence=0.3,
    frequency=0.1, top_lp=5, gumbel=_t(noise))
  np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
  np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
  np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-5)
  np.testing.assert_allclose(lps_t.numpy(), np.asarray(lps_j), atol=1e-5)


def test_kernel_wrappers_refuse_what_they_cannot_launch():
  """Off the CPU a wrapper launches its kernel or raises: a meta tensor (no data,
  no card) is refused rather than sent to the plain version."""
  q = torch.empty(1, 16, 4, 16, device="meta")
  k = torch.empty(1, 16, 2, 16, device="meta")
  with pytest.raises(ValueError):
    flash_attention.flash_attention(q, k, k)
  with pytest.raises(ValueError):
    flash_decode.flash_cached_attention(q, k, k, torch.zeros(1, dtype=torch.int32, device="meta"))
  assert flash_attention.flash_attention.launches == 0
  assert flash_decode.flash_cached_attention.launches == 0


@pytest.mark.parametrize("block_q,block_k,D,refusal", [
  (32, 128, 64, "XOT_FLASH_BLOCK_Q"), (128, 256, 64, "XOT_FLASH_BLOCK_Q"),
  (100, 64, 64, "XOT_FLASH_BLOCK_Q"), (128, 128, 48, "head_dim"),
  # What the kernel takes passes these checks and stops at the device check.
  (64, 64, 32, "cuda or cpu"), (64, 128, 32, "cuda or cpu"), (128, 64, 32, "cuda or cpu"),
  (128, 128, 32, "cuda or cpu")])
def test_flash_attention_refuses_tiles_it_cannot_launch(monkeypatch, block_q, block_k, D, refusal):
  """K1 takes 64 or 128 query rows a block (XOT_FLASH_BLOCK_Q) and keys a tile
  (XOT_FLASH_BLOCK_K), and head_dim 16, 32, 64 or 128: anything else raises ValueError
  in the wrapper, before the device is looked at and before anything launches."""
  monkeypatch.setenv("XOT_FLASH_BLOCK_Q", str(block_q))
  monkeypatch.setenv("XOT_FLASH_BLOCK_K", str(block_k))
  q = torch.empty(1, 16, 4, D, dtype=torch.bfloat16, device="meta")
  k = torch.empty(1, 16, 2, D, dtype=torch.bfloat16, device="meta")
  with pytest.raises(ValueError, match=refusal):
    flash_attention.flash_attention(q, k, k)
  assert flash_attention.flash_attention.launches == 0


def _entry_points(source: str) -> dict:
  """{name: [parameter kind, ...]} of the extern "C" functions of a CUDA source: a
  pointer is c_void_p, an int c_int, a float c_float."""
  import ctypes
  import re
  kinds = {}
  for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source):
    row = []
    for p in params.split(","):
      p = " ".join(p.split())
      row.append(ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float ")
                 else ctypes.c_int if p.startswith("int ") else p)
    kinds[name] = row
  return kinds


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd", "flash_decode",
                                  "paged_attention", "quant_matvec"])
def test_ctypes_signatures_match_the_entry_points(name):
  """Every extern "C" entry point of csrc/<name>.cu takes, in order, the kinds of
  parameter _build.SIGNATURES gives ctypes (a mismatch would show only as corrupt
  arguments on the card), and SIGNATURES names every entry point and no other."""
  from xotorch_tpu_torch.ops import _build
  assert name in _build.KERNELS
  declared = _entry_points((_build.CSRC_DIR / f"{name}.cu").read_text())
  assert declared and sorted(declared) == sorted(_build.SIGNATURES[name])
  for fn, kinds in declared.items():
    assert kinds == _build.SIGNATURES[name][fn], fn


def test_lib_path_follows_the_shared_header(monkeypatch, tmp_path):
  """A library's name hashes its source, every csrc/*.cuh header and the flags: an
  edit to the shared tile core alone (attention_mma.cuh) names a new library, so a
  stale one is never loaded. No nvcc needed."""
  from xotorch_tpu_torch.ops import _build
  import shutil
  csrc = tmp_path / "csrc"
  shutil.copytree(_build.CSRC_DIR, csrc)
  monkeypatch.setattr(_build, "CSRC_DIR", csrc)
  before = {name: _build._lib_path(name) for name in _build.KERNELS}
  assert before == {name: _build._lib_path(name) for name in _build.KERNELS}
  header = csrc / "attention_mma.cuh"
  header.write_text(header.read_text() + "\n// edited\n")
  after = {name: _build._lib_path(name) for name in _build.KERNELS}
  for name in _build.KERNELS:
    assert after[name] != before[name], name
    assert after[name].parent == _build.BUILD_DIR
  (csrc / "flash_attention.cu").write_text((csrc / "flash_attention.cu").read_text() + "\n")
  assert _build._lib_path("flash_attention") != after["flash_attention"]
  assert _build._lib_path("flash_decode") == after["flash_decode"]
