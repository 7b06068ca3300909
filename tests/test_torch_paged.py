"""The port's paged KV pool and paged attention against the JAX package's, on the CPU.

The same sequences of operations go through both packages' `VirtualKV` and `PagePool`
and must leave identical bookkeeping (allocation order, refcounts, free lists, defrag
plans). The same numpy inputs, made from a seed, go through the JAX paged-attention
ops (the Pallas kernels in interpret mode, and the XLA gather path) and the port's
K3/K4 wrappers, which take their plain versions for CPU tensors: fp32 on both sides
with JAX's matmul precision pinned to 'highest', so the outputs differ only by the
order of fp32 sums, within 1e-5 absolute on values of magnitude ~1. Models run
synthetic-tiny (head_dim 16, 2 kv heads) at page 16 on the JAX package's own weights,
carried across by `params_from_jax`; greedy token streams must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_tpu.inference.jax_engine import paged_cache as j_paged_cache
from xotorch_tpu.inference.jax_engine import vkv as j_vkv
from xotorch_tpu.models import generate as j_generate
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.models.registry import get_model_card as j_get_model_card
from xotorch_tpu.ops import paged_attention as j_paged
from xotorch_tpu_torch.inference.engine import CacheExhausted
from xotorch_tpu_torch.inference.torch_engine import paged_cache, vkv
from xotorch_tpu_torch.models import generate, transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import params_from_jax
from xotorch_tpu_torch.ops import paged_attention

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
  with jax.default_matmul_precision("highest"):
    yield


def _cfgs():
  return (j_config_from_hf_dict(j_get_model_card(MODEL)["synthetic_config"]),
          config_from_hf_dict(get_model_card(MODEL)["synthetic_config"]))


def _pool_state(pool):
  return (list(pool._free), pool._ref.tolist(), pool.peak_pages_in_use, pool.pages_in_use,
          pool.free_pages, pool.fragmentation())


def test_page_pool_bookkeeping_matches_jax():
  jcfg, cfg = _cfgs()
  jpool = j_paged_cache.PagePool(jcfg, 2, num_pages=12, page_size=16, dtype=jnp.float32)
  pool = paged_cache.PagePool(cfg, 2, num_pages=12, page_size=16, dtype=torch.float32)
  assert tuple(pool.arena["k"].shape) == tuple(jpool.arena["k"].shape)

  def both(name, *args):
    outs = []
    for p in (jpool, pool):
      try:
        outs.append(("ok", getattr(p, name)(*args)))
      except (AssertionError, CacheExhausted, j_paged_cache.CacheExhausted) as e:
        outs.append(("raised", type(e).__name__ == "AssertionError"))
    assert outs[0] == outs[1], (name, args, outs)
    assert _pool_state(jpool) == _pool_state(pool), (name, args)
    return outs[1][1]

  a = both("alloc", 3)
  b = both("alloc", 4)
  both("incref", a[:2])
  both("decref", a)  # only a[2] frees
  c = both("alloc", 2)  # takes the freed id first
  both("decref", b[1:3])  # holes in the middle
  assert pool.fragmentation() > 0
  both("alloc", 20)  # more than free: CacheExhausted on both
  both("decref", [0])  # the scratch page: refused on both
  for max_moves in (0, 1, 8):
    assert both("defrag_plan", max_moves) == jpool.defrag_plan(max_moves)
  both("apply_moves", pool.defrag_plan(8))
  assert pool.fragmentation() == 0
  both("decref", [p for p in range(1, 12) if pool.refcount(p) > 0])
  both("decref", c[:1])  # double free: refused on both
  assert pool.pages_in_use == 0 and [both("pages_for", n) for n in (1, 16, 17)] == [1, 1, 2]


def test_virtual_kv_matches_jax():
  jh, h = j_vkv.VirtualKV(), vkv.VirtualKV()
  ops = [("extend", [5, 9, 2, 7, 11]), ("append", 4), ("release_below", 2),
         ("remap", {9: 1, 7: 3, 0: 8}), ("trim_to", 4), ("release_below", 1),
         ("prefix_ids", 2), ("live",), ("trim_to", 9)]
  for name, *args in ops:
    assert getattr(jh, name)(*args) == getattr(h, name)(*args), name
    assert (jh.blocks, jh.base) == (h.blocks, h.base), name
  assert vkv.VirtualKV([1, 2]).prefix_ids(2) == j_vkv.VirtualKV([1, 2]).prefix_ids(2) == [1, 2]
  handles = [h, [3, 4, 5], vkv.VirtualKV()]
  np.testing.assert_array_equal(vkv.resolve_page_table(handles, 4),
                                j_vkv.resolve_page_table([jh, [3, 4, 5], []], 4))
  assert vkv.remap_ids([1, 2, 3], {2: 7}) == j_vkv.remap_ids([1, 2, 3], {2: 7})
  for pos, window, page in ((0, 0, 16), (40, 8, 16), (100, 33, 16), (5, 64, 16)):
    assert vkv.dead_page_count(pos, window, page) == j_vkv.dead_page_count(pos, window, page)
  base = dict(get_model_card(MODEL)["synthetic_config"])
  for extra in ({}, {"model_type": "mistral", "sliding_window": 24},
                {"model_type": "gemma2", "sliding_window": 24}):
    jc, c = j_config_from_hf_dict({**base, **extra}), config_from_hf_dict({**base, **extra})
    assert vkv.freeable_window(c, 0, 4) == j_vkv.freeable_window(jc, 0, 4)


def _arena(rng, P, page, Hkv, D):
  # Page 0 (scratch) holds garbage too: every read of it must be masked.
  return (rng.standard_normal((P, page, Hkv, D)).astype(np.float32),
          rng.standard_normal((P, page, Hkv, D)).astype(np.float32))


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


# Split edges of K3's decode kernel: a table of 16 pages of 16 (256 positions) at B = 3,
# Hkv = 2 is cut into four 64-key splits on a 132-SM card (flash_decode.split_plan).
EDGES = [64, 65, 256]  # a split's last key at position 63, the next split's first, S


@pytest.mark.parametrize("window,softcap,scale,lengths,maxp", [
  pytest.param(0, 0.0, None, [1, 37, 120], 8, id="0-0.0-None"),
  pytest.param(20, 0.0, None, [1, 37, 120], 8, id="20-0.0-None"),
  pytest.param(0, 30.0, 0.3, [1, 37, 120], 8, id="0-30.0-0.3"),
  pytest.param(9, 20.0, None, [1, 37, 120], 8, id="9-20.0-None"),
  pytest.param(0, 0.0, None, EDGES, 16, id="split-edges"),
  pytest.param(0, 0.0, None, [63, 128, 129], 16, id="split-edges-2"),
  # windows that leave whole splits below them empty
  pytest.param(20, 0.0, None, [200, 129, 256], 16, id="windows-empty-splits"),
  pytest.param(64, 25.0, None, [128, 193, 255], 16, id="window-of-one-split-softcap"),
])
def test_paged_decode_attention_ref_matches_jax(window, softcap, scale, lengths, maxp):
  rng = np.random.default_rng(11)
  B, Hq, Hkv, D, page = 3, 4, 2, 16, 16
  P = 24 if maxp == 8 else 3 * maxp + 2
  lengths = np.array(lengths, np.int32)
  kp, vp = _arena(rng, P, page, Hkv, D)
  table = _shuffled_table(rng, P, lengths, page, maxp)
  q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
  jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), jnp.asarray(lengths))
  win = jnp.int32(window) if window else None
  want_kernel = j_paged.paged_decode_attention(*jargs, softcap=softcap, scale=scale, use_kernel=True,
                                               interpret=True, window=win)
  want_xla = j_paged.paged_decode_attention(*jargs, softcap=softcap, scale=scale, window=win)
  got = paged_attention.paged_decode_attention(
    torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(table),
    torch.from_numpy(lengths), window=window, softcap=softcap, scale=scale)
  np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL)
  np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=ATOL)


@pytest.mark.parametrize("T,valid,window,softcap,Hq,Hkv", [
  # a first segment, from position 0
  pytest.param(16, [16, 16], 0, 0.0, 4, 2, id="16-valid0-0-0.0"),
  # segments over a resident prefix, ragged
  pytest.param(12, [40, 100], 0, 0.0, 4, 2, id="12-valid1-0-0.0"),
  # ... under a window and a softcap
  pytest.param(12, [40, 100], 10, 25.0, 4, 2, id="12-valid2-10-25.0"),
  # The edges of the card kernel's tiles: groups 8, T off the 16-row mma tile,
  # segments that start mid-page, a window edge inside a tile.
  pytest.param(12, [40, 100], 0, 0.0, 16, 2, id="groups8"),
  pytest.param(17, [17, 90], 0, 0.0, 4, 2, id="T17-from-0-and-mid-page"),
  pytest.param(15, [22, 123], 11, 20.0, 16, 2, id="groups8-T15-window-mid-tile"),
  pytest.param(1, [1, 37], 0, 0.0, 2, 2, id="groups1-T1"),
])
def test_paged_prefill_attention_ref_matches_jax(T, valid, window, softcap, Hq, Hkv):
  rng = np.random.default_rng(12)
  D, page, P, maxp = 16, 16, 20, 8
  lengths = np.array(valid, np.int32)
  kp, vp = _arena(rng, P, page, Hkv, D)
  table = _shuffled_table(rng, P, lengths, page, maxp)
  q = rng.standard_normal((len(valid), T, Hq, D)).astype(np.float32)
  q_pos = (lengths[:, None] - T + np.arange(T)[None, :]).astype(np.int32)
  jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), jnp.asarray(q_pos),
           jnp.asarray(lengths))
  win = jnp.int32(window) if window else None
  want_kernel = j_paged.paged_prefill_attention(*jargs, softcap=softcap, use_kernel=True,
                                                interpret=True, window=win)
  want_xla = j_paged.paged_prefill_attention(*jargs, softcap=softcap, window=win)
  got = paged_attention.paged_prefill_attention(
    torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(table),
    torch.from_numpy(lengths), window=window, softcap=softcap)
  np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL)
  np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=ATOL)


def test_commit_gather_migrate_match_jax():
  jcfg, cfg = _cfgs()
  rng = np.random.default_rng(13)
  L, page, P = 2, 16, 10
  jpool = j_paged_cache.PagePool(jcfg, L, P, page, jnp.float32)
  pool = paged_cache.PagePool(cfg, L, P, page, torch.float32)
  cache = {n: rng.standard_normal((L, 1, 40, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
           for n in ("k", "v")}
  ids = [7, 2, 5]  # 40 tokens -> 3 pages; the third is partly past the buffer
  jpool.arena = j_paged_cache.commit_pages(jpool.arena, {n: jnp.asarray(a) for n, a in cache.items()},
                                           np.asarray(ids, np.int32), 0)
  paged_cache.commit_pages(pool.arena, {n: torch.from_numpy(a) for n, a in cache.items()}, ids, 0)
  for n in ("k", "v"):
    np.testing.assert_array_equal(pool.arena[n].numpy(), np.asarray(jpool.arena[n]))
  back = paged_cache.gather_pages(pool.arena, ids[:2])
  jback = j_paged_cache.gather_pages(jpool.arena, np.asarray(ids[:2], np.int32))
  np.testing.assert_array_equal(back["k"].numpy(), np.asarray(jback["k"]))
  np.testing.assert_array_equal(back["k"].numpy(), cache["k"][:, :, :32])
  jpool.arena = j_paged_cache.migrate_pages(jpool.arena, [7, 5], [1, 3])
  paged_cache.migrate_pages(pool.arena, [7, 5], [1, 3])
  for n in ("k", "v"):
    np.testing.assert_array_equal(pool.arena[n].numpy(), np.asarray(jpool.arena[n]))


def _jax_params(jcfg):
  return j_transformer.init_random_params(jcfg, jcfg.num_layers, True, True, jax.random.PRNGKey(0),
                                          dtype=jnp.float32)


def test_decode_chunk_paged_matches_jax():
  """Three requests prefilled into one arena through their own shuffled page tables
  (one paged segment each: K4's plain version), then decoded together, B=3 at
  per-row positions with one pad row: the greedy tokens and the written arena equal
  JAX's forward_paged + decode_chunk_paged."""
  jcfg, cfg = _cfgs()
  jp = _jax_params(jcfg)
  params = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
  rng = np.random.default_rng(14)
  L, page, P, maxp, K = cfg.num_layers, 16, 24, 4, 8
  prompts = [rng.integers(3, 256, size=(1, n)).astype(np.int32) for n in (5, 20, 37)]
  table = _shuffled_table(rng, P, [len(p[0]) + K for p in prompts], page, maxp)
  shape = (L, P, page, cfg.num_kv_heads, cfg.head_dim)
  jarena = {n: jnp.zeros(shape, jnp.float32) for n in ("k", "v")}
  arena = {n: torch.zeros(shape) for n in ("k", "v")}
  last = []
  for b, toks in enumerate(prompts):
    jl, jarena = j_generate.forward_paged(jp, jnp.asarray(toks), jarena, jnp.asarray(table[b:b + 1]),
                                          jnp.int32(0), jcfg)
    tl, _ = transformer.forward_shard(params, torch.from_numpy(toks).long(), arena, 0, cfg, True,
                                      True, page_table=torch.from_numpy(table[b:b + 1]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    last.append(int(np.argmax(np.asarray(jl)[0, -1])))
  pos = np.array([len(p[0]) for p in prompts], np.int32)
  jtoks, jarena = j_generate.decode_chunk_paged(
    jp, jarena, jnp.asarray(table), jnp.asarray(np.array(last, np.int32)[:, None]), jnp.asarray(pos),
    jax.random.PRNGKey(0), jcfg, K, jnp.zeros(3, jnp.float32), 0, pad_rows=1)
  toks, _ = generate.decode_chunk_paged(
    params, arena, torch.from_numpy(table), torch.tensor(last)[:, None], torch.from_numpy(pos), cfg,
    K, torch.zeros(3), 0, pad_rows=1)
  np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
  real = np.unique(table[table > 0])  # the scratch page holds pad-row garbage on both sides
  np.testing.assert_allclose(arena["k"].numpy()[:, real], np.asarray(jarena["k"])[:, real], atol=1e-4)


def test_paged_kernel_wrappers_refuse_what_they_cannot_launch():
  """Off the CPU a paged wrapper launches its kernel or raises: a meta tensor is
  refused rather than sent to the plain version."""
  q = torch.empty(2, 1, 4, 16, device="meta")
  pages = torch.empty(8, 16, 2, 16, device="meta")
  table = torch.zeros(2, 4, dtype=torch.int32, device="meta")
  lens = torch.zeros(2, dtype=torch.int32, device="meta")
  with pytest.raises(ValueError):
    paged_attention.paged_decode_attention(q, pages, pages, table, lens)
  with pytest.raises(ValueError):
    paged_attention.paged_prefill_attention(q, pages, pages, table, lens)
  assert paged_attention.paged_decode_attention.launches == 0
  assert paged_attention.paged_prefill_attention.launches == 0


@pytest.mark.parametrize("Hq,refusal", [(130, "q heads per kv head exceed 64"), (32, "cuda or cpu"),
                                         (16, "cuda or cpu")])
def test_paged_prefill_takes_at_most_eight_groups(Hq, refusal):
  """K4 (as K3, and K2) takes at most 64 query heads per kv head: more raise ValueError
  in the wrapper before the device is looked at; 16 and 8 pass on to the device check."""
  q = torch.empty(2, 20, Hq, 16, dtype=torch.bfloat16, device="meta")
  pages = torch.empty(8, 16, 2, 16, dtype=torch.bfloat16, device="meta")
  table = torch.zeros(2, 4, dtype=torch.int32, device="meta")
  lens = torch.zeros(2, dtype=torch.int32, device="meta")
  with pytest.raises(ValueError, match=refusal):
    paged_attention.paged_prefill_attention(q, pages, pages, table, lens)
  assert paged_attention.paged_prefill_attention.launches == 0



@pytest.mark.parametrize("page", [8, 24])
@pytest.mark.parametrize("Hq,Hkv", [(24, 2), (32, 2)], ids=["groups12", "groups16"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_paged_plain_versions_at_any_page_and_group_count(kind, Hq, Hkv, page):
  """K3's and K4's plain versions at pages 8 and 24 (JAX's pool takes any page; its own
  tests run 8) and at 12 and 16 q heads per kv head (mistral-large's and
  llama-3.1-405b's groups) against JAX's Pallas kernels in interpret mode (every case
  here is one JAX's kernel takes) and JAX's XLA path, over shuffled tables, windowed and
  softcapped: within ATOL in fp32. K4's segments start from 0 and mid-page, and T = 13
  rows times 12 groups cross the card kernel's 64-row blocks mid-position."""
  rng = np.random.default_rng(26 + page + Hq)
  D, maxp = 16, -(-130 // page) + 1
  P = 3 * maxp + 2
  kp, vp = _arena(rng, P, page, Hkv, D)
  for window, softcap in ((0, 0.0), (9, 20.0)):
    win = jnp.int32(window) if window else None
    if kind == "decode":
      lengths = np.array([1, page + 1, 130], np.int32)
      fn, port = j_paged.paged_decode_attention, paged_attention.paged_decode_attention
      q = rng.standard_normal((3, 1, Hq, D)).astype(np.float32)
      extra = ()
    else:
      T, lengths = 13, np.array([13, page + 20, 130], np.int32)
      fn, port = j_paged.paged_prefill_attention, paged_attention.paged_prefill_attention
      q = rng.standard_normal((3, T, Hq, D)).astype(np.float32)
      extra = ((lengths[:, None] - T + np.arange(T)[None, :]).astype(np.int32),)
    table = _shuffled_table(rng, P, lengths, page, maxp)
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, table) + extra + (lengths,))
    want_kernel = fn(*jargs, softcap=softcap, use_kernel=True, interpret=True, window=win)
    want_xla = fn(*jargs, softcap=softcap, window=win)
    got = port(*(torch.from_numpy(a) for a in (q, kp, vp, table, lengths)), window=window,
               softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=ATOL)
