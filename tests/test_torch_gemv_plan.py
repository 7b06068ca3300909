"""The launch plan of the split-K GEMV kernels K5, K5v4 and K6 (ops/int8_matmul.gemv_plan,
split_ranges) and the sums the kernels take over it, on the CPU.

- One decode row over K <= 4096 takes the one-row kernel (tile 0, one split); every
  other launch takes one of the cluster kernels' column tiles and covers the
  contraction [0, K) in ranges of whole 32-row k-steps (the last ends at K), none
  empty, at most 8 (one thread-block cluster). It gives at least as many blocks as the
  card has SMs wherever K and N allow it, on the widest tile that does: at
  synthetic-llama-1b's, llama-3.1-8B's and llama-3.1-70B's projections, at N = 4 and
  36, at K = one group, on 132 and 114 SMs, at rows 1, 3 and 8.
- Summing the plain versions' per-range products in the kernels' order (rank 0
  first; inside a range, K5 one fp32 dot a group slice, scaled after it; K5v4 two exact
  integer dots a group slice, even and odd, composed with the whole row's two
  activation scales and the group's scale) gives the unsplit plain result: bit for bit
  for K6 (the int32 sums are exact, the activation scale is the whole row's), within
  2^-7 of the output's range for K5 and K5v4 (fp32 sums in another order), and all
  three agree with the JAX package's Pallas kernels run in interpret mode on the same
  numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_tpu.models import quantize as jq
from xotorch_tpu.ops.int4_matmul import int4_grouped_matmul as j_int4_grouped_matmul
from xotorch_tpu.ops.int8_matmul import int8_rowquant_matmul as j_int8_rowquant_matmul
from xotorch_tpu_torch.ops import int4_matmul, int8_matmul
from xotorch_tpu_torch.ops.int8_matmul import (GEMV_KSTEP, GEMV_MAX_SPLITS, GEMV_ROW_MAX_K,
                                               GEMV_TILES, gemv_plan, split_ranges)

torch.set_num_threads(2)

# (name, K, N): the decode projections of the three model widths, and small edges.
SHAPES = [
  ("1b wq/wo", 2048, 2048), ("1b wk/wv", 2048, 512), ("1b gate/up", 2048, 8192),
  ("1b down", 8192, 2048),
  ("8b wq/wo", 4096, 4096), ("8b wk/wv", 4096, 1024), ("8b gate/up", 4096, 14336),
  ("8b down", 14336, 4096),
  ("70b wq/wo", 8192, 8192), ("70b wk/wv", 8192, 1024), ("70b gate/up", 8192, 28672),
  ("70b down", 28672, 8192),
  ("N=4", 2048, 4), ("N=36", 2048, 36), ("one group", 128, 2048), ("one group, N=36", 128, 36),
  ("ragged last step", 2052, 36),
]
MODEL_SHAPES = [s for s in SHAPES if s[0][:2] in ("1b", "8b", "70")]


def _ids(shapes):
  return [s[0] for s in shapes]


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("name,K,N", SHAPES, ids=_ids(SHAPES))
def test_plan_covers_the_contraction_in_whole_k_steps(name, K, N, sm_count, rows):
  tile, splits = gemv_plan(rows, K, N, sm_count)
  ranges = split_ranges(K, splits)
  if rows == 1 and K <= GEMV_ROW_MAX_K:
    assert (tile, splits) == (0, 1)  # the one-row kernel walks the whole contraction
  else:
    assert tile in GEMV_TILES and (tile, splits) == gemv_plan(8, K, N, sm_count)
  assert 1 <= splits <= GEMV_MAX_SPLITS and len(ranges) == splits
  assert ranges[0][0] == 0 and ranges[-1][1] == K
  for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
    assert a1 == b0
  for k0, k1 in ranges:
    assert k1 > k0, f"{name}: empty split {ranges}"
    assert k0 % GEMV_KSTEP == 0 and (k1 == K or k1 % GEMV_KSTEP == 0), ranges


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("name,K,N", SHAPES, ids=_ids(SHAPES))
def test_plan_reaches_the_sm_count_where_the_shape_allows(name, K, N, sm_count):
  tile, splits = gemv_plan(8, K, N, sm_count)
  blocks, steps = -(-N // tile) * splits, -(-K // GEMV_KSTEP)
  most = -(-N // min(GEMV_TILES)) * min(GEMV_MAX_SPLITS, steps)  # narrowest tile, all splits
  assert blocks >= min(sm_count, most), (name, tile, splits)
  if (name, K, N) in MODEL_SHAPES:
    assert blocks >= sm_count, (name, tile, splits)
  for wider in GEMV_TILES[:GEMV_TILES.index(tile)]:  # no wider tile reaches the SM count
    assert -(-N // wider) * min(GEMV_MAX_SPLITS, steps) < sm_count, (name, wider)


def _inputs(rows, K, N, seed):
  rng = np.random.default_rng(seed)
  h = rng.standard_normal((rows, K)).astype(np.float32)
  w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
  return h, w


def _k6_split_sum(h, w8, w_scale, splits):
  """K6 in the kernel's order: every range's integer product over the row's own
  int8 codes (the cluster agrees on the whole row's scale), summed in rank order,
  then acc * a_scale * w_scale in fp32."""
  h8, a_scale = int8_matmul.rowquant_int8(h)
  acc = torch.zeros((h.shape[0], w8.shape[1]), dtype=torch.int64)
  for k0, k1 in split_ranges(h.shape[1], splits):
    acc += h8[:, k0:k1].to(torch.int64) @ w8[k0:k1].to(torch.int64)
  return (acc.to(torch.float32) * a_scale * w_scale.to(torch.float32)[None, :]).to(h.dtype)


# (K, N, sm_count): a 132-SM card's plan at a 1b shape cut to few columns, a ragged last
# k-step (K % 32 == 4), one k-step, and N off the 16-column tile.
K6_CASES = [(2048, 36, 132), (2052, 36, 132), (260, 4, 132), (32, 20, 132), (1024, 48, 8)]


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("K,N,sm_count", K6_CASES)
def test_w8a8_split_sums_equal_the_unsplit_plain_version(K, N, sm_count, rows):
  h, w = _inputs(rows, K, N, 7 * K + N + rows)
  jqv, js = jq.quantize_tensor(jnp.asarray(w), 0, jnp.int8, jnp.float32)
  w8, ws = torch.from_numpy(np.array(jqv)), torch.from_numpy(np.array(js))
  _, splits = gemv_plan(8, K, N, sm_count)  # the cluster kernels' ranges
  assert splits > 1 or K <= GEMV_KSTEP
  for dtype in (torch.float32, torch.bfloat16):
    ht, wst = torch.from_numpy(h).to(dtype), ws.to(dtype)
    got = _k6_split_sum(ht, w8, wst, splits)
    assert torch.equal(got, int8_matmul.int8_rowquant_matmul_ref(ht, w8, wst)), (dtype, splits)
  want = np.asarray(j_int8_rowquant_matmul(jnp.asarray(h), jqv, js, block_out=N, interpret=True))
  np.testing.assert_allclose(_k6_split_sum(torch.from_numpy(h), w8, ws, splits).numpy(), want,
                             atol=1e-6 * np.abs(want).max(), rtol=0)


def _k5_split_sum(h, packed, gscale, splits):
  """K5 in the kernel's order: per range, one fp32 dot for each group slice (a range
  may hold part of a group), scaled by the group's scale when the slice ends and added
  to the range's total; the ranges' totals summed in rank order."""
  G, gs_half, N = packed.shape
  lo, hi = int4_matmul._nibbles(packed.reshape(G * gs_half, N))
  hf = h.to(torch.float32)
  he, ho = hf[:, 0::2], hf[:, 1::2]  # the columns that meet the low and the high nibbles
  out = torch.zeros((h.shape[0], N), dtype=torch.float32)
  for k0, k1 in split_ranges(h.shape[1], splits):
    total = torch.zeros_like(out)
    p = k0 // 2
    while p < k1 // 2:
      g = p // gs_half
      e = min(k1 // 2, (g + 1) * gs_half)
      dot = he[:, p:e] @ lo[p:e].to(torch.float32) + ho[:, p:e] @ hi[p:e].to(torch.float32)
      total += dot * gscale[g].to(torch.float32)[None, :]
      p = e
    out += total
  return out.to(h.dtype)


# (K, gs, N, sm_count): one group; ranges that cut groups of 128 (K = 384: 12 k-steps in
# 8 ranges) and of 64; N off the tile; a 1b projection cut to 36 columns.
K5_CASES = [(128, 128, 36, 132), (384, 128, 20, 132), (256, 64, 4, 132), (512, 32, 48, 16),
            (2048, 128, 36, 132)]


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("K,gs,N,sm_count", K5_CASES)
def test_w4a16_split_sums_match_the_unsplit_plain_version(K, gs, N, sm_count, rows):
  h, w = _inputs(rows, K, N, 11 * K + N + rows)
  jpk, jgs = jq.quantize_tensor_grouped(jnp.asarray(w[None]), jnp.float32, group_size=gs)
  pk, gsc = torch.from_numpy(np.array(jpk)[0]), torch.from_numpy(np.array(jgs)[0])
  _, splits = gemv_plan(8, K, N, sm_count)  # the cluster kernels' ranges
  assert splits > 1 or K <= GEMV_KSTEP
  cut = [k0 for k0, _ in split_ranges(K, splits) if k0 % gs]
  if (K, gs) == (384, 128):
    assert cut, "the plan should cut a group here"
  for dtype in (torch.float32, torch.bfloat16):
    ht, gst = torch.from_numpy(h).to(dtype), gsc.to(dtype)
    want = int4_matmul.int4_w4a16_matmul_ref(ht, pk, gst).float()
    got = _k5_split_sum(ht, pk, gst, splits).float()
    atol = 2.0 ** -7 * want.abs().max().item()
    torch.testing.assert_close(got, want, atol=atol, rtol=0)
  want = np.asarray(j_int4_grouped_matmul(jnp.asarray(h), jpk[0], jgs[0], block_out=N,
                                          interpret=True, variant=1))
  got = _k5_split_sum(torch.from_numpy(h), pk, gsc, splits).numpy()
  np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def _k5v4_split_sum(h, packed, gscale, splits):
  """K5v4 in the kernel's order: one pair of activation scales for the whole row (the
  even and the odd columns apart, as the cluster agrees on them); per range and per
  group slice (a range may hold part of a group), the exact integer dots of the even
  codes by the low nibbles (pe) and of the odd codes by the high ones (po), composed
  as (pe * s_even + po * s_odd) * gscale in fp32 and added to the range's total; the
  ranges' totals summed in rank order."""
  G, gs_half, N = packed.shape
  lo, hi = int4_matmul._nibbles(packed.reshape(G * gs_half, N))
  he8, s_e = int8_matmul.rowquant_int8(h[:, 0::2])
  ho8, s_o = int8_matmul.rowquant_int8(h[:, 1::2])
  out = torch.zeros((h.shape[0], N), dtype=torch.float32)
  for k0, k1 in split_ranges(h.shape[1], splits):
    total = torch.zeros_like(out)
    p = k0 // 2
    while p < k1 // 2:
      g = p // gs_half
      e = min(k1 // 2, (g + 1) * gs_half)
      pe = (he8[:, p:e].to(torch.int64) @ lo[p:e].to(torch.int64)).to(torch.float32)
      po = (ho8[:, p:e].to(torch.int64) @ hi[p:e].to(torch.int64)).to(torch.float32)
      total += (pe * s_e + po * s_o) * gscale[g].to(torch.float32)[None, :]
      p = e
    out += total
  return out.to(h.dtype)


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("K,gs,N,sm_count", K5_CASES)
def test_w4a8_split_sums_match_the_unsplit_plain_version(K, gs, N, sm_count, rows):
  h, w = _inputs(rows, K, N, 13 * K + N + rows)
  jpk, jgs = jq.quantize_tensor_grouped(jnp.asarray(w[None]), jnp.float32, group_size=gs)
  pk, gsc = torch.from_numpy(np.array(jpk)[0]), torch.from_numpy(np.array(jgs)[0])
  _, splits = gemv_plan(8, K, N, sm_count)  # the cluster kernels' ranges
  assert splits > 1 or K <= GEMV_KSTEP
  for dtype in (torch.float32, torch.bfloat16):
    ht, gst = torch.from_numpy(h).to(dtype), gsc.to(dtype)
    want = int4_matmul.int4_w4a8_matmul_ref(ht, pk, gst).float()
    got = _k5v4_split_sum(ht, pk, gst, splits).float()
    atol = 2.0 ** -7 * want.abs().max().item()
    torch.testing.assert_close(got, want, atol=atol, rtol=0)
  want = np.asarray(j_int4_grouped_matmul(jnp.asarray(h), jpk[0], jgs[0], block_out=N,
                                          interpret=True, variant=4))
  got = _k5v4_split_sum(torch.from_numpy(h), pk, gsc, splits).numpy()
  np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
