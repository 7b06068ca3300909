"""`models/generate.forward_paged` on the port against the JAX package's, on the CPU:
the full-logits forward over a page arena, at fp32 with JAX's matmul precision pinned
to 'highest'. Two requests fill one arena through shuffled page tables: a segment from
position 0 and one at a position > 0 (K4's plain version), then both rows' decode steps
at their own positions (K3's), against JAX's forward_paged with its Pallas ragged
kernel in interpret mode and with its XLA gather. The logits agree within 1e-4 and the
written pages within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_paged import _cfgs, _jax_params, _shuffled_table
from xotorch_tpu.models import generate as j_generate
from xotorch_tpu_torch.models import generate, transformer
from xotorch_tpu_torch.models.weights import params_from_jax
from xotorch_tpu_torch.ops import paged_attention

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _highest_precision():
  with jax.default_matmul_precision("highest"):
    yield


@pytest.mark.parametrize("use_kernel", [True, False], ids=["pallas-interpret", "xla-gather"])
def test_forward_paged_matches_jax(use_kernel, monkeypatch):
  calls = {"decode": 0, "prefill": 0}
  for kind, name in (("decode", "paged_decode_attention"), ("prefill", "paged_prefill_attention")):
    real = getattr(paged_attention, name)

    def counted(*a, kind=kind, real=real, **kw):
      calls[kind] += 1
      return real(*a, **kw)
    monkeypatch.setattr(transformer, name, counted)
  jcfg, cfg = _cfgs()
  jp = _jax_params(jcfg)
  params = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
  rng = np.random.default_rng(27)
  L, page, P, maxp = cfg.num_layers, 16, 20, 5
  firsts = [rng.integers(3, 256, size=(1, n)).astype(np.int32) for n in (21, 9)]
  seconds = [rng.integers(3, 256, size=(1, n)).astype(np.int32) for n in (12, 30)]
  table = _shuffled_table(rng, P, [a.shape[1] + b.shape[1] + 1 for a, b in zip(firsts, seconds)],
                          page, maxp)
  shape = (L, P, page, cfg.num_kv_heads, cfg.head_dim)
  jarena = {n: jnp.zeros(shape, jnp.float32) for n in ("k", "v")}
  arena = {n: torch.zeros(shape) for n in ("k", "v")}
  ends = []
  for b in range(2):
    pos = 0
    for toks in (firsts[b], seconds[b]):
      jl, jarena = j_generate.forward_paged(jp, jnp.asarray(toks), jarena, jnp.asarray(table[b:b + 1]),
                                            jnp.int32(pos), jcfg, use_kernel=use_kernel)
      tl, arena = generate.forward_paged(params, torch.from_numpy(toks).long(), arena,
                                         torch.from_numpy(table[b:b + 1]), pos, cfg)
      assert tl.dtype == torch.float32 and tl.shape == (1, toks.shape[1], cfg.vocab_size)
      np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
      pos += toks.shape[1]
    ends.append(pos)
  step = np.array([[int(rng.integers(3, 256))], [int(rng.integers(3, 256))]], np.int32)
  pos = np.array(ends, np.int32)
  jl, jarena = j_generate.forward_paged(jp, jnp.asarray(step), jarena, jnp.asarray(table),
                                        jnp.asarray(pos), jcfg, use_kernel=use_kernel)
  tl, arena = generate.forward_paged(params, torch.from_numpy(step).long(), arena,
                                     torch.from_numpy(table), torch.from_numpy(pos), cfg)
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
  real = np.unique(table[table > 0])
  for n in ("k", "v"):
    np.testing.assert_allclose(arena[n].numpy()[:, real], np.asarray(jarena[n])[:, real], atol=1e-5)
  # Four segments through K4's plain version and one decode step through K3's, a layer each.
  assert calls == {"prefill": 4 * L, "decode": L}
