"""The port's ring attention (ops/ring_attention.py) against the JAX package's, on the
CPU: tests/test_ring_attention.py one for one.

The same numpy-seeded inputs go through the port's `ring_attention_sharded` over an sp
mesh of XOT_VIRTUAL_DEVICES=8 CPU positions and through JAX's on its virtual 8-device
CPU mesh (JAX's matmul precision pinned to 'highest'), and through the plain causal
GQA attention of each package. fp32 throughout: outputs within 1e-5 absolute and
relative (JAX's own tolerance against its baseline), the gradients within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from xotorch_tpu.ops.attention import gqa_attention as j_gqa_attention
from xotorch_tpu.ops.ring_attention import ring_attention_sharded as j_ring_attention_sharded
from xotorch_tpu_torch.ops.attention import gqa_attention
from xotorch_tpu_torch.ops.ring_attention import ring_attention_sharded
from xotorch_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _eight_positions(monkeypatch):
  monkeypatch.setenv("XOT_VIRTUAL_DEVICES", "8")
  with jax.default_matmul_precision("highest"):
    yield


def _mesh(n):
  return make_mesh({"sp": n})


def _j_mesh(n):
  return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _inputs(B, T, Hq, Hkv, D, seed=0):
  rng = np.random.default_rng(seed)
  return tuple(rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))


def _baseline(q, k, v):
  B, T = q.shape[0], q.shape[1]
  pos = torch.arange(T)[None, :].repeat(B, 1)
  return gqa_attention(q, k, v, pos, torch.full((B,), T, dtype=torch.int32))


def _t(arrays):
  return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_ring_matches_baseline(n_dev):
  """The port's ring over sp = n_dev against its plain attention and JAX's ring."""
  arrays = _inputs(2, 128, 4, 2, 32)
  out = ring_attention_sharded(*_t(arrays), _mesh(n_dev))
  np.testing.assert_allclose(out.numpy(), _baseline(*_t(arrays)).numpy(), **TOL)
  want = j_ring_attention_sharded(*(jnp.asarray(a) for a in arrays), _j_mesh(n_dev))
  np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_ring_gqa_and_single_device():
  """Four q heads per kv head, over one position and over eight, against the plain
  attention and JAX's ring; the sp x tp mesh (heads over tp) too."""
  arrays = _inputs(1, 64, 8, 2, 16, seed=4)
  ref = _baseline(*_t(arrays)).numpy()
  for mesh in (_mesh(1), _mesh(8), make_mesh({"sp": 4, "tp": 2})):
    np.testing.assert_allclose(ring_attention_sharded(*_t(arrays), mesh).numpy(), ref, **TOL)
  pos = jnp.arange(64, dtype=jnp.int32)[None, :]
  j_ref = j_gqa_attention(*(jnp.asarray(a) for a in arrays), pos, jnp.full((1,), 64, jnp.int32))
  np.testing.assert_allclose(ref, np.asarray(j_ref), **TOL)


def test_ring_causality():
  """Mutating the tail of the sequence does not change earlier outputs."""
  q, k, v = _t(_inputs(1, 64, 2, 2, 16, seed=9))
  mesh = _mesh(4)
  out1 = ring_attention_sharded(q, k, v, mesh)
  k2, v2 = k.clone(), v.clone()
  k2[:, 48:] = 7.0
  v2[:, 48:] = -7.0
  out2 = ring_attention_sharded(q, k2, v2, mesh)
  np.testing.assert_allclose(out1[:, :48].numpy(), out2[:, :48].numpy(), atol=1e-6)


def test_ring_differentiable():
  """Gradients flow through the rotations: autograd of the port's ring equals the
  plain attention's and JAX's grad of its ring."""
  arrays = _inputs(1, 32, 2, 2, 16, seed=2)
  mesh = _mesh(4)

  def grads(fn):
    qkv = [t.clone().requires_grad_(True) for t in _t(arrays)]
    (fn(*qkv) ** 2).sum().backward()
    return [t.grad.numpy() for t in qkv]

  g_ring = grads(lambda q, k, v: ring_attention_sharded(q, k, v, mesh))
  g_base = grads(_baseline)
  j_mesh = _j_mesh(4)
  g_jax = jax.grad(lambda qkv: (j_ring_attention_sharded(*qkv, j_mesh) ** 2).sum())(
    tuple(jnp.asarray(a) for a in arrays))
  for gr, gb, gj in zip(g_ring, g_base, g_jax):
    np.testing.assert_allclose(gr, gb, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gr, np.asarray(gj), atol=1e-4, rtol=1e-4)
