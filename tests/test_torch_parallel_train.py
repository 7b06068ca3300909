"""Training over the port's local mesh (parallel/{mesh,zero,collectives}.py, the
transformer's training forward over a mesh, train/step.py) against the JAX package's,
on the CPU.

One for one the four tests of tests/test_parallel_train.py on a dp 4 x tp 2 mesh, at
JAX's tolerances, then what the port adds around them: sequence-parallel steps through
ring attention (against JAX's make_train_step(ring_mesh=) on its sp mesh), an
expert-parallel qwen3-moe step, the dp denominator with a control that must miss, LoRA
over the mesh, and moments files of a ZeRO-1 state crossing between the packages.
XOT_VIRTUAL_DEVICES=8 gives the port eight positions on the CPU, as conftest's
--xla_force_host_platform_device_count=8 gives JAX; JAX's weights cross with
params_from_jax. Every mesh step is also held to the port's own unsharded step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train import _flat, _model, _np, _variant
from xotorch_tpu.parallel.mesh import make_mesh as j_make_mesh
from xotorch_tpu.parallel.mesh import shard_params as j_shard_params
from xotorch_tpu.train import lora as j_lora
from xotorch_tpu.train import optstate as j_optstate
from xotorch_tpu.train import step as j_step
from xotorch_tpu_torch.models import transformer
from xotorch_tpu_torch.ops import flash_attention as fa
from xotorch_tpu_torch.parallel import (MeshAdamW, gather_params, make_mesh, moment_bytes_per_device,
                                        shard_params, zero1_constraint, zero1_shard_opt_state,
                                        zero1_spec)
from xotorch_tpu_torch.parallel.mesh import dp_rows
from xotorch_tpu_torch.train import lora, optstate, step

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _mesh_env(monkeypatch):
  monkeypatch.setenv("XOT_VIRTUAL_DEVICES", "8")
  with jax.default_matmul_precision("highest"):
    yield


def _batch(cfg, B=4, T=16, seed=0):
  """JAX's test batch: random tokens and targets, lengths 4..T (unequal rows)."""
  rng = np.random.RandomState(seed)
  return {"inputs": rng.randint(0, cfg.vocab_size, (B, T)),
          "targets": rng.randint(0, cfg.vocab_size, (B, T)),
          "lengths": rng.randint(4, T + 1, (B,))}


def _jb(b):
  return {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}


def _pb(b):
  return {k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in b.items()}


def _leaves_close(got, want, atol, rtol=0.0):
  g, w = _flat(got), _flat(want)
  assert sorted(g) == sorted(w)
  for path in w:
    np.testing.assert_allclose(_np(g[path]), np.asarray(w[path]), atol=atol, rtol=rtol,
                               err_msg="/".join(path))


def _jax_steps(jp, jcfg, optimizer, batches, **kw):
  stepf = j_step.make_train_step(jcfg, optimizer, **kw)
  params = jax.tree.map(jnp.asarray, jp)
  state = optimizer.init(j_step.trainable_subtree(params))
  losses = []
  for b in batches:
    params, state, loss = stepf(params, state, _jb(b))
    losses.append(float(loss))
  return jax.tree.map(np.asarray, params), state, losses


def _port_steps(params, cfg, optimizer, batches, **kw):
  stepf = step.make_train_step(cfg, optimizer, **kw)
  return [float(stepf(params, _pb(b))) for b in batches]


@pytest.fixture(scope="module")
def tiny():
  """synthetic-tiny on JAX's PRNGKey(0) draw, and JAX's two unsharded AdamW(1e-3) steps
  over batches of seed 0 and 1: the reference of the first and the fourth test."""
  cfg, jcfg, jp, _ = _model("synthetic-tiny", seed=0)
  batches = [_batch(cfg, seed=0), _batch(cfg, seed=1)]
  with jax.default_matmul_precision("highest"):
    p1, _, l1 = _jax_steps(jp, jcfg, optax.adamw(1e-3), batches[:1])
    p2, _, l2 = _jax_steps(jp, jcfg, optax.adamw(1e-3), batches)
  return {"cfg": cfg, "jcfg": jcfg, "jp": jp, "batches": batches, "p1": p1, "loss1": l1[0],
          "p2": p2, "loss2": l2[-1]}


def _fresh(tiny):
  from xotorch_tpu_torch.models.weights import params_from_jax
  return params_from_jax(tiny["jp"], tiny["cfg"])


# ------------------------------------------------------ tests/test_parallel_train.py


def test_sharded_step_matches_unsharded(tiny):
  """JAX's first test: one AdamW step on a dp 4 x tp 2 mesh equals the unsharded step,
  the port's and JAX's (loss rtol 1e-5, every leaf atol 1e-5)."""
  cfg, b = tiny["cfg"], tiny["batches"][0]
  plain = _fresh(tiny)
  loss_plain = _port_steps(plain, cfg, lora.optimizer_for(plain, 1e-3), [b])[0]
  mesh = make_mesh({"dp": 4, "tp": 2})
  mp = shard_params(_fresh(tiny), mesh)
  loss = _port_steps(mp, cfg, lora.optimizer_for(mp, 1e-3), [b])[0]
  np.testing.assert_allclose(loss, tiny["loss1"], rtol=1e-5)
  np.testing.assert_allclose(loss, loss_plain, rtol=1e-5)
  _leaves_close(gather_params(mp), tiny["p1"], atol=1e-5)
  _leaves_close(gather_params(mp), {k: v for k, v in plain.items()}, atol=1e-5)


def test_loss_decreases_over_steps(tiny):
  """JAX's second test on the mesh: eight AdamW(5e-3) steps on one batch lower the loss
  by more than a tenth, step for step with JAX's unsharded run."""
  cfg, jcfg = tiny["cfg"], tiny["jcfg"]
  _, _, jp, pp = _model("synthetic-tiny", seed=1)
  b = _batch(cfg, seed=3)
  _, _, want = _jax_steps(jp, jcfg, optax.adamw(5e-3), [b] * 8)
  mp = shard_params(pp, make_mesh({"dp": 4, "tp": 2}))
  losses = _port_steps(mp, cfg, lora.optimizer_for(mp, 5e-3), [b] * 8)
  assert losses[-1] < losses[0] * 0.9, losses
  np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_pipelined_shard_grads_match_full_autodiff(tiny):
  """JAX's third test with both shards on the dp 4 x tp 2 mesh: the forward chained
  through two MeshParams shards and the gradients chained back equal end-to-end
  autodiff (JAX's), loss rtol 1e-5 and gradients atol 1e-5."""
  cfg, jcfg, jp = tiny["cfg"], tiny["jcfg"], tiny["jp"]
  n = cfg.num_layers
  b = _batch(cfg, B=4, T=8, seed=5)
  loss_ref, grads_ref = jax.value_and_grad(
    lambda p: j_step.full_model_loss(p, _jb(b), jcfg))(jax.tree.map(jnp.asarray, jp))
  pp = _fresh(tiny)
  p1 = {"layers": {k: v[: n // 2] for k, v in pp["layers"].items()}, "embed": pp["embed"]}
  p2 = {"layers": {k: v[n // 2:] for k, v in pp["layers"].items()},
        "final_norm": pp["final_norm"], "lm_head": pp["lm_head"]}
  mesh = make_mesh({"dp": 4, "tp": 2})
  m1, m2 = shard_params(p1, mesh), shard_params(p2, mesh)
  pb = _pb(b)
  with torch.no_grad():
    hidden = step.training_forward(m1, pb["inputs"], cfg, True, False)
  loss2, x_grad, g2 = step.shard_loss_and_grads(m2, cfg, hidden, pb["targets"], pb["lengths"],
                                                False, True, start_layer=n // 2)
  _, _, g1 = step.shard_loss_and_grads(m1, cfg, pb["inputs"], x_grad, pb["lengths"], True, False)
  np.testing.assert_allclose(float(loss2), float(loss_ref), rtol=1e-5)
  np.testing.assert_allclose(_np(g2["lm_head"]), np.asarray(grads_ref["lm_head"]), atol=1e-5)
  np.testing.assert_allclose(_np(g1["layers"]["wq"]), np.asarray(grads_ref["layers"]["wq"][: n // 2]),
                             atol=1e-5)
  np.testing.assert_allclose(_np(g1["embed"]["embedding"]),
                             np.asarray(grads_ref["embed"]["embedding"]), atol=1e-5)
  np.testing.assert_allclose(_np(g2["layers"]["w_down"]),
                             np.asarray(grads_ref["layers"]["w_down"][n // 2:]), atol=1e-5)


def test_zero1_sharded_optimizer_state(tiny):
  """JAX's fourth test: AdamW's moments split over dp (parallel/zero.py), params after
  two steps within JAX's atol 2e-4 / rtol 2e-3 of the unsharded run, a dp-split moment
  at rest after the step, and the moments position 0 holds under half the replicated
  state's."""
  cfg, batches = tiny["cfg"], tiny["batches"]
  mesh = make_mesh({"dp": 4, "tp": 2})
  mp = shard_params(_fresh(tiny), mesh)
  opt = lora.optimizer_for(mp, 1e-3)
  repl_bytes = moment_bytes_per_device(opt)
  opt = zero1_shard_opt_state(opt, mesh)
  losses = _port_steps(mp, cfg, opt, batches, opt_sharding_fn=zero1_constraint(mesh))
  assert abs(losses[-1] - tiny["loss2"]) <= 1e-3 * max(1.0, abs(tiny["loss2"]))
  _leaves_close(gather_params(mp), tiny["p2"], atol=2e-4, rtol=2e-3)
  assert any("dp" in spec for spec in opt.moment_specs), opt.moment_specs
  i = next(i for i, s in enumerate(opt.moment_specs) if "dp" in s)
  dim = opt.moment_specs[i].index("dp")
  c, stepped = opt.shards[i][0][0]
  assert opt.optimizer.state[stepped]["exp_avg"].shape[dim] == opt.shapes[i][dim] // 4
  assert opt.optimizer.state[stepped]["exp_avg"].data_ptr() != stepped.data_ptr()
  sharded_bytes = moment_bytes_per_device(opt)
  assert sharded_bytes * 2 < repl_bytes, f"{sharded_bytes} !<< {repl_bytes}"


def test_zero1_spec_matches_jax():
  """The moment specs of every synthetic-tiny leaf equal JAX's zero1_spec on the same
  mesh shape (None for an unsplit dimension)."""
  from xotorch_tpu.parallel.zero import zero1_spec as j_zero1_spec
  _, _, jp, pp = _model("synthetic-tiny")
  jmesh, mesh = j_make_mesh({"dp": 4, "tp": 2}), make_mesh({"dp": 4, "tp": 2})
  for path, t in step.leaf_paths(pp):
    want = tuple(j_zero1_spec(path[-1], t.shape, jmesh))
    got = zero1_spec(path[-1], t.shape, mesh)
    assert got + (None,) * (len(want) - len(got)) == want + (None,) * (len(got) - len(want)), path


# ------------------------------------------------------------- the dp denominator


def test_dp_loss_divides_by_the_global_count(tiny):
  """Over dp 4 each replica's masked sum is divided by the count over the whole batch:
  the loss equals JAX's masked_ce_loss over the global batch (rtol 1e-5), while the
  control, a mean per replica averaged over replicas, misses that limit (the rows'
  lengths differ)."""
  cfg, b = tiny["cfg"], tiny["batches"][0]
  assert len(set(b["lengths"].tolist())) > 1
  mesh = make_mesh({"dp": 4, "tp": 2})
  mp = shard_params(_fresh(tiny), mesh)
  want = float(j_step.full_model_loss(jax.tree.map(jnp.asarray, tiny["jp"]), _jb(b), tiny["jcfg"]))
  pb = _pb(b)
  with torch.no_grad():
    got = float(step.full_model_loss(mp, pb, cfg))
    outs = transformer.forward_replicas(mp, pb["inputs"], cfg, True, True, route=step.TRAIN_ROUTE)
    per_replica = [float(step.masked_ce_loss(o, t, n)) for o, t, n in
                   zip(outs, dp_rows(pb["targets"], mesh), dp_rows(pb["lengths"], mesh))]
  np.testing.assert_allclose(got, want, rtol=1e-5)
  control = float(np.mean(per_replica))
  assert abs(control - want) > 1e-5 * abs(want), (control, want)


# ------------------------------------------------------------------ sp and ep


@pytest.mark.parametrize("axes", [{"sp": 2}, {"sp": 2, "tp": 2}], ids=["sp2", "sp2xtp2"])
def test_sp_step_through_ring_attention(tiny, axes, monkeypatch):
  """A sequence-parallel AdamW step (ring attention over sp, no cache) equals the
  unsharded step and JAX's make_train_step(ring_mesh=) on its own sp mesh: loss rtol
  1e-5, leaves atol 1e-5; K1 is not called (the ring replaces it)."""
  cfg, jcfg, b = tiny["cfg"], tiny["jcfg"], tiny["batches"][0]
  jmesh = j_make_mesh(axes)
  with jmesh:
    jsp = j_shard_params(jax.tree.map(jnp.asarray, tiny["jp"]), jmesh)
    opt = optax.adamw(1e-3)
    jparams, _, jloss = j_step.make_train_step(jcfg, opt, ring_mesh=jmesh)(jsp, opt.init(jsp), _jb(b))
  calls = []
  monkeypatch.setattr(transformer, "flash_attention_train", lambda *a, **k: calls.append(1))
  mesh = make_mesh(axes)
  mp = shard_params(_fresh(tiny), mesh)
  loss = _port_steps(mp, cfg, lora.optimizer_for(mp, 1e-3), [b], ring_mesh=mesh)[0]
  assert calls == []
  np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
  np.testing.assert_allclose(loss, tiny["loss1"], rtol=1e-5)
  _leaves_close(gather_params(mp), jax.tree.map(np.asarray, jparams), atol=1e-5)
  _leaves_close(gather_params(mp), tiny["p1"], atol=1e-5)


def test_ring_mesh_must_be_the_params_mesh(tiny):
  mp = shard_params(_fresh(tiny), make_mesh({"sp": 2}))
  with pytest.raises(ValueError, match="ring_mesh"):
    step.full_model_loss(mp, _pb(tiny["batches"][0]), tiny["cfg"], ring_mesh=make_mesh({"sp": 2}))


def test_ep_moe_step_matches_unsharded():
  """An ep 2 x tp 2 qwen3-moe-tiny AdamW step (each position its resident experts with
  the dense combine, the router replicated) equals the unsharded step, the port's and
  JAX's: loss rtol 1e-5, leaves atol 1e-5."""
  cfg, jcfg, jp, pp = _model("synthetic-tiny-moe")
  b = _batch(cfg, seed=2, B=2, T=12)
  jparams, _, jloss = _jax_steps(jp, jcfg, optax.adamw(1e-3), [b])
  plain_loss = _port_steps(pp, cfg, lora.optimizer_for(pp, 1e-3), [b])[0]
  _, _, _, pp2 = _model("synthetic-tiny-moe")
  mp = shard_params(pp2, make_mesh({"ep": 2, "tp": 2}))
  loss = _port_steps(mp, cfg, lora.optimizer_for(mp, 1e-3), [b])[0]
  np.testing.assert_allclose(loss, jloss[0], rtol=1e-5)
  np.testing.assert_allclose(loss, plain_loss, rtol=1e-5)
  _leaves_close(gather_params(mp), jparams, atol=1e-5)
  _leaves_close(gather_params(mp), pp, atol=1e-5)


# ----------------------------------------------------------------- LoRA on the mesh


@pytest.mark.parametrize("kind", ["lora", "qlora"])
def test_lora_steps_on_the_mesh_match_optax(kind, monkeypatch):
  """Adapters replicated over a dp 2 x tp 2 mesh (each tp position its views: B's
  out-columns on wq/wk/wv, A's in-rows on wo), three masked AdamW steps: losses within
  1e-5 of optax's masked run, adapters within 1e-3 x lr a step (eps 1e-4, as
  tests/test_torch_train.py holds the unsharded port), the base bit for bit."""
  cfg, jcfg, jp, pp = _variant(kind)
  batches = [_batch(cfg, B=2, T=10, seed=s) for s in range(3)]
  lr, eps = 1e-2, 1e-4
  monkeypatch.setattr(lora, "ADAMW_EPS", eps)
  jparams = jax.tree.map(jnp.asarray, jp)
  jopt = j_lora.masked_optimizer(optax.adamw(lr, eps=eps), jparams)
  want_params, _, want = _jax_steps(jp, jcfg, jopt, batches)
  mp = shard_params({**pp, "layers": {k: v for k, v in pp["layers"].items() if not k.startswith("lora_")}},
                    make_mesh({"dp": 2, "tp": 2}))
  from xotorch_tpu_torch.parallel.mesh import with_layers
  mp = with_layers(mp, {k: v for k, v in pp["layers"].items() if k.startswith("lora_")})
  base = {k: v.clone() for k, v in mp.pieces[1]["layers"].items() if not k.startswith("lora_")}
  opt = lora.masked_optimizer(mp, lr)
  assert [p[-1] for p in opt.paths] == sorted(k for k in pp["layers"] if k.startswith("lora_"))
  losses = _port_steps(mp, cfg, opt, batches)
  np.testing.assert_allclose(losses, want, rtol=1e-5)
  got = gather_params(mp)
  for k in got["layers"]:
    if k.startswith("lora_"):
      np.testing.assert_allclose(_np(got["layers"][k]), want_params["layers"][k], rtol=0,
                                 atol=1e-3 * lr * len(batches), err_msg=k)
  for k, v in mp.pieces[1]["layers"].items():
    if not k.startswith("lora_"):
      assert torch.equal(v, base[k]), k


# ------------------------------------------------------------------ moments files


def test_zero_moments_file_crosses_between_the_packages(tiny, tmp_path):
  """A ZeRO-1 state over dp 4 x tp 2 is written in JAX's layout (whole leaves, gathered):
  JAX's loader reads the port's file after two steps, value for value, and JAX's file
  loads into a fresh ZeRO state whose whole moments equal JAX's."""
  cfg, jcfg, batches = tiny["cfg"], tiny["jcfg"], tiny["batches"]
  mesh = make_mesh({"dp": 4, "tp": 2})
  mp = shard_params(_fresh(tiny), mesh)
  opt = zero1_shard_opt_state(lora.optimizer_for(mp, 1e-3), mesh)
  _port_steps(mp, cfg, opt, batches)
  optstate.save_opt_state(opt, opt.leaves, tmp_path / "port.safetensors")
  jopt = optax.adamw(1e-3)
  template = jopt.init(j_step.trainable_subtree(jax.tree.map(jnp.asarray, tiny["jp"])))
  restored = jax.tree_util.tree_leaves(j_optstate.load_opt_state(template, tmp_path / "port.safetensors"))
  count, ms, vs = opt.whole_moments()
  n = len(ms)
  assert int(restored[0]) == count == 2 and len(restored) == 1 + 2 * n
  for i in range(n):
    np.testing.assert_array_equal(np.asarray(restored[1 + i]), _np(ms[i]))
    np.testing.assert_array_equal(np.asarray(restored[1 + n + i]), _np(vs[i]))
  _, jstate, _ = _jax_steps(tiny["jp"], jcfg, jopt, batches)
  j_optstate.save_opt_state(jstate, tmp_path / "jax.safetensors")
  fresh = zero1_shard_opt_state(lora.optimizer_for(shard_params(_fresh(tiny), mesh), 1e-3), mesh)
  optstate.load_opt_state(fresh, fresh.leaves, tmp_path / "jax.safetensors")
  jleaves = jax.tree_util.tree_leaves(jstate)
  count, ms, vs = fresh.whole_moments()
  assert count == int(jleaves[0]) == 2
  for i in range(n):
    np.testing.assert_array_equal(_np(ms[i]), np.asarray(jleaves[1 + i]))
    np.testing.assert_array_equal(_np(vs[i]), np.asarray(jleaves[1 + n + i]))


def test_copies_on_distinct_devices_share_one_summed_update():
  """The gradient sum goes per distinct tensor: on a mesh whose two tp positions are
  distinct tensors of one replicated leaf (two 'devices' that are both the CPU, built
  by hand), each copy receives the sum of both terms and takes the same step; a mesh
  that shares one tensor sums nothing twice."""
  from xotorch_tpu_torch.parallel.mesh import MeshParams
  mesh = make_mesh({"tp": 2})
  w = torch.ones(4)
  shared = MeshParams(mesh, [{"n": w}, {"n": w}], {"n": ()})
  copies = MeshParams(mesh, [{"n": w.clone()}, {"n": w.clone()}], {"n": ()})
  for mp, grads in ((shared, [torch.full((4,), 3.0)]),
                    (copies, [torch.full((4,), 1.0), torch.full((4,), 2.0)])):
    opt = MeshAdamW(mp, [("n",)], 0.1)
    assert len(opt.leaves) == len(grads)
    opt.apply(grads)
    for piece in mp.pieces:
      torch.testing.assert_close(piece["n"], shared.pieces[0]["n"], rtol=0, atol=0)


def test_each_tp_position_calls_k1_and_k1b_on_its_heads(tiny, monkeypatch):
  """The training forward over tp 2 calls K1's function (and its backward K1b's) once a
  layer at each tp position, on Hq/tp query heads over Hkv/tp kv heads."""
  cfg = tiny["cfg"]
  seen = []
  real = fa.flash_attention_bwd_ref

  def bwd(q, k, v, dout, **kw):
    seen.append(("bwd", q.shape[2], k.shape[2]))
    return real(q, k, v, dout, **kw)

  monkeypatch.setattr(fa, "flash_attention_bwd_ref", bwd)
  real_fwd = fa.flash_attention_train

  def fwd(q, k, v, **kw):
    seen.append(("fwd", q.shape[2], k.shape[2]))
    return real_fwd(q, k, v, **kw)

  monkeypatch.setattr(transformer, "flash_attention_train", fwd)
  mp = shard_params(_fresh(tiny), make_mesh({"tp": 2}))
  _port_steps(mp, cfg, lora.optimizer_for(mp, 1e-3), [tiny["batches"][0]])
  heads = (cfg.num_heads // 2, cfg.num_kv_heads // 2)
  assert sorted(seen) == sorted([("fwd",) + heads, ("bwd",) + heads] * (2 * cfg.num_layers))
