"""The port's training leaf (xotorch_tpu_torch/train/{dataset,step,optstate,lora}.py, K1's
autograd Function, the engine's train_example / evaluate_example, the train and eval
commands) against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages; JAX's weights cross
with params_from_jax. Everything runs in fp32 with JAX's matmuls at "highest":

- batches: equal to JAX's, element for element;
- losses and every gradient: within 1e-5 of the largest |value| of each leaf (fp32
  sums in another order);
- AdamW steps against optax.adamw (full, masked LoRA, QLoRA over int8): losses within
  1e-5, parameters within 1e-3 x lr a step, with eps 1e-4 on both sides. Adam divides
  each gradient element by its own running size (or eps): a gradient error of 1e-5 of
  the leaf's largest |g| becomes up to 1e-5 x max|g| / eps of a step for an element
  whose gradient is small, so at the default eps (1e-8) a few elements whose gradients
  cancel differ by a good share of their step (3.2e-5 seen on 40 of w_down's 32768
  elements at lr 1e-2; 4e-6 on 3 embedding elements at eps 1e-4). The defaults
  themselves are held equal to optax's separately;
- the engines' losses over three steps within 1e-4.

Then JAX's own training cases of tests/test_lora.py, tests/test_quantize.py and
tests/test_cli_wiring.py run on the port.
"""
import argparse
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_model_equivalence import TINY_LLAMA_CFG, make_hf_checkpoint
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import quantize as jq
from xotorch_tpu.models import registry as j_registry
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.models.transformer import init_random_params as j_init_random_params
from xotorch_tpu.ops.attention import gqa_attention as j_gqa_attention
from xotorch_tpu.train import dataset as j_dataset
from xotorch_tpu.train import lora as j_lora
from xotorch_tpu.train import optstate as j_optstate
from xotorch_tpu.train import step as j_step
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.dummy import DummyInferenceEngine
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine import engine as engine_mod
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import quantize as q
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import _SafetensorsFile, params_from_jax
from xotorch_tpu_torch.ops import flash_attention as fa
from xotorch_tpu_torch.train import dataset, lora, optstate, step

torch.set_num_threads(2)

KNOBS = ("XOT_QUANTIZE", "XOT_LORA_RANK", "XOT_LORA_TARGETS", "XOT_ADAPTERS", "XOT_LR",
         "XOT_SAVE_OPT_STATE", "XOT_INT8_KERNEL", "XOT_INT4_KERNEL")
TOL = 1e-5
N = TINY_LLAMA_CFG["num_hidden_layers"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  for name in KNOBS:
    monkeypatch.delenv(name, raising=False)
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_SEED", "7")
  with jax.default_matmul_precision("highest"):
    yield


def _np(x):
  return np.asarray(x.detach()) if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=TOL, what=""):
  got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(float(np.abs(want).max()), 1e-6)
  err = float(np.abs(got - want).max())
  assert err <= tol * scale, f"{what}: max error {err:.3e} against {tol:.0e} x {scale:.3e}"


def _flat(tree, prefix=()):
  """{key path: leaf} of a nested dict (JAX's or the port's)."""
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat(v, prefix + (k,)))
    else:
      out[prefix + (k,)] = v
  return out


def _trees_close(got, want, tol=TOL):
  g, w = _flat(got), _flat(want)
  assert sorted(g) == sorted(w)
  for path in w:
    _close(g[path], w[path], tol, what="/".join(path))


def _model(name="synthetic-tiny", seed=0):
  """(port cfg, JAX cfg, JAX params as numpy, port params) of a synthetic card at full
  depth, JAX's draw carried across."""
  hf = get_model_card(name)["synthetic_config"]
  cfg, jcfg = config_from_hf_dict(hf), j_config_from_hf_dict(hf)
  jp = jax.tree.map(np.asarray, j_init_random_params(jcfg, jcfg.num_layers, True, True,
                                                     jax.random.PRNGKey(seed), dtype=jnp.float32))
  return cfg, jcfg, jp, params_from_jax(jp, cfg)


def _batch(seed=0, B=2, T=12, vocab=256, short=True):
  rng = np.random.default_rng(seed)
  x = rng.integers(3, vocab, (B, T + 1))
  lengths = np.full((B,), T, np.int64)
  if short:
    lengths[-1] = T - 5  # a padded row: its tail is masked out of the loss
  return x[:, :-1], x[:, 1:], lengths


def _jbatch(inputs, targets, lengths):
  return {"inputs": jnp.asarray(inputs, jnp.int32), "targets": jnp.asarray(targets, jnp.int32),
          "lengths": jnp.asarray(lengths, jnp.int32)}


def _pbatch(inputs, targets, lengths):
  return {"inputs": torch.from_numpy(np.asarray(inputs)), "targets": torch.from_numpy(np.asarray(targets)),
          "lengths": torch.from_numpy(np.asarray(lengths))}


class HashTokenizer:
  """Words to ids by a fixed hash: batches of varied ids and lengths."""

  def encode(self, text):
    import zlib
    return [3 + zlib.crc32(w.encode()) % 250 for w in text.split()]


# ------------------------------------------------------------------------ dataset


def test_data_copy_is_the_jax_packages():
  from pathlib import Path
  ours, theirs = Path(dataset.DEFAULT_DATA), Path(j_dataset.__file__).parent / "data" / "lora"
  for name in ("train.jsonl", "valid.jsonl", "test.jsonl"):
    assert (ours / name).read_bytes() == (theirs / name).read_bytes()


@pytest.mark.parametrize("train,seed,batch,max_len", [(True, 0, 4, 512), (True, 3, 3, 6),
                                                       (False, 0, 1, 512)])
def test_batches_match_jax(train, seed, batch, max_len):
  tok = HashTokenizer()
  ours = dataset.load_dataset(dataset.DEFAULT_DATA)
  theirs = j_dataset.load_dataset(dataset.DEFAULT_DATA)
  for split in range(3):
    got = list(dataset.iterate_batches(ours[split], tok, batch, max_len, train=train, seed=seed))
    want = list(j_dataset.iterate_batches(theirs[split], tok, batch, max_len, train=train, seed=seed))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
      for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)
  rows = [[5, 6, 7, 8], [9], [1, 2, 3, 4, 5, 6, 7, 8, 9]]
  for a, b in zip(dataset.batch_with_lengths(rows, 6), j_dataset.batch_with_lengths(rows, 6)):
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype


def test_load_dataset_refuses_an_empty_directory(tmp_path):
  with pytest.raises(ValueError, match="No training data"):
    dataset.load_dataset(str(tmp_path))


# --------------------------------------------------------------- loss, gradients


def test_masked_ce_loss_matches_jax():
  rng = np.random.default_rng(1)
  logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
  targets = rng.integers(0, 50, (3, 7))
  for lengths in ([7, 3, 1], [0, 0, 0], [7, 7, 7]):
    lengths = np.asarray(lengths)
    want = j_step.masked_ce_loss(jnp.asarray(logits), jnp.asarray(targets, jnp.int32),
                                 jnp.asarray(lengths, jnp.int32))
    got = step.masked_ce_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                              torch.from_numpy(lengths))
    _close(got, want, what=f"lengths {lengths.tolist()}")


@pytest.mark.parametrize("model", ["synthetic-tiny", "synthetic-tiny-gemma2", "synthetic-tiny-moe"])
def test_full_model_loss_and_gradients_match_jax(model):
  """Every parameter's gradient; gemma2 brings the softcap, the window on alternate
  layers, the (1 + w) norms and the tied embedding; the MoE card its router and
  experts through the dense combine (B*T = 40)."""
  cfg, jcfg, jp, pp = _model(model)
  inputs, targets, lengths = _batch(vocab=cfg.vocab_size, T=20)
  jl, jg = jax.value_and_grad(j_step.full_model_loss)(jax.tree.map(jnp.asarray, jp),
                                                      _jbatch(inputs, targets, lengths), jcfg)
  paths = [p for p, _ in step.leaf_paths(pp)]
  leaves = [t for _, t in step.leaf_paths(pp)]
  loss, grads = step.value_and_grad(lambda: step.full_model_loss(pp, _pbatch(inputs, targets, lengths), cfg),
                                    leaves)
  _close(loss, jl, what="loss")
  _trees_close(step.unflatten(paths, grads), jg)
  assert not any(t.requires_grad for t in leaves)  # the leaves require grad for the call only
  want = j_step.make_eval_step(jcfg)(jax.tree.map(jnp.asarray, jp), _jbatch(inputs, targets, lengths))
  _close(step.make_eval_step(cfg)(pp, _pbatch(inputs, targets, lengths)), want, what="eval step")


@pytest.mark.parametrize("groups,window,softcap,scale,D", [
  (1, 0, 0.0, None, 16), (4, 0, 0.0, None, 16), (2, 5, 0.0, None, 16), (4, 4, 30.0, 0.3, 16),
  (2, 4, 50.0, 1 / 16, 256)],  # gemma-2: head_dim 256, softcap 50, query_pre_attn_scalar 256
  ids=["1-0-0.0-None", "4-0-0.0-None", "2-5-0.0-None", "4-4-30.0-0.3", "gemma2-D256"])
def test_attention_function_gradient_matches_jax(groups, window, softcap, scale, D):
  """K1's autograd Function (its plain versions on the CPU) against jax.grad of JAX's
  gqa_attention, the same cotangent."""
  rng = np.random.default_rng(groups * 10 + window)
  B, T, Hkv = 2, 11, 2
  q_, k_, v_ = (rng.standard_normal((B, T, h, D)).astype(np.float32) for h in (Hkv * groups, Hkv, Hkv))
  w = rng.standard_normal((B, T, Hkv * groups, D)).astype(np.float32)
  pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))

  def jfn(q, k, v):
    out = j_gqa_attention(q, k, v, pos, jnp.full((B,), T, jnp.int32), scale=scale,
                          softcap=softcap, window=jnp.int32(window))
    return (out * w).sum()

  want = jax.grad(jfn, argnums=(0, 1, 2))(jnp.asarray(q_), jnp.asarray(k_), jnp.asarray(v_))
  tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q_, k_, v_))
  out = fa.flash_attention_train(tq, tk, tv, window=window, softcap=softcap, scale=scale)
  (out * torch.from_numpy(w)).sum().backward()
  for name, g, j in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
    _close(g, j, what=f"d{name}")
  # The wrapper's plain version gives the same three tensors.
  dq, dk, dv = fa.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), out.detach(),
                                      torch.from_numpy(w), window=window, softcap=softcap, scale=scale)
  for g, j in zip((dq, dk, dv), want):
    _close(g, j)


def test_bwd_wrapper_refuses_what_k1b_is_not_built_for():
  """K1b is built for every head width K1 serves, gemma-2's 256 included: a width
  outside its builds, a missing or mistyped log-sum-exp and a non-bf16 input are refused
  before the device is looked at; what it takes stops at the device check."""
  lse = torch.zeros(1, 4, 2, dtype=torch.float32, device="meta")
  for D in (48, 512):
    x = torch.zeros(1, 4, 2, D, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
      fa.flash_attention_bwd(x, x, x, x, x, lse)
    with pytest.raises(ValueError, match="head_dim"):
      fa.check_bwd_head_dim(D)
  y = torch.zeros(1, 4, 2, 64, dtype=torch.float32, device="meta")
  with pytest.raises(ValueError, match="bf16"):
    fa.flash_attention_bwd(y, y, y, y, y, lse)
  x = torch.zeros(1, 4, 2, 256, dtype=torch.bfloat16, device="meta")
  with pytest.raises(ValueError, match="lse"):
    fa.flash_attention_bwd(x, x, x, x, x)
  with pytest.raises(ValueError, match="lse must be contiguous float32"):
    fa.flash_attention_bwd(x, x, x, x, x, lse.bfloat16())
  fa.check_bwd_head_dim(256)
  with pytest.raises(ValueError, match="cuda or cpu"):
    fa.flash_attention_bwd(x, x, x, x, x, lse)
  assert fa.flash_attention_bwd.launches == 0


@pytest.mark.parametrize("groups,window,softcap,scale,empty_row", [
  (1, 0, 0.0, None, False), (4, 0, 0.0, None, False), (4, 5, 0.0, None, False),
  (2, 0, 30.0, 0.3, False), (2, 4, 50.0, 1 / 16, True)])
def test_flash_attention_lse_ref_matches_jax(groups, window, softcap, scale, empty_row):
  """K1's log-sum-exp output, plain version, against jax.nn.logsumexp of JAX's masked
  gqa_attention scores (in base 2), from the same numpy inputs. A row with no visible key
  (batch row 1 with kv_valid_len 0, through gqa_attention_lse) is +inf."""
  from xotorch_tpu_torch.ops.attention import gqa_attention_lse
  rng = np.random.default_rng(groups * 100 + window)
  B, T, Hkv, D = 2, 13, 2, 16
  q_ = rng.standard_normal((B, T, Hkv * groups, D)).astype(np.float32) * 3
  k_ = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
  valid = np.array([T, 0 if empty_row else T], np.int32)
  # JAX's scores, as xotorch_tpu/ops/attention.py::gqa_attention builds and masks them.
  qj = jnp.asarray(q_).reshape(B, T, Hkv, groups, D)
  scores = jnp.einsum("btkgd,bskd->bkgts", qj, jnp.asarray(k_)) * jnp.float32(
    scale if scale is not None else D ** -0.5)
  if softcap:
    scores = jnp.tanh(scores / softcap) * softcap
  pos = jnp.arange(T)
  visible = (pos[None, None, :] <= pos[None, :, None]) & (pos[None, None, :] < jnp.asarray(valid)[:, None, None])
  if window:
    visible = visible & (pos[None, None, :] > pos[None, :, None] - window)
  want = jax.nn.logsumexp(jnp.where(visible[:, None, None], scores, -jnp.inf), axis=-1) / np.log(2.0)
  want = np.asarray(want).transpose(0, 3, 1, 2).reshape(B, T, Hkv * groups)
  tq, tk = torch.from_numpy(q_), torch.from_numpy(k_)
  if empty_row:
    got = gqa_attention_lse(tq, tk, torch.arange(T)[None].expand(B, T), torch.from_numpy(valid),
                            scale=scale, softcap=softcap, window=window)
    assert torch.isinf(got[1]).all() and (got[1] > 0).all()
    assert np.isneginf(want[1]).all()  # JAX's logsumexp of nothing; K1 and its reference store +inf
    got, want = got[:1], want[:1]
  else:
    got = fa.flash_attention_lse_ref(tq, tk, window=window, softcap=softcap, scale=scale)
    assert torch.equal(fa.flash_attention(tq, tk, tk, window=window, softcap=softcap, scale=scale,
                                          lse=True)[1], got)
  _close(got, want, what="lse")


def test_two_shards_match_one_and_jax():
  """shard_loss_and_grads: the last shard's loss, input gradient and parameter
  gradients, then the first shard's pull-back, against one shard and against JAX's."""
  cfg, jcfg, jp, _ = _model()
  inputs, targets, lengths = _batch(T=16)
  half = cfg.num_layers // 2

  def cut(tree, lo, hi, first, last):
    out = {"layers": {k: v[lo:hi] for k, v in tree["layers"].items()}}
    if first or (last and cfg.tie_word_embeddings):
      out["embed"] = tree["embed"]
    if last:
      out["final_norm"] = tree["final_norm"]
      if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    return out

  ja, jb = cut(jp, 0, half, True, False), cut(jp, half, cfg.num_layers, False, True)
  pa, pb = params_from_jax(ja, cfg), params_from_jax(jb, cfg)
  x = torch.from_numpy(inputs)
  h = step.training_forward(pa, x, cfg, True, False)
  loss_b, hx, gb = step.shard_loss_and_grads(pb, cfg, h.detach(), torch.from_numpy(targets),
                                             torch.from_numpy(lengths), False, True, start_layer=half)
  loss_a, zx, ga = step.shard_loss_and_grads(pa, cfg, x, hx, torch.from_numpy(lengths), True, False)
  assert float(loss_a) == 0.0 and zx.shape == (2, 16, cfg.hidden_size) and not zx.any()
  pf = params_from_jax(jp, cfg)
  loss, _, gf = step.shard_loss_and_grads(pf, cfg, x, torch.from_numpy(targets),
                                          torch.from_numpy(lengths), True, True)
  _close(loss_b, loss, what="loss")
  for k in gf["layers"]:
    _close(torch.cat([ga["layers"][k], gb["layers"][k]]), gf["layers"][k], what=k)
  # JAX's pipeline on the same cut.
  jh, _ = j_step.forward_shard(jax.tree.map(jnp.asarray, ja), jnp.asarray(inputs, jnp.int32),
                               j_step.init_kv_cache(jcfg, half, 2, 16, jnp.float32), jnp.int32(0),
                               jcfg, True, False)
  jl, jhx, jgb = j_step.shard_loss_and_grads(jax.tree.map(jnp.asarray, jb), jcfg, jh,
                                             jnp.asarray(targets, jnp.int32),
                                             jnp.asarray(lengths, jnp.int32), False, True,
                                             start_layer=half)
  _, _, jga = j_step.shard_loss_and_grads(jax.tree.map(jnp.asarray, ja), jcfg,
                                          jnp.asarray(inputs, jnp.int32), jhx,
                                          jnp.asarray(lengths, jnp.int32), True, False)
  _close(loss_b, jl)
  _close(hx, jhx, what="input gradient")
  _trees_close(gb, jgb)
  _trees_close(ga, jga)


# -------------------------------------------------------------------- optimizers


def _optax_run(jparams, optimizer, cfg, batches):
  stepf = j_step.make_train_step(cfg, optimizer)
  state = optimizer.init(j_step.trainable_subtree(jparams))
  losses = []
  for b in batches:
    jparams, state, loss = stepf(jparams, state, _jbatch(*b))
    losses.append(float(loss))
  return jparams, state, losses


def _port_run(pparams, optimizer, cfg, batches):
  stepf = step.make_train_step(cfg, optimizer)
  return [float(stepf(pparams, _pbatch(*b))) for b in batches]


def _variant(kind):
  """(port cfg, JAX cfg, JAX params, port params) for `kind`: full, lora or qlora."""
  cfg, jcfg, jp, _ = _model()
  if kind == "qlora":
    jp = jax.tree.map(np.asarray, jq.quantize_params(jax.tree.map(jnp.asarray, jp),
                                                     scale_dtype=jnp.float32))
  if kind != "full":
    jp = j_lora.add_lora_params(jax.tree.map(jnp.asarray, jp), rank=4, key=jax.random.PRNGKey(7))
    # Seeded nonzero B: with B = 0 the A gradients are all zero at the first step.
    rng = np.random.default_rng(5)
    layers = dict(jp["layers"])
    for k in sorted(layers):
      if k.endswith("_b"):
        layers[k] = jnp.asarray((rng.standard_normal(layers[k].shape) * 0.05).astype(np.float32))
    jp = jax.tree.map(np.asarray, {**jp, "layers": layers})
  return cfg, jcfg, jp, params_from_jax(jp, cfg)


@pytest.mark.parametrize("kind", ["full", "lora", "qlora"])
def test_adamw_steps_match_optax(kind, monkeypatch):
  cfg, jcfg, jp, pp = _variant(kind)
  batches = [_batch(seed=s, T=10) for s in range(3)]
  lr, eps = 1e-2, 1e-4
  monkeypatch.setattr(lora, "ADAMW_EPS", eps)
  jparams = jax.tree.map(jnp.asarray, jp)
  if kind == "full":
    jopt = optax.adamw(lr, eps=eps)
    popt = lora.adamw([t for _, t in lora.trainable_leaves(pp)], lr)
  else:
    jopt = j_lora.masked_optimizer(optax.adamw(lr, eps=eps), jparams)
    popt = lora.masked_optimizer(pp, lr)
  assert popt.defaults["eps"] == eps
  jparams, _, jlosses = _optax_run(jparams, jopt, jcfg, batches)
  before = {k: v.clone() for k, v in pp["layers"].items()}
  plosses = _port_run(pp, popt, cfg, batches)
  np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
  g, w = _flat(pp), _flat(jax.tree.map(np.asarray, jparams))
  assert sorted(g) == sorted(w)
  for path in w:
    np.testing.assert_allclose(_np(g[path]), w[path], rtol=0, atol=1e-3 * lr * len(batches),
                               err_msg="/".join(path))
  if kind != "full":
    for k, v in pp["layers"].items():  # the base is bit for bit what it was
      if not k.startswith("lora_"):
        assert torch.equal(v, before[k]), k
    assert len(popt.param_groups[0]["params"]) == sum(k.startswith("lora_") for k in pp["layers"])


def test_lora_mask_and_defaults_match_optax():
  _, _, jp, pp = _variant("lora")
  assert _flat(lora.lora_mask(pp)) == {k: bool(v) for k, v in _flat(j_lora.lora_mask(jp)).items()}
  import inspect
  opt = lora.adamw([torch.zeros(2)], 1e-3)
  defaults = inspect.signature(optax.adamw).parameters
  assert opt.defaults["weight_decay"] == defaults["weight_decay"].default == 1e-4
  assert opt.defaults["eps"] == defaults["eps"].default == 1e-8
  assert opt.defaults["betas"] == (defaults["b1"].default, defaults["b2"].default)


def test_quantized_base_without_adapters_is_refused():
  cfg, _, _, pp = _model()
  qp = q.quantize_params(pp, "int8", scale_dtype=torch.float32)
  opt = lora.adamw([t for _, t in lora.trainable_leaves(qp)], 1e-2)
  with pytest.raises(ValueError, match="LoRA"):
    step.make_train_step(cfg, opt)(qp, _pbatch(*_batch()))


# ----------------------------------------------------------------- moments files


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_moments_file_crosses_between_the_packages(kind, tmp_path):
  cfg, jcfg, jp, pp = _variant(kind)
  batches = [_batch(seed=s, T=8) for s in range(2)]
  jparams = jax.tree.map(jnp.asarray, jp)
  jopt = optax.adamw(1e-2) if kind == "full" else j_lora.masked_optimizer(optax.adamw(1e-2), jparams)
  _, jstate, _ = _optax_run(jparams, jopt, jcfg, batches)
  j_optstate.save_opt_state(jstate, tmp_path / "jax.safetensors")
  leaves = [t for path, t in lora.trainable_leaves(pp)]
  popt = lora.adamw(leaves, 1e-2)
  optstate.load_opt_state(popt, leaves, tmp_path / "jax.safetensors")
  jleaves = jax.tree_util.tree_leaves(jstate)
  assert len(jleaves) == 1 + 2 * len(leaves)
  assert float(popt.state[leaves[0]]["step"]) == int(jleaves[0]) == 2
  for i, t in enumerate(leaves):
    _close(popt.state[t]["exp_avg"], jleaves[1 + i], tol=0)
    _close(popt.state[t]["exp_avg_sq"], jleaves[1 + len(leaves) + i], tol=0)
  # The port's file, written after its own two steps, read by JAX's loader.
  popt2 = lora.adamw(leaves, 1e-2)
  _port_run(pp, popt2, cfg, batches)
  optstate.save_opt_state(popt2, leaves, tmp_path / "port.safetensors")
  template = jopt.init(j_step.trainable_subtree(jparams))
  restored = jax.tree_util.tree_leaves(j_optstate.load_opt_state(template, tmp_path / "port.safetensors"))
  assert int(restored[0]) == 2 and restored[0].dtype == jnp.int32
  for i, t in enumerate(leaves):
    _close(restored[1 + i], popt2.state[t]["exp_avg"], tol=0)
    _close(restored[1 + len(leaves) + i], popt2.state[t]["exp_avg_sq"], tol=0)


def test_moments_file_refusals_match_jax(tmp_path):
  _, _, _, pp = _variant("lora")
  leaves = [t for _, t in lora.trainable_leaves(pp)]
  popt = lora.adamw(leaves, 1e-2)
  optstate.save_opt_state(popt, leaves, tmp_path / "m.safetensors")
  f = _SafetensorsFile(tmp_path / "m.safetensors")
  assert f.get("opt.0").dtype == torch.int32 and int(f.get("opt.0")) == 0
  with pytest.raises(ValueError, match="has .* leaves; the current optimizer state has"):
    optstate.load_opt_state(lora.adamw(leaves[:-1], 1e-2), leaves[:-1], tmp_path / "m.safetensors")
  wide = [torch.zeros(*t.shape[:-1], t.shape[-1] + 1) for t in leaves]
  with pytest.raises(ValueError, match="leaf 1 shape"):
    optstate.load_opt_state(lora.adamw(wide, 1e-2), wide, tmp_path / "m.safetensors")
  half = [t.to(torch.bfloat16) for t in leaves]
  with pytest.raises(ValueError, match="leaf 1 dtype float32 != expected bfloat16"):
    optstate.load_opt_state(lora.adamw(half, 1e-2), half, tmp_path / "m.safetensors")


# ----------------------------------------------------------------------- engines


@pytest.fixture()
def jax_weights(monkeypatch):
  """The port's synthetic init replaced by JAX's draw (PRNGKey(0), per-layer folding)."""
  def init(cfg, n, first, last, seed=0, dtype=torch.float32, device="cpu", start_layer=0, **_):
    jcfg = j_config_from_hf_dict(j_registry.get_model_card("synthetic-tiny")["synthetic_config"])
    jp = j_init_random_params(jcfg, n, first, last, jax.random.PRNGKey(seed), dtype=jnp.float32,
                              start_layer=start_layer)
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device=device, dtype=dtype)
  monkeypatch.setattr(engine_mod, "init_random_params", init)


@pytest.mark.parametrize("rank", [0, 2])
async def test_engine_train_and_eval_match_the_jax_engine(jax_weights, monkeypatch, rank):
  monkeypatch.setenv("XOT_LR", "1e-2")
  if rank:
    monkeypatch.setenv("XOT_LORA_RANK", str(rank))
  n = get_model_card("synthetic-tiny")["layers"]
  port = TorchShardInferenceEngine(device="cpu", seed=7)
  jeng = JAXShardInferenceEngine(dtype="float32")
  try:
    if rank:  # the same adapters on both sides: JAX's draw
      await jeng.ensure_shard(JShard("synthetic-tiny", 0, n - 1, n))
      await port.ensure_shard(Shard("synthetic-tiny", 0, n - 1, n))
      ctx = port._ctx
      for k, v in jeng.params["layers"].items():
        if k.startswith("lora_"):
          ctx.params["layers"][k] = torch.from_numpy(np.array(v))
    got, want = [], []
    for i in range(3):
      b = _batch(seed=i, T=14)
      got.append((await port.train_example(f"p{i}", Shard("synthetic-tiny", 0, n - 1, n), *b))[0])
      want.append((await jeng.train_example(f"j{i}", JShard("synthetic-tiny", 0, n - 1, n), *b))[0])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    b = _batch(seed=9, T=14)
    np.testing.assert_allclose(await port.evaluate_example("pe", Shard("synthetic-tiny", 0, n - 1, n), *b),
                               await jeng.evaluate_example("je", JShard("synthetic-tiny", 0, n - 1, n), *b),
                               rtol=1e-4)
  finally:
    port.executor.shutdown(wait=True)


async def test_training_updates_in_place_and_serving_reads_the_new_weights(jax_weights, monkeypatch):
  """The optimizer writes into the tensors the context holds (a captured graph's
  addresses stay valid): after a step the engine's logits equal a fresh engine's over
  the trained tensors."""
  monkeypatch.setenv("XOT_LR", "1e-2")
  n = get_model_card("synthetic-tiny")["layers"]
  shard = Shard("synthetic-tiny", 0, n - 1, n)
  eng = TorchShardInferenceEngine(device="cpu", seed=7)
  other = TorchShardInferenceEngine(device="cpu", seed=7)
  try:
    await eng.ensure_shard(shard)
    ptrs = {k: v.data_ptr() for k, v in eng._ctx.params["layers"].items()}
    prompt = np.array([[1, 5, 9, 2]], dtype=np.int64)
    before, _ = await eng.infer_tensor("r0", shard, prompt)
    await eng.train_example("t", shard, *_batch(T=10))
    assert {k: v.data_ptr() for k, v in eng._ctx.params["layers"].items()} == ptrs
    after, _ = await eng.infer_tensor("r1", shard, prompt)
    assert not np.allclose(after, before, atol=1e-4)
    await other.ensure_shard(shard)
    octx = other._ctx
    with torch.no_grad():
      for path, t in step.leaf_paths(eng._ctx.params):
        node = octx.params
        for k in path[:-1]:
          node = node[k]
        node[path[-1]].copy_(t)
    want, _ = await other.infer_tensor("r2", shard, prompt)
    np.testing.assert_allclose(after, want, atol=1e-6)
    # Parameters stay ordinary tensors that need no grad between steps.
    assert not any(t.requires_grad or t.is_inference() for _, t in step.leaf_paths(eng._ctx.params))
  finally:
    eng.executor.shutdown(wait=True)
    other.executor.shutdown(wait=True)


async def test_engine_refusals(monkeypatch):
  """A non-last shard without forward_fn and a quantized base without adapters are
  refused before a step, in JAX's words; the MoE card, once refused here, trains and
  evaluates (as JAX's engine does: no family is refused)."""
  eng = TorchShardInferenceEngine(device="cpu", seed=7)
  try:
    n = get_model_card("synthetic-tiny-moe")["layers"]
    loss, _ = await eng.train_example("m", Shard("synthetic-tiny-moe", 0, n - 1, n), *_batch())
    assert np.isfinite(loss)
    assert np.isfinite(await eng.evaluate_example("m", Shard("synthetic-tiny-moe", 0, n - 1, n),
                                                  *_batch()))
    n = get_model_card("synthetic-tiny")["layers"]
    with pytest.raises(ValueError, match="forward_fn"):
      await eng.train_example("m", Shard("synthetic-tiny", 0, 1, n), *_batch())
  finally:
    eng.executor.shutdown(wait=True)
  monkeypatch.setenv("XOT_QUANTIZE", "int8")
  eng = TorchShardInferenceEngine(device="cpu", seed=7)
  try:
    with pytest.raises(ValueError, match="Full-parameter training on an int8-quantized base is not "
                                         "supported; attach adapters"):
      await eng.train_example("q", Shard("synthetic-tiny", 0, n - 1, n), *_batch())
  finally:
    eng.executor.shutdown(wait=True)


def test_training_on_the_card_refuses_head_dims_k1b_lacks():
  """On the card a head_dim outside K1b's builds is refused before any step; evaluation
  runs K1 alone. gemma-2's 256 is built, so gemma-2 trains on the card."""
  from types import SimpleNamespace
  eng = TorchShardInferenceEngine(device="cpu", seed=7)
  try:
    eng.device = torch.device("cuda")  # decided from the engine's device, before any tensor moves
    ctx = SimpleNamespace(shard=Shard("g", 0, 1, 2), params={"layers": {}},
                          cfg=SimpleNamespace(is_moe=False, is_multimodal=False, head_dim=48))
    for head_dim in (48, 512):
      ctx.cfg.head_dim = head_dim
      with pytest.raises(ValueError, match="g: training: the attention gradient kernel K1b is built "
                                           "for head_dim"):
        eng._check_example(ctx, train=True)
      eng._check_example(ctx, train=False)
    for head_dim in (128, 256):
      ctx.cfg.head_dim = head_dim
      eng._check_example(ctx, train=True)
  finally:
    eng.executor.shutdown(wait=True)


async def test_base_and_dummy_engines_answer_the_training_contract():
  from xotorch_tpu_torch.inference.engine import InferenceEngine
  dummy = DummyInferenceEngine()
  await dummy.save_session("k", 1)
  assert dummy.session == {"k": 1}
  await dummy.clear_session()
  assert dummy.session == {}
  shard = Shard("dummy", 0, 7, 8)
  loss, grads = await dummy.train_example("r", shard, np.ones((1, 4)), np.ones((1, 4)), np.array([4]))
  assert loss == 0.42 and grads.shape == (1, 4)
  assert await dummy.evaluate_example("r", shard, np.ones((1, 4)), np.ones((1, 4)), np.array([4])) == 0.42

  class Bare(DummyInferenceEngine):
    train_example = InferenceEngine.train_example
    evaluate_example = InferenceEngine.evaluate_example
  with pytest.raises(NotImplementedError, match="Bare does not support training"):
    await Bare().train_example("r", shard, None, None, None)
  with pytest.raises(NotImplementedError, match="Bare does not support evaluation"):
    await Bare().evaluate_example("r", shard, None, None, None)


# ---------------------------------------------- JAX's training cases, on the port


@pytest.fixture()
def tiny_model_dir(tmp_path):
  return make_hf_checkpoint(tmp_path, TINY_LLAMA_CFG, seed=3)


def _full_shard():
  return Shard("m", 0, N - 1, N)


def _engine(model_dir, monkeypatch, rank=0):
  if rank:
    monkeypatch.setenv("XOT_LORA_RANK", str(rank))
  else:
    monkeypatch.delenv("XOT_LORA_RANK", raising=False)
  monkeypatch.setenv("XOT_LR", "1e-2")
  return TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu", seed=7)


def _lbatch(seed=0, B=2, T=16):
  rng = np.random.RandomState(seed)
  inputs = rng.randint(3, TINY_LLAMA_CFG["vocab_size"], (B, T)).astype(np.int64)
  return inputs, np.roll(inputs, -1, axis=1), np.full((B,), T - 1, np.int64)


def _params(eng, shard=None):
  return (eng._contexts[shard] if shard else eng._ctx).params


async def _logits(eng, shard, rid="r"):
  out, _ = await eng.infer_tensor(rid, shard, np.array([[1, 5, 9, 2]], dtype=np.int64))
  return np.asarray(out)


def _node(name, engine):
  from xotorch_tpu_torch.orchestration.node import Node
  from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy
  from tests.test_torch_survivability import Kit
  node = Node(name, None, engine, None, RingMemoryWeightedPartitioningStrategy())
  node.device_capabilities = Kit("port", "tcp").caps()
  node.topology.update_node(name, node.device_capabilities)
  return node


async def test_lora_train_freezes_base_and_reduces_loss(tiny_model_dir, monkeypatch):
  eng = _engine(tiny_model_dir, monkeypatch, rank=2)
  shard = _full_shard()
  await eng.ensure_shard(shard)
  params = _params(eng)
  assert lora.has_lora(params)
  adapter, total = lora.lora_param_counts(params)
  assert 0 < adapter / total < 0.03
  base = {k: v.clone() for k, v in params["layers"].items() if not k.startswith("lora_")}
  embed = params["embed"]["embedding"].clone()
  losses = [(await eng.train_example(f"it{i}", shard, *_lbatch()))[0] for i in range(45)]
  assert losses[-1] < losses[0] * 0.9, losses
  for k, before in base.items():
    assert torch.equal(params["layers"][k], before), k
  assert torch.equal(params["embed"]["embedding"], embed)
  assert any(v.abs().max() > 0 for k, v in params["layers"].items() if k.endswith("_b"))
  eng.executor.shutdown(wait=True)


async def test_lora_adapter_only_checkpoint_roundtrip(tiny_model_dir, monkeypatch, tmp_path):
  eng = _engine(tiny_model_dir, monkeypatch, rank=2)
  shard = _full_shard()
  for i in range(4):
    await eng.train_example(f"it{i}", shard, *_lbatch())
  ckpt = tmp_path / "adapters.safetensors"
  await eng.save_checkpoint(shard, str(ckpt))
  names = list(_SafetensorsFile(ckpt).header)
  assert names and all(n.startswith("lora.") for n in names)
  assert ckpt.stat().st_size < sum(p.stat().st_size for p in tiny_model_dir.glob("*.safetensors")) / 5
  assert (tmp_path / "adapters-opt.safetensors").exists()
  want = await _logits(eng, shard)
  fresh = _engine(tiny_model_dir, monkeypatch, rank=2)
  await fresh.load_checkpoint(shard, str(ckpt))
  np.testing.assert_allclose(await _logits(fresh, shard), want, atol=1e-6)
  for e in (eng, fresh):
    e.executor.shutdown(wait=True)


async def test_lora_coordinate_save_resume_roundtrip(tiny_model_dir, monkeypatch, tmp_path):
  eng = _engine(tiny_model_dir, monkeypatch, rank=2)
  shard = _full_shard()
  node = _node("trainer", eng)
  for i in range(4):
    await eng.train_example(f"it{i}", shard, *_lbatch())
  await node.coordinate_save(shard, 4, str(tmp_path))
  assert node.checkpoints == {"m": {"0-3": 4}}
  saved = sorted(p.name for p in (tmp_path / "m").glob("*.safetensors"))
  assert saved == ["0-3-4-opt.safetensors", "0-3-4.safetensors"], saved
  want = await _logits(eng, shard)
  fresh_eng = _engine(tiny_model_dir, monkeypatch, rank=2)
  await _node("resumer", fresh_eng).coordinate_resume(shard, str(tmp_path / "m"))
  np.testing.assert_allclose(await _logits(fresh_eng, shard), want, atol=1e-6)
  assert fresh_eng._ctx.optimizer is not None  # the moments came back with the adapters
  for e in (eng, fresh_eng):
    e.executor.shutdown(wait=True)


async def test_lora_pipelined_two_shard_training(tiny_model_dir, monkeypatch):
  first, second = Shard("m", 0, N // 2 - 1, N), Shard("m", N // 2, N - 1, N)
  eng_a = _engine(tiny_model_dir, monkeypatch, rank=2)
  eng_b = _engine(tiny_model_dir, monkeypatch, rank=2)
  await eng_a.ensure_shard(first)
  await eng_b.ensure_shard(second)
  base_a = {k: v.clone() for k, v in _params(eng_a)["layers"].items() if not k.startswith("lora_")}

  async def downstream(activations, target, lengths_, train):
    return await eng_b.train_example("req", second, activations, target, lengths_)

  losses = [(await eng_a.train_example("req", first, *_lbatch(), forward_fn=downstream))[0]
            for _ in range(10)]
  assert losses[-1] < losses[0] * 0.95, losses
  for k, before in base_a.items():
    assert torch.equal(_params(eng_a)["layers"][k], before), k
  for e in (eng_a, eng_b):
    e.executor.shutdown(wait=True)


async def test_full_checkpoint_coordinate_save_resume(tiny_model_dir, monkeypatch, tmp_path):
  eng = _engine(tiny_model_dir, monkeypatch)
  shard = _full_shard()
  node = _node("full-trainer", eng)
  for i in range(3):
    await eng.train_example(f"it{i}", shard, *_lbatch())
  await node.coordinate_save(shard, 3, str(tmp_path))
  assert (tmp_path / "m" / "0-3-3.safetensors").exists()
  assert (tmp_path / "m" / "0-3-3-opt.safetensors").exists()
  want = await _logits(eng, shard)
  fresh = _engine(tiny_model_dir, monkeypatch)
  await _node("full-resumer", fresh).coordinate_resume(shard, str(tmp_path / "m"))
  got = await _logits(fresh, shard)
  np.testing.assert_allclose(got, want, atol=1e-6)
  base = _engine(tiny_model_dir, monkeypatch)
  assert not np.allclose(got, await _logits(base, shard), atol=1e-5)
  for e in (eng, fresh, base):
    e.executor.shutdown(wait=True)


async def test_lora_resume_after_repartition(tiny_model_dir, monkeypatch, tmp_path):
  first, second = Shard("m", 0, N // 2 - 1, N), Shard("m", N // 2, N - 1, N)
  eng_a = _engine(tiny_model_dir, monkeypatch, rank=2)
  eng_b = _engine(tiny_model_dir, monkeypatch, rank=2)

  async def downstream(activations, target, lengths_, train):
    return await eng_b.train_example("req", second, activations, target, lengths_)

  for _ in range(4):
    await eng_a.train_example("req", first, *_lbatch(), forward_fn=downstream)
  ckpt_dir = tmp_path / "split"
  await eng_a.save_checkpoint(first, str(ckpt_dir / f"0-{N // 2 - 1}-4.safetensors"))
  await eng_b.save_checkpoint(second, str(ckpt_dir / f"{N // 2}-{N - 1}-4.safetensors"))
  hidden, _ = await eng_a.infer_tensor("chk", first, np.array([[1, 5, 9, 2]], dtype=np.int64))
  want, _ = await eng_b.infer_tensor("chk", second, hidden)
  full_eng = _engine(tiny_model_dir, monkeypatch, rank=2)
  await full_eng.load_checkpoint(_full_shard(), str(ckpt_dir))
  np.testing.assert_allclose(await _logits(full_eng, _full_shard(), "chk"), np.asarray(want),
                             atol=1e-5, rtol=1e-4)
  # A merge of two saves restores no moments: neither belongs to the merged point.
  assert full_eng._ctx.optimizer is None
  for e in (eng_a, eng_b, full_eng):
    e.executor.shutdown(wait=True)


async def test_qlora_over_int8_base_end_to_end(tiny_model_dir, monkeypatch, tmp_path):
  monkeypatch.setenv("XOT_QUANTIZE", "int8")
  eng = _engine(tiny_model_dir, monkeypatch, rank=2)
  shard = _full_shard()
  await eng.ensure_shard(shard)
  params = _params(eng)
  assert q.is_quantized(params) and params["layers"]["wq"].dtype == torch.int8
  assert params["layers"]["lora_wq_a"].dtype != torch.int8
  base = {k: v.clone() for k, v in params["layers"].items() if not k.startswith("lora_")}
  losses = [(await eng.train_example(f"it{i}", shard, *_lbatch()))[0] for i in range(30)]
  assert losses[-1] < losses[0] * 0.95, losses
  for k, before in base.items():  # codes and scales alike
    assert torch.equal(params["layers"][k], before), k
  ckpt = tmp_path / "qlora.safetensors"
  await eng.save_checkpoint(shard, str(ckpt))
  want = await _logits(eng, shard)
  fresh = _engine(tiny_model_dir, monkeypatch, rank=2)
  await fresh.load_checkpoint(shard, str(ckpt))
  assert q.is_quantized(_params(fresh))
  np.testing.assert_allclose(await _logits(fresh, shard), want, atol=1e-5)
  for e in (eng, fresh):
    e.executor.shutdown(wait=True)


async def test_optimizer_state_resume_matches_uninterrupted(tiny_model_dir, monkeypatch, tmp_path):
  shard = _full_shard()
  ckpt_dir = tmp_path / "resume"
  ref = _engine(tiny_model_dir, monkeypatch, rank=2)
  for i in range(4):
    await ref.train_example(f"ref{i}", shard, *_lbatch())
  want = {k: v.clone() for k, v in _params(ref)["layers"].items() if k.startswith("lora_")}
  a = _engine(tiny_model_dir, monkeypatch, rank=2)
  for i in range(2):
    await a.train_example(f"a{i}", shard, *_lbatch())
  await a.save_checkpoint(shard, str(ckpt_dir / "0-3-1.safetensors"))
  opt_file = ckpt_dir / "0-3-1-opt.safetensors"
  assert opt_file.exists()
  b = _engine(tiny_model_dir, monkeypatch, rank=2)
  await b.load_checkpoint(shard, str(ckpt_dir))
  assert b._contexts[shard].optimizer is not None, "moments were not restored"
  for i in range(2):
    await b.train_example(f"b{i}", shard, *_lbatch())
  for k, w in want.items():
    _close(_params(b)["layers"][k], w, tol=1e-5, what=k)
  opt_file.unlink()  # the control: a cold resume diverges
  c = _engine(tiny_model_dir, monkeypatch, rank=2)
  await c.load_checkpoint(shard, str(ckpt_dir))
  for i in range(2):
    await c.train_example(f"c{i}", shard, *_lbatch())
  assert any(not torch.allclose(_params(c)["layers"][k], w, atol=1e-5) for k, w in want.items())
  # XOT_SAVE_OPT_STATE=0: no moments written, and a stale file beside the save goes.
  optstate.save_opt_state(b._ctx.optimizer, b._ctx.opt_leaves, opt_file)
  monkeypatch.setenv("XOT_SAVE_OPT_STATE", "0")
  await b.save_checkpoint(shard, str(ckpt_dir / "0-3-1.safetensors"))
  assert not opt_file.exists()
  for e in (ref, a, b, c):
    e.executor.shutdown(wait=True)


def test_qlora_train_step_updates_adapters_only():
  cfg, _, _, pp = _model()
  qp = q.quantize_params(pp, "int8", scale_dtype=torch.float32)
  g = torch.Generator().manual_seed(7)
  qp = lora.add_lora_params(qp, 4, g)
  assert qp["layers"]["lora_wq_a"].dtype == torch.float32
  adapter, total = lora.lora_param_counts(qp)
  assert adapter < total * 0.2
  opt = lora.masked_optimizer(qp, 1e-2)
  train = step.make_train_step(cfg, opt)
  rng = np.random.RandomState(0)
  batch = {"inputs": torch.from_numpy(rng.randint(0, 255, (2, 8))),
           "targets": torch.from_numpy(np.random.RandomState(1).randint(0, 255, (2, 8))),
           "lengths": torch.tensor([8, 8])}
  wq, a = qp["layers"]["wq"].clone(), qp["layers"]["lora_wq_a"].clone()
  losses = [float(train(qp, batch)) for _ in range(9)]
  assert losses[-1] < losses[0], losses
  assert torch.equal(qp["layers"]["wq"], wq)
  assert not torch.equal(qp["layers"]["lora_wq_a"], a)


async def test_engine_quantized_full_train_rejected(tiny_model_dir, monkeypatch):
  monkeypatch.setenv("XOT_QUANTIZE", "int8")
  eng = _engine(tiny_model_dir, monkeypatch)
  x = np.random.RandomState(0).randint(0, 255, (1, 8))
  with pytest.raises(ValueError, match="LoRA"):
    await eng.train_example("t", _full_shard(), x, x, np.array([8]))
  eng.executor.shutdown(wait=True)


# ----------------------------------------------------------------------- the CLI


def test_cli_train_flags_have_jax_defaults():
  from xotorch_tpu.main import build_parser as j_build_parser
  ours = port_main.build_parser().parse_args(["train", "m", "--lora-rank", "8"])
  theirs = j_build_parser().parse_args(["train", "m", "--lora-rank", "8"])
  for name in ("iters", "batch_size", "sequence_length", "save_every", "save_checkpoint_dir",
               "resume_checkpoint", "lora_rank", "command"):
    assert getattr(ours, name) == getattr(theirs, name), name
  assert ours.data == dataset.DEFAULT_DATA
  assert port_main.build_parser().parse_args(["eval"]).command == "eval"


def test_resumed_iteration(tmp_path):
  assert port_main.resumed_iteration(None) == 0
  assert port_main.resumed_iteration(str(tmp_path / "0-15-4.safetensors")) == 4
  for name in ("0-7-4.safetensors", "0-7-8.safetensors", "0-7-8-opt.safetensors", "model.safetensors"):
    (tmp_path / name).write_bytes(b"")
  assert port_main.resumed_iteration(str(tmp_path)) == 8
  assert port_main.resumed_iteration(str(tmp_path / "model.safetensors")) == 0


async def test_resume_checkpoint_loads_before_training(tmp_path):
  engine = DummyInferenceEngine()
  calls = []

  async def record_load(shard, path):
    calls.append((shard, path))

  engine.load_checkpoint = record_load
  node = _node("train-node", engine)
  args = argparse.Namespace(data=dataset.DEFAULT_DATA, iters=1, batch_size=1, sequence_length=32,
                            save_every=0, save_checkpoint_dir=str(tmp_path),
                            resume_checkpoint=str(tmp_path / "ckpt"))
  losses = await port_main.train_model_cli(node, "DummyInferenceEngine", "dummy", args)
  assert calls == [(Shard("dummy", 0, 7, 8), str(tmp_path / "ckpt"))]
  assert losses == [(1, 0.42)]


async def test_coordinate_resume_reaches_all_peers():
  from tests.test_torch_survivability import Kit
  kit = Kit("port", "inprocess")
  loads = {"node-a": [], "node-b": []}

  def recording(name):
    eng = DummyInferenceEngine()

    async def record_load(shard, path, _name=name):
      loads[_name].append((shard, path))
    eng.load_checkpoint = record_load
    return eng

  a, b = await kit.ring(recording("node-a"), recording("node-b"))
  try:
    await a.coordinate_resume(Shard("dummy", 0, 0, 8), "/ckpts/dummy")
    for _ in range(50):
      if loads["node-b"]:
        break
      await asyncio.sleep(0.05)
    (sa, pa), = loads["node-a"]
    (sb, pb), = loads["node-b"]
    assert pa == pb == "/ckpts/dummy"
    assert sorted(list(range(sa.start_layer, sa.end_layer + 1))
                  + list(range(sb.start_layer, sb.end_layer + 1))) == list(range(8))
  finally:
    await kit.stop(a, b)


async def test_eval_model_cli_reports_mean_loss(capsys):
  engine = DummyInferenceEngine()
  node = _node("eval-node", engine)
  seen = []
  orig = node.enqueue_example

  async def record(shard, ex, tgt, lengths, train=True):
    seen.append(train)
    return await orig(shard, ex, tgt, lengths, train=train)

  node.enqueue_example = record
  args = argparse.Namespace(data=dataset.DEFAULT_DATA, batch_size=1, sequence_length=32)
  assert await port_main.eval_model_cli(node, "DummyInferenceEngine", "dummy", args) == pytest.approx(0.42)
  assert seen and not any(seen)
  assert "eval loss: 0.4200" in capsys.readouterr().out


async def test_train_command_runs_saves_and_resumes_on_the_cpu(monkeypatch, tmp_path):
  """`main.py train` end to end on synthetic-tiny (CPU): 4 steps with a save at 2, then
  a resume from that save runs steps 3-4 with the uninterrupted run's losses (the
  moments came back), and `eval` prints a loss."""
  monkeypatch.setenv("XOT_LR", "1e-2")
  monkeypatch.setenv("XOT_LORA_RANK", "0")  # build_node sets it from --lora-rank: restored after
  monkeypatch.setattr(port_main, "resolve_cli_tokenizer", _hash_tokenizer)

  async def run(argv):
    args = port_main.build_parser().parse_args(argv)
    node, engine, classname, _ = port_main.build_node(args)
    try:
      if args.command == "train":
        return await port_main.train_model_cli(node, classname, "synthetic-tiny", args)
      return await port_main.eval_model_cli(node, classname, "synthetic-tiny", args)
    finally:
      engine.executor.shutdown(wait=True)

  common = ["--device", "cpu", "--batch-size", "2", "--sequence-length", "24",
            "--save-checkpoint-dir", str(tmp_path), "--lora-rank", "2"]
  full = await run(["train", "synthetic-tiny", "--iters", "4", "--save-every", "2", *common])
  assert [it for it, _ in full] == [1, 2, 3, 4]
  assert sorted(p.name for p in (tmp_path / "synthetic-tiny").iterdir()) == [
    "0-3-2-opt.safetensors", "0-3-2.safetensors", "0-3-4-opt.safetensors", "0-3-4.safetensors"]
  resumed = await run(["train", "synthetic-tiny", "--iters", "4", "--save-every", "0",
                       "--resume-checkpoint", str(tmp_path / "synthetic-tiny" / "0-3-2.safetensors"),
                       *common])
  assert [it for it, _ in resumed] == [3, 4]
  np.testing.assert_allclose([l for _, l in resumed], [l for _, l in full[2:]], rtol=1e-5)
  assert full[-1][1] < full[0][1]
  loss = await run(["eval", "synthetic-tiny", *common])
  assert np.isfinite(loss)


async def _hash_tokenizer(model_name, engine_classname):
  return HashTokenizer()


# ------------------------------------------------ every family: qwen3-moe and llava
#
# The MoE card trains through its router and experts as JAX's forward_shard runs them:
# the dense combine at B*T > 8 and the routed gather at or under it (the regime is
# JAX's), int8 experts frozen under QLoRA; llava trains its text stack alone (the tower
# sits outside the params in both packages). Tolerances as above.

MOE = "synthetic-tiny-moe"


def _jax_loss_and_grads(jp, jcfg, b):
  return jax.value_and_grad(j_step.full_model_loss)(jax.tree.map(jnp.asarray, jp), _jbatch(*b), jcfg)


def _port_loss_and_grads(pp, cfg, b):
  paths = [p for p, _ in step.leaf_paths(pp)]
  leaves = [t for _, t in step.leaf_paths(pp)]
  loss, grads = step.value_and_grad(lambda: step.full_model_loss(pp, _pbatch(*b), cfg), leaves)
  return loss, step.unflatten(paths, grads)


@pytest.mark.parametrize("B,T,routed", [(2, 12, False), (1, 9, False), (2, 4, True), (1, 3, True)],
                         ids=["dense 24", "dense 9", "routed 8", "routed 3"])
def test_moe_loss_and_gradients_match_jax_in_both_regimes(B, T, routed, monkeypatch):
  """synthetic-tiny-moe: the loss and every gradient (the router's through the sorted
  top-k values, every expert slot's) against JAX's full_model_loss, on either side of
  the B*T = 8 boundary; the port takes the routed gather exactly where JAX does."""
  from xotorch_tpu_torch.models import transformer
  cfg, jcfg, jp, pp = _model(MOE)
  took = []
  real = transformer._moe_mlp_routed
  monkeypatch.setattr(transformer, "_moe_mlp_routed", lambda *a: took.append(1) or real(*a))
  b = _batch(seed=4, B=B, T=T, vocab=cfg.vocab_size, short=B > 1)
  jl, jg = _jax_loss_and_grads(jp, jcfg, b)
  loss, grads = _port_loss_and_grads(pp, cfg, b)
  assert bool(took) == routed
  _close(loss, jl, what="loss")
  _trees_close(grads, jg)
  assert float(np.abs(_np(grads["layers"]["router"])).max()) > 0


def _moe_variant(kind):
  """(port cfg, JAX cfg, JAX params, port params) of synthetic-tiny-moe for `kind`: full,
  lora, or qlora (int8 experts and attention, adapters on JAX's attention slots only)."""
  cfg, jcfg, jp, _ = _model(MOE)
  if kind == "qlora":
    jp = jax.tree.map(np.asarray, jq.quantize_params(jax.tree.map(jnp.asarray, jp),
                                                     scale_dtype=jnp.float32))
  if kind != "full":
    jp = j_lora.add_lora_params(jax.tree.map(jnp.asarray, jp), rank=4, key=jax.random.PRNGKey(7),
                                targets=j_lora.ATTN_SLOTS + j_lora.MLP_SLOTS)
    rng = np.random.default_rng(5)
    layers = dict(jp["layers"])
    for k in sorted(layers):
      if k.endswith("_b"):
        layers[k] = jnp.asarray((rng.standard_normal(layers[k].shape) * 0.05).astype(np.float32))
    jp = jax.tree.map(np.asarray, {**jp, "layers": layers})
  return cfg, jcfg, jp, params_from_jax(jp, cfg)


@pytest.mark.parametrize("kind", ["full", "lora", "qlora"])
def test_moe_adamw_steps_match_optax(kind, monkeypatch):
  """Three AdamW steps on synthetic-tiny-moe against optax (dense and routed batches
  mixed): losses within 1e-5, parameters within 1e-3 x lr a step; under LoRA and QLoRA
  the experts carry no adapter (JAX's sites) and every base leaf, int8 experts and their
  scales included, stays bit for bit."""
  cfg, jcfg, jp, pp = _moe_variant(kind)
  if kind != "full":
    assert not any(k.startswith("lora_we") for k in pp["layers"])
  if kind == "qlora":
    assert pp["layers"]["we_gate"].dtype == torch.int8
  batches = [_batch(seed=0, T=10, vocab=cfg.vocab_size), _batch(seed=1, B=2, T=4, short=False),
             _batch(seed=2, T=10, vocab=cfg.vocab_size)]
  lr, eps = 1e-2, 1e-4
  monkeypatch.setattr(lora, "ADAMW_EPS", eps)
  jparams = jax.tree.map(jnp.asarray, jp)
  if kind == "full":
    jopt = optax.adamw(lr, eps=eps)
    popt = lora.adamw([t for _, t in lora.trainable_leaves(pp)], lr)
  else:
    jopt = j_lora.masked_optimizer(optax.adamw(lr, eps=eps), jparams)
    popt = lora.masked_optimizer(pp, lr)
  jparams, _, jlosses = _optax_run(jparams, jopt, jcfg, batches)
  before = {k: v.clone() for k, v in pp["layers"].items()}
  plosses = _port_run(pp, popt, cfg, batches)
  np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
  g, w = _flat(pp), _flat(jax.tree.map(np.asarray, jparams))
  assert sorted(g) == sorted(w)
  for path in w:
    np.testing.assert_allclose(_np(g[path]).astype(np.float64), np.asarray(w[path], np.float64),
                               rtol=0, atol=1e-3 * lr * len(batches), err_msg="/".join(path))
  if kind != "full":
    for k, v in pp["layers"].items():
      if not k.startswith("lora_"):
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_moe_moments_file_crosses_between_the_packages(kind, tmp_path):
  """A MoE card's moments file in JAX's flatten order (router, expert slots, their
  adapters' neighbours), written by either package and read by the other."""
  cfg, jcfg, jp, pp = _moe_variant(kind)
  batches = [_batch(seed=s, T=8) for s in range(2)]
  jparams = jax.tree.map(jnp.asarray, jp)
  jopt = optax.adamw(1e-2) if kind == "full" else j_lora.masked_optimizer(optax.adamw(1e-2), jparams)
  _, jstate, _ = _optax_run(jparams, jopt, jcfg, batches)
  j_optstate.save_opt_state(jstate, tmp_path / "jax.safetensors")
  leaves = [t for _, t in lora.trainable_leaves(pp)]
  popt = lora.adamw(leaves, 1e-2)
  optstate.load_opt_state(popt, leaves, tmp_path / "jax.safetensors")
  jleaves = jax.tree_util.tree_leaves(jstate)
  assert len(jleaves) == 1 + 2 * len(leaves)
  for i, t in enumerate(leaves):
    _close(popt.state[t]["exp_avg"], jleaves[1 + i], tol=0)
    _close(popt.state[t]["exp_avg_sq"], jleaves[1 + len(leaves) + i], tol=0)
  popt2 = lora.adamw(leaves, 1e-2)
  _port_run(pp, popt2, cfg, batches)
  optstate.save_opt_state(popt2, leaves, tmp_path / "port.safetensors")
  template = jopt.init(j_step.trainable_subtree(jparams))
  restored = jax.tree_util.tree_leaves(j_optstate.load_opt_state(template, tmp_path / "port.safetensors"))
  assert int(restored[0]) == 2
  for i, t in enumerate(leaves):
    _close(restored[1 + i], popt2.state[t]["exp_avg"], tol=0)
    _close(restored[1 + len(leaves) + i], popt2.state[t]["exp_avg_sq"], tol=0)


@pytest.fixture(scope="module")
def llava_dir(tmp_path_factory):
  from tests.test_vision_llava import save_tiny_llava, tiny_llava_cfg
  d = tmp_path_factory.mktemp("llava-train") / "llava"
  d.mkdir()
  save_tiny_llava(d, tiny_llava_cfg(), seed=7)
  return d


def _llava_params(llava_dir):
  from xotorch_tpu.models.config import load_model_config as j_load_model_config
  from xotorch_tpu.models.weights import load_shard_params as j_load_shard_params
  from xotorch_tpu_torch.models.config import load_model_config
  from xotorch_tpu_torch.models.weights import load_shard_params
  cfg, jcfg = load_model_config(llava_dir), j_load_model_config(llava_dir)
  n = cfg.num_layers
  jp = jax.tree.map(np.asarray, j_load_shard_params(llava_dir, jcfg, JShard("llava", 0, n - 1, n),
                                                    dtype=jnp.float32))
  pp = load_shard_params(llava_dir, cfg, Shard("llava", 0, n - 1, n), dtype=torch.float32)
  return cfg, jcfg, jp, pp


def test_llava_text_loss_gradients_and_steps_match_jax(llava_dir, monkeypatch):
  """llava's text path: the loss and every gradient against JAX's, the tower nowhere in
  the params; then three LoRA steps against optax's masked AdamW."""
  cfg, jcfg, jp, pp = _llava_params(llava_dir)
  assert cfg.is_multimodal and not any("vision" in k or "projector" in k for k in pp)
  b = _batch(seed=6, T=14, vocab=cfg.vocab_size)
  jl, jg = _jax_loss_and_grads(jp, jcfg, b)
  loss, grads = _port_loss_and_grads(pp, cfg, b)
  _close(loss, jl, what="loss")
  _trees_close(grads, jg)
  monkeypatch.setattr(lora, "ADAMW_EPS", 1e-4)
  jparams = j_lora.add_lora_params(jax.tree.map(jnp.asarray, jp), rank=4, key=jax.random.PRNGKey(3))
  pp = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
  jopt = j_lora.masked_optimizer(optax.adamw(1e-2, eps=1e-4), jparams)
  batches = [_batch(seed=s, T=10, vocab=cfg.vocab_size) for s in range(3)]
  _, _, jlosses = _optax_run(jparams, jopt, jcfg, batches)
  np.testing.assert_allclose(_port_run(pp, lora.masked_optimizer(pp, 1e-2), cfg, batches), jlosses,
                             rtol=1e-5)


@pytest.fixture()
def family_weights(monkeypatch):
  """The port's synthetic init replaced by JAX's draw of the same card (dense or MoE)."""
  def init(cfg, n, first, last, seed=0, dtype=torch.float32, device="cpu", start_layer=0, **_):
    name = MOE if cfg.is_moe else "synthetic-tiny"
    jcfg = j_config_from_hf_dict(j_registry.get_model_card(name)["synthetic_config"])
    jp = j_init_random_params(jcfg, n, first, last, jax.random.PRNGKey(seed), dtype=jnp.float32,
                              start_layer=start_layer)
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device=device, dtype=dtype)
  monkeypatch.setattr(engine_mod, "init_random_params", init)


def _family_engines(family, llava_dir):
  if family == "moe":
    n = get_model_card(MOE)["layers"]
    return (TorchShardInferenceEngine(device="cpu", seed=7), JAXShardInferenceEngine(dtype="float32"),
            MOE, n, 256)
  from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
  from xotorch_tpu_torch.models.config import load_model_config
  cfg = load_model_config(llava_dir)
  return (TorchShardInferenceEngine(LocalShardDownloader({"llava": llava_dir}), device="cpu", seed=7),
          JAXShardInferenceEngine(JLocalShardDownloader({"llava": llava_dir}), dtype="float32"),
          "llava", cfg.num_layers, cfg.vocab_size)


@pytest.mark.parametrize("family", ["moe", "llava"])
async def test_engine_trains_moe_and_llava_like_the_jax_engine(family, family_weights, llava_dir,
                                                               monkeypatch):
  """train_example on one peer, three steps, then evaluate_example: losses within 1e-4
  of the JAX engine's on the same weights and batches."""
  monkeypatch.setenv("XOT_LR", "1e-2")
  port, jeng, model, n, vocab = _family_engines(family, llava_dir)
  try:
    got, want = [], []
    for i in range(3):
      b = _batch(seed=i, T=14, vocab=vocab)
      got.append((await port.train_example(f"p{i}", Shard(model, 0, n - 1, n), *b))[0])
      want.append((await jeng.train_example(f"j{i}", JShard(model, 0, n - 1, n), *b))[0])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    b = _batch(seed=9, T=14, vocab=vocab)
    np.testing.assert_allclose(await port.evaluate_example("pe", Shard(model, 0, n - 1, n), *b),
                               await jeng.evaluate_example("je", JShard(model, 0, n - 1, n), *b),
                               rtol=1e-4)
  finally:
    port.executor.shutdown(wait=True)


@pytest.mark.parametrize("family", ["moe", "llava"])
async def test_two_shard_ring_trains_moe_and_llava_like_the_jax_engines(family, family_weights,
                                                                        llava_dir, monkeypatch):
  """Pipelined training over two shards (the first chains to the last through
  forward_fn, as SendExample does): three steps' losses and an evaluation within 1e-4
  of JAX's two engines chained the same way."""
  monkeypatch.setenv("XOT_LR", "1e-2")
  a, ja, model, n, vocab = _family_engines(family, llava_dir)
  b_, jb, *_ = _family_engines(family, llava_dir)
  h = n // 2
  first, second = Shard(model, 0, h - 1, n), Shard(model, h, n - 1, n)
  jfirst, jsecond = JShard(model, 0, h - 1, n), JShard(model, h, n - 1, n)

  async def down(activations, target, lengths, train):
    if train:
      return await b_.train_example("r", second, activations, target, lengths)
    return await b_.evaluate_example("r", second, activations, target, lengths), None

  async def jdown(activations, target, lengths, train):
    if train:
      return await jb.train_example("r", jsecond, activations, target, lengths)
    return await jb.evaluate_example("r", jsecond, activations, target, lengths), None

  try:
    got, want = [], []
    for i in range(3):
      batch = _batch(seed=i, T=12, vocab=vocab)
      got.append((await a.train_example("r", first, *batch, forward_fn=down))[0])
      want.append((await ja.train_example("r", jfirst, *batch, forward_fn=jdown))[0])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    batch = _batch(seed=8, T=12, vocab=vocab)
    np.testing.assert_allclose(await a.evaluate_example("e", first, *batch, forward_fn=down),
                               await ja.evaluate_example("e", jfirst, *batch, forward_fn=jdown),
                               rtol=1e-4)
  finally:
    for e in (a, b_):
      e.executor.shutdown(wait=True)


@pytest.mark.parametrize("extra", [[], ["--quantize", "int8"]], ids=["lora", "qlora"])
async def test_train_command_trains_the_moe_card(monkeypatch, tmp_path, extra):
  """`main.py train|eval synthetic-tiny-moe` on the CPU with JAX's flags: LoRA, and QLoRA
  over int8 experts; the loss falls over four steps and the experts stay as loaded."""
  monkeypatch.setenv("XOT_LR", "1e-2")
  monkeypatch.setenv("XOT_LORA_RANK", "0")
  monkeypatch.delenv("XOT_QUANTIZE", raising=False)
  monkeypatch.setattr(port_main, "resolve_cli_tokenizer", _hash_tokenizer)

  async def run(argv):
    args = port_main.build_parser().parse_args(argv)
    node, engine, classname, _ = port_main.build_node(args)
    try:
      if args.command == "train":
        out = await port_main.train_model_cli(node, classname, MOE, args)
        experts = engine._ctx.params["layers"]["we_up"]
        return out, experts.dtype
      return await port_main.eval_model_cli(node, classname, MOE, args)
    finally:
      engine.executor.shutdown(wait=True)

  common = ["--device", "cpu", "--batch-size", "2", "--sequence-length", "24", "--lora-rank", "2",
            "--save-checkpoint-dir", str(tmp_path), *extra]
  steps, experts_dtype = await run(["train", MOE, "--iters", "4", "--save-every", "0", *common])
  assert [it for it, _ in steps] == [1, 2, 3, 4]
  assert steps[-1][1] < steps[0][1]
  assert experts_dtype == (torch.int8 if extra else torch.float32)
  assert np.isfinite(await run(["eval", MOE, *common]))
