"""The port's weight quantization (xotorch_tpu_torch.models.quantize, K5, K5v4, K6)
against the JAX package's, on the CPU.

- Layouts are byte-identical: the same numpy weights quantize to equal int8 codes,
  equal packed int4 nibbles and equal scales in both packages, whole trees included.
- The kernels' plain versions (what the wrappers run on CPU tensors, and what
  chip_smoke.py holds the CUDA kernels against) agree with JAX's Pallas kernels run
  in interpret mode, as tests/test_quantize.py runs them: rows 1/3/8, one group and
  several. fp32 throughout; K5 differs only in the order of fp32 sums (atol 1e-5 on
  outputs of magnitude ~10); K5v4 and K6 quantize the activations with the same
  recipe, so their int8 codes are equal and only the fp32 scale products differ.
- Quantized `forward_shard` logits match JAX's (1e-4 absolute, fp32), with the
  kernels' functions forced on and off, on synthetic-tiny (untied: lm_head_scale)
  and on a narrow tied config whose contraction splits into two int4 groups.
- The engines' greedy streams are identical under XOT_QUANTIZE, on the JAX engine's
  weights, with the kernels forced on and off; a batched paged int4 stream equals
  the one-at-a-time stream.
"""
import asyncio

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_weights  # noqa: F401 (fixture)
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import quantize as jq
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.models.registry import get_model_card as j_get_model_card
from xotorch_tpu.ops.int4_matmul import int4_grouped_matmul as j_int4_grouped_matmul
from xotorch_tpu.ops.int8_matmul import int8_rowquant_matmul as j_int8_rowquant_matmul
from xotorch_tpu.ops.int8_matmul import rowquant_int8 as j_rowquant_int8
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import quantize as q
from xotorch_tpu_torch.models import transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import params_from_jax
from xotorch_tpu_torch.ops import int4_matmul, int8_matmul
from xotorch_tpu_torch.utils import knobs

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
# A narrow llama with tied embeddings whose 256-wide contraction splits into two
# int4 groups of 128 (synthetic-tiny's 64-wide one is a single group).
NARROW = {"model_type": "llama", "hidden_size": 256, "intermediate_size": 512,
          "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
          "vocab_size": 256, "max_position_embeddings": 2048, "rope_theta": 10000.0,
          "tie_word_embeddings": True, "eos_token_id": 2}
KNOB_ENV = ("XOT_QUANTIZE", "XOT_KV_QUANT", "XOT_INT4_KERNEL", "XOT_INT4_V", "XOT_INT8_KERNEL")


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


def _weights(shape, seed, scale=0.05):
  return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ layouts


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32"])
def test_quantize_tensor_is_byte_identical(axis, scale_dtype):
  w = _weights((96, 160), 1)
  w[:, 3] = 0.0  # an all-zero channel (axis 0) / zero entries (axis 1)
  jqv, js = jq.quantize_tensor(jnp.asarray(w), axis, jnp.int8, getattr(jnp, scale_dtype))
  tq, ts = q.quantize_tensor(torch.from_numpy(w), axis, torch.int8, getattr(torch, scale_dtype))
  _same(tq, jqv, "q")
  _same(ts, js, "scale")
  back = q.dequantize_tensor(tq, ts, axis, torch.float32)
  np.testing.assert_array_equal(back.numpy(), _np(jq.dequantize_tensor(jqv, js, axis, jnp.float32)))


@pytest.mark.parametrize("d_in,group", [(256, 128), (256, 64), (96, 128)])
def test_quantize_tensor_grouped_and_packing_are_byte_identical(d_in, group):
  w = _weights((2, d_in, 48), 2)
  jpk, jgs = jq.quantize_tensor_grouped(jnp.asarray(w), jnp.bfloat16, group_size=group)
  tpk, tgs = q.quantize_tensor_grouped(torch.from_numpy(w), torch.bfloat16, group_size=group)
  assert tpk.dtype == torch.uint8 and tuple(tpk.shape) == jpk.shape
  _same(tpk, jpk, "packed")
  _same(tgs, jgs, "gscale")
  _same(q.unpack_int4(tpk), jq.unpack_int4(jpk), "unpacked")
  _same(q.dequantize_tensor_grouped(tpk, tgs, torch.bfloat16),
        jq.dequantize_tensor_grouped(jpk, jgs, jnp.bfloat16), "dequantized")
  # pack_int4 of every value in [-8, 7] at both nibble positions.
  vals = np.stack(np.meshgrid(np.arange(-8, 8), np.arange(-8, 8)), -1).reshape(-1, 2, 1).astype(np.int32)
  _same(q.pack_int4(torch.from_numpy(vals.reshape(-1, 1))), jq.pack_int4(jnp.asarray(vals.reshape(-1, 1))))
  assert torch.equal(q.unpack_int4(q.pack_int4(torch.from_numpy(vals.reshape(-1, 1)))).int(),
                     torch.from_numpy(vals.reshape(-1, 1)))


def _tiny_jax_params(cfg_dict=None, dtype=jnp.bfloat16):
  jcfg = j_config_from_hf_dict(cfg_dict or j_get_model_card(MODEL)["synthetic_config"])
  jp = j_transformer.init_random_params(jcfg, jcfg.num_layers, True, True, jax.random.PRNGKey(0),
                                        dtype=dtype)
  return jcfg, jax.tree.map(np.asarray, jp)


def _flat(tree, prefix=""):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _flat(v, f"{prefix}{k}/")
    else:
      yield f"{prefix}{k}", v


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("cfg_dict", [None, NARROW], ids=["tiny", "narrow-tied"])
def test_quantize_params_is_byte_identical(fmt, cfg_dict):
  jcfg, np_params = _tiny_jax_params(cfg_dict)
  cfg = config_from_hf_dict(cfg_dict or get_model_card(MODEL)["synthetic_config"])
  jtree = jq.quantize_params(np_params, fmt)
  want = dict(_flat(jax.tree.map(np.asarray, jtree)))
  tparams = params_from_jax(np_params, cfg)
  got = dict(_flat(q.quantize_params(tparams, fmt)))
  assert sorted(got) == sorted(want)
  for name, arr in want.items():
    _same(got[name], arr, name)
  # In place: the same bytes, in the caller's own dictionaries.
  inplace = q.quantize_params(tparams, fmt, inplace=True)
  assert inplace is tparams
  for name, t in _flat(inplace):
    _same(t, want[name], name)
  assert q.is_quantized(inplace) and q.quantized_bytes(inplace) == jq.quantized_bytes(jtree)
  back = dict(_flat(jax.tree.map(np.asarray, jq.dequantize_params(jtree))))
  for name, t in _flat(q.dequantize_params(inplace)):
    _same(t, back[name], name)


def test_rowquant_int8_is_byte_identical():
  a = _weights((8, 300), 3, scale=1.0)
  a[2] = 0.0  # an all-zero row takes scale 1
  a[5, 7] = 127.5 * np.abs(a[5]).max() / 127.0  # a half-way value
  j8, js = j_rowquant_int8(jnp.asarray(a))
  t8, ts = int8_matmul.rowquant_int8(torch.from_numpy(a))
  _same(t8, j8, "int8")
  _same(ts, js, "scale")


# ------------------------------------------------------- kernels' plain versions


def _int4_case(d_in, group, rows, seed):
  w = _weights((1, d_in, 384), seed, scale=1.0)
  jpk, jgs = jq.quantize_tensor_grouped(jnp.asarray(w), jnp.float32, group_size=group)
  h = _weights((rows, d_in), seed + 1, scale=1.0)
  return h, _np(jpk)[0], _np(jgs)[0]


@pytest.mark.parametrize("variant", [1, 2, 3, 4])
@pytest.mark.parametrize("d_in,group", [(128, 128), (256, 64)], ids=["G1", "G4"])
def test_int4_plain_kernels_match_jax_interpret(variant, d_in, group):
  for rows in (1, 3, 8):
    h, pk, gs = _int4_case(d_in, group, rows, 10 * rows)
    want = _np(j_int4_grouped_matmul(jnp.asarray(h), jnp.asarray(pk), jnp.asarray(gs),
                                     block_out=128, interpret=True, variant=variant))
    got = int4_matmul.int4_grouped_matmul(torch.from_numpy(h), torch.from_numpy(pk),
                                          torch.from_numpy(gs), variant=variant)
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, 384)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_int8_plain_kernel_matches_jax_interpret(rows):
  w = _weights((256, 384), 20, scale=1.0)
  jqv, js = jq.quantize_tensor(jnp.asarray(w), 0, jnp.int8, jnp.float32)
  h = _weights((rows, 256), 21 + rows, scale=1.0)
  want = _np(j_int8_rowquant_matmul(jnp.asarray(h), jqv, js, block_out=128, interpret=True))
  got = int8_matmul.int8_rowquant_matmul(torch.from_numpy(h), torch.from_numpy(_np(jqv)),
                                         torch.from_numpy(_np(js)))
  np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)


def test_plain_kernels_in_bf16_round_once():
  """The bf16 call the card makes: the plain versions compute in fp32 and round
  the output to bf16 once, so they sit within one bf16 rounding of the fp32 call."""
  h, pk, gs = _int4_case(256, 64, 8, 30)
  hb, gsb = torch.from_numpy(h).to(torch.bfloat16), torch.from_numpy(gs).to(torch.bfloat16)
  for fn in (int4_matmul.int4_w4a16_matmul, int4_matmul.int4_w4a8_matmul):
    got = fn(hb, torch.from_numpy(pk), gsb)
    want = fn(hb.float(), torch.from_numpy(pk), gsb.float())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, atol=0, rtol=2 ** -8)


def test_wrappers_refuse_other_devices_and_count_only_launches():
  h = torch.zeros(1, 64)
  pk, gs = torch.zeros(1, 32, 32, dtype=torch.uint8), torch.ones(1, 32)
  before = (int4_matmul.int4_w4a16_matmul.launches, int4_matmul.int4_w4a8_matmul.launches,
            int8_matmul.int8_rowquant_matmul.launches)
  int4_matmul.int4_grouped_matmul(h, pk, gs)
  int4_matmul.int4_grouped_matmul(h, pk, gs, variant=4)
  int8_matmul.int8_rowquant_matmul(h, torch.zeros(64, 32, dtype=torch.int8), torch.ones(32))
  # A CPU tensor takes the plain version: no kernel launched, no count.
  assert before == (int4_matmul.int4_w4a16_matmul.launches, int4_matmul.int4_w4a8_matmul.launches,
                    int8_matmul.int8_rowquant_matmul.launches)
  meta = torch.zeros(1, 64, device="meta")
  with pytest.raises(ValueError, match="cuda or cpu"):
    int4_matmul.int4_grouped_matmul(meta, pk.to("meta"), gs.to("meta"))
  with pytest.raises(ValueError, match="cuda or cpu"):
    int8_matmul.int8_rowquant_matmul(meta, torch.zeros(64, 32, dtype=torch.int8, device="meta"),
                                     torch.ones(32, device="meta"))
  with pytest.raises(ValueError, match="do not cover"):
    int4_matmul.int4_grouped_matmul(torch.zeros(1, 48), pk, gs)


# ------------------------------------------------------------------ the model


def _forward_pair(cfg_dict, fmt, env, monkeypatch, steps=3):
  for name, value in env.items():
    monkeypatch.setenv(name, value)
  jcfg, np_params = _tiny_jax_params(cfg_dict, dtype=jnp.float32)
  cfg = config_from_hf_dict(cfg_dict or get_model_card(MODEL)["synthetic_config"])
  jp = jq.quantize_params(jax.tree.map(jnp.asarray, np_params), fmt, scale_dtype=jnp.float32)
  params = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
  L, S = cfg.num_layers, 32
  jcache = j_transformer.init_kv_cache(jcfg, L, 1, S, jnp.float32)
  cache = transformer.init_kv_cache(cfg, L, 1, S, torch.float32)
  toks = np.random.default_rng(4).integers(3, cfg.vocab_size, size=(1, 11)).astype(np.int32)
  pairs, pos = [], 0
  for step in range(steps + 1):
    jl, jcache = j_transformer.forward_shard(jp, jnp.asarray(toks), jcache, jnp.int32(pos), jcfg,
                                             True, True)
    tl, cache = transformer.forward_shard(params, torch.from_numpy(toks).long(), cache, pos, cfg,
                                          True, True)
    pairs.append((tl.numpy(), _np(jl)))
    pos += toks.shape[1]
    toks = np.array([[int(np.argmax(_np(jl)[0, -1]))]], np.int32)
  return pairs


FORWARD_MODES = {
  "int8-default": ("int8", {}),
  "int8-K6": ("int8", {"XOT_INT8_KERNEL": "force"}),
  "int4-plain": ("int4", {"XOT_INT4_KERNEL": "0"}),
  "int4-K5": ("int4", {"XOT_INT4_KERNEL": "force"}),
  "int4-K5v4": ("int4", {"XOT_INT4_KERNEL": "force", "XOT_INT4_V": "4"}),
}


@pytest.mark.parametrize("mode", list(FORWARD_MODES))
@pytest.mark.parametrize("cfg_dict", [None, NARROW], ids=["tiny", "narrow-tied"])
def test_quantized_forward_shard_logits_match_jax(mode, cfg_dict, monkeypatch):
  fmt, env = FORWARD_MODES[mode]
  calls = {"int4": 0, "int8": 0}
  real4, real8 = transformer.int4_grouped_matmul, transformer.int8_rowquant_matmul

  def int4(*a, **kw):
    calls["int4"] += 1
    return real4(*a, **kw)

  def int8(*a, **kw):
    calls["int8"] += 1
    return real8(*a, **kw)

  monkeypatch.setattr(transformer, "int4_grouped_matmul", int4)
  monkeypatch.setattr(transformer, "int8_rowquant_matmul", int8)
  pairs = _forward_pair(cfg_dict, fmt, env, monkeypatch)
  for i, (got, want) in enumerate(pairs):
    np.testing.assert_allclose(got, want, atol=1e-4, err_msg=f"{mode} step {i}")
  # Only the 3 decode steps (B*T = 1) reach a kernel's function, 7 projections a
  # layer; the 11-token prefill and the knobs' off modes take the plain product.
  L = (NARROW if cfg_dict else get_model_card(MODEL)["synthetic_config"])["num_hidden_layers"]
  forced = env.get("XOT_INT4_KERNEL" if fmt == "int4" else "XOT_INT8_KERNEL") == "force"
  assert calls[fmt] == (7 * L * 3 if forced else 0)


def test_check_params_admits_quantized_slots_and_refuses_lora():
  cfg = config_from_hf_dict(get_model_card(MODEL)["synthetic_config"])
  params = q.quantize_params(transformer.init_random_params(cfg, 1, True, True), "int4")
  transformer._check_params(params["layers"])
  with pytest.raises(NotImplementedError, match="LoRA"):
    transformer._check_params({**params["layers"], "lora_wq_a": torch.zeros(1)})


# ---------------------------------------------------------------- the engines


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


ENGINE_MODES = {
  "int8": ("int8", {}),
  "int8-K6": ("int8", {"XOT_INT8_KERNEL": "force"}),
  "int4": ("int4", {}),
  "int4-K5": ("int4", {"XOT_INT4_KERNEL": "force"}),
  "int4-K5v4": ("int4", {"XOT_INT4_KERNEL": "force", "XOT_INT4_V": "4"}),
}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
async def test_greedy_stream_matches_jax_engine(mode, jax_weights, monkeypatch):
  fmt, env = ENGINE_MODES[mode]
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_QUANTIZE", fmt)
  for name, value in env.items():
    monkeypatch.setenv(name, value)
  prompt = np.random.default_rng(9).integers(3, 256, size=(1, 7))
  jeng = JAXShardInferenceEngine(dtype="float32")
  want = await _greedy(jeng, JShard(MODEL, 0, 3, 4), "r", prompt)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  assert eng.quantize == fmt
  got = await _greedy(eng, Shard(MODEL, 0, 3, 4), "r", prompt)
  layers = eng._ctx.params["layers"]
  assert layers["wq"].dtype == (torch.uint8 if fmt == "int4" else torch.int8)
  assert ("wq_gscale" if fmt == "int4" else "wq_scale") in layers
  for e in (jeng, eng):
    e.executor.shutdown(wait=True)
  assert got == want


async def test_batched_paged_int4_stream_matches_one_at_a_time(monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_QUANTIZE", "int4")
  monkeypatch.setenv("XOT_INT4_KERNEL", "force")
  monkeypatch.setenv("XOT_PAGED_KV", "1")
  monkeypatch.setenv("XOT_KV_PAGE", "16")
  monkeypatch.setenv("XOT_KV_POOL_TOKENS", "512")
  prompts = {f"r{i}": np.random.default_rng(50 + i).integers(3, 256, size=(1, n))
             for i, n in enumerate((3, 9, 14, 20))}
  shard = Shard(MODEL, 0, 3, 4)
  calls = []
  real = transformer.int4_grouped_matmul
  monkeypatch.setattr(transformer, "int4_grouped_matmul",
                      lambda h, *a, **kw: calls.append(h.shape[0]) or real(h, *a, **kw))
  batched = TorchShardInferenceEngine(device="cpu", seed=0)
  together = await asyncio.gather(*(_greedy(batched, shard, rid, p) for rid, p in prompts.items()))
  assert max(calls) > 1  # decode rows of several requests went through K5's function at once
  alone_eng = TorchShardInferenceEngine(device="cpu", seed=0)
  alone = [await _greedy(alone_eng, shard, rid, p) for rid, p in prompts.items()]
  for e in (batched, alone_eng):
    e.executor.shutdown(wait=True)
  assert together == alone


# ------------------------------------------------------------ knobs and repairs


def test_knobs_are_registered_with_the_jax_defaults():
  from xotorch_tpu.utils import knobs as j_knobs
  for name in KNOB_ENV:
    assert knobs.REGISTRY[name].default == j_knobs.REGISTRY[name].default, name
    assert knobs.REGISTRY[name].kind == j_knobs.REGISTRY[name].kind, name


@pytest.mark.parametrize("value", ["int8", "INT8", "int4"])
async def test_kv_quant_serves_an_int8_cache_rather_than_a_bf16_one(value, monkeypatch):
  """XOT_KV_QUANT=int8 (any case) builds an int8 cache with its scales; a format the
  JAX engine refuses (int4) raises ValueError, as it does there."""
  monkeypatch.setenv("XOT_KV_QUANT", value)
  if value == "int4":
    with pytest.raises(ValueError, match="int4"):
      TorchShardInferenceEngine(device="cpu")
    with pytest.raises(ValueError, match="int4"):
      JAXShardInferenceEngine(dtype="float32")
    return
  eng = TorchShardInferenceEngine(device="cpu", dtype="float32", seed=0)
  await eng.infer_tensor("r", Shard(MODEL, 0, 3, 4), np.ones((1, 5), np.int64))
  eng.executor.shutdown(wait=True)
  cache = eng._ctx.states["r"].cache
  assert eng.kv_quant == "int8" and sorted(cache) == ["k", "k_scale", "v", "v_scale"]
  assert cache["k"].dtype == cache["v"].dtype == torch.int8
  assert cache["k_scale"].dtype == torch.float32 and cache["k_scale"][:, :, :5].all()


@pytest.mark.parametrize("how", ["argument", "env"])
def test_engine_refuses_unknown_quantization(how, monkeypatch):
  if how == "env":
    monkeypatch.setenv("XOT_QUANTIZE", "int3")
  with pytest.raises(ValueError, match="int3"):
    TorchShardInferenceEngine(device="cpu", quantize="int3" if how == "argument" else None)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_params_from_jax_keeps_quantized_leaves(fmt):
  _, np_params = _tiny_jax_params()
  cfg = config_from_hf_dict(get_model_card(MODEL)["synthetic_config"])
  tree = jax.tree.map(np.asarray, jq.quantize_params(np_params, fmt))
  want = dict(_flat(tree))
  got = dict(_flat(params_from_jax(tree, cfg, dtype=torch.float32)))
  for name, arr in want.items():
    if arr.dtype in (np.int8, np.uint8):
      _same(got[name], arr, name)  # codes kept as they are
    else:
      assert got[name].dtype == torch.float32, name


def test_cli_quantize_flag_sets_the_engine_knob():
  """--quantize reaches the engine as its argument and leaves the process's
  XOT_QUANTIZE alone, so an engine built later in the process is not quantized."""
  args = port_main.build_parser().parse_args(["--device", "cpu", "--quantize", "int4"])
  node, engine, _, _ = port_main.build_node(args)
  later = TorchShardInferenceEngine(device="cpu")
  try:
    assert engine.quantize == "int4" and knobs.get_str("XOT_QUANTIZE") is None
    assert later.quantize is None
  finally:
    for e in (engine, later):
      e.executor.shutdown(wait=True)
  with pytest.raises(SystemExit):
    port_main.build_parser().parse_args(["--quantize", "int2"])


# (XOT_INT4_KERNEL, XOT_INT8_KERNEL) -> (int4, int8) kernels taken (on the card, on the CPU)
ROUTES = {
  "defaults": ({}, (True, False), (False, False)),
  "int4-0": ({"XOT_INT4_KERNEL": "0"}, (True, False), (False, False)),
  "force": ({"XOT_INT4_KERNEL": "force", "XOT_INT8_KERNEL": "force"}, (True, True), (True, True)),
  "int8-1": ({"XOT_INT8_KERNEL": "1"}, (True, True), (False, False)),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_quant_route_never_sends_the_card_to_the_plain_int4_product(name, monkeypatch):
  """On the card int4 decode projections always take K5/K5v4 (`0` included); the
  CPU takes a kernel's function only under `force`; K6 only when asked for."""
  env, card, cpu = ROUTES[name]
  for knob, value in env.items():
    monkeypatch.setenv(knob, value)
  for on_card, want in ((True, card), (False, cpu)):
    route = transformer.quant_route(on_card)
    assert (route.int4_kernel, route.int8_kernel) == want, (name, on_card)


async def test_engine_reads_the_quant_route_once_when_built(monkeypatch):
  """The knobs are read when the engine is built: changing them afterwards moves no
  projection, and the variant reaches int4_grouped_matmul explicitly."""
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_QUANTIZE", "int4")
  monkeypatch.setenv("XOT_INT4_KERNEL", "force")
  monkeypatch.setenv("XOT_INT4_V", "4")
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  monkeypatch.setenv("XOT_INT4_KERNEL", "0")
  monkeypatch.setenv("XOT_INT4_V", "1")
  variants = []
  real = transformer.int4_grouped_matmul
  monkeypatch.setattr(transformer, "int4_grouped_matmul",
                      lambda h, w, s, variant: variants.append(variant) or real(h, w, s, variant))
  prompt = np.random.default_rng(9).integers(3, 256, size=(1, 7))
  await _greedy(eng, Shard(MODEL, 0, 3, 4), "r", prompt, n=4)
  eng.executor.shutdown(wait=True)
  # 3 decode steps (the 7-token prefill takes the dequantized product), 7 a layer.
  assert variants == [4] * (7 * 4 * 3)
