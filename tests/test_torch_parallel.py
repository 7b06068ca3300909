"""The port's serving mesh (parallel/mesh.py) against the JAX package's, on the CPU.

One for one the tests of tests/test_mesh_tp.py, tests/test_multichip_serving.py and
tests/test_moe_ep.py, on the same inputs: the tiny llama checkpoint that
`transformers` writes (TINY_LLAMA_CFG, seed 3) for the dense paths, and
synthetic-tiny-moe on the JAX engine's own random draw (PRNGKey(0), carried across
with `params_from_jax`) for the experts. XOT_VIRTUAL_DEVICES=8 gives the port eight
positions on the CPU, as conftest's --xla_force_host_platform_device_count=8 gives JAX.

Where a JAX test holds its mesh engine to its single-device engine, the port's test
holds the port's mesh engine to the port's single-device engine (greedy streams
identical, logits within 1e-4 absolute / 1e-3 relative in fp32, JAX's own tolerance:
the partial sums of a tp position add in another order), and to JAX's engine over the
same mesh on the same weights. The paged tests run for the bf16-layout arena and the
int8 one (K3/K4's plain versions, and K3q/K4q's): the port's counterpart of JAX's
XLA-gather / Pallas-kernel parameter, whose legacy gathered read the port does not
have. Each path the port does not serve under a mesh is refused, and a test below
shows each refusal; training and LoRA over a mesh are tests/test_torch_parallel_train.py's.
"""
import asyncio
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine import engine as engine_mod
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import generate, transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import params_from_jax
from xotorch_tpu_torch.parallel.mesh import MeshParams, device_bytes, make_mesh, shard_params
from xotorch_tpu_torch.parallel.zero import MeshAdamW
from xotorch_tpu_torch.train import lora

from tests.test_model_equivalence import TINY_LLAMA_CFG, make_hf_checkpoint

torch.set_num_threads(2)

N_LAYERS = TINY_LLAMA_CFG["num_hidden_layers"]
_PROMPT = np.array([[1, 5, 9, 200, 17, 3, 42]], dtype=np.int64)
MESH_KNOBS = ("XOT_TP", "XOT_SERVE_TP", "XOT_SERVE_SP", "XOT_SERVE_EP", "XOT_PAGED_KV",
              "XOT_KV_QUANT", "XOT_PREFILL_CHUNK", "XOT_QUANTIZE", "XOT_LORA_RANK", "XOT_ADAPTERS",
              "XOT_LORA_TARGETS", "XOT_LR", "XOT_SAVE_OPT_STATE", "XOT_INT8_KERNEL")


@pytest.fixture(autouse=True)
def _mesh_env(monkeypatch):
  """Eight positions on the CPU, fp32 engines, JAX's matmul precision pinned to
  'highest', and no mesh knob left over from the environment."""
  monkeypatch.setenv("XOT_VIRTUAL_DEVICES", "8")
  monkeypatch.setenv("XOT_DTYPE", "float32")
  for knob in MESH_KNOBS:
    monkeypatch.delenv(knob, raising=False)
  with jax.default_matmul_precision("highest"):
    yield


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
  return make_hf_checkpoint(tmp_path_factory.mktemp("port_meshtp"), TINY_LLAMA_CFG, seed=3)


def _env(monkeypatch, tp, **extra):
  monkeypatch.setenv("XOT_SEED", "7")
  monkeypatch.setenv("XOT_CACHE_LEN", "32")
  monkeypatch.setenv("XOT_KV_PAGE", "16")
  monkeypatch.setenv("XOT_KV_POOL_TOKENS", "512")
  monkeypatch.setenv("XOT_TP", str(tp))
  for k, v in extra.items():
    monkeypatch.setenv(k, str(v))


def _engine(model_dir):
  return TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu")


def _jax_engine(model_dir):
  return JAXShardInferenceEngine(JLocalShardDownloader({"m": model_dir}), dtype="float32")


def _full_shard(cls=Shard):
  return cls("m", 0, N_LAYERS - 1, N_LAYERS)


def _tp(eng) -> int:
  mesh = eng._ctx.mesh if isinstance(eng, TorchShardInferenceEngine) else eng._mesh
  return 0 if mesh is None else mesh.shape.get("tp", 1)


async def _greedy_stream(eng, rid: str, n_tokens: int):
  """Prefill + one fused greedy chunk: the drive both sides of every equality share."""
  shard = _full_shard(Shard if isinstance(eng, TorchShardInferenceEngine) else JShard)
  tok, _ = await eng.infer_sample_tensor(rid, shard, _PROMPT, temp=0.0)
  seq = [int(tok)]
  out = await eng.generate_chunk(rid, shard, seq[-1], n_tokens - 1, temp=0.0)
  seq.extend(int(t) for t in np.asarray(out).reshape(-1))
  return seq


async def _greedy_reference(model_dir, n_tokens: int):
  """Sequential per-token greedy continuation of _PROMPT on a solo port engine."""
  eng = _engine(model_dir)
  shard = _full_shard()
  tok, _ = await eng.infer_sample_tensor("ref", shard, _PROMPT, temp=0.0)
  seq = [int(tok)]
  for _ in range(n_tokens - 1):
    tok, _ = await eng.infer_sample_tensor("ref", shard, np.asarray([[seq[-1]]]), temp=0.0)
    seq.append(int(tok))
  return seq


def _piece_heads(cache, name="k"):
  """The kv heads of each tp piece of a sharded cache or arena leaf."""
  return [t.shape[3] for n, t in sorted(cache.items()) if n.split("@")[0] == name]


# ----------------------------------------------------------- tests/test_mesh_tp.py


async def test_xot_tp_overrides_serve_tp(tiny_model_dir, monkeypatch):
  """XOT_TP is the primary knob: 0 forces the mesh off even when XOT_SERVE_TP asks for
  one; N forces it on when XOT_SERVE_TP says 0; unset defers to XOT_SERVE_TP; an
  infeasible request clamps down to the largest divisor of every dense dim (2 kv heads
  bound the tiny model). JAX's engine chooses the same widths."""
  shard = _full_shard()
  cases = (({"XOT_TP": "0", "XOT_SERVE_TP": "2"}, 0), ({"XOT_TP": "2", "XOT_SERVE_TP": "0"}, 2),
           ({"XOT_SERVE_TP": "2"}, 2), ({"XOT_TP": "8"}, 2))
  for env, want in cases:
    for knob in ("XOT_TP", "XOT_SERVE_TP"):
      monkeypatch.delenv(knob, raising=False)
    for k, v in env.items():
      monkeypatch.setenv(k, v)
    eng = _engine(tiny_model_dir)
    await eng.ensure_shard(shard)
    jeng = _jax_engine(tiny_model_dir)
    await jeng.ensure_shard(_full_shard(JShard))
    assert _tp(eng) == _tp(jeng) == want, env
    eng.executor.shutdown(wait=True)


async def test_tp_contiguous_stream_byte_identical(tiny_model_dir, monkeypatch):
  """Contiguous path: the tp=2 greedy stream equals the tp-off stream and JAX's tp=2
  stream token for token, and the resident cache holds one piece of Hkv/tp heads per
  tp position."""
  _env(monkeypatch, 0)
  off = await _greedy_stream(_engine(tiny_model_dir), "r", 12)
  _env(monkeypatch, 2)
  eng = _engine(tiny_model_dir)
  got = await _greedy_stream(eng, "r", 12)
  want = await _greedy_stream(_jax_engine(tiny_model_dir), "r", 12)
  assert _tp(eng) == 2
  assert got == off == want, (got, off, want)
  state = eng._contexts[_full_shard()].states["r"]
  assert _piece_heads(state.cache, "k") == _piece_heads(state.cache, "v") == [1, 1]


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["K3-K4", "K3q-K4q"])
async def test_tp_paged_stream_byte_identical(tiny_model_dir, monkeypatch, kv_quant):
  """Paged path: tp=2 equals tp-off byte for byte (and JAX's tp=2 engine on the bf16
  arena), the request stays page-native on the SHARDED arena (zero unpage gathers,
  zero commit-copy bytes), and the pool invariants hold."""
  extra = {"XOT_PAGED_KV": "1", **({"XOT_KV_QUANT": kv_quant} if kv_quant else {})}
  _env(monkeypatch, 0, **extra)
  off = await _greedy_stream(_engine(tiny_model_dir), "r", 12)
  _env(monkeypatch, 2, **extra)
  eng = _engine(tiny_model_dir)
  got = await _greedy_stream(eng, "r", 12)
  assert _tp(eng) == 2
  assert got == off, f"{got} != {off}"
  if not kv_quant:
    monkeypatch.setenv("XOT_KV_PAGE", "8")  # JAX's page; the port's kernels take 16 or 128
    assert got == await _greedy_stream(_jax_engine(tiny_model_dir), "r", 12)
  ctx = eng._contexts[_full_shard()]
  state, pool = ctx.states["r"], ctx.page_pool
  assert state.cache is None and state.pages, "stream must stay page-native"
  assert len(state.pages) == pool.pages_for(state.pos)
  assert all(pool.refcount(p) >= 1 for p in state.pages.live())
  assert _piece_heads(pool.arena, "k") == _piece_heads(pool.arena, "v") == [1, 1]
  assert ("k_scale@1" in pool.arena) == bool(kv_quant)
  assert eng._unpage_calls == 0, "tp paged decode must never gather back"
  assert eng._commit_copy_bytes == 0, "tp paged decode must never commit-copy"


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["K4", "K4q"])
async def test_tp_paged_verify_byte_identical(tiny_model_dir, monkeypatch, kv_quant):
  """Speculative verify on the tp mesh: perfect, wrong-tail and fully-wrong drafts
  against a page-backed state reproduce the sequential greedy stream exactly, with the
  zero-copy counters and the pages invariant intact."""
  extra = {"XOT_PAGED_KV": "1", **({"XOT_KV_QUANT": kv_quant} if kv_quant else {})}
  _env(monkeypatch, 0, **extra)
  ref = await _greedy_reference(tiny_model_dir, 8)
  _env(monkeypatch, 2, **extra)
  eng = _engine(tiny_model_dir)
  shard = _full_shard()
  tok, _ = await eng.infer_sample_tensor("spec", shard, _PROMPT, temp=0.0)
  assert _tp(eng) == 2
  got = [int(tok)]
  assert got[0] == ref[0]
  accepted = await eng.verify_draft("spec", shard, got[-1], ref[1:4])
  assert accepted == ref[1:5], f"{accepted} != {ref[1:5]}"
  got.extend(accepted)
  wrong = [ref[5], (ref[6] + 1) % 250, (ref[6] + 2) % 250]
  accepted = await eng.verify_draft("spec", shard, got[-1], wrong)
  assert accepted[:2] == ref[5:7] and len(accepted) == 2
  got.extend(accepted)
  bad = [(ref[7] + 9) % 250, 1, 2]
  accepted = await eng.verify_draft("spec", shard, got[-1], bad)
  assert accepted == [ref[7]]
  got.extend(accepted)
  assert got == ref[: len(got)]
  ctx = eng._contexts[shard]
  state, pool = ctx.states["spec"], ctx.page_pool
  assert state.cache is None and state.pages
  assert len(state.pages) == pool.pages_for(state.pos)
  assert eng._unpage_calls == 0 and eng._commit_copy_bytes == 0


@pytest.mark.parametrize("fmt", [None, "int8", "int4"])
def test_weight_bytes_per_device_matches_sharded_pytree(fmt):
  """CostModel.weight_bytes_per_device against what one position of a {'tp': 2} mesh
  holds: the port's tree placed by parallel/mesh.shard_params equals JAX's
  `shard_params` leaf for leaf in per-position bytes (int8 row scales replicate, the
  int4 grouped fallback replicates G=1 row payloads), and the port's cost model
  predicts it."""
  from xotorch_tpu.models.config import config_from_hf_dict as j_config
  from xotorch_tpu.models.quantize import quantize_params as j_quantize
  from xotorch_tpu.models.transformer import init_random_params as j_init
  from xotorch_tpu.parallel.mesh import device_bytes as j_device_bytes
  from xotorch_tpu.parallel.mesh import make_mesh as j_make_mesh
  from xotorch_tpu.parallel.mesh import shard_params as j_shard_params
  from xotorch_tpu_torch.inference.torch_engine.costmodel import CostModel
  from xotorch_tpu_torch.models.quantize import quantize_params, quantized_bytes

  jcfg, cfg = j_config(TINY_LLAMA_CFG), config_from_hf_dict(TINY_LLAMA_CFG)
  jp = j_init(jcfg, N_LAYERS, True, True, jax.random.PRNGKey(0), dtype=jnp.float32)
  params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, dtype=torch.float32)
  if fmt:
    jp = j_quantize(jp, fmt, scale_dtype=jnp.float32)
    params = quantize_params(params, fmt, scale_dtype=torch.float32)
  cm = CostModel(cfg, N_LAYERS, True, True, quantize=fmt, dtype_bytes=4, tp=2)
  assert cm.weight_bytes(fmt) == quantized_bytes(params)
  sharded = shard_params(params, make_mesh({"tp": 2}))
  want = j_device_bytes(j_shard_params(jp, j_make_mesh({"tp": 2})))
  assert device_bytes(sharded) == want == cm.weight_bytes_per_device(fmt)
  cm1 = CostModel(cfg, N_LAYERS, True, True, quantize=fmt, dtype_bytes=4, tp=1)
  assert cm1.weight_bytes_per_device(fmt) == cm1.weight_bytes(fmt)
  assert cm1.collective_bytes_per_token() == 0


async def _drive_perf(engine, rid: str):
  """tests/test_perf_attr.py's drive: a 16-token prefill and one 4-token chunk."""
  shard = Shard("synthetic-tiny", 0, 3, 4)
  prompt = np.arange(1, 17, dtype=np.int64).reshape(1, -1)
  tok, _ = await engine.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
  toks = await engine.generate_chunk(rid, shard, int(tok), 4, temp=0.0, top_k=0)
  assert toks is not None


async def test_perf_report_mesh_attribution(monkeypatch):
  """/v1/perf under XOT_TP=2 (synthetic model): the report carries the tp-divided
  mesh terms, the per-device prediction equals the bytes one position of the resident
  tree holds, and the collective term matches the two all-reduces per layer; the same
  keys and values as JAX's engine's report."""
  monkeypatch.setenv("XOT_TP", "2")
  engine = TorchShardInferenceEngine(device="cpu")
  await _drive_perf(engine, "mesh-r1")
  assert _tp(engine) == 2
  report = engine.perf_report()
  model = report["model"]
  assert model["tp"] == 2
  assert model["weight_bytes_per_device_predicted"] == model["weight_bytes_per_device_actual"]
  assert model["weight_bytes_per_device_predicted"] < model["weight_bytes_predicted"]
  assert model["kv_read_bytes_per_token_at_cache_len"] == \
    2 * model["kv_read_bytes_per_token_at_cache_len_per_device"]
  n_layers, hidden = 4, 64
  want = n_layers * 2 * (2 * (2 - 1) * hidden * 4 // 2)
  assert model["collective_bytes_per_token"] == want
  ceil = report["ceilings"]
  assert ceil["tp"] == 2 and ceil["collective_bytes_per_token"] == want
  for label in ("bf16", "int8", "int4"):
    assert ceil[f"{label}_weight_bytes_per_device"] < ceil[f"{label}_weight_bytes"]
  jeng = JAXShardInferenceEngine(dtype="float32")
  await _drive_perf(jeng, "mesh-r1")
  jmodel = jeng.perf_report()["model"]
  for key in ("tp", "weight_bytes_predicted", "weight_bytes_per_device_predicted",
              "weight_bytes_per_device_actual", "kv_read_bytes_per_token_at_cache_len_per_device",
              "collective_bytes_per_token"):
    assert model[key] == jmodel[key], key


async def test_perf_report_off_mesh_degenerates(monkeypatch):
  """tp off: per-device terms equal their global twins, the ceilings table carries no
  mesh keys, and the collective term is zero."""
  monkeypatch.setenv("XOT_TP", "0")
  engine = TorchShardInferenceEngine(device="cpu")
  await _drive_perf(engine, "mesh-r0")
  assert engine._ctx.mesh is None
  model = engine.perf_report()["model"]
  assert model["tp"] == 1
  assert model["weight_bytes_per_device_predicted"] == model["weight_bytes_predicted"]
  assert model["weight_bytes_per_device_actual"] == model["weight_bytes_actual"]
  assert model["collective_bytes_per_token"] == 0
  ceil = engine.perf_report()["ceilings"]
  assert ceil["tp"] == 1
  assert "collective_bytes_per_token" not in ceil
  assert "bf16_weight_bytes_per_device" not in ceil


# --------------------------------------------------- tests/test_multichip_serving.py

def _tp_engine(model_dir, monkeypatch, tp):
  monkeypatch.setenv("XOT_SERVE_TP", str(tp))
  return _engine(model_dir)


async def test_tp_serving_matches_single_device(tiny_model_dir, monkeypatch):
  """Prefill logits and a decode step's logits over tp=2 within JAX's tolerance of the
  single-device engine's and of JAX's tp=2 engine's."""
  shard = _full_shard()
  tokens = np.array([[1, 5, 9, 200, 17]], dtype=np.int64)
  ref = _tp_engine(tiny_model_dir, monkeypatch, 0)
  out_ref, _ = await ref.infer_tensor("r", shard, tokens)
  assert ref._ctx.mesh is None
  tp = _tp_engine(tiny_model_dir, monkeypatch, 2)
  out_tp, _ = await tp.infer_tensor("r", shard, tokens)
  assert _tp(tp) == 2
  np.testing.assert_allclose(out_tp, out_ref, atol=1e-4, rtol=1e-3)
  jeng = _jax_engine(tiny_model_dir)
  out_j, _ = await jeng.infer_tensor("r", _full_shard(JShard), tokens)
  np.testing.assert_allclose(out_tp, np.asarray(out_j), atol=1e-4, rtol=1e-3)
  t_ref = np.array([[int(np.argmax(out_ref[0, -1]))]], dtype=np.int64)
  d_ref, _ = await ref.infer_tensor("r", shard, t_ref)
  d_tp, _ = await tp.infer_tensor("r", shard, t_ref)
  np.testing.assert_allclose(d_tp, d_ref, atol=1e-4, rtol=1e-3)


async def test_tp_requested_size_reduced_to_feasible(tiny_model_dir, monkeypatch):
  """Asking for tp=8 on a 2-kv-head model reduces to 2, not fail."""
  eng = _tp_engine(tiny_model_dir, monkeypatch, 8)
  out, _ = await eng.infer_tensor("r", _full_shard(), np.array([[1, 2, 3]], dtype=np.int64))
  assert _tp(eng) == 2
  assert out.shape[-1] == TINY_LLAMA_CFG["vocab_size"]


async def test_tp_fused_decode_chunk(tiny_model_dir, monkeypatch):
  """The fused multi-token decode (generate_chunk) over the tp mesh agrees with the
  per-token path of the single-device engine."""
  shard = _full_shard()
  prompt = np.array([[1, 5, 9, 200, 17]], dtype=np.int64)
  tp = _tp_engine(tiny_model_dir, monkeypatch, 2)
  out, _ = await tp.infer_tensor("req", shard, prompt)
  first = int(np.argmax(out[0, -1]))
  toks = await tp.generate_chunk("req", shard, first, 4, temp=0.0, top_k=0)
  assert toks is not None and toks.shape == (4,)
  ref = _tp_engine(tiny_model_dir, monkeypatch, 0)
  out_r, _ = await ref.infer_tensor("req", shard, prompt)
  seq = [int(np.argmax(out_r[0, -1]))]
  for _ in range(4):
    out_r, _ = await ref.infer_tensor("req", shard, np.array([[seq[-1]]], dtype=np.int64))
    seq.append(int(np.argmax(out_r[0, -1])))
  assert toks.tolist() == seq[1:]


async def test_tp_split_ring_equivalence(tiny_model_dir, monkeypatch):
  """A pipeline split where EACH stage is tp-sharded locally (the ring's hop between
  two tp engines, a hidden state in between) matches the full single-device model."""
  tokens = np.array([[1, 5, 9, 200, 17]], dtype=np.int64)
  full = _tp_engine(tiny_model_dir, monkeypatch, 0)
  out_full, _ = await full.infer_tensor("r", Shard("m", 0, N_LAYERS - 1, N_LAYERS), tokens)
  first = _tp_engine(tiny_model_dir, monkeypatch, 2)
  second = _tp_engine(tiny_model_dir, monkeypatch, 2)
  hidden, st = await first.infer_tensor("r", Shard("m", 0, N_LAYERS // 2 - 1, N_LAYERS), tokens)
  out_split, _ = await second.infer_tensor("r", Shard("m", N_LAYERS // 2, N_LAYERS - 1, N_LAYERS),
                                           hidden, st)
  assert _tp(first) == _tp(second) == 2
  np.testing.assert_allclose(out_split, out_full, atol=1e-4, rtol=1e-3)


async def test_tp_serving_with_int8_kv_cache(tiny_model_dir, monkeypatch):
  """int8 KV under the tp mesh: the rank-4 scale leaves split alongside K/V and greedy
  decode, a fused chunk included, matches the unquantized tp stream."""
  shard = _full_shard()
  tokens = np.array([[1, 5, 9, 200, 17]], dtype=np.int64)
  ref = _tp_engine(tiny_model_dir, monkeypatch, 2)
  out_ref, _ = await ref.infer_tensor("r", shard, tokens)
  monkeypatch.setenv("XOT_KV_QUANT", "int8")
  q = _tp_engine(tiny_model_dir, monkeypatch, 2)
  out_q, _ = await q.infer_tensor("r", shard, tokens)
  assert _tp(q) == 2
  cache = q._contexts[shard].states["r"].cache
  assert cache["k@1"].dtype == torch.int8 and cache["k_scale@1"].shape[3] == 1
  assert int(np.argmax(out_q[0, -1])) == int(np.argmax(out_ref[0, -1]))
  t = np.array([[int(np.argmax(out_ref[0, -1]))]], dtype=np.int64)
  d_ref, _ = await ref.infer_tensor("r", shard, t)
  d_q, _ = await q.infer_tensor("r", shard, t)
  assert int(np.argmax(d_q[0, -1])) == int(np.argmax(d_ref[0, -1]))
  ref_toks = []
  nxt = np.array([[int(np.argmax(d_ref[0, -1]))]], dtype=np.int64)
  for _ in range(4):
    d_ref, _ = await ref.infer_tensor("r", shard, nxt)
    ref_toks.append(int(np.argmax(d_ref[0, -1])))
    nxt = np.array([[ref_toks[-1]]], dtype=np.int64)
  chunk = await q.generate_chunk("r", shard, int(np.argmax(d_q[0, -1])), 4, temp=0.0)
  assert [int(x) for x in chunk] == ref_toks, f"{chunk} != {ref_toks}"


async def _sp_run(eng, prompt, cls=Shard):
  shard = _full_shard(cls)
  logits, _ = await eng.infer_tensor("r", shard, prompt)
  toks = [int(np.argmax(np.asarray(logits)[0, -1]))]
  out = await eng.generate_chunk("r", shard, toks[-1], 4, temp=0.0, top_k=0)
  toks.extend(int(t) for t in out)
  return toks


async def test_sp_prefill_ring_attention_matches_solo(tiny_model_dir, monkeypatch):
  """Sequence-parallel serving prefill (XOT_SERVE_SP): a long prompt's from-zero
  segment splits its positions over the sp axis and runs ring attention, composing
  with tp. The whole request (chunked prefill + fused decode) matches the solo
  engine's greedy stream and JAX's sp=2 x tp=2 engine's, and the ring ran once."""
  prompt = np.array([np.arange(90) % 250], dtype=np.int64)
  monkeypatch.setenv("XOT_PREFILL_CHUNK", "32")
  want = await _sp_run(_tp_engine(tiny_model_dir, monkeypatch, 0), prompt)
  monkeypatch.setenv("XOT_SERVE_SP", "2")
  sp = _tp_engine(tiny_model_dir, monkeypatch, 2)
  await sp.ensure_shard(_full_shard())
  mesh = sp._ctx.mesh
  assert mesh.shape == {"sp": 2, "tp": 2}
  got = await _sp_run(sp, prompt)
  assert sp.sp_ring_prefills == 1, sp.sp_ring_prefills
  assert got == want
  assert got == await _sp_run(_jax_engine(tiny_model_dir), prompt, JShard)


async def test_sp_only_mesh_serves(tiny_model_dir, monkeypatch):
  """XOT_SERVE_SP without tp (tp forced off) still builds a mesh and serves: sp is not
  parasitic on tp."""
  shard = _full_shard()
  prompt = np.array([np.arange(64) % 250], dtype=np.int64)
  monkeypatch.setenv("XOT_PREFILL_CHUNK", "32")
  ref, _ = await _tp_engine(tiny_model_dir, monkeypatch, 0).infer_tensor("r", shard, prompt)
  monkeypatch.setenv("XOT_SERVE_SP", "4")
  eng = _tp_engine(tiny_model_dir, monkeypatch, 0)
  await eng.ensure_shard(shard)
  assert eng._ctx.mesh is not None and eng._ctx.mesh.shape == {"sp": 4, "tp": 1}
  out, _ = await eng.infer_tensor("r", shard, prompt)
  assert eng.sp_ring_prefills == 1
  np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-3)


async def test_sp_clamps_and_shard_gating(tiny_model_dir, monkeypatch):
  """A non-power-of-two sp clamps down (3 -> 2), and a pipeline mid-shard never
  reserves sp devices: tp only. JAX's engine builds the same meshes."""
  for sp, shard, want in (("3", (0, N_LAYERS - 1), {"sp": 2, "tp": 2}),
                          ("2", (0, 1), {"tp": 2})):
    monkeypatch.setenv("XOT_SERVE_SP", sp)
    eng = _tp_engine(tiny_model_dir, monkeypatch, 2)
    await eng.ensure_shard(Shard("m", *shard, N_LAYERS))
    assert eng._ctx.mesh.shape == want
    jeng = _jax_engine(tiny_model_dir)
    await jeng.ensure_shard(JShard("m", *shard, N_LAYERS))
    assert dict(jeng._mesh.shape) == want


# ------------------------------------------------------------ tests/test_moe_ep.py

MOE = "synthetic-tiny-moe"
MOE_CFG = config_from_hf_dict(get_model_card(MOE)["synthetic_config"])
MOE_SHARD = Shard(MOE, 0, MOE_CFG.num_layers - 1, MOE_CFG.num_layers)
MOE_PROMPT = np.array([[7, 21, 3, 99, 150, 4, 61, 18]], dtype=np.int64)


def _jax_moe_params(n=None, first=True, last=True, seed=0, start_layer=0):
  from xotorch_tpu.models.config import config_from_hf_dict as j_config
  from xotorch_tpu.models.registry import get_model_card as j_card
  from xotorch_tpu.models.transformer import init_random_params as j_init
  jcfg = j_config(j_card(MOE)["synthetic_config"])
  return j_init(jcfg, n or jcfg.num_layers, first, last, jax.random.PRNGKey(seed),
                dtype=jnp.float32, start_layer=start_layer)


@pytest.fixture()
def moe_jax_weights(monkeypatch):
  """The port's synthetic init replaced by the JAX engine's draw (PRNGKey(0))."""
  def init(cfg, n, first, last, seed=0, dtype=torch.float32, device="cpu", start_layer=0, **_):
    jp = _jax_moe_params(n, first, last, seed, start_layer)
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device=device, dtype=dtype)
  monkeypatch.setattr(engine_mod, "init_random_params", init)


def test_routed_decode_equals_dense():
  """The routed gather and the dense combine are the same math: identical greedy
  chunks, as the port's ep positions take the dense form."""
  params = params_from_jax(jax.tree.map(np.asarray, _jax_moe_params(seed=7)), MOE_CFG)
  tok = torch.tensor([[3]])
  outs = {}
  for routed in (True, False):
    real = transformer._moe_mlp
    transformer._moe_mlp = lambda layer, h, cfg, **kw: real(layer, h, cfg, routed=routed)
    try:
      cache = transformer.init_kv_cache(MOE_CFG, MOE_CFG.num_layers, 1, 64, torch.float32)
      toks, _ = generate.decode_chunk(params, tok, cache, 0, MOE_CFG, 8, 0.0, 0)
    finally:
      transformer._moe_mlp = real
    outs[routed] = np.asarray(toks)
  np.testing.assert_array_equal(outs[True], outs[False])


def test_routed_decode_batched_rows_equal_dense():
  """Routed gather handles B > 1 (continuous batching rows) identically."""
  params = params_from_jax(jax.tree.map(np.asarray, _jax_moe_params(seed=1)), MOE_CFG)
  tok = torch.tensor([[3], [9], [200]])
  outs = {}
  for routed in (True, False):
    real = transformer._moe_mlp
    transformer._moe_mlp = lambda layer, h, cfg, **kw: real(layer, h, cfg, routed=routed)
    try:
      caches = [transformer.init_kv_cache(MOE_CFG, MOE_CFG.num_layers, 1, 64, torch.float32)
                for _ in range(3)]
      toks, _ = generate.decode_chunk_batched(params, caches, tok, torch.zeros(3, dtype=torch.int32),
                                              MOE_CFG, 6, torch.zeros(3), 0)
    finally:
      transformer._moe_mlp = real
    outs[routed] = np.asarray(toks)
  np.testing.assert_array_equal(outs[True], outs[False])


async def _serve_stream(monkeypatch, ep: int, tp: int = 0, quantize=None, jax_side=False):
  """A prompt + fused chunk on an engine with XOT_SERVE_EP=ep: (stream, mesh, engine)."""
  monkeypatch.setenv("XOT_SERVE_EP", str(ep))
  monkeypatch.setenv("XOT_SERVE_TP", str(tp))
  if jax_side:
    eng, shard = JAXShardInferenceEngine(dtype="float32", quantize=quantize), JShard(MOE, 0, MOE_CFG.num_layers - 1, MOE_CFG.num_layers)
  else:
    eng, shard = TorchShardInferenceEngine(device="cpu", quantize=quantize), MOE_SHARD
  out, _ = await eng.infer_tensor("moe-req", shard, MOE_PROMPT)
  tok = int(np.argmax(np.asarray(out)[0, -1]))
  chunk = await eng.generate_chunk("moe-req", shard, tok, 8, temp=0.0, top_k=0)
  mesh = eng._mesh if jax_side else eng._ctx.mesh
  return [tok] + [int(t) for t in chunk], mesh, eng


async def test_ep_sharded_serving_matches_dense_single_chip(monkeypatch, moe_jax_weights):
  """XOT_SERVE_EP=2: the experts split over ep (each position holds E/ep of them) and
  serving reproduces the single-device stream and JAX's ep=2 stream token for token."""
  dense_stream, dense_mesh, _ = await _serve_stream(monkeypatch, 0)
  assert dense_mesh is None
  ep_stream, ep_mesh, eng = await _serve_stream(monkeypatch, 2)
  assert ep_mesh is not None and ep_mesh.shape == {"ep": 2, "tp": 1}
  pieces = eng._ctx.params.pieces
  assert [p["layers"]["we_gate"].shape[1] for p in pieces] == [MOE_CFG.num_experts // 2] * 2
  assert ep_stream == dense_stream and len(ep_stream) == 9
  j_stream, _, _ = await _serve_stream(monkeypatch, 2, jax_side=True)
  assert ep_stream == j_stream


async def test_ep_with_int8_experts_matches_dense(monkeypatch, moe_jax_weights):
  """ep composes with int8-quantized experts (scale leaves follow their base tensors'
  ep placement), as in JAX's engine."""
  dense_stream, _, _ = await _serve_stream(monkeypatch, 0, quantize="int8")
  ep_stream, ep_mesh, eng = await _serve_stream(monkeypatch, 2, quantize="int8")
  assert ep_mesh.shape["ep"] == 2
  scale = eng._ctx.params.pieces[1]["layers"]["we_gate_scale"]
  assert scale.shape[1] == MOE_CFG.num_experts // 2
  assert ep_stream == dense_stream
  j_stream, _, _ = await _serve_stream(monkeypatch, 2, quantize="int8", jax_side=True)
  assert ep_stream == j_stream


async def test_ep_composes_with_tp(monkeypatch, moe_jax_weights):
  """ep x tp: experts over ep AND their inner dim over tp (attention fully tp): the
  stream equals the dense single-device run and JAX's ep=2 x tp=2 engine's."""
  dense_stream, _, _ = await _serve_stream(monkeypatch, 0)
  stream, mesh, eng = await _serve_stream(monkeypatch, 2, tp=2)
  assert mesh.shape == {"ep": 2, "tp": 2}
  we = eng._ctx.params.pieces[3]["layers"]["we_gate"]
  assert we.shape[1:] == (MOE_CFG.num_experts // 2, MOE_CFG.hidden_size,
                          MOE_CFG.moe_intermediate_size // 2)
  assert stream == dense_stream
  j_stream, _, _ = await _serve_stream(monkeypatch, 2, tp=2, jax_side=True)
  assert stream == j_stream


async def test_ep_reduces_to_divisor_of_expert_count(monkeypatch, moe_jax_weights):
  """A requested ep that does not divide num_experts (4) reduces to the largest
  divisor instead of failing placement."""
  _, mesh, _ = await _serve_stream(monkeypatch, 3)
  assert mesh is not None and mesh.shape["ep"] == 2


def test_serve_ep_cli_flag(monkeypatch):
  """--serve-ep, --serve-tp and --serve-sp ride the env into the engine."""
  from xotorch_tpu_torch.main import build_node, build_parser
  for knob in ("XOT_SERVE_EP", "XOT_SERVE_TP", "XOT_SERVE_SP"):
    monkeypatch.setenv(knob, "0")  # restored (unset) when the test ends: build_node writes them
  args = build_parser().parse_args(["run", "synthetic-tiny-moe", "--serve-ep", "4", "--serve-tp",
                                    "2", "--serve-sp", "2", "--inference-engine", "dummy"])
  build_node(args)
  assert (os.environ["XOT_SERVE_EP"], os.environ["XOT_SERVE_TP"],
          os.environ["XOT_SERVE_SP"]) == ("4", "2", "2")


# ------------------------------------------------------------------ refusals


@pytest.mark.parametrize("knob,value", [("XOT_FABRIC_PEERS", "http://127.0.0.1:1"),
                                        ("XOT_FABRIC_ROLE", "prefill")])
def test_mesh_refuses_knob_paths_when_built(knob, value, monkeypatch):
  """The KV fabric is not served over a mesh: the engine refuses it when it is built,
  naming the knob; without a mesh it builds. (LoRA over a mesh serves and trains:
  tests/test_torch_parallel_train.py.)"""
  monkeypatch.setenv(knob, value)
  monkeypatch.setenv("XOT_TP", "2")
  with pytest.raises(ValueError, match=knob):
    TorchShardInferenceEngine(device="cpu")
  monkeypatch.setenv("XOT_TP", "0")
  TorchShardInferenceEngine(device="cpu").executor.shutdown(wait=True)


async def test_mesh_refuses_called_paths(monkeypatch):
  """The fused in-process ring and the fabric's transfers refuse under a mesh request
  with a ValueError naming the mesh knobs, and the engine offers no ring fusion; a
  multimodal model refuses when its shard loads. (Training, evaluation and checkpoints
  over a mesh run: tests/test_torch_parallel_train.py.)"""
  monkeypatch.setenv("XOT_TP", "2")
  eng = TorchShardInferenceEngine(device="cpu")
  shard = Shard("synthetic-tiny", 0, 3, 4)
  assert eng.supports_ring_fusion is False
  calls = [eng.generate_chunk_ring("r", [(eng, shard)], 1, 4),
           eng.verify_draft_ring("r", [(eng, shard)], 1, [2]),
           eng.prefill_export(shard, "hello")]
  for call in calls:
    with pytest.raises(ValueError, match="XOT_TP"):
      await call
  with pytest.raises(ValueError, match="XOT_TP"):
    eng.fabric_offer(shard, np.arange(4), 4, 16, "http://127.0.0.1:1")
  cfg = config_from_hf_dict(get_model_card("synthetic-tiny")["synthetic_config"])
  import dataclasses
  with pytest.raises(ValueError, match="vision"):
    monkeypatch.setattr(engine_mod, "config_from_hf_dict",
                        lambda d: dataclasses.replace(cfg, vision=object()))
    await eng.ensure_shard(shard)
  eng.executor.shutdown(wait=True)


async def test_unset_tp_serves_one_position(tiny_model_dir, monkeypatch):
  """With no mesh knob set, eight local devices leave the engine on one position (JAX
  takes every local card; the port's auto-tp waits for a run over distinct cards), and
  nothing is refused."""
  for knob in ("XOT_TP", "XOT_SERVE_TP"):
    monkeypatch.delenv(knob, raising=False)
  eng = _engine(tiny_model_dir)
  assert len(eng._local_devices) == 8 and not eng._mesh_requested()
  assert eng.supports_ring_fusion is not False
  await eng.ensure_shard(_full_shard())
  assert eng._ctx.mesh is None
  eng.executor.shutdown(wait=True)


def test_process_group_refused_when_built(monkeypatch):
  """A process group of more than one process (XOT_COORDINATOR, XOT_MULTIHOST) is
  refused when the engine is built: the serving mesh does not span processes, and each
  rank would serve its shard alone. A group of one builds."""
  import torch.distributed as dist
  monkeypatch.setattr(dist, "is_initialized", lambda: True)
  monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
  with pytest.raises(ValueError, match="XOT_COORDINATOR/XOT_MULTIHOST"):
    TorchShardInferenceEngine(device="cpu")
  monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
  TorchShardInferenceEngine(device="cpu").executor.shutdown(wait=True)


def test_graph_capture_refused_across_devices():
  """A decode program whose mesh spans distinct devices is refused before its first
  run, naming its key; one over a repeated device runs."""
  from tests.test_torch_graphs import EagerGraphCache
  from xotorch_tpu_torch.models import graphs
  gc = EagerGraphCache("cpu")
  for devices, refused in ((["cpu", "cpu"], False), (["cuda:0", "cuda:1"], True)):
    params = MeshParams(make_mesh({"tp": 2}, devices), [{}, {}])
    key = ("decode", "contiguous", 1) + graphs._mesh_key(params)
    prog = gc.program(key, dict, lambda st: (lambda: 7))
    if refused:
      with pytest.raises(RuntimeError, match=r"refused: its mesh spans 2 devices"):
        gc.run(prog)
    else:
      assert gc.run(prog) == 7


# ------------------------------------------------------------------ the host KV tier

@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_tp_host_tier_spill_and_restore(paged, monkeypatch):
  """The host KV tier under a tp=2 mesh: an evicted prefix entry spills every cache
  piece, and a restore puts each back on its own position bit for bit (tests/
  test_torch_kv_offload.py's spill-and-restore, over pieces); a prompt sharing the head
  then decodes warm to the single-device engine's cold stream."""
  from xotorch_tpu_torch.inference.torch_engine import paged_cache
  for name, value in (("XOT_SEED", "7"), ("XOT_CACHE_LEN", "16"), ("XOT_PREFIX_CACHE_MIN", "16"),
                      ("XOT_KV_HOST_BYTES", str(64 << 20)), ("XOT_KV_PAGE", "16"),
                      ("XOT_KV_POOL_TOKENS", "512"), ("XOT_PAGED_KV", paged)):
    monkeypatch.setenv(name, value)
  shard = Shard("synthetic-tiny", 0, 3, 4)
  prompt_a = np.array([np.arange(44) % 250 + 1], dtype=np.int64)
  prompt_b = np.concatenate([prompt_a, np.array([[99, 98, 97, 96]])], axis=1)

  async def generate(eng, rid, prompt):
    tok, _ = await eng.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
    out = await eng.generate_chunk(rid, shard, int(tok), 8, temp=0.0, top_k=0)
    return [int(tok)] + [int(t) for t in np.asarray(out).reshape(-1)]

  monkeypatch.setenv("XOT_TP", "0")
  monkeypatch.setenv("XOT_PREFIX_CACHE", "0")
  cold = await generate(TorchShardInferenceEngine(device="cpu", seed=0), "cold", prompt_b)
  monkeypatch.setenv("XOT_TP", "2")
  monkeypatch.setenv("XOT_PREFIX_CACHE", "2")
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  await generate(eng, "ra", prompt_a)
  ctx = eng._ctx
  assert ctx.mesh.shape == {"tp": 2}
  (_, entry), = ctx.prefix_cache.values()
  if paged == "1":
    before = paged_cache.gather_pages(ctx.page_pool.arena, entry["pages"])
  else:
    before = {n: t.clone() for n, t in entry.items()}
  assert set(before) == {"k", "v", "k@1", "v@1"}
  eng._free_device_memory()
  with torch.inference_mode():
    eng._host_promote(ctx, prompt_b.reshape(-1))
  (_, restored), = ctx.prefix_cache.values()
  after = (paged_cache.gather_pages(ctx.page_pool.arena, restored["pages"]) if paged == "1"
           else restored)
  for name, buf in before.items():
    n = buf.shape[2]
    assert torch.equal(after[name][:, :, :n], buf), name
  assert eng._host_kv_hits == 1 and eng._host_restore_fallbacks == 0
  assert await generate(eng, "rb", prompt_b) == cold
  assert eng._prefix_hits >= 1


def test_shard_cache_and_batch_follow_jax_specs():
  """parallel/mesh.shard_cache splits a made cache (int8 scale leaves at rank 4 too)
  into the pieces init_kv_cache(mesh=) makes in place, with the same values; shard_batch
  splits rows over dp and positions over sp, as JAX's batch_spec places them."""
  from xotorch_tpu_torch.parallel.mesh import cache_piece, shard_batch, shard_cache
  cfg = config_from_hf_dict(TINY_LLAMA_CFG)
  mesh = make_mesh({"sp": 2, "tp": 2})
  cache = transformer.init_kv_cache(cfg, 2, 1, 8, torch.float32, kv_quant=True)
  for name in cache:
    cache[name].copy_(torch.randn(cache[name].shape).to(cache[name].dtype))
  split = shard_cache(cache, mesh)
  made = transformer.init_kv_cache(cfg, 2, 1, 8, torch.float32, kv_quant=True, mesh=mesh)
  assert {n: (t.shape, t.dtype) for n, t in split.items()} == \
    {n: (t.shape, t.dtype) for n, t in made.items()}
  for j in range(2):
    for name, piece in cache_piece(split, j).items():
      assert torch.equal(piece, cache[name][:, :, :, j:j + 1])
  batch = shard_batch({"x": torch.arange(16).reshape(2, 8)}, make_mesh({"dp": 2, "sp": 2}))
  assert [p.tolist() for p in batch["x"]] == [[[0, 1, 2, 3]], [[4, 5, 6, 7]],
                                             [[8, 9, 10, 11]], [[12, 13, 14, 15]]]


# ------------------------------------------ training, checkpoints and LoRA over tp
#
# The JAX engine trains over its tp mesh (GSPMD partitions the gradient of its sharded
# params); the port's engine over XOT_TP=2 runs the training forward on the mesh, each
# tp position's K1/K1b on its heads, and parallel/zero.MeshAdamW over the pieces. Losses
# are held within 1e-4 relative (the partial sums add in another order) of the port's
# single-device engine and of JAX's tp=2 engine; files byte for byte.


def _train_batch(seed):
  rng = np.random.RandomState(seed)
  x = rng.randint(3, TINY_LLAMA_CFG["vocab_size"], (2, 13))
  return x[:, :-1], x[:, 1:], np.array([12, 7], np.int64)


def _with_adapters(eng, layers):
  """Replace the active context's adapter leaves (a plain tree's, or replicated over a
  mesh) with `layers` (numpy), and drop its optimizer."""
  from xotorch_tpu_torch.parallel.mesh import with_layers
  ctx = eng._ctx
  new = {k: torch.from_numpy(np.array(v)) for k, v in layers.items() if k.startswith("lora_")}
  if isinstance(ctx.params, MeshParams):
    ctx.params = with_layers(ctx.params, new)
  else:
    ctx.params = {**ctx.params, "layers": {**ctx.params["layers"], **new}}
  ctx.optimizer = ctx.opt_leaves = None


@pytest.mark.parametrize("kind", ["full", "lora", "qlora"])
async def test_tp_engine_trains_like_one_device_and_jax(tiny_model_dir, monkeypatch, kind):
  """train_example twice and evaluate_example over XOT_TP=2: full fine-tune, LoRA, and
  QLoRA over int8 weights, each against the port's single-device engine and JAX's tp=2
  engine on the same checkpoint and, under LoRA, JAX's adapter draw."""
  extra = {"XOT_LR": "1e-2", "XOT_INT8_KERNEL": "0"}
  if kind != "full":
    extra["XOT_LORA_RANK"] = "2"
  if kind == "qlora":
    extra["XOT_QUANTIZE"] = "int8"
  shard, jshard = _full_shard(), _full_shard(JShard)
  _env(monkeypatch, 0, **extra)
  one = _engine(tiny_model_dir)
  _env(monkeypatch, 2, **extra)
  tp = _engine(tiny_model_dir)
  jeng = _jax_engine(tiny_model_dir)
  for eng, s in ((one, shard), (tp, shard), (jeng, jshard)):
    await eng.ensure_shard(s)
  assert _tp(tp) == 2 and _tp(one) == 0
  if kind != "full":
    for eng in (one, tp):
      _with_adapters(eng, jeng.params["layers"])
  losses = {id(e): [] for e in (one, tp, jeng)}
  for i in range(2):
    for eng, s in ((one, shard), (tp, shard), (jeng, jshard)):
      losses[id(eng)].append((await eng.train_example(f"t{i}", s, *_train_batch(i)))[0])
  for eng, s in ((one, shard), (tp, shard), (jeng, jshard)):
    losses[id(eng)].append(await eng.evaluate_example("e", s, *_train_batch(9)))
  np.testing.assert_allclose(losses[id(tp)], losses[id(one)], rtol=1e-4)
  np.testing.assert_allclose(losses[id(tp)], losses[id(jeng)], rtol=1e-4)
  assert isinstance(tp._ctx.optimizer, MeshAdamW)
  for eng in (one, tp):
    eng.executor.shutdown(wait=True)


async def test_tp_peer_in_a_training_ring(tiny_model_dir, monkeypatch):
  """A two-shard LoRA training ring whose first peer serves over tp=2: the activations
  go downstream, the gradient comes back through the mesh's pieces; losses and the
  evaluation equal the same ring with both peers on one device."""
  first, second = Shard("m", 0, N_LAYERS // 2 - 1, N_LAYERS), Shard("m", N_LAYERS // 2, N_LAYERS - 1, N_LAYERS)
  runs = []
  for tp in (2, 0):
    _env(monkeypatch, tp, XOT_LR="1e-2", XOT_LORA_RANK="2")
    eng_a = _engine(tiny_model_dir)
    _env(monkeypatch, 0, XOT_LR="1e-2", XOT_LORA_RANK="2")
    eng_b = _engine(tiny_model_dir)
    await eng_a.ensure_shard(first)
    await eng_b.ensure_shard(second)
    assert _tp(eng_a) == tp

    async def downstream(activations, target, lengths_, train, eng_b=eng_b):
      if train:
        return await eng_b.train_example("req", second, activations, target, lengths_)
      return await eng_b.evaluate_example("req", second, activations, target, lengths_), None

    losses = [(await eng_a.train_example("req", first, *_train_batch(i), forward_fn=downstream))[0]
              for i in range(3)]
    losses.append(await eng_a.evaluate_example("req", first, *_train_batch(9), forward_fn=downstream))
    runs.append(losses)
    for e in (eng_a, eng_b):
      e.executor.shutdown(wait=True)
  np.testing.assert_allclose(runs[0], runs[1], rtol=1e-4)


def _files(d):
  return {p.name: p.read_bytes() for p in sorted(Path(d).glob("*.safetensors"))}


@pytest.mark.parametrize("kind", ["full", "lora"])
async def test_tp_checkpoints_are_the_single_device_files(tiny_model_dir, monkeypatch, tmp_path, kind):
  """save_checkpoint over tp=2 writes the single-device engine's files byte for byte: an
  untrained save, and (a shard save or an adapter file with its moments file, in JAX's
  layout) after load_checkpoint of a single-device engine's trained save; the loaded
  tp engine streams the single-device engine's greedy tokens and resumes training with
  the restored moments at its loss."""
  extra = {"XOT_LR": "1e-2", "XOT_SAVE_OPT_STATE": "1"}
  if kind == "lora":
    extra["XOT_LORA_RANK"] = "2"
  shard = _full_shard()
  name = f"0-{N_LAYERS - 1}-2.safetensors"
  _env(monkeypatch, 0, **extra)
  one = _engine(tiny_model_dir)
  _env(monkeypatch, 2, **extra)
  tp = _engine(tiny_model_dir)
  await one.save_checkpoint(shard, str(tmp_path / "u1" / name))
  await tp.save_checkpoint(shard, str(tmp_path / "u2" / name))
  assert _files(tmp_path / "u1") == _files(tmp_path / "u2")
  for i in range(2):
    await one.train_example(f"t{i}", shard, *_train_batch(i))
  await one.save_checkpoint(shard, str(tmp_path / "a" / name))
  assert (tmp_path / "a" / name.replace(".safetensors", "-opt.safetensors")).exists()
  await tp.load_checkpoint(shard, str(tmp_path / "a" / name))
  assert tp._ctx.optimizer is not None and _tp(tp) == 2
  await tp.save_checkpoint(shard, str(tmp_path / "b" / name))
  assert _files(tmp_path / "a") == _files(tmp_path / "b")
  _env(monkeypatch, 0, **extra)
  fresh = _engine(tiny_model_dir)
  await fresh.load_checkpoint(shard, str(tmp_path / "a" / name))
  assert await _greedy_stream(tp, "g", 10) == await _greedy_stream(fresh, "g", 10)
  resumed = [(await e.train_example("t", shard, *_train_batch(5)))[0] for e in (one, tp, fresh)]
  np.testing.assert_allclose(resumed[1], resumed[0], rtol=1e-4)
  np.testing.assert_allclose(resumed[2], resumed[0], rtol=1e-4)
  for e in (one, tp, fresh):
    e.executor.shutdown(wait=True)


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_tp_lora_serving(tiny_model_dir, monkeypatch, tmp_path, paged):
  """LoRA serving over tp=2: a registered adapter (XOT_ADAPTERS, `m@ad`, seeded nonzero
  B, written by JAX) streams the single-device engine's and JAX's tp=2 engine's greedy
  tokens, its context aliasing the base context's pieces; fresh adapters
  (XOT_LORA_RANK) stream the single-device engine's."""
  from tests.test_torch_multi_lora import write_adapter
  from xotorch_tpu.train import lora as j_lora
  ad = write_adapter(tmp_path / "ad.safetensors", 1, j_lora.ATTN_SLOTS + j_lora.MLP_SLOTS, rank=4)
  extra = {"XOT_PAGED_KV": paged, "XOT_ADAPTERS": f"ad={ad}", "XOT_MAX_RESIDENT_MODELS": "3"}
  streams = {}
  shards = (Shard("m", 0, N_LAYERS - 1, N_LAYERS), Shard("m@ad", 0, N_LAYERS - 1, N_LAYERS))
  jshards = (JShard("m", 0, N_LAYERS - 1, N_LAYERS), JShard("m@ad", 0, N_LAYERS - 1, N_LAYERS))
  for tp in (0, 2):
    _env(monkeypatch, tp, **extra)
    eng = _engine(tiny_model_dir)
    streams[tp] = [await _lora_stream(eng, s, f"r{i}") for i, s in enumerate(shards)]
    if tp:
      base, adapted = eng._contexts[shards[0]], eng._contexts[shards[1]]
      assert base.mesh is adapted.mesh and isinstance(adapted.params, MeshParams)
      assert adapted.params.pieces[1]["layers"]["wq"] is base.params.pieces[1]["layers"]["wq"]
    eng.executor.shutdown(wait=True)
  assert streams[2] == streams[0] and streams[2][1] != streams[2][0], streams
  from xotorch_tpu.inference.jax_engine import engine as j_engine_mod
  monkeypatch.setattr(j_engine_mod, "MAX_RESIDENT_MODELS", 3)
  jeng = _jax_engine(tiny_model_dir)
  assert [await _lora_stream(jeng, s, f"r{i}") for i, s in enumerate(jshards)] == streams[2]
  monkeypatch.delenv("XOT_ADAPTERS")
  fresh = {}
  for tp in (0, 2):
    _env(monkeypatch, tp, XOT_PAGED_KV=paged, XOT_LORA_RANK="4")
    eng = _engine(tiny_model_dir)
    fresh[tp] = await _lora_stream(eng, shards[0], "f")
    assert lora.has_lora(eng._ctx.params)
    eng.executor.shutdown(wait=True)
  assert fresh[2] == fresh[0]


async def _lora_stream(eng, shard, rid, n=10):
  tok, _ = await eng.infer_sample_tensor(rid, shard, _PROMPT, temp=0.0)
  seq = [int(tok)]
  out = await eng.generate_chunk(rid, shard, seq[-1], n - 1, temp=0.0)
  seq.extend(int(t) for t in np.asarray(out).reshape(-1))
  await eng.clear_request(rid)
  return seq
