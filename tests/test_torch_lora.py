"""LoRA in the port's model and its adapter-only checkpoints (xotorch_tpu_torch/train/lora.py,
models/transformer._maybe_lora, the engine's load_checkpoint / save_checkpoint) against
the JAX package, on the CPU.

Adapters carry seeded NONZERO B (fresh adapters have B = 0, which would make every
equality below hold for a model that ignores them); each logits case also runs a
control with the adapters dropped, which must miss. Logits are compared at fp32 with
atol 1e-4, JAX's matmuls at "highest" precision:

- the forward with adapters on attention only and on all seven slots, over fp32,
  int8 (plain and K6's function) and int4 (plain and K5's function) bases;
- `add_lora_params`' shapes and dtypes, the int4 packed input width included;
- adapter files written by either package load in the other, tensor for tensor;
- `validate_adapter_file` gives JAX's result on JAX's cases and more (a wrong depth,
  mixed ranks, an unknown slot, a missing pair, a directory of shard saves);
- the engines' checkpoint round trips of tests/test_lora.py (an adapter-only file, the
  union of shard saves over a re-partitioned range with base files beside them, an
  explicit full file beating the HF index), with trained weights stood in for by
  seeded ones, held against the JAX engine loading the same files.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model_equivalence import TINY_LLAMA_CFG, make_hf_checkpoint
from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import quantize as jq
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.train import lora as j_lora
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import quantize as q
from xotorch_tpu_torch.models import transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.weights import _SafetensorsFile, params_from_jax
from xotorch_tpu_torch.train import lora

torch.set_num_threads(2)

# A narrow llama whose 256-wide contractions split into two int4 groups of 128.
NARROW = {"model_type": "llama", "hidden_size": 256, "intermediate_size": 512,
          "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
          "vocab_size": 256, "max_position_embeddings": 2048, "rope_theta": 10000.0,
          "tie_word_embeddings": False, "eos_token_id": 2}
ATOL = 1e-4
N = TINY_LLAMA_CFG["num_hidden_layers"]
KNOBS = ("XOT_QUANTIZE", "XOT_INT4_KERNEL", "XOT_INT4_V", "XOT_INT8_KERNEL", "XOT_LORA_RANK",
         "XOT_LORA_TARGETS", "XOT_ADAPTERS")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  for name in KNOBS:
    monkeypatch.delenv(name, raising=False)
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_SEED", "7")
  with jax.default_matmul_precision("highest"):
    yield


def _np(x):
  return np.asarray(x)


def seeded_b(layers: dict, seed: int, scale: float = 0.05) -> dict:
  """`layers` with every `lora_*_b` replaced by a seeded normal draw (numpy), in each
  leaf's own dtype: what training would have made of the zero init."""
  rng = np.random.default_rng(seed)
  out = dict(layers)
  for k in sorted(layers):
    if k.startswith("lora_") and k.endswith("_b"):
      v = layers[k]
      draw = (rng.standard_normal(tuple(v.shape)) * scale).astype(np.float32)
      out[k] = (torch.from_numpy(draw).to(v.dtype) if torch.is_tensor(v)
                else jnp.asarray(draw).astype(v.dtype))
  return out


def _jax_tree(cfg_dict, fmt, targets, rank=4, seed=1):
  """JAX params for `cfg_dict` (fp32), quantized to `fmt`, with rank-`rank` adapters on
  `targets` and seeded nonzero B."""
  jcfg = j_config_from_hf_dict(cfg_dict)
  jp = j_transformer.init_random_params(jcfg, jcfg.num_layers, True, True, jax.random.PRNGKey(0),
                                        dtype=jnp.float32)
  if fmt:
    jp = jq.quantize_params(jp, fmt, scale_dtype=jnp.float32)
  if targets:
    jp = j_lora.add_lora_params(jp, rank, jax.random.PRNGKey(seed), targets)
    jp = {**jp, "layers": seeded_b(jp["layers"], seed)}
  return jcfg, jp


TARGETS = {"attn": j_lora.ATTN_SLOTS, "all": j_lora.ATTN_SLOTS + j_lora.MLP_SLOTS}
BASES = {
  "fp32": (None, {}),
  "int8": ("int8", {}),
  "int8-K6": ("int8", {"XOT_INT8_KERNEL": "force"}),
  "int4": ("int4", {"XOT_INT4_KERNEL": "0"}),
  "int4-K5": ("int4", {"XOT_INT4_KERNEL": "force"}),
}


def _run_forward(jp, jcfg, cfg, params, steps=3):
  """A 9-token prefill then `steps` greedy decode steps (JAX's argmax fed to both):
  [(port logits, JAX logits)] each call."""
  L, S = cfg.num_layers, 32
  jcache = j_transformer.init_kv_cache(jcfg, L, 1, S, jnp.float32)
  cache = transformer.init_kv_cache(cfg, L, 1, S, torch.float32)
  toks = np.random.default_rng(4).integers(3, cfg.vocab_size, size=(1, 9)).astype(np.int32)
  pairs, pos = [], 0
  for _ in range(steps + 1):
    jl, jcache = j_transformer.forward_shard(jp, jnp.asarray(toks), jcache, jnp.int32(pos), jcfg,
                                             True, True)
    tl, cache = transformer.forward_shard(params, torch.from_numpy(toks).long(), cache, pos, cfg,
                                          True, True)
    pairs.append((tl.numpy(), _np(jl)))
    pos += toks.shape[1]
    toks = np.array([[int(np.argmax(_np(jl)[0, -1]))]], np.int32)
  return pairs


@pytest.mark.parametrize("base", list(BASES))
@pytest.mark.parametrize("targets", list(TARGETS))
def test_forward_with_adapters_matches_jax(base, targets, monkeypatch):
  """forward_shard with adapters against JAX's on the same tree (params_from_jax):
  prefill and decode logits within 1e-4. Over a quantized base the decode steps reach
  K5's / K6's function where the knob forces it (the delta adds to its output), the
  prefill the dequantized product. Control: the same tree without its adapters misses."""
  fmt, env = BASES[base]
  for name, value in env.items():
    monkeypatch.setenv(name, value)
  jcfg, jp = _jax_tree(NARROW, fmt, TARGETS[targets])
  cfg = config_from_hf_dict(NARROW)
  params = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
  want_slots = {f"lora_{s}_{ab}" for s in TARGETS[targets] for ab in "ab"}
  assert {k for k in params["layers"] if k.startswith("lora_")} == want_slots
  for i, (got, want) in enumerate(_run_forward(jp, jcfg, cfg, params)):
    np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"{base}/{targets} call {i}")
  bare = {**params, "layers": {k: v for k, v in params["layers"].items() if not k.startswith("lora_")}}
  worst = max(np.abs(g - w).max() for g, w in _run_forward(jp, jcfg, cfg, bare, steps=0))
  assert worst > 100 * ATOL, f"dropping the adapters moved the logits only {worst}"


@pytest.mark.parametrize("fmt", [None, "int8", "int4"])
def test_add_lora_params_matches_jax_layout(fmt):
  """Shapes and dtypes of fresh adapters as JAX makes them, the int4 packed input width
  [L, G, gs/2, out] -> G * gs included; A ~ N(0, 0.02), B = 0; base leaves untouched."""
  jcfg, jp = _jax_tree(NARROW, fmt, ())
  cfg = config_from_hf_dict(NARROW)
  params = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
  targets = TARGETS["all"]
  want = j_lora.add_lora_params(jp, 8, jax.random.PRNGKey(3), targets)
  got = lora.add_lora_params(params, 8, torch.Generator().manual_seed(3), targets)
  for slot in targets:
    for name in lora.lora_names(slot):
      w, g = want["layers"][name], got["layers"][name]
      assert tuple(g.shape) == tuple(w.shape), name
      assert str(g.dtype).split(".")[-1] == str(w.dtype), name
    a, b = got["layers"][f"lora_{slot}_a"], got["layers"][f"lora_{slot}_b"]
    assert not b.any() and abs(float(a.float().std()) - 0.02) < 0.004
    assert got["layers"][slot] is params["layers"][slot]
  assert lora.has_lora(got) and not lora.has_lora(params)
  jcount = j_lora.lora_param_counts(want)
  assert lora.lora_param_counts(got) == jcount and jcount[0] > 0


def test_quantize_params_leaves_adapters_alone():
  """quantize_params quantizes the base slots only: adapters stay in the compute dtype,
  as JAX keeps them (models/quantize.py), whichever order the two are applied in."""
  cfg = config_from_hf_dict(NARROW)
  params = transformer.init_random_params(cfg, 2, True, True)
  params = lora.add_lora_params(params, 4, torch.Generator().manual_seed(0), TARGETS["all"])
  for fmt in ("int8", "int4"):
    out = q.quantize_params(params, fmt, scale_dtype=torch.float32)
    for k, v in params["layers"].items():
      if k.startswith("lora_"):
        assert out["layers"][k] is v
    assert not any(k.startswith("lora_") and (k.endswith("_scale") or k.endswith("_gscale"))
                   for k in out["layers"])


def _layers_equal(got: dict, want: dict, names):
  for n in names:
    np.testing.assert_array_equal(np.asarray(got[n].float()), np.asarray(want[n], np.float32),
                                  err_msg=n)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_adapter_files_load_across_packages(dtype, tmp_path):
  """A file JAX's save_lora_checkpoint writes loads in the port bit for bit, and the
  port's file loads in JAX: the same names (`lora.layers.{i}.{slot}_{a|b}`, absolute
  layer indices), shapes, dtypes and values, over a shard that starts mid-model."""
  jcfg, jp = _jax_tree(NARROW, None, TARGETS["all"])
  jp = jax.tree.map(lambda x: x.astype(dtype), jp)
  cfg = config_from_hf_dict(NARROW)
  names = [k for k in jp["layers"] if k.startswith("lora_")]
  jshard, shard = JShard("m", 2, 3, 4), Shard("m", 2, 3, 4)
  j_lora.save_lora_checkpoint(jp, jshard, tmp_path / "jax.safetensors")
  params = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
  lora.save_lora_checkpoint(params, shard, tmp_path / "port.safetensors")
  hj, hp = (_SafetensorsFile(tmp_path / f).header for f in ("jax.safetensors", "port.safetensors"))
  assert {k: (v["dtype"], v["shape"]) for k, v in hj.items()} == \
         {k: (v["dtype"], v["shape"]) for k, v in hp.items()}
  assert sorted(hj) == sorted(f"lora.layers.{i}.{n[5:]}" for i in (2, 3) for n in names)

  bare = {**params, "layers": {k: v for k, v in params["layers"].items() if not k.startswith("lora_")}}
  jbare = {**jp, "layers": {k: v for k, v in jp["layers"].items() if not k.startswith("lora_")}}
  got = lora.load_lora_checkpoint(bare, shard, tmp_path / "jax.safetensors")
  _layers_equal(got["layers"], jax.tree.map(np.asarray, jp)["layers"], names)
  back = j_lora.load_lora_checkpoint(jbare, jshard, tmp_path / "port.safetensors")
  _layers_equal(params["layers"], jax.tree.map(np.asarray, back)["layers"], names)
  for f in ("jax.safetensors", "port.safetensors"):
    assert lora.is_lora_checkpoint(tmp_path / f) and j_lora.is_lora_checkpoint(tmp_path / f)
  with pytest.raises(KeyError) as port_err:
    lora.load_lora_checkpoint(bare, Shard("m", 1, 3, 4), tmp_path / "jax.safetensors")
  with pytest.raises(KeyError) as jax_err:
    j_lora.load_lora_checkpoint(jbare, JShard("m", 1, 3, 4), tmp_path / "jax.safetensors")
  assert str(port_err.value) == str(jax_err.value)


def _validate_cases(tmp_path):
  """(label, path, n_layers) of every case both packages judge."""
  jcfg, jp = _jax_tree(NARROW, None, TARGETS["attn"])
  shard = JShard("m", 0, 1, 2)
  ok = tmp_path / "ok.safetensors"
  j_lora.save_lora_checkpoint(jp, shard, ok)
  junk = tmp_path / "junk.safetensors"
  junk.write_bytes(b"not safetensors")
  shard_dir = tmp_path / "ckpt_dir"
  shard_dir.mkdir()
  j_lora.save_lora_checkpoint(jp, JShard("m", 0, 0, 2), shard_dir / "0-0-1.safetensors")
  j_lora.save_lora_checkpoint(jp, JShard("m", 1, 1, 2), shard_dir / "1-1-3.safetensors")
  (shard_dir / "1-1-2.safetensors").write_bytes(junk.read_bytes())  # an older iteration
  half_dir = tmp_path / "half_dir"
  half_dir.mkdir()
  j_lora.save_lora_checkpoint(jp, JShard("m", 0, 0, 2), half_dir / "0-0-1.safetensors")
  empty = tmp_path / "empty_dir"
  empty.mkdir()
  mixed = tmp_path / "mixed.safetensors"
  j_lora.save_lora_checkpoint({**jp, "layers": {**jp["layers"],
                                                "lora_wv_a": jnp.zeros((2, 256, 2)),
                                                "lora_wv_b": jnp.zeros((2, 2, 128))}}, shard, mixed)
  unpaired = tmp_path / "unpaired.safetensors"
  j_lora.save_lora_checkpoint({**jp, "layers": {k: v for k, v in jp["layers"].items()
                                                if k != "lora_wq_b"}}, shard, unpaired)
  expert = tmp_path / "expert.safetensors"
  j_lora.save_lora_checkpoint({**jp, "layers": {**jp["layers"],
                                                "lora_we_up_a": jnp.zeros((2, 256, 4))}}, shard, expert)
  base = tmp_path / "base.safetensors"
  from safetensors.numpy import save_file
  save_file({"model.norm.weight": np.ones(4, np.float32)}, str(base))
  return [("ok", ok, 2), ("deeper base", ok, 4), ("shallower base", ok, 1), ("junk", junk, 2),
          ("shard dir", shard_dir, 2), ("half dir", half_dir, 2), ("empty dir", empty, 2),
          ("mixed ranks", mixed, 2), ("unpaired", unpaired, 2), ("expert slot", expert, 2),
          ("base weights", base, 2), ("missing", tmp_path / "nope.safetensors", 2)]


def test_validate_adapter_file_matches_jax(tmp_path):
  """Both packages' header checks give the same verdict and message on every case;
  where the file is unreadable the reader's own exception follows JAX's words."""
  verdicts = {}
  for label, path, n in _validate_cases(tmp_path):
    got, want = lora.validate_adapter_file(path, n), j_lora.validate_adapter_file(path, n)
    if want is not None and want.startswith("unreadable adapter checkpoint: "):
      assert got is not None and got.startswith("unreadable adapter checkpoint: "), label
    else:
      assert got == want, label
    verdicts[label] = got
  assert verdicts["ok"] is None and verdicts["shard dir"] is None
  assert "different base depth" in verdicts["deeper base"]
  assert "inconsistent LoRA rank" in verdicts["mixed ranks"]
  assert "no adapter checkpoint files" in verdicts["empty dir"]


def test_is_lora_checkpoint_matches_jax(tmp_path):
  for label, path, _ in _validate_cases(tmp_path):
    if path.is_file() or not path.exists():
      assert lora.is_lora_checkpoint(path) == j_lora.is_lora_checkpoint(path), label


def test_adapter_checkpoint_files_matches_jax(tmp_path):
  for label, path, _ in _validate_cases(tmp_path):
    assert lora.adapter_checkpoint_files(path) == j_lora.adapter_checkpoint_files(path), label


# ----------------------------------------------------------- engine checkpoints


@pytest.fixture()
def tiny_model_dir(tmp_path):
  return make_hf_checkpoint(tmp_path / "m", TINY_LLAMA_CFG, seed=3)


PROMPT = np.array([[1, 5, 9, 2]], dtype=np.int64)


def _engines(model_dir, monkeypatch, rank=0):
  if rank:
    monkeypatch.setenv("XOT_LORA_RANK", str(rank))
  else:
    monkeypatch.delenv("XOT_LORA_RANK", raising=False)
  return (TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu", seed=0),
          JAXShardInferenceEngine(JLocalShardDownloader({"m": model_dir}), dtype="float32"))


def _shutdown(*engines):
  for e in engines:
    e.executor.shutdown(wait=True)


async def _logits(eng, shard, rid="chk", x=PROMPT):
  out, _ = await eng.infer_tensor(rid, shard, x)
  return np.asarray(out)


async def _train_stand_in(eng, shard, seed):
  """Seeded nonzero B in the context's adapters, in place of the steps a training run
  would take (the port's training leaf is not ported)."""
  await eng.ensure_shard(shard)
  ctx = eng._contexts[shard]
  ctx.params = {**ctx.params, "layers": seeded_b(ctx.params["layers"], seed)}


async def test_adapter_only_checkpoint_roundtrip(tiny_model_dir, monkeypatch, tmp_path):
  """test_lora.py:101: save_checkpoint with adapters writes ONLY lora.* tensors, a
  sliver of the base's bytes; a fresh engine over the same base restores the same
  logits, and the JAX engine (rank 2 too) loading the port's file gives them as well."""
  port, jeng = _engines(tiny_model_dir, monkeypatch, rank=2)
  shard, jshard = Shard("m", 0, N - 1, N), JShard("m", 0, N - 1, N)
  await _train_stand_in(port, shard, seed=5)
  ckpt = tmp_path / "adapters.safetensors"
  await port.save_checkpoint(shard, str(ckpt))
  names = list(_SafetensorsFile(ckpt).header)
  assert names and all(n.startswith("lora.") for n in names)
  base_size = sum(p.stat().st_size for p in tiny_model_dir.glob("*.safetensors"))
  assert ckpt.stat().st_size < base_size / 5
  want = await _logits(port, shard)

  fresh, _ = _engines(tiny_model_dir, monkeypatch, rank=2)
  await fresh.load_checkpoint(shard, str(ckpt))
  np.testing.assert_allclose(await _logits(fresh, shard), want, atol=1e-6)
  await jeng.load_checkpoint(jshard, str(ckpt))
  np.testing.assert_allclose(await _logits(jeng, jshard), want, atol=ATOL)
  plain, _ = _engines(tiny_model_dir, monkeypatch, rank=0)
  assert not np.allclose(await _logits(plain, shard), want, atol=1e-3)
  _shutdown(port, jeng, fresh, plain)


async def test_repartition_resume_with_base_files_in_same_dir(tiny_model_dir, monkeypatch):
  """test_lora.py:298: adapter saves of two half shards written INTO the HF model dir
  (beside model.safetensors) merge onto the whole range: the base files do not shadow
  them. The full engine's logits equal the two halves chained, and the JAX engine
  resuming from the same directory agrees."""
  n = N
  first, second = Shard("m", 0, n // 2 - 1, n), Shard("m", n // 2, n - 1, n)
  eng_a, _ = _engines(tiny_model_dir, monkeypatch, rank=2)
  eng_b, jeng = _engines(tiny_model_dir, monkeypatch, rank=2)
  await _train_stand_in(eng_a, first, seed=11)
  await _train_stand_in(eng_b, second, seed=12)
  await eng_a.save_checkpoint(first, str(tiny_model_dir / f"0-{n // 2 - 1}-3.safetensors"))
  await eng_b.save_checkpoint(second, str(tiny_model_dir / f"{n // 2}-{n - 1}-3.safetensors"))
  hidden = await _logits(eng_a, first)
  want = await _logits(eng_b, second, x=hidden)

  full_eng, _ = _engines(tiny_model_dir, monkeypatch, rank=2)
  full = Shard("m", 0, n - 1, n)
  await full_eng.load_checkpoint(full, str(tiny_model_dir))
  np.testing.assert_allclose(await _logits(full_eng, full), want, atol=1e-5, rtol=1e-4)
  await jeng.load_checkpoint(JShard("m", 0, n - 1, n), str(tiny_model_dir))
  np.testing.assert_allclose(await _logits(jeng, JShard("m", 0, n - 1, n)), want, atol=ATOL)
  _shutdown(eng_a, eng_b, jeng, full_eng)


async def test_explicit_full_checkpoint_file_beats_hf_index(tiny_model_dir, monkeypatch):
  """test_lora.py:273: a full {sid}-{iter} save written INTO the HF model dir wins over
  the pristine index beside it when named; the JAX engine loading the port's save
  serves the same logits."""
  port, jeng = _engines(tiny_model_dir, monkeypatch, rank=0)
  shard, jshard = Shard("m", 0, N - 1, N), JShard("m", 0, N - 1, N)
  await port.ensure_shard(shard)
  ctx = port._contexts[shard]
  rng = np.random.default_rng(9)
  layers = dict(ctx.params["layers"])
  for slot in ("wq", "w_up"):  # a fine-tune's change, seeded
    layers[slot] = layers[slot] + torch.from_numpy(
      (rng.standard_normal(tuple(layers[slot].shape)) * 0.05).astype(np.float32))
  ctx.params = {**ctx.params, "layers": layers}
  ckpt = tiny_model_dir / f"0-{N - 1}-3.safetensors"
  await port.save_checkpoint(shard, str(ckpt))
  want = await _logits(port, shard)

  fresh, _ = _engines(tiny_model_dir, monkeypatch, rank=0)
  await fresh.load_checkpoint(shard, str(ckpt))
  got = await _logits(fresh, shard)
  np.testing.assert_allclose(got, want, atol=1e-6)
  await jeng.load_checkpoint(jshard, str(ckpt))
  np.testing.assert_allclose(await _logits(jeng, jshard), want, atol=ATOL)
  base, _ = _engines(tiny_model_dir, monkeypatch, rank=0)
  assert not np.allclose(got, await _logits(base, shard), atol=1e-5)
  _shutdown(port, jeng, fresh, base)


async def test_full_reload_keeps_adapters_and_requantizes(tiny_model_dir, monkeypatch):
  """A full-weight reload into an int8 context with adapters: the weights are quantized
  again (the save dequantized them) and fresh adapters of the same rank and slots come
  back (B = 0, so the logits are the base's), as in JAX; the reloaded engine and the
  JAX engine after the same reload agree."""
  monkeypatch.setenv("XOT_QUANTIZE", "int8")
  port, jeng = _engines(tiny_model_dir, monkeypatch, rank=2)
  shard, jshard = Shard("m", 0, N - 1, N), JShard("m", 0, N - 1, N)
  await _train_stand_in(port, shard, seed=4)
  await jeng.ensure_shard(jshard)
  await port.load_checkpoint(shard, str(tiny_model_dir))
  await jeng.load_checkpoint(jshard, str(tiny_model_dir))
  layers = port._contexts[shard].params["layers"]
  assert layers["wq"].dtype == torch.int8 and "wq_scale" in layers
  assert sorted(k for k in layers if k.startswith("lora_")) == \
         sorted(k for k in jeng._contexts[jshard].params["layers"] if k.startswith("lora_"))
  assert not any(layers[k].any() for k in layers if k.startswith("lora_") and k.endswith("_b"))
  np.testing.assert_allclose(await _logits(port, shard), await _logits(jeng, jshard), atol=ATOL)
  _shutdown(port, jeng)


async def test_quantized_save_matches_jax(tiny_model_dir, monkeypatch, tmp_path):
  """save_checkpoint of an int8 context without adapters writes the compute-dtype HF
  layout, dequantized, the tensors JAX's engine writes for the same base."""
  monkeypatch.setenv("XOT_QUANTIZE", "int8")
  port, jeng = _engines(tiny_model_dir, monkeypatch)
  shard, jshard = Shard("m", 0, N - 1, N), JShard("m", 0, N - 1, N)
  await port.save_checkpoint(shard, str(tmp_path / "port.safetensors"))
  await jeng.save_checkpoint(jshard, str(tmp_path / "jax.safetensors"))
  fp, fj = _SafetensorsFile(tmp_path / "port.safetensors"), _SafetensorsFile(tmp_path / "jax.safetensors")
  assert sorted(fp.header) == sorted(fj.header)
  for name in fj.header:
    np.testing.assert_allclose(fp.get(name).float().numpy(), fj.get(name).float().numpy(),
                               atol=1e-6, err_msg=name)
  _shutdown(port, jeng)


async def test_load_checkpoint_drops_context_caches(tiny_model_dir, monkeypatch, tmp_path):
  """After a load, the context's prefix entries and host-tier entries (computed under
  the old weights) are gone, and a repeated prompt streams the new weights' tokens:
  the port's own contract (JAX clears its prefix cache too)."""
  monkeypatch.setenv("XOT_PREFIX_CACHE_MIN", "8")
  port, _ = _engines(tiny_model_dir, monkeypatch, rank=2)
  shard = Shard("m", 0, N - 1, N)
  prompt = np.arange(24, dtype=np.int64)[None, :] % 200 + 3
  await _train_stand_in(port, shard, seed=8)
  ckpt = tmp_path / "a.safetensors"
  await port.save_checkpoint(shard, str(ckpt))
  fresh, _ = _engines(tiny_model_dir, monkeypatch, rank=2)
  await fresh.ensure_shard(shard)
  tok0, _ = await fresh.infer_sample_tensor("r0", shard, prompt, temp=0.0, top_k=0)
  await fresh.clear_request("r0")
  ctx = fresh._contexts[shard]
  assert len(ctx.prefix_cache) == 1
  await fresh.load_checkpoint(shard, str(ckpt))
  assert len(ctx.prefix_cache) == 0
  tok1, _ = await fresh.infer_sample_tensor("r1", shard, prompt, temp=0.0, top_k=0)
  want, _ = await port.infer_sample_tensor("rw", shard, prompt, temp=0.0, top_k=0)
  assert int(tok1) == int(want) and fresh._prefix_hits == 0
  _shutdown(port, fresh)
