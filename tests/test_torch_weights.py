"""The port's safetensors reader, writer and checkpoint loader against the
`safetensors` library and the JAX package's loader.

The port reads and writes the format with the standard library and numpy (the card
has no `safetensors`). Here, on files the tests write themselves: the reader against
the library for every dtype a checkpoint carries, single-file and indexed; the
writer's files read back by the library and by JAX's `load_shard_params`; and, on
tiny HF checkpoints of the six dense families (written by `transformers`, as
tests/test_model_equivalence.py does), `tensor_names_for_shard` and
`load_shard_params` equal to JAX's, bit for bit in fp32, for the whole model and for
shards split mid-model.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from tests.test_model_equivalence import (TINY_GEMMA2_CFG, TINY_LLAMA_CFG, TINY_MISTRAL_CFG,
                                          TINY_PHI3_CFG, TINY_QWEN2_CFG, TINY_QWEN3_CFG,
                                          make_hf_checkpoint)
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import weights as j_weights
from xotorch_tpu.models.config import load_model_config as j_load_model_config
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models import weights
from xotorch_tpu_torch.models.config import load_model_config

torch.set_num_threads(2)

FAMILIES = {
  "llama3-scaled-rope": TINY_LLAMA_CFG, "qwen2-bias-tied": TINY_QWEN2_CFG,
  "phi3-fused-proj": TINY_PHI3_CFG, "mistral-headdim": TINY_MISTRAL_CFG,
  "qwen3-qk-norm": TINY_QWEN3_CFG, "gemma2-sandwich-window": TINY_GEMMA2_CFG,
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
  """family id -> the directory of its tiny HF checkpoint (one model.safetensors)."""
  root = tmp_path_factory.mktemp("families")
  return {fid: make_hf_checkpoint(root, cfg, seed=i) for i, (fid, cfg) in enumerate(FAMILIES.items())}


def _shards(n):
  """(start, end) layer ranges: the whole model, and a split after the first layer
  (the second shard starts at an odd layer)."""
  return [(0, n - 1), (0, 0), (1, n - 1)]


def _same_tree(got, want, path=""):
  """Bit-for-bit equality of the port's tensors and JAX's arrays, key for key."""
  assert isinstance(got, dict) == isinstance(want, dict), path
  if isinstance(want, dict):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
      _same_tree(got[k], want[k], f"{path}/{k}")
    return
  w = np.asarray(want)
  g = got.numpy() if got.dtype != torch.bfloat16 else got.float().numpy()
  assert g.shape == w.shape, path
  assert np.array_equal(g, w.astype(np.float32) if got.dtype == torch.bfloat16 else w), path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8,
                                   torch.uint8, torch.int64],
                         ids=["fp32", "bf16", "fp16", "int8", "uint8", "int64"])
def test_reader_matches_the_safetensors_library(tmp_path, dtype):
  g = torch.Generator().manual_seed(0)
  tensors = {}
  for i, shape in enumerate([(3, 5), (7,), (2, 3, 4), (1,), (0, 4)]):
    if dtype.is_floating_point:
      t = torch.randn(shape, generator=g).to(dtype)
    else:
      info = torch.iinfo(dtype)
      t = torch.randint(max(info.min, -2**40), min(info.max, 2**40), shape, generator=g,
                        dtype=torch.int64).to(dtype)
    tensors[f"model.layers.{i}.w"] = t
  # A one-byte tensor first, so the wider ones after it may sit off their alignment.
  tensors = {"a.byte": torch.ones(3, dtype=torch.uint8), **tensors}
  path = tmp_path / "model.safetensors"
  st_save_torch(tensors, str(path), metadata={"format": "pt"})
  want = st_load_torch(str(path))
  f = weights._SafetensorsFile(path)
  assert sorted(f.header) == sorted(want)
  for name, w in want.items():
    got = f.get(name)
    assert got.dtype == w.dtype and got.shape == w.shape, name
    assert torch.equal(got, w), name
  assert weights._index_for(tmp_path) == {name: "model.safetensors" for name in want}


def test_reader_follows_an_index_over_two_files(tmp_path):
  g = torch.Generator().manual_seed(1)
  first = {"model.embed_tokens.weight": torch.randn(16, 8, generator=g).to(torch.bfloat16),
           "model.layers.0.mlp.up_proj.weight": torch.randn(12, 8, generator=g)}
  second = {"model.layers.1.mlp.up_proj.weight": torch.randn(12, 8, generator=g).half(),
            "model.norm.weight": torch.randn(8, generator=g)}
  st_save_torch(first, str(tmp_path / "model-00001-of-00002.safetensors"))
  st_save_torch(second, str(tmp_path / "model-00002-of-00002.safetensors"))
  weight_map = {**{n: "model-00001-of-00002.safetensors" for n in first},
                **{n: "model-00002-of-00002.safetensors" for n in second}}
  (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
  index = weights._index_for(tmp_path)
  assert index == weight_map
  got = weights._read_tensors(tmp_path, list(index), index)
  for name, w in {**first, **second}.items():
    assert got[name].dtype == w.dtype and torch.equal(got[name], w), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_written_shard_reads_back_in_the_library_and_in_jax(checkpoints, tmp_path, family, dtype):
  model_dir = checkpoints[family]
  cfg = load_model_config(model_dir)
  n = cfg.num_layers
  shard = Shard(family, 1, n - 1, n)
  params = weights.load_shard_params(model_dir, cfg, shard, dtype=dtype)
  out = tmp_path / "shard.safetensors"
  weights.save_shard_params(params, cfg, shard, out)
  # The library reads every tensor, in the params' dtype, the linear ones as [out, in].
  lib = st_load_torch(str(out))
  assert torch.equal(lib["model.layers.1.self_attn.q_proj.weight"], params["layers"]["wq"][0].T)
  assert all(t.dtype == dtype for t in lib.values())
  # Read back by the port and by JAX (a single-file shard save), the same arrays.
  again = weights.load_shard_params(model_dir, cfg, shard, dtype=dtype, checkpoint_file=out)
  jcfg = j_load_model_config(model_dir)
  jparams = j_weights.load_shard_params(model_dir, jcfg, JShard(family, 1, n - 1, n),
                                        dtype=jnp.float32, checkpoint_file=out)
  _same_tree(again, jparams)
  _same_tree({k: v.float() for k, v in params["layers"].items()}, jparams["layers"])
  if dtype == torch.float32:
    np.testing.assert_array_equal(st_load_numpy(str(out))["model.norm.weight"],
                                  params["final_norm"].numpy())


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_names_for_shard_match_jax(checkpoints, family):
  model_dir = checkpoints[family]
  names = list(weights._index_for(model_dir))
  cfg = load_model_config(model_dir)
  n = cfg.num_layers
  for start, end in _shards(n):
    for tied in (False, True):
      got = weights.tensor_names_for_shard(names, Shard(family, start, end, n), tied)
      want = j_weights.tensor_names_for_shard(names, JShard(family, start, end, n), tied)
      assert got == want, (start, end, tied)
  assert weights.layer_of("model.layers.12.mlp.up_proj.weight") == 12
  assert weights.layer_of("model.norm.weight") is None


@pytest.mark.parametrize("family", FAMILIES)
def test_load_shard_params_matches_jax_bit_for_bit(checkpoints, family):
  model_dir = checkpoints[family]
  cfg, jcfg = load_model_config(model_dir), j_load_model_config(model_dir)
  n = cfg.num_layers
  for start, end in _shards(n):
    got = weights.load_shard_params(model_dir, cfg, Shard(family, start, end, n),
                                    dtype=torch.float32)
    want = j_weights.load_shard_params(model_dir, jcfg, JShard(family, start, end, n),
                                       dtype=jnp.float32)
    _same_tree(got, jax.tree.map(np.asarray, want), f"{family} {start}-{end}")


def test_load_model_config_caps_max_seq_len(checkpoints, monkeypatch):
  model_dir = checkpoints["gemma2-sandwich-window"]
  assert load_model_config(model_dir) == load_model_config(model_dir)
  assert load_model_config(model_dir, 64).max_seq_len == 64
  monkeypatch.setenv("XOT_MAX_SEQ_LEN", "32")
  assert load_model_config(model_dir).max_seq_len == 32
  assert j_load_model_config(model_dir).max_seq_len == 32
