"""The port's native sidecar engine against the JAX package's: both clients of the same
C++ sidecar binary (built from native/ by the port's `ensure_sidecar_binary`, `make -C`
on a copy of the sources in a temporary directory, and named to both engines by
XOT_SIDECAR_BIN) on test_native_sidecar.py's tiny llama and qwen2 checkpoints. The
logits are the same bits (fp32, and int8 under XOT_SIDECAR_QUANT), a ring split over two
sidecars gives the full model's logits, and temperature 0 samples the argmax. `main.py --inference-engine native` answers a
request with the greedy tokens of the port's torch engine in fp32 on the CPU.
"""
import os
import shutil
from unittest import mock

import numpy as np
import pytest

from tests.test_model_equivalence import TINY_LLAMA_CFG, TINY_QWEN2_CFG, make_hf_checkpoint
from tests.test_native_sidecar import DirShardDownloader
from xotorch_tpu.inference.native.engine import NativeSidecarInferenceEngine as JNative
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.native import engine as native
from xotorch_tpu_torch.inference.native.engine import NativeSidecarInferenceEngine
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models import registry

N = TINY_LLAMA_CFG["num_hidden_layers"]
ROOT = native._REPO_ROOT


@pytest.fixture(scope="module")
def sidecar_bin(tmp_path_factory):
  """ensure_sidecar_binary's make step on a copy of native/ (the repo's own build
  directory is left to test_native_sidecar.py)."""
  root = tmp_path_factory.mktemp("repo")
  shutil.copytree(ROOT / "native", root / "native", ignore=shutil.ignore_patterns("build"))
  env = {k: v for k, v in os.environ.items() if k != "XOT_SIDECAR_BIN"}
  with mock.patch.dict(os.environ, env, clear=True), \
       mock.patch.object(native, "_REPO_ROOT", root), \
       mock.patch.object(native, "_DEFAULT_BINARY", root / "native" / "build" / "xot-sidecar"):
    binary = native.ensure_sidecar_binary()
  assert binary == root / "native" / "build" / "xot-sidecar" and os.access(binary, os.X_OK)
  return binary


@pytest.fixture(autouse=True)
def _sidecar(sidecar_bin, monkeypatch):
  monkeypatch.setenv("XOT_SIDECAR_BIN", str(sidecar_bin))


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
  return make_hf_checkpoint(tmp_path_factory.mktemp("native_llama"), TINY_LLAMA_CFG, seed=3)


@pytest.fixture(scope="module")
def qwen2_dir(tmp_path_factory):
  return make_hf_checkpoint(tmp_path_factory.mktemp("native_qwen2"), TINY_QWEN2_CFG, seed=4)


def _port(model_dir):
  return NativeSidecarInferenceEngine(LocalShardDownloader({"m": model_dir}))


def _jax(model_dir):
  # One compute thread, as the port's default: the sidecar's parallel_for may signal a
  # condition variable of a call that has returned (the port engine's docstring).
  return JNative(DirShardDownloader(model_dir), threads=1)


async def _both(model_dir, tokens, start=0, end=None, n=None, x=None):
  """(port logits, JAX logits) of one call on a fresh engine each."""
  out = []
  for make, shard_cls in ((_port, Shard), (_jax, JShard)):
    engine = make(model_dir)
    try:
      n_layers = n or N
      got, _ = await engine.infer_tensor("r", shard_cls("m", start, n_layers - 1 if end is None else end,
                                                        n_layers), tokens if x is None else x)
    finally:
      await engine.stop()
    out.append(got)
  return out


def test_the_binary_is_the_one_both_engines_start(sidecar_bin, monkeypatch):
  from xotorch_tpu.inference.native.engine import ensure_sidecar_binary as j_binary
  assert j_binary() == native.ensure_sidecar_binary() == sidecar_bin
  monkeypatch.setenv("XOT_SIDECAR_BIN", str(sidecar_bin) + ".missing")
  with pytest.raises(FileNotFoundError, match="XOT_SIDECAR_BIN=.*does not exist"):
    native.ensure_sidecar_binary()


@pytest.mark.parametrize("family", ["llama", "qwen2"])
async def test_logits_are_jaxs_bits(llama_dir, qwen2_dir, family):
  model_dir = llama_dir if family == "llama" else qwen2_dir
  n = (TINY_LLAMA_CFG if family == "llama" else TINY_QWEN2_CFG)["num_hidden_layers"]
  tokens = np.random.default_rng(27).integers(1, 250, size=(1, 7)).astype(np.int64)
  port, jax_ = await _both(model_dir, tokens, n=n)
  assert port.dtype == jax_.dtype == np.float32 and port.shape == jax_.shape
  np.testing.assert_array_equal(port, jax_)


async def test_split_ring_equals_the_full_model(llama_dir):
  """Two sidecars of half the layers each: the bf16 hidden state between them is JAX's
  bit for bit, and the logits are the full model's within the bf16 hop's rounding."""
  tokens = np.array([[5, 9, 42, 7]], dtype=np.int64)
  full, _ = await _both(llama_dir, tokens)
  hidden, jhidden = await _both(llama_dir, tokens, end=N // 2 - 1)
  np.testing.assert_array_equal(hidden, jhidden)
  assert hidden.shape == (1, 4, TINY_LLAMA_CFG["hidden_size"])
  split, jsplit = await _both(llama_dir, tokens, start=N // 2, x=hidden)
  np.testing.assert_array_equal(split, jsplit)
  np.testing.assert_allclose(split, full, atol=3e-2, rtol=3e-2)


async def test_temperature_zero_is_the_argmax_and_a_chunk_decodes(llama_dir):
  engine = _port(llama_dir)
  shard = Shard("m", 0, N - 1, N)
  try:
    out, _ = await engine.infer_tensor("s", shard, np.array([[5, 9]], dtype=np.int64))
    assert (await engine.sample(out, temp=0.0)).tolist() == [int(np.argmax(out[0, -1]))]
    tok, _ = await engine.infer_sample_tensor("g", shard, np.array([[5, 9]]), temp=0.0)
    chunk = await engine.generate_chunk("g", shard, tok, 4, temp=0.0)
    # The same tokens one infer_tensor at a time on a fresh session.
    want, prev = [], tok
    await engine.infer_tensor("h", shard, np.array([[5, 9]]))
    for _ in range(4):
      logits, _ = await engine.infer_tensor("h", shard, np.array([[prev]]))
      prev = int(np.argmax(logits[0, -1]))
      want.append(prev)
    assert tok == int(np.argmax(out[0, -1])) and chunk.tolist() == want
    await engine.clear_request("g")
  finally:
    await engine.stop()
  assert engine.client is None


async def test_int8_is_jaxs_bits_and_stays_close(llama_dir, monkeypatch):
  tokens = np.array([[5, 9, 42, 7, 101, 3]], dtype=np.int64)
  ref, _ = await _both(llama_dir, tokens)
  monkeypatch.setenv("XOT_SIDECAR_QUANT", "int8")
  got, jgot = await _both(llama_dir, tokens)
  np.testing.assert_array_equal(got, jgot)
  rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
  assert 0.0 < rel < 0.05
  assert int(got[0, -1].argmax()) == int(ref[0, -1].argmax())


async def test_main_serves_through_the_sidecar(llama_dir, tmp_path, monkeypatch):
  """`main.py run --inference-engine native` on a card whose checkpoint is in XOT_HOME
  streams the torch engine's fp32 greedy tokens on the CPU."""
  monkeypatch.setenv("XOT_HOME", str(tmp_path / "home"))
  monkeypatch.setenv("HF_ENDPOINT", "http://127.0.0.1:9")  # nothing is fetched: no endpoint
  monkeypatch.setenv("XOT_DTYPE", "float32")
  target = tmp_path / "home" / "models" / "test--tiny-native"
  shutil.copytree(llama_dir, target)
  # A tokenizer file that cannot be built: both engines serve the fake with the config's eos.
  (target / "tokenizer.model").write_bytes(b"not a real tokenizer")
  monkeypatch.setitem(registry.model_cards, "tiny-native",
                      {"layers": N, "repo": {registry.TORCH: "test/tiny-native"}})
  assert registry.get_repo("tiny-native", registry.NATIVE) == "test/tiny-native"
  assert registry.get_repo("qwen-3-30b-a3b", registry.NATIVE) is None  # MoE: no fallback
  assert "tiny-native" in registry.get_supported_models(registry.NATIVE)
  streams = {}
  for engine_name in ("native", "torch"):
    args = port_main.build_parser().parse_args(
      ["run", "tiny-native", "--inference-engine", engine_name, "--device", "cpu", "--prompt",
       "one two three four", "--default-temp", "0", "--max-generate-tokens", "6", "--disable-tui"])
    node, engine, classname, _ = port_main.build_node(args)
    try:
      streams[engine_name] = await port_main.run_model_cli(node, classname, "tiny-native", args.prompt)
    finally:
      await node.stop()
      if engine_name == "native":
        assert classname == "NativeSidecarInferenceEngine" and engine.client is not None
        await engine.stop()
      else:
        engine.executor.shutdown(wait=True)
  assert streams["native"] == streams["torch"] and len(streams["native"]) >= 1
