"""The port's engine, node, API and entry points, on the CPU.

`TorchShardInferenceEngine` and `JAXShardInferenceEngine` serve synthetic-tiny in
fp32 on the same weights (the JAX engine's seeded params, carried into the port
by a test-side stand-in for the port's own seeded init), and must produce
identical greedy token streams, including a prompt longer than XOT_PREFILL_CHUNK
so that the segments at pos > 0 run. The port's Node and standard-library HTTP
server then answer chat completions. Import hygiene: nothing in the port or in
chip_smoke.py imports jax or the JAX package.
"""
import ast
import asyncio
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models.transformer import init_random_params as j_init_random_params
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine import engine as engine_mod
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import transformer
from xotorch_tpu_torch.models.registry import get_supported_models
from xotorch_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
MODEL = "synthetic-tiny"


@pytest.fixture()
def jax_weights(monkeypatch):
  """The port's synthetic init replaced by the JAX engine's draw (PRNGKey(0),
  per-layer key folding), carried across with params_from_jax."""
  def init(cfg, n, first, last, seed=0, dtype=torch.float32, device="cpu", start_layer=0, **_):
    from xotorch_tpu.models.config import config_from_hf_dict
    from xotorch_tpu.models.registry import get_model_card
    jcfg = config_from_hf_dict(get_model_card(MODEL)["synthetic_config"])
    jp = j_init_random_params(jcfg, n, first, last, jax.random.PRNGKey(seed),
                              dtype=jnp.float32, start_layer=start_layer)
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device=device, dtype=dtype)
  monkeypatch.setattr(engine_mod, "init_random_params", init)


async def _greedy_stream(engine, shard, request_id, prompt, n):
  tok, _ = await engine.infer_sample_tensor(request_id, shard, prompt, temp=0.0, top_k=0)
  out = [int(tok)]
  size = 2
  while len(out) < n:
    chunk = await engine.generate_chunk(request_id, shard, out[-1], min(size, n - len(out)),
                                        temp=0.0, top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
    size *= 2
  await engine.clear_request(request_id)
  return out[:n]


@pytest.mark.parametrize("prompt_len", [5, 40])
async def test_greedy_stream_matches_jax_engine(prompt_len, jax_weights, monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_PREFILL_CHUNK", "16")  # 40 tokens: segments at 0, 16 and 32
  prompt = np.random.default_rng(prompt_len).integers(3, 256, size=(1, prompt_len))
  with jax.default_matmul_precision("highest"):
    jeng = JAXShardInferenceEngine(dtype="float32")
    want = await _greedy_stream(jeng, JShard(MODEL, 0, 3, 4), "r", prompt, 20)

  calls = {"flash": 0, "cached": 0}
  real_flash, real_cached = transformer.flash_attention, transformer.flash_cached_attention

  def flash(*a, **kw):
    calls["flash"] += 1
    return real_flash(*a, **kw)

  def cached(*a, **kw):
    calls["cached"] += 1
    return real_cached(*a, **kw)

  monkeypatch.setattr(transformer, "flash_attention", flash)
  monkeypatch.setattr(transformer, "flash_cached_attention", cached)
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  assert eng.dtype == torch.float32
  got = await _greedy_stream(eng, Shard(MODEL, 0, 3, 4), "r", prompt, 20)
  eng.executor.shutdown(wait=True)
  assert got == want
  # The first segment goes through the prefill wrapper (K1's), every later segment
  # and every decode step through the cached one (K2's), once per layer. With two or
  # more leading whole segments the scan prefill takes them (JAX's prefill_scan
  # routing, XOT_SCAN_PREFILL=1): all through the cached wrapper, the from-zero one too.
  segments = -(-prompt_len // 16)
  scanned = (prompt_len - 1) // 16 >= 2
  assert calls["flash"] == (0 if scanned else 4)
  assert calls["cached"] == 4 * (segments - (0 if scanned else 1) + 19)


async def test_cache_exhausted_at_max_cache_len(monkeypatch):
  from xotorch_tpu_torch.inference.engine import CacheExhausted
  monkeypatch.setenv("XOT_CACHE_LEN", "16")
  monkeypatch.setenv("XOT_MAX_CACHE_LEN", "32")
  eng = TorchShardInferenceEngine(device="cpu", dtype="float32", seed=0)
  shard = Shard(MODEL, 0, 3, 4)
  tok, _ = await eng.infer_sample_tensor("r", shard, np.ones((1, 10), np.int64), temp=0.0)
  state = eng._ctx.states["r"]
  assert state.cache["k"].shape[2] == 16
  # 10 resident + 8: the cache grows to 32; asking 16 more shrinks to the tail (14 -> 8).
  toks = await eng.generate_chunk("r", shard, tok, 8, temp=0.0)
  assert len(toks) == 8 and state.cache["k"].shape[2] == 32
  toks = await eng.generate_chunk("r", shard, int(toks[-1]), 16, temp=0.0)
  assert len(toks) == 8 and state.pos == 26
  toks = await eng.generate_chunk("r", shard, int(toks[-1]), 16, temp=0.0)
  assert len(toks) == 4 and state.pos == 30
  await eng.generate_chunk("r", shard, int(toks[-1]), 2, temp=0.0)
  with pytest.raises(CacheExhausted):
    await eng.generate_chunk("r", shard, 5, 1, temp=0.0)
  with pytest.raises(CacheExhausted):
    await eng.infer_sample_tensor("big", shard, np.ones((1, 40), np.int64), temp=0.0)
  eng.executor.shutdown(wait=True)


async def test_infer_tensor_split_shards_chain_to_the_full_model():
  full = TorchShardInferenceEngine(device="cpu", dtype="float32", seed=0)
  first = TorchShardInferenceEngine(device="cpu", dtype="float32", seed=0)
  second = TorchShardInferenceEngine(device="cpu", dtype="float32", seed=0)
  tokens = np.array([[1, 5, 9, 200, 17]], dtype=np.int64)
  want, _ = await full.infer_tensor("r", Shard(MODEL, 0, 3, 4), tokens)
  hidden, state = await first.infer_tensor("r", Shard(MODEL, 0, 1, 4), tokens)
  got, _ = await second.infer_tensor("r", Shard(MODEL, 2, 3, 4), hidden, state)
  np.testing.assert_allclose(got, want, atol=1e-5)
  tok = await full.sample(want, temp=0.0)
  assert tok.tolist() == [int(np.argmax(want[0, -1]))]
  for eng in (full, first, second):
    eng.executor.shutdown(wait=True)


def _http(url, body=None, stream=False):
  req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as resp:
    if not stream:
      return json.loads(resp.read())
    events = []
    for raw in resp:
      line = raw.decode().strip()
      if line.startswith("data: ") and line != "data: [DONE]":
        events.append(json.loads(line[len("data: "):]))
    return events


async def test_node_and_api_serve_chat_completions():
  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-model", MODEL, "--chatgpt-api-port", "0",
     "--default-temp", "0"])
  node, engine, classname, api = port_main.build_node(args)
  server = await api.start("127.0.0.1", 0)
  base = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"
  loop = asyncio.get_running_loop()
  call = lambda *a, **kw: loop.run_in_executor(None, lambda: _http(*a, **kw))
  try:
    assert (await call(base + "/healthcheck")) == {"status": "ok"}
    listed = [m["id"] for m in (await call(base + "/v1/models"))["data"]]
    assert {"synthetic-tiny", "synthetic-llama-1b"} <= set(listed)
    assert listed == get_supported_models(classname)

    body = {"model": MODEL, "temperature": 0, "max_tokens": 9,
            "messages": [{"role": "user", "content": "one two three four five"}]}
    resp = await call(base + "/v1/chat/completions", body)
    assert resp["object"] == "chat.completion"
    assert resp["choices"][0]["finish_reason"] == "length"
    assert resp["usage"]["completion_tokens"] == 9
    assert resp["usage"]["prompt_tokens"] == len("user: one two three four five assistant:".split())
    assert resp["choices"][0]["message"]["content"] == " ".join(["dummy"] * 9)

    events = await call(base + "/v1/chat/completions",
                        {**body, "max_tokens": 12, "stream": True,
                         "stream_options": {"include_usage": True}}, stream=True)
    finishes = [c["finish_reason"] for e in events for c in e["choices"] if c["finish_reason"]]
    assert finishes == ["length"]
    assert events[-1]["usage"]["completion_tokens"] == 12
    content = "".join(c["delta"].get("content", "") for e in events for c in e["choices"])
    assert content.count("dummy") == 12

    with pytest.raises(urllib.error.HTTPError) as err:
      await call(base + "/v1/chat/completions", {**body, "model": "no-such-model"})
    assert err.value.code == 400
  finally:
    server.close()
    await server.wait_closed()
    await node.stop()
    engine.executor.shutdown(wait=True)


async def test_run_command_completes_one_prompt(capsys):
  args = port_main.build_parser().parse_args(
    ["run", MODEL, "--device", "cpu", "--prompt", "hello there", "--max-generate-tokens", "6"])
  node, engine, classname, _ = port_main.build_node(args)
  try:
    tokens = await port_main.run_model_cli(node, classname, MODEL, args.prompt)
  finally:
    engine.executor.shutdown(wait=True)
  assert 1 <= len(tokens) <= 6
  assert "dummy" in capsys.readouterr().out


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    TorchShardInferenceEngine()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    port_main.build_node(port_main.build_parser().parse_args([]))
  assert TorchShardInferenceEngine(device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_alone(tmp_path):
  env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
  here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                        capture_output=True, text=True, timeout=120)
  assert here.returncode != 0 and '"ok"' not in here.stdout
  (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
  alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
  assert alone.returncode != 0 and '"ok"' not in alone.stdout


def _imports(path: Path):
  for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
      yield node.module


def _function_imports(path: Path):
  """The modules imported inside a function body (lazily, at call time)."""
  for fn in ast.walk(ast.parse(path.read_text(), filename=str(path))):
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
      for node in ast.walk(fn):
        if isinstance(node, ast.Import):
          yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
          yield node.module


def test_chip_smoke_defines_each_function_once():
  """A second top-level def of a name shadows the first for every phase that calls it."""
  tree = ast.parse((ROOT / "chip_smoke.py").read_text())
  names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                        ast.ClassDef))]
  assert sorted({n for n in names if names.count(n) > 1}) == []


def test_every_jax_module_has_a_counterpart():
  """Each .py file of the JAX package has one at the same path in the port, with
  torch_engine/ for jax_engine/ and networking/tcp/ for networking/grpc/."""
  jax_files = sorted(p.relative_to(ROOT / "xotorch_tpu").as_posix()
                     for p in (ROOT / "xotorch_tpu").rglob("*.py"))
  assert len(jax_files) >= 92
  renamed = [f.replace("inference/jax_engine/", "inference/torch_engine/")
              .replace("networking/grpc/", "networking/tcp/") for f in jax_files]
  assert [f for f in renamed if not (ROOT / "xotorch_tpu_torch" / f).is_file()] == []


def test_port_imports_neither_jax_nor_the_jax_package():
  files = sorted((ROOT / "xotorch_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
  assert len(files) > 20
  walked = {str(f.relative_to(ROOT)) for f in files}
  assert {"xotorch_tpu_torch/models/weights.py",
          "xotorch_tpu_torch/inference/tokenizers.py",
          "xotorch_tpu_torch/download/__init__.py",
          "xotorch_tpu_torch/download/download_progress.py",
          "xotorch_tpu_torch/download/shard_download.py",
          "xotorch_tpu_torch/download/hf_shard_download.py",
          "xotorch_tpu_torch/ops/paged_attention.py",
          "xotorch_tpu_torch/ops/ring_attention.py",
          "xotorch_tpu_torch/parallel/__init__.py",
          "xotorch_tpu_torch/parallel/collectives.py",
          "xotorch_tpu_torch/parallel/mesh.py",
          "xotorch_tpu_torch/parallel/multihost.py",
          "xotorch_tpu_torch/parallel/zero.py",
          "xotorch_tpu_torch/inference/torch_engine/paged_cache.py",
          "xotorch_tpu_torch/inference/torch_engine/vkv.py",
          "xotorch_tpu_torch/topology/device_capabilities.py",
          "xotorch_tpu_torch/topology/partitioning.py",
          "xotorch_tpu_torch/networking/codec.py",
          "xotorch_tpu_torch/networking/tcp/server.py",
          "xotorch_tpu_torch/networking/tcp/peer_handle.py",
          "xotorch_tpu_torch/networking/manual/discovery.py",
          "xotorch_tpu_torch/networking/udp/discovery.py",
          "xotorch_tpu_torch/train/step.py",
          "xotorch_tpu_torch/train/optstate.py",
          "xotorch_tpu_torch/train/dataset.py",
          "xotorch_tpu_torch/fabric/__init__.py",
          "xotorch_tpu_torch/fabric/client.py",
          "xotorch_tpu_torch/fabric/server.py",
          "xotorch_tpu_torch/router/__init__.py",
          "xotorch_tpu_torch/router/__main__.py",
          "xotorch_tpu_torch/router/app.py",
          "xotorch_tpu_torch/fleet/__init__.py",
          "xotorch_tpu_torch/fleet/spawner.py",
          "xotorch_tpu_torch/fleet/controller.py",
          "xotorch_tpu_torch/api/http.py",
          "xotorch_tpu_torch/download/hf_mirror.py",
          "xotorch_tpu_torch/viz/__init__.py",
          "xotorch_tpu_torch/viz/chat_tui.py",
          "xotorch_tpu_torch/viz/topology_viz.py",
          "xotorch_tpu_torch/inference/native/__init__.py",
          "xotorch_tpu_torch/inference/native/engine.py"} <= walked
  bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
         if name.split(".")[0] in ("jax", "jaxlib", "xotorch_tpu", "safetensors", "optax")]
  assert bad == []
  # The card's machine is not known to have aiohttp or rich: the router, the API and the
  # downloader speak the port's own HTTP (api/http.py) or urllib, the TUI draws ANSI
  # text, and the control plane (fabric, router, fleet) needs no torch either.
  aio = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
         if name.split(".")[0] in ("aiohttp", "rich")]
  assert aio == []
  control = [f for f in files if f.parent.name in ("fabric", "router", "fleet")]
  assert len(control) == 9
  assert [(str(f.relative_to(ROOT)), name) for f in control for name in _imports(f)
          if name.split(".")[0] == "torch"] == []
  # The card has no `transformers`: only resolving a Hugging Face tokenizer imports it,
  # inside the call.
  hf = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
        if name.split(".")[0] == "transformers"]
  tokenizers = ROOT / "xotorch_tpu_torch" / "inference" / "tokenizers.py"
  assert hf == [(str(tokenizers.relative_to(ROOT)), "transformers")]
  assert list(_function_imports(tokenizers)).count("transformers") == 1
