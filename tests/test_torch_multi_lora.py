"""Multi-LoRA serving on the port (`base@name` ids over one shared base: the registry,
the engine's adapter contexts, the API's listing, main.py --adapters) against the JAX
package, on the CPU.

The twins of tests/test_multi_lora.py run on both engines over one transformers-written
checkpoint in fp32, with adapters written by JAX's save_lora_checkpoint with seeded
NONZERO B (a zero B would make the adapter the base and every equality vacuous):

- an adapter id serves logits equal to JAX's (atol 1e-4) and unlike the base's;
  XOT_LORA_RANK does not clobber a registered adapter;
- greedy engine streams of base@ad equal JAX's token for token, on contiguous caches
  and on the page pool (page 16), and differ from the base's;
- the adapter contexts alias the base's tensors (the same objects, the same
  data_ptr), and keep them when the donor context is evicted under the default
  XOT_MAX_RESIDENT_MODELS=2, as JAX's do;
- an unregistered name, a missing path and an empty directory fail with JAX's messages;
- base and adapter requests on one engine share no prefix-cache or host-tier entry,
  with the same hits as the JAX engine;
- /v1/models lists the adapters as JAX's handler does, and a completion for
  `synthetic-tiny@name` through main.py --adapters, the API, the Node and the engine
  streams the adapter's greedy tokens.
"""
import asyncio
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tests.test_model_equivalence import TINY_LLAMA_CFG, make_hf_checkpoint
from tests.test_multi_lora import _make_adapter
from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.inference.jax_engine import engine as j_engine_mod
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import registry as j_registry
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import registry

torch.set_num_threads(2)

N = TINY_LLAMA_CFG["num_hidden_layers"]
PROMPT = np.array([[1, 5, 9, 200, 17, 3]], dtype=np.int64)
KNOBS = ("XOT_LORA_RANK", "XOT_LORA_TARGETS", "XOT_ADAPTERS", "XOT_PAGED_KV", "XOT_QUANTIZE",
         "XOT_MAX_RESIDENT_MODELS")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  for name in KNOBS:
    monkeypatch.delenv(name, raising=False)
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_SEED", "7")
  with jax.default_matmul_precision("highest"):
    yield


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
  return make_hf_checkpoint(tmp_path_factory.mktemp("mlora"), TINY_LLAMA_CFG, seed=7)


def write_adapter(path, seed: int, targets, rank: int = 4, b_scale: float = 0.5):
  """A rank-`rank` adapter on `targets` for the tiny llama with seeded nonzero B (numpy),
  written by JAX's save_lora_checkpoint. B at 0.5 moves the tiny model's greedy argmax,
  which 0.05 (test_multi_lora.py's) leaves where the base's is."""
  from xotorch_tpu.models.config import config_from_hf_dict
  from xotorch_tpu.models.transformer import init_random_params
  from xotorch_tpu.train import lora as j_lora
  cfg = config_from_hf_dict(TINY_LLAMA_CFG)
  jp = init_random_params(cfg, N, True, True, jax.random.PRNGKey(0), dtype=jax.numpy.float32)
  jp = j_lora.add_lora_params(jp, rank, jax.random.PRNGKey(seed), targets)
  rng = np.random.default_rng(seed)
  layers = dict(jp["layers"])
  for k in sorted(layers):
    if k.startswith("lora_") and k.endswith("_b"):
      layers[k] = jax.numpy.asarray((rng.standard_normal(layers[k].shape) * b_scale).astype(np.float32))
  j_lora.save_lora_checkpoint({**jp, "layers": layers}, JShard("m", 0, N - 1, N), path)
  return path


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
  """A rank-4 attention adapter and a rank-8 one on all seven slots, nonzero B, written
  by JAX."""
  from xotorch_tpu.train import lora as j_lora
  root = tmp_path_factory.mktemp("adapters")
  return {"a1": write_adapter(root / "a1.safetensors", 1, j_lora.ATTN_SLOTS),
          "a2": write_adapter(root / "a2.safetensors", 2, j_lora.ATTN_SLOTS + j_lora.MLP_SLOTS,
                              rank=8)}


def _engines(model_dir, monkeypatch, adapters: dict, resident: int = 4):
  """The port's engine and JAX's over `model_dir`, with `adapters` registered and room
  for `resident` model contexts (JAX reads its bound once, at import)."""
  monkeypatch.setenv("XOT_ADAPTERS", ",".join(f"{k}={v}" for k, v in adapters.items()))
  monkeypatch.setenv("XOT_MAX_RESIDENT_MODELS", str(resident))
  monkeypatch.setattr(j_engine_mod, "MAX_RESIDENT_MODELS", resident)
  return (TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu", seed=0),
          JAXShardInferenceEngine(JLocalShardDownloader({"m": model_dir}), dtype="float32"))


def _shards(mid):
  return Shard(mid, 0, N - 1, N), JShard(mid, 0, N - 1, N)


def _shutdown(*engines):
  for e in engines:
    e.executor.shutdown(wait=True)


async def _logits(eng, shard, rid, x=PROMPT):
  out, _ = await eng.infer_tensor(rid, shard, x)
  return np.asarray(out)


async def _greedy(eng, shard, rid, prompt, n=12):
  tok, _ = await eng.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
  out, size = [int(tok)], 2
  while len(out) < n:
    chunk = await eng.generate_chunk(rid, shard, out[-1], min(size, n - len(out)), temp=0.0, top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
    size *= 2
  await eng.clear_request(rid)
  return out[:n]


async def test_adapter_id_serves_and_differs_from_base(model_dir, adapters, monkeypatch):
  """test_multi_lora.py:63: the adapter changes the output, and the port's adapter
  logits equal the JAX engine's on the same base and file."""
  port, jeng = _engines(model_dir, monkeypatch, {"ad1": adapters["a1"]})
  (sb, jsb), (sa, jsa) = _shards("m"), _shards("m@ad1")
  lb, la = await _logits(port, sb, "rb"), await _logits(port, sa, "ra")
  assert not np.allclose(la, lb, atol=1e-3), "adapter changed nothing"
  np.testing.assert_allclose(la, await _logits(jeng, jsa, "ra"), atol=1e-4)
  np.testing.assert_allclose(lb, await _logits(jeng, jsb, "rb"), atol=1e-4)
  _shutdown(port, jeng)


async def test_lora_rank_does_not_clobber_adapter(model_dir, adapters, monkeypatch):
  """test_multi_lora.py:85: with XOT_LORA_RANK set, a base@name context serves the
  REGISTERED adapter (fresh zero-B adapters would serve the base), as JAX does; the
  plain base context gets the fresh ones, which change nothing."""
  monkeypatch.setenv("XOT_LORA_RANK", "4")
  port, jeng = _engines(model_dir, monkeypatch, {"ad1": adapters["a1"]})
  (sb, jsb), (sa, jsa) = _shards("m"), _shards("m@ad1")
  la = await _logits(port, sa, "ra")
  np.testing.assert_allclose(la, await _logits(jeng, jsa, "ra"), atol=1e-4)
  lb = await _logits(port, sb, "rb")
  assert "lora_wq_a" in port._contexts[sb].params["layers"]
  monkeypatch.delenv("XOT_LORA_RANK")
  plain, _ = _engines(model_dir, monkeypatch, {})
  np.testing.assert_allclose(lb, await _logits(plain, sb, "rb"), atol=1e-6)
  assert not np.allclose(la, lb, atol=1e-3)
  _shutdown(port, jeng, plain)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
async def test_adapter_greedy_streams_match_jax(model_dir, adapters, monkeypatch, paged):
  """Greedy engine streams of the base, m@ad1 and m@ad2 on one engine equal the JAX
  engine's token for token, on contiguous caches and on the page pool; each adapter's
  stream differs from the base's. On the page pool each context has its own pool, and
  every page goes back when the requests end."""
  if paged:
    for name, value in (("XOT_PAGED_KV", "1"), ("XOT_CACHE_LEN", "16"), ("XOT_KV_PAGE", "16"),
                        ("XOT_KV_POOL_TOKENS", "512")):
      monkeypatch.setenv(name, value)
  port, jeng = _engines(model_dir, monkeypatch, {"ad1": adapters["a1"], "ad2": adapters["a2"]})
  prompt = np.random.default_rng(5).integers(3, TINY_LLAMA_CFG["vocab_size"], size=(1, 21))
  streams = {}
  for mid in ("m", "m@ad1", "m@ad2"):
    shard, jshard = _shards(mid)
    got = await _greedy(port, shard, "r-" + mid, prompt, n=14)
    assert got == await _greedy(jeng, jshard, "r-" + mid, prompt, n=14), mid
    streams[mid] = got
  assert streams["m@ad1"] != streams["m"] and streams["m@ad2"] != streams["m"]
  if paged:
    pools = [port._contexts[_shards(mid)[0]].page_pool for mid in streams]
    assert len({id(p) for p in pools}) == 3
    assert all(p is not None and p.pages_in_use == 0 for p in pools)
  _shutdown(port, jeng)


async def test_adapter_contexts_alias_base_tensors(model_dir, adapters, monkeypatch):
  """test_multi_lora.py:132: with the base and two adapters resident, every context's
  base tensors are the same tensors (one base on the device: the same data_ptr), only
  the adapter leaves differ, the two adapters disagree, and the base answers as before."""
  port, jeng = _engines(model_dir, monkeypatch, {"a1": adapters["a1"], "a2": adapters["a2"]})
  (sb, _), (s1, _), (s2, _) = _shards("m"), _shards("m@a1"), _shards("m@a2")
  lb = await _logits(port, sb, "rb")
  l1, l2 = await _logits(port, s1, "r1"), await _logits(port, s2, "r2")
  assert not np.allclose(l1, l2, atol=1e-3), "two different adapters agreed"
  cb, c1, c2 = (port._contexts[s].params for s in (sb, s1, s2))
  for slot in ("wq", "wo", "w_gate", "attn_norm"):
    assert c1["layers"][slot] is cb["layers"][slot] and c2["layers"][slot] is cb["layers"][slot]
    assert c1["layers"][slot].data_ptr() == cb["layers"][slot].data_ptr()
  assert c1["embed"]["embedding"].data_ptr() == cb["embed"]["embedding"].data_ptr()
  assert "lora_wq_a" in c1["layers"] and "lora_wq_a" in c2["layers"]
  assert "lora_wq_a" not in cb["layers"]
  assert port._contexts[s1].tokenizer is port._contexts[sb].tokenizer
  np.testing.assert_allclose(await _logits(port, sb, "rb2"), lb, atol=1e-6)
  _shutdown(port, jeng)


async def test_donor_eviction_keeps_adapter_tensors(model_dir, adapters, monkeypatch):
  """Under the default bound of two contexts, base, m@a1, m@a2 evicts the base; m@a2
  aliases m@a1's base tensors (a resident donor of the same base), which are still the
  evicted base's, and m@a1 serves the same logits after the eviction, as on JAX (the
  same contexts resident, the same aliasing, the same logits). The base then loads
  again as its own tensors."""
  port, jeng = _engines(model_dir, monkeypatch, {"a1": adapters["a1"], "a2": adapters["a2"]},
                        resident=2)
  (sb, jsb), (s1, js1), (s2, js2) = _shards("m"), _shards("m@a1"), _shards("m@a2")
  for eng, (b, a1, a2) in ((port, (sb, s1, s2)), (jeng, (jsb, js1, js2))):
    await eng.ensure_shard(b)
    base_wq = eng._contexts[b].params["layers"]["wq"]
    l1 = await _logits(eng, a1, "r1")
    await eng.ensure_shard(a2)
    assert b not in eng._contexts and a1 in eng._contexts and a2 in eng._contexts
    assert eng._contexts[a2].params["layers"]["wq"] is base_wq
    assert eng._contexts[a1].params["layers"]["wq"] is base_wq
    np.testing.assert_allclose(await _logits(eng, a1, "r1b"), l1, atol=1e-6)
    await eng.ensure_shard(b)
    assert eng._contexts[b].params["layers"]["wq"] is not base_wq
  np.testing.assert_allclose(await _logits(port, s2, "x"), await _logits(jeng, js2, "x"), atol=1e-4)
  _shutdown(port, jeng)


async def test_load_checkpoint_drops_stale_graphs(model_dir, adapters, monkeypatch):
  """A replay reads the parameters its capture saw. With the CPU's stand-in for the
  graph cache (tests/test_torch_graphs.EagerGraphCache: a replay runs the captured
  body over the tensors it closed over), m@ad1's context swapped by load_checkpoint to
  ad2's file drops its programs and streams m@ad2's tokens, not its old ones; it still
  aliases the base; the JAX engine after the same swap streams the same tokens; and
  save_checkpoint writes back ad2's tensors."""
  from tests.test_torch_graphs import EagerGraphCache
  from xotorch_tpu_torch.models.weights import _SafetensorsFile
  port, jeng = _engines(model_dir, monkeypatch, {"ad1": adapters["a1"], "ad2": adapters["a2"]})
  load = port._load_shard

  def load_with_cache(*a):
    ctx = load(*a)
    ctx.graphs = EagerGraphCache("cpu")
    return ctx
  port._load_shard = load_with_cache
  prompt = np.random.default_rng(6).integers(3, TINY_LLAMA_CFG["vocab_size"], size=(1, 19))
  (sb, _), (s1, js1), (s2, _) = _shards("m"), _shards("m@ad1"), _shards("m@ad2")
  await port.ensure_shard(sb)
  want = await _greedy(port, s2, "two", prompt)
  old = await _greedy(port, s1, "one", prompt)
  ctx = port._contexts[s1]
  assert ctx.graphs.programs and old != want
  await port.load_checkpoint(s1, str(adapters["a2"]))
  assert not ctx.graphs.programs
  got = await _greedy(port, s1, "swapped", prompt)
  assert got == want
  assert ctx.params["layers"]["wq"] is port._contexts[sb].params["layers"]["wq"]
  await jeng.load_checkpoint(js1, str(adapters["a2"]))
  assert await _greedy(jeng, js1, "swapped", prompt) == got
  out = model_dir.parent / "saved-ad1.safetensors"
  await port.save_checkpoint(s1, str(out))
  a, b = _SafetensorsFile(out), _SafetensorsFile(adapters["a2"])
  assert sorted(a.header) == sorted(b.header)
  assert all(torch.equal(a.get(n), b.get(n)) for n in b.header)
  _shutdown(port, jeng)


async def test_adapter_errors_match_jax(model_dir, tmp_path, monkeypatch):
  """test_multi_lora.py:162: an unregistered name, a missing path and a directory with
  no shard saves fail loudly, with the JAX engine's exception types and messages."""
  empty = tmp_path / "empty"
  empty.mkdir()
  port, jeng = _engines(model_dir, monkeypatch, {"gone": tmp_path / "nope.safetensors",
                                                 "empty": empty})
  messages = {}
  for name in ("nope", "gone", "empty"):
    (s, js) = _shards(f"m@{name}")
    with pytest.raises(Exception) as want:
      await jeng.ensure_shard(js)
    with pytest.raises(type(want.value)) as got:
      await port.ensure_shard(s)
    assert str(got.value) == str(want.value)
    messages[name] = str(got.value)
  assert "is not registered" in messages["nope"] and "does not exist" in messages["gone"]
  assert "no adapter checkpoint files" in messages["empty"]
  assert not port._contexts
  _shutdown(port, jeng)


def test_registry_resolution(monkeypatch):
  """test_multi_lora.py:168 on both registries: ids split alike, card, repo and shard
  lookups resolve through the base and the shard keeps the full id, and XOT_ADAPTERS
  parses alike."""
  for mid in ("llama-3.2-1b@fin", "llama-3.2-1b", "llama-3.2-1b@", "a@b@c"):
    assert registry.split_adapter(mid) == j_registry.split_adapter(mid)
  card = registry.get_model_card("synthetic-tiny@x")
  assert card is not None and card["layers"] == 4
  assert registry.get_repo("llama-3.2-1b@x", registry.TORCH) == \
         registry.get_repo("llama-3.2-1b", registry.TORCH) is not None
  shard = registry.build_base_shard("synthetic-tiny@x", registry.TORCH)
  assert shard.model_id == "synthetic-tiny@x" and shard.n_layers == 4
  monkeypatch.setenv("XOT_ADAPTERS", "fin=/tmp/fin.safetensors, med=/tmp/med,=x,bad")
  assert registry.registered_adapters() == j_registry.registered_adapters()
  assert registry.adapter_path("med") == "/tmp/med" and registry.adapter_path("nope") is None


async def test_prefix_and_host_tiers_stay_per_context(model_dir, adapters, monkeypatch):
  """Base and adapter requests on one engine share no prefix-cache or host-tier entry:
  an adapter prompt equal to a cached base prompt misses both tiers and streams its
  cold tokens, while the base's own repeat hits the host tier. The JAX engine takes
  the same hits and streams the same tokens."""
  for name, value in (("XOT_PREFIX_CACHE", "1"), ("XOT_PREFIX_CACHE_MIN", "8")):
    monkeypatch.setenv(name, value)
  port, jeng = _engines(model_dir, monkeypatch, {"ad1": adapters["a1"]})
  rng = np.random.default_rng(8)
  p, q = (rng.integers(3, TINY_LLAMA_CFG["vocab_size"], size=(1, 24)) for _ in range(2))
  counts = []
  for eng, (b, a) in ((port, (_shards("m")[0], _shards("m@ad1")[0])),
                      (jeng, (_shards("m")[1], _shards("m@ad1")[1]))):
    seen = [await _greedy(eng, b, "b1", p, n=6), await _greedy(eng, b, "b2", q, n=6)]
    seen.append(await _greedy(eng, a, "a1", p, n=6))  # P sits in the base's host tier
    hits = (eng._prefix_hits, eng._host_kv_hits)
    seen.append(await _greedy(eng, b, "b3", p, n=6))  # the base's own repeat: a host hit
    counts.append((hits, (eng._prefix_hits, eng._host_kv_hits), seen))
  (port_hits, port_after, port_seen), (j_hits, j_after, j_seen) = counts
  assert port_seen == j_seen and port_hits == j_hits == (0, 0)
  assert port_after == j_after and port_after[1] == 1
  cold, _ = _engines(model_dir, monkeypatch, {"ad1": adapters["a1"]})
  assert port_seen[2] == await _greedy(cold, _shards("m@ad1")[0], "c", p, n=6)
  assert port_seen[2] != port_seen[0]
  _shutdown(port, jeng, cold)


def _http(url, body=None):
  req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as r:
    return json.loads(r.read())


async def _jax_models(adapter_env: str) -> list:
  from aiohttp.test_utils import TestClient, TestServer
  from tests.test_orchestration import _caps, _make_node
  from xotorch_tpu.api.chatgpt_api import ChatGPTAPI
  node = await _make_node("api-lora", JAXShardInferenceEngine())
  node.topology.update_node("api-lora", _caps())
  client = TestClient(TestServer(ChatGPTAPI(node, "JAXShardInferenceEngine",
                                            default_model="synthetic-tiny").app))
  await client.start_server()
  try:
    return (await (await client.get("/v1/models")).json())["data"]
  finally:
    await client.close()
    await node.stop()


async def test_models_endpoint_and_adapter_completion(tmp_path, monkeypatch):
  """test_multi_lora.py:187: /v1/models lists each registered adapter as
  `synthetic-tiny@name` with the entries JAX's handler gives (ready, adapter_of, and the
  depth error of an adapter written for a 2-layer base), a second listing from the
  cache; then a completion for `synthetic-tiny@fin` through main.py --adapters, the API,
  the Node and the engine streams the adapter's greedy tokens, which are not the base's."""
  syn_cfg = registry.get_model_card("synthetic-tiny")["synthetic_config"]
  fin = _make_adapter(tmp_path / "fin.safetensors", seed=4, hf_cfg=syn_cfg)
  bad = _make_adapter(tmp_path / "bad.safetensors", seed=5, hf_cfg=syn_cfg, n_layers=2)
  saves = tmp_path / "saves"
  saves.mkdir()
  _make_adapter(saves / "0-3-7.safetensors", seed=6, hf_cfg=syn_cfg)
  env = f"fin={fin},bad={bad},dir={saves}"
  monkeypatch.setenv("XOT_ADAPTERS", env)
  want = [m for m in await _jax_models(env) if "@" in m["id"]]
  assert [m["id"] for m in want] == ["synthetic-tiny@fin", "synthetic-tiny@bad", "synthetic-tiny@dir"]
  monkeypatch.delenv("XOT_ADAPTERS")

  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-model", "synthetic-tiny", "--chatgpt-api-host", "127.0.0.1",
     "--chatgpt-api-port", "0", "--default-temp", "0", "--adapters", env])
  node, engine, classname, api = port_main.build_node(args)
  server = await api.start("127.0.0.1", 0)
  base = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"
  loop = asyncio.get_running_loop()
  try:
    for _ in range(2):
      listed = (await loop.run_in_executor(None, _http, base + "/v1/models"))["data"]
      assert [m for m in listed if "@" in m["id"]] == want
    assert len(api._adapter_validation_cache) == 3
    tokens_of = {}
    node.on_token.register("test-multi-lora").on_next(
      lambda rid, toks, finished: tokens_of.__setitem__(rid, list(toks)))
    messages = [{"role": "user", "content": "one two three four five"}]
    streamed = {}
    for model in ("synthetic-tiny", "synthetic-tiny@fin"):  # the base first: the donor
      before = set(tokens_of)
      resp = await loop.run_in_executor(None, _http, base + "/v1/chat/completions",
                                        {"model": model, "temperature": 0, "max_tokens": 8,
                                         "messages": messages})
      assert resp["usage"]["completion_tokens"] == 8 and resp["model"] == model
      (rid,) = set(tokens_of) - before
      streamed[model] = tokens_of[rid]
    assert streamed["synthetic-tiny@fin"] != streamed["synthetic-tiny"]
    shard = registry.build_full_shard("synthetic-tiny@fin", classname)
    ctx = engine._contexts[shard]
    assert "lora_wq_b" in ctx.params["layers"]
    base_ctx = engine._contexts[registry.build_full_shard("synthetic-tiny", classname)]
    assert ctx.params["layers"]["wq"] is base_ctx.params["layers"]["wq"]
    prompt, _ = await api._request_prompt("synthetic-tiny@fin", messages, None)
    ids = await engine.encode(shard, prompt)
    assert await _greedy(engine, shard, "direct", ids[None], n=8) == streamed["synthetic-tiny@fin"]
  finally:
    server.close()
    await server.wait_closed()
    await node.stop()
    engine.executor.shutdown(wait=True)
