"""The serving mesh's last paths (the fused in-process ring, the KV fabric, vision) and an
engine inside a process group, against the JAX package, on the CPU.

Every engine serves the tiny llama checkpoint that `transformers` writes
(tests/test_model_equivalence.TINY_LLAMA_CFG, seed 3) or the tiny llava of
tests/test_vision_llava.py, in fp32 with JAX's matmul precision pinned to 'highest'.
XOT_VIRTUAL_DEVICES=8 gives the port eight positions on the CPU, as conftest's
--xla_force_host_platform_device_count=8 gives JAX; XOT_TP=2 puts both packages' engines
on a tp-2 mesh.

- The fused ring over tp 2 (2 and 3 segments, a chain whose segments differ in their
  meshes, concurrent requests in one batched chunk, the ring's verify of lookup drafts):
  the greedy streams equal the port's one-device fused ring's and JAX's tp-2 ring's,
  token for token, every chunk fused (no decline).
- The KV fabric over tp 2: a tp-2 engine's host entry has the single device's leaves
  and shapes (whole leaves, JAX's layout, values within 1e-5: fp32 sums in another
  order), each engine's blob packs byte for byte as the other package packs the same
  entry, the three blobs (port tp 2, port one device, JAX tp 2) share one layout and
  length, and a tp-2 replica and a single-device one import each other's blobs
  and stream their own cold prefill's tokens; a JAX tp-2 engine's blob imports too. The
  prefill role builds and exports on a mesh.
- A multimodal prefill over tp 2 (and tp 2 x sp 2, where the merged sequence prefills
  by ring attention): the logits within 1e-4 of JAX's tp-2 engine's and of the port's
  single device's, then JAX's greedy tokens.
- Two gloo ranks in subprocesses, each an engine with XOT_TP=2 over two virtual devices,
  each stream the single-process greedy tokens.
"""
import asyncio
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import xotorch_tpu.fabric as j_fabric
from tests.test_model_equivalence import TINY_LLAMA_CFG, make_hf_checkpoint
from tests.test_ring_fused import _generate as j_generate_stream
from tests.test_ring_fused import _ring as j_ring
from tests.test_torch_fabric import _wire
from tests.test_torch_graphs import EagerGraphCache
from tests.test_torch_ring_fused import _caps, _generate, _node, _shutdown, _spy_ring_calls
from tests.test_torch_vision import _image_stream, save_tiny_llava, tiny_llava_cfg
from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
import xotorch_tpu_torch.fabric as p_fabric
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.networking.inprocess import InProcessPeerHandle
from xotorch_tpu_torch.parallel.mesh import MeshParams

torch.set_num_threads(2)

N_LAYERS = TINY_LLAMA_CFG["num_hidden_layers"]
MESH_KNOBS = ("XOT_TP", "XOT_SERVE_TP", "XOT_SERVE_SP", "XOT_SERVE_EP", "XOT_PAGED_KV",
              "XOT_KV_QUANT", "XOT_FABRIC_PEERS", "XOT_FABRIC_ROLE", "XOT_SPECULATE")


@pytest.fixture(autouse=True)
def _mesh_env(monkeypatch):
  monkeypatch.setenv("XOT_VIRTUAL_DEVICES", "8")
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_SEED", "7")
  for knob in MESH_KNOBS:
    monkeypatch.delenv(knob, raising=False)
  with jax.default_matmul_precision("highest"):
    yield


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
  return make_hf_checkpoint(tmp_path_factory.mktemp("port_meshpaths"), TINY_LLAMA_CFG, seed=3)


def _engine(model_dir, graph_cache=False):
  eng = TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu", seed=0)
  if graph_cache:
    load = eng._load_shard

    def load_with_cache(*a):
      ctx = load(*a)
      ctx.graphs = EagerGraphCache("cpu")
      return ctx
    eng._load_shard = load_with_cache
  return eng


def _jax_engine(model_dir):
  return JAXShardInferenceEngine(JLocalShardDownloader({"m": model_dir}), dtype="float32")


def _mesh_tp(eng) -> int:
  ctx = eng._ctx
  return ctx.mesh.axis_size("tp") if ctx is not None and ctx.mesh is not None else 1


# ------------------------------------------------------------------ the fused ring


def _ring_of(engines, max_tokens):
  """Port Nodes in one process over the given engines, joined by InProcessPeerHandles."""
  nodes = [_node(f"ring-{i}", eng, max_tokens) for i, eng in enumerate(engines)]
  for node in nodes:
    for other in nodes:
      node.topology.update_node(other.id, _caps())
    node.peers = [InProcessPeerHandle(o) for o in nodes if o is not node]
  return nodes


def _tp_engines(monkeypatch, model_dir, tps, graph_cache=False):
  """One engine a segment, each built under its own XOT_TP (the engine reads it once)."""
  out = []
  for tp in tps:
    monkeypatch.setenv("XOT_TP", str(tp))
    out.append(_engine(model_dir, graph_cache))
  monkeypatch.delenv("XOT_TP")
  return out


async def _fused(nodes, prompt, rid):
  calls = _spy_ring_calls(nodes)
  try:
    got = await _generate(nodes[0], prompt, rid, watch=nodes[1:])
  finally:
    _shutdown(nodes)
  assert calls, "the fused ring path was never taken"
  driver = next(n.inference_engine for n in nodes if n.inference_engine._ring_chunks)
  assert driver.ring_stats()["declines"] == {}, driver.ring_stats()
  return got, driver


@pytest.mark.parametrize("tps", [(2, 2), (2, 2, 2), (2, 0), (0, 2, 2)],
                         ids=["2 segs", "3 segs", "tp2 then one device", "one device then tp2"])
@pytest.mark.parametrize("graph_cache", [False, True], ids=["eager", "graph cache"])
async def test_fused_ring_over_tp2_matches_one_device_and_jax(tiny_model_dir, monkeypatch, tps,
                                                             graph_cache):
  """A chain of 2 or 3 partitions whose engines serve over tp 2 (or some over tp 2 and
  some on one device) decodes in fused chunks: the greedy stream of the port's
  one-device fused ring and of JAX's tp-2 fused ring, no chunk declined; each segment's
  params a MeshParams where its engine has a mesh, and under the graph cache the ring's
  programs keyed by every segment's mesh."""
  max_tokens, prompt = 12, "fused ring over a mesh"
  want = (await _fused(_ring_of(_tp_engines(monkeypatch, tiny_model_dir, [0] * len(tps)),
                                max_tokens), prompt, "one-device"))[0]
  if not graph_cache:
    monkeypatch.setenv("XOT_TP", "2")
    jnodes = j_ring(tiny_model_dir, len(tps), max_tokens)
    assert await j_generate_stream(jnodes[0], prompt, "jax-tp2", watch=jnodes[1:]) == want
    assert all(n.inference_engine._mesh is not None for n in jnodes)
    monkeypatch.delenv("XOT_TP")
  engines = _tp_engines(monkeypatch, tiny_model_dir, tps, graph_cache)
  got, driver = await _fused(_ring_of(engines, max_tokens), prompt, "tp2")
  assert got == want and len(got) == max_tokens
  assert [_mesh_tp(e) for e in engines] == [2 if tp else 1 for tp in tps]
  assert [isinstance(e._ctx.params, MeshParams) for e in engines] == [bool(tp) for tp in tps]
  if graph_cache:
    (_, gc), = driver._ring_graphs.values()
    assert gc.replays > 0
    key = next(k for k in gc.programs if k[:2] == ("decode", "ring"))
    assert sum(1 for part in key if isinstance(part, tuple) and part[:1] == ("mesh",)) == \
        sum(1 for tp in tps if tp)


async def test_fused_ring_over_tp2_batches_concurrent_requests(tiny_model_dir, monkeypatch):
  """Concurrent requests on a tp-2 chain coalesce into batched fused chunks (every
  segment's cache pieces stacked along the batch), each stream its one-device solo
  run's. The width check retries a bounded number of times: one request can finish
  before the other's prefill lands."""
  max_tokens = 24
  prompts = ["first concurrent prompt", "a different second prompt here"]
  solo = []
  for i, p in enumerate(prompts):
    node = _ring_of(_tp_engines(monkeypatch, tiny_model_dir, [0]), max_tokens)[0]
    try:
      solo.append(await _generate(node, p, f"solo-{i}"))
    finally:
      _shutdown([node])
  widths = []
  for attempt in range(3):
    nodes = _ring_of(_tp_engines(monkeypatch, tiny_model_dir, [2, 2]), max_tokens)
    for node in nodes:
      eng = node.inference_engine
      orig = eng._ring_batch_sync

      def recording(items, *a, _orig=orig):
        widths.append(len(items))
        return _orig(items, *a)
      eng._ring_batch_sync = recording
    try:
      results = await asyncio.gather(*(_generate(nodes[0], p, f"conc-{i}-{attempt}",
                                                 watch=nodes[1:])
                                       for i, p in enumerate(prompts)))
    finally:
      _shutdown(nodes)
    assert sorted(map(tuple, results)) == sorted(map(tuple, solo))
    if widths and max(widths) >= 2:
      driver = next(n.inference_engine for n in nodes if n.inference_engine._ring_batch_dispatches)
      assert driver._ring_batch_rows >= 2 * driver._ring_batch_dispatches
      return
  raise AssertionError(f"ring chunks never coalesced in 3 attempts: {widths}")


async def test_fused_ring_over_tp2_verifies_lookup_drafts(tiny_model_dir, monkeypatch):
  """Prompt lookup over a tp-2 chain: drafts verified through verify_draft_ring (every
  segment's K2 at T > 1 on its heads) reproduce the one-device stream and JAX's tp-2
  ring's, and drafts were proposed."""
  monkeypatch.setenv("XOT_SPECULATE", "4")
  max_tokens = 16
  prompt = "the cat sat on the mat the cat sat on the mat the cat"
  want = (await _fused(_ring_of(_tp_engines(monkeypatch, tiny_model_dir, [0, 0]), max_tokens),
                       prompt, "one-device"))[0]
  monkeypatch.setenv("XOT_TP", "2")
  jnodes = j_ring(tiny_model_dir, 2, max_tokens)
  assert await j_generate_stream(jnodes[0], prompt, "jax-tp2", watch=jnodes[1:]) == want
  monkeypatch.delenv("XOT_TP")
  engines = _tp_engines(monkeypatch, tiny_model_dir, [2, 2])
  nodes = _ring_of(engines, max_tokens)
  assert nodes[0].speculate_tokens == 4
  got, _ = await _fused(nodes, prompt, "tp2")
  assert got == want
  assert sum(e._spec_proposed for e in engines) > 0


# ------------------------------------------------------------------ the KV fabric

SHARD, JSHARD = Shard("m", 0, N_LAYERS - 1, N_LAYERS), JShard("m", 0, N_LAYERS - 1, N_LAYERS)
PROMPT_A = np.array([np.arange(44) % 250 + 1], dtype=np.int64)
PROMPT_B = np.concatenate([PROMPT_A, np.array([[99, 98, 97, 96]])], axis=1)


def _fabric_env(monkeypatch, paged):
  for name, value in (("XOT_CACHE_LEN", "16"), ("XOT_PREFIX_CACHE_MIN", "16"),
                      ("XOT_KV_HOST_BYTES", str(64 << 20)), ("XOT_KV_PAGE", "16"),
                      ("XOT_KV_POOL_TOKENS", "512"), ("XOT_PAGED_KV", paged)):
    monkeypatch.setenv(name, value)


async def _stream(eng, shard, rid, prompt, chunks=2, size=8):
  tok, _ = await eng.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
  toks = [int(tok)]
  for _ in range(chunks):
    out = await eng.generate_chunk(rid, shard, toks[-1], size, temp=0.0, top_k=0)
    toks.extend(int(t) for t in np.asarray(out).reshape(-1))
  return toks


async def _spilled(eng, shard=SHARD):
  """`eng` after prefilling PROMPT_A and spilling its prefix to the host tier: its one
  entry's export payload."""
  await _stream(eng, shard, "ra", PROMPT_A)
  eng._free_device_memory()
  (ctx_key, toks), = eng._host_kv.snapshot_keys()
  return eng._host_kv.export_entry(ctx_key, toks)


def _jax_words(payload):
  """A JAX entry's payload as the port holds it (bf16 leaves would be raw words; these
  engines run fp32, so the leaves pass as they are)."""
  return {**payload, "data": {n: np.asarray(a) for n, a in payload["data"].items()}}


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_fabric_over_tp2_blobs_and_imports_both_ways(tiny_model_dir, monkeypatch, paged):
  _fabric_env(monkeypatch, paged)
  monkeypatch.setenv("XOT_TP", "0")
  cold = _engine(tiny_model_dir)
  cold._prefix_cache_max = 0
  want = await _stream(cold, SHARD, "cold", PROMPT_B)
  one = _engine(tiny_model_dir)
  one_entry = await _spilled(one)
  monkeypatch.setenv("XOT_TP", "2")
  tp2 = _engine(tiny_model_dir)
  tp2_entry = await _spilled(tp2)
  assert _mesh_tp(tp2) == 2
  jeng = _jax_engine(tiny_model_dir)
  j_entry = await _spilled(jeng, JSHARD)
  assert jeng._mesh is not None and jeng._mesh.shape["tp"] == 2
  # One layout on every side: whole leaves [L, 1, T, Hkv, D], the same names and length.
  for e in (tp2_entry, j_entry):
    assert e["length"] == one_entry["length"] and np.array_equal(e["toks"], one_entry["toks"])
    assert {n: (a.shape, a.dtype) for n, a in e["data"].items()} == \
        {n: (a.shape, a.dtype) for n, a in one_entry["data"].items()}
    for name, arr in e["data"].items():
      np.testing.assert_allclose(arr, one_entry["data"][name], atol=1e-5, rtol=0)
  assert set(tp2_entry["data"]) == {"k", "v"}
  assert tp2_entry["data"]["k"].shape[3] == TINY_LLAMA_CFG["num_key_value_heads"]
  # The blobs: each side's entry packs byte for byte as the other package's packer packs
  # it, and the three unpack to one layout (the values differ only in the last bits).
  tp2_blob, one_blob = p_fabric.pack_entry(tp2_entry), p_fabric.pack_entry(one_entry)
  j_blob = j_fabric.pack_entry(j_entry)
  assert j_fabric.pack_entry(_jax_words(tp2_entry)) == tp2_blob
  assert j_fabric.pack_entry(_jax_words(one_entry)) == one_blob
  assert p_fabric.pack_entry(_jax_words(p_fabric.unpack_entry(j_blob))) == j_blob

  def layout(blob):
    e = p_fabric.unpack_entry(blob)
    return (e["length"], e["toks"].tolist(),
            sorted((n, a.dtype.str, a.shape) for n, a in e["data"].items()))
  assert layout(tp2_blob) == layout(one_blob) == layout(j_blob)
  assert len(tp2_blob) == len(one_blob) == len(j_blob)
  # Imports both ways: a single-device replica from the tp-2 one, a tp-2 replica from
  # the single device and from JAX's tp-2 engine; each streams its cold tokens.
  monkeypatch.setenv("XOT_FABRIC_PEERS", "http://peer-a")
  for tp, source, server in ((0, tp2, None), (2, one, None), (2, jeng, "jax")):
    monkeypatch.setenv("XOT_TP", str(tp))
    b = _engine(tiny_model_dir)
    if server == "jax":
      import xotorch_tpu.fabric.server as j_server
      _wire(b._fabric_client(), source._host_kv, server=j_server)
    else:
      _wire(b._fabric_client(), source._host_kv)
    assert await _stream(b, SHARD, "rb", PROMPT_B) == want, (tp, server)
    assert _mesh_tp(b) == (tp or 1)
    assert (b._fabric_hits, b._fabric_errors) == (1, 0)
    assert b._host_hits_by_source == {"fabric": 1} and b._prefix_hits == 1
    if paged == "1":
      assert b._unpage_calls == 0 and b._commit_copy_bytes == 0
    b.executor.shutdown(wait=True)
  for e in (cold, one, tp2, jeng):
    e.executor.shutdown(wait=True)


async def test_fabric_knobs_and_prefill_role_serve_over_tp2(tiny_model_dir, monkeypatch):
  """With XOT_TP=2 the engine builds under XOT_FABRIC_PEERS and XOT_FABRIC_ROLE=prefill;
  `prefill_export` on the mesh returns a handle whose entry a single-device replica
  pulls through an offer before its request, which then streams cold's tokens."""
  _fabric_env(monkeypatch, "1")
  monkeypatch.setenv("XOT_TP", "0")
  cold = _engine(tiny_model_dir)
  cold._prefix_cache_max = 0
  want = await _stream(cold, SHARD, "cold", PROMPT_B)
  monkeypatch.setenv("XOT_TP", "2")
  monkeypatch.setenv("XOT_FABRIC_PEERS", "http://peer-b")
  monkeypatch.setenv("XOT_FABRIC_ROLE", "prefill")
  a = _engine(tiny_model_dir)
  assert a.supports_ring_fusion is True
  ctx = await a._ensure_ctx(SHARD)
  assert ctx.mesh.shape == {"tp": 2}

  class _Tok:
    eos_token_id = 0

    def encode(self, prompt):
      assert prompt == "prompt a"
      return PROMPT_A.reshape(-1)
  ctx.tokenizer = _Tok()
  handle = await a.prefill_export(SHARD, "prompt a")
  assert handle["key"] == p_fabric.entry_key(SHARD, np.asarray(handle["tokens"], np.int64))
  assert handle["length"] == 32 and handle["nbytes"] > 0
  for name in ("XOT_FABRIC_PEERS", "XOT_FABRIC_ROLE"):
    monkeypatch.delenv(name)
  monkeypatch.setenv("XOT_TP", "0")
  b = _engine(tiny_model_dir)
  await b._ensure_ctx(SHARD)
  assert b.fabric_offer(SHARD, handle["tokens"], handle["length"], handle["nbytes"],
                        "http://peer-a")
  _wire(b._fabric_client(), a._host_kv)
  assert await b.prefetch_fabric_offer(SHARD, handle["tokens"]) is True
  assert await _stream(b, SHARD, "rb", PROMPT_B) == want
  assert b._fabric_hits == 1 and b._host_hits_by_source == {"fabric": 1}
  for e in (cold, a, b):
    e.executor.shutdown(wait=True)


# ------------------------------------------------------------------ vision


@pytest.fixture(scope="module")
def llava_dir(tmp_path_factory):
  d = tmp_path_factory.mktemp("llava_mesh") / "llava"
  d.mkdir()
  save_tiny_llava(d, tiny_llava_cfg(), seed=7)
  return d


@pytest.mark.parametrize("mesh", [{"XOT_TP": "2"}, {"XOT_TP": "2", "XOT_SERVE_SP": "2"}],
                         ids=["tp2", "tp2-sp2"])
async def test_multimodal_prefill_over_a_mesh_matches_jax_tp2(llava_dir, monkeypatch, mesh):
  """An image request on a mesh: the tower and the projector once on the engine's device,
  the merged sequence through every tp position's K1 (and, with sp, by ring attention:
  counted in sp_ring_prefills). Its logits within 1e-4 of JAX's tp-2 engine's and of
  the port's single device's (fp32 sums in another order), then JAX's greedy tokens.
  A `base@adapter` context on the mesh aliases the base's tower."""
  from tests.test_torch_vision import MODEL
  from xotorch_tpu.download.shard_download import LocalShardDownloader as JLoader
  for name, value in (("XOT_CACHE_LEN", "16"), ("XOT_KV_PAGE", "16"),
                      ("XOT_KV_POOL_TOKENS", "256")):
    monkeypatch.setenv(name, value)
  n = tiny_llava_cfg()["text_config"]["num_hidden_layers"]
  shard, jshard = Shard(MODEL, 0, n - 1, n), JShard(MODEL, 0, n - 1, n)
  monkeypatch.setenv("XOT_TP", "0")
  one = TorchShardInferenceEngine(LocalShardDownloader({MODEL: llava_dir}), device="cpu", seed=0)
  one_logits, one_toks = await _image_stream(one, shard, "mm")
  monkeypatch.setenv("XOT_TP", "2")
  jeng = JAXShardInferenceEngine(JLoader({MODEL: llava_dir}), dtype="float32")
  jlogits, want = await _image_stream(jeng, jshard, "mm")
  assert jeng._mesh is not None and jeng._mesh.shape["tp"] == 2
  for knob, value in mesh.items():
    monkeypatch.setenv(knob, value)
  eng = TorchShardInferenceEngine(LocalShardDownloader({MODEL: llava_dir}), device="cpu", seed=0)
  logits, got = await _image_stream(eng, shard, "mm")
  ctx = eng._ctx
  assert ctx.mesh.axis_size("tp") == 2 and ctx.vision is not None
  assert ctx.mesh.axis_size("sp") == int(mesh.get("XOT_SERVE_SP", 1))
  assert eng.sp_ring_prefills == (1 if "XOT_SERVE_SP" in mesh else 0)
  np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=0)
  np.testing.assert_allclose(logits, one_logits, atol=1e-4, rtol=0)
  assert got == want == one_toks
  for e in (one, jeng, eng):
    e.executor.shutdown(wait=True)


async def test_multimodal_adapter_context_aliases_the_tower_over_tp2(llava_dir, monkeypatch):
  """A `base@adapter` context of a vision base over tp 2 (XOT_LORA_RANK adapters on the
  text stack) aliases the base's tower and projector, and serves an image request."""
  from tests.test_torch_vision import MODEL
  for name, value in (("XOT_CACHE_LEN", "16"), ("XOT_TP", "2"), ("XOT_MAX_RESIDENT_MODELS", "2")):
    monkeypatch.setenv(name, value)
  n = tiny_llava_cfg()["text_config"]["num_hidden_layers"]
  eng = TorchShardInferenceEngine(LocalShardDownloader({MODEL: llava_dir}), device="cpu", seed=0)
  base = Shard(MODEL, 0, n - 1, n)
  await eng.ensure_shard(base)
  base_ctx = eng._ctx
  adapter = Shard(f"{MODEL}@fin", 0, n - 1, n)
  donor = eng._donor_ctx(adapter, MODEL)
  assert donor is base_ctx
  ctx = eng._load_shard(adapter, llava_dir, donor)
  assert ctx.vision is base_ctx.vision and ctx.mesh is base_ctx.mesh
  assert isinstance(ctx.params, MeshParams)
  eng.executor.shutdown(wait=True)


# ------------------------------------------------------------------ a process group

WORKER = textwrap.dedent("""
  import asyncio, json, os, sys
  sys.path.insert(0, os.environ["XOT_REPO"])
  import numpy as np
  import torch
  torch.set_num_threads(1)
  from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
  from xotorch_tpu_torch.inference.shard import Shard
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  import torch.distributed as dist
  from xotorch_tpu_torch.parallel.multihost import init_multihost

  n_proc, rank = init_multihost()
  assert n_proc == dist.get_world_size() == 2, n_proc
  eng = TorchShardInferenceEngine(LocalShardDownloader({"m": os.environ["XOT_MODEL"]}),
                                  device="cpu", seed=0)
  n = int(os.environ["XOT_LAYERS"])
  shard = Shard("m", 0, n - 1, n)

  async def stream():
    prompt = np.array([json.loads(os.environ["XOT_PROMPT"])], dtype=np.int64)
    tok, _ = await eng.infer_sample_tensor("r", shard, prompt, temp=0.0)
    out = [int(tok)]
    chunk = await eng.generate_chunk("r", shard, out[-1], 9, temp=0.0)
    return out + [int(t) for t in np.asarray(chunk).reshape(-1)]

  toks = asyncio.run(stream())
  print(json.dumps({"rank": rank, "tp": eng._ctx.mesh.axis_size("tp"), "tokens": toks}),
        flush=True)
  eng.executor.shutdown(wait=True)
""")


@pytest.mark.skipif(os.getenv("XOT_MULTIHOST_TEST", "1") == "0",
                    reason="no local ports to bind (XOT_MULTIHOST_TEST=0)")
async def test_process_group_ranks_serve_their_local_mesh(tiny_model_dir, monkeypatch):
  """Two gloo ranks (XOT_COORDINATOR, as tests/test_torch_multihost.py spawns them) each
  build an engine with XOT_TP=2 over two virtual devices and serve as their own peer, as
  every rank of JAX's main.py does: each streams the single-process greedy tokens."""
  prompt = [1, 5, 9, 200, 17, 3, 42]
  monkeypatch.setenv("XOT_TP", "0")
  eng = _engine(tiny_model_dir)
  tok, _ = await eng.infer_sample_tensor("r", SHARD, np.array([prompt]), temp=0.0)
  want = [int(tok)]
  chunk = await eng.generate_chunk("r", SHARD, want[-1], 9, temp=0.0)
  want += [int(t) for t in np.asarray(chunk).reshape(-1)]
  eng.executor.shutdown(wait=True)
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
  env_base = {**os.environ, "XOT_REPO": os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
              "XOT_COORDINATOR": f"127.0.0.1:{port}", "XOT_NUM_PROCESSES": "2",
              "CUDA_VISIBLE_DEVICES": "", "XOT_TP": "2", "XOT_VIRTUAL_DEVICES": "2",
              "XOT_MODEL": str(tiny_model_dir), "XOT_LAYERS": str(N_LAYERS),
              "XOT_PROMPT": json.dumps(prompt)}
  procs = [subprocess.Popen([sys.executable, "-c", WORKER], env={**env_base, "XOT_PROCESS_ID": str(r)},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for r in (0, 1)]
  outs = []
  for p in procs:
    try:
      out, _ = p.communicate(timeout=240)
    except subprocess.TimeoutExpired:
      p.kill()
      out, _ = p.communicate()
    outs.append(out)
  for rank, (p, out) in enumerate(zip(procs, outs)):
    assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    result = json.loads(out.strip().splitlines()[-1])
    assert result == {"rank": rank, "tp": 2, "tokens": want}, (result, want)
