"""The port's KV fabric (xotorch_tpu_torch/fabric, the engine's hooks, the /v1/kv/* routes)
against the JAX package's, on the CPU.

Keys and the wire: `shard_key` and `entry_key` are equal in both packages for the same
shard and tokens; `pack_entry` of the same entry is byte for byte JAX's, its bf16 leaves
given as JAX's ml_dtypes arrays on one side and the port's raw 16-bit words on the
other, with int8 K/V and their scales; each package unpacks and imports the other's
blob with the digest verified both ways, and refuses the same torn blobs.
`OfferDirectory.best` answers the same under the same records and one injected clock,
and the probe retry absorbs one failure and counts a dead peer once, as JAX's.

Across engines (synthetic-tiny, fp32, page 16): engine A prefills a prompt and spills it
to its host tier; engine B shares nothing with A but the fabric's transport (the
server functions over A's store, or a real HTTP server) and streams a prompt sharing
A's head exactly as its own cold run, contiguous, paged and with an int8 KV cache, the
import counted on B's fabric counters and its host hit attributed to "fabric". An
unreachable peer and a tampered blob are counted errors and cold prefills with the same
tokens. An offer resolves without a probe and is pulled before the request. A
`prefill_export` handle (from the engine, and from a prefill-role API over HTTP) is
servable. Across the two backends: the blob JAX's `serve_entry` serves from a JAX
engine's host tier is imported by a port engine on the same weights, which then decodes
its own cold prefill's greedy tokens.
"""
import asyncio
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import xotorch_tpu.fabric as j_fabric
import xotorch_tpu.fabric.client as j_client
import xotorch_tpu.fabric.server as j_server
from tests.test_torch_engine import jax_weights  # noqa: F401 (fixture)
from xotorch_tpu.inference.jax_engine import kv_offload as j_kv
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
import xotorch_tpu_torch.fabric as p_fabric
import xotorch_tpu_torch.fabric.client as p_client
import xotorch_tpu_torch.fabric.server as p_server
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine import kv_offload as p_kv
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
SHARD, JSHARD = Shard(MODEL, 0, 3, 4), JShard(MODEL, 0, 3, 4)
PROMPT_A = np.array([np.arange(44) % 250 + 1], dtype=np.int64)
PROMPT_B = np.concatenate([PROMPT_A, np.array([[99, 98, 97, 96]])], axis=1)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  for name, value in (("XOT_DTYPE", "float32"), ("XOT_SEED", "7"), ("XOT_CACHE_LEN", "16"),
                      ("XOT_PREFIX_CACHE_MIN", "16"), ("XOT_KV_HOST_BYTES", str(64 << 20)),
                      ("XOT_KV_PAGE", "16"), ("XOT_KV_POOL_TOKENS", "512")):
    monkeypatch.setenv(name, value)
  with jax.default_matmul_precision("highest"):
    yield


# ------------------------------------------------------------ keys and the wire


def test_keys_match_jax():
  toks = np.arange(40, dtype=np.int64) * 7
  for p, j in ((SHARD, JSHARD), (Shard("m@fin", 0, 1, 2), JShard("m@fin", 0, 1, 2))):
    assert p_fabric.shard_key(p) == j_fabric.shard_key(j)
    assert p_fabric.entry_key(p, toks) == j_fabric.entry_key(j, toks)
    assert p_fabric.entry_key(p, toks.astype(np.int32)) == p_fabric.entry_key(p, toks)
  assert p_fabric.shard_key("ctx") == j_fabric.shard_key("ctx") == "ctx"
  # An adapter context never matches its base's entries: the key names its shard.
  assert p_fabric.entry_key(Shard("m@fin", 0, 1, 2), toks) != p_fabric.entry_key(Shard("m", 0, 1, 2), toks)


def _entries():
  """The same two entries as (JAX leaves, port leaves): bf16 K/V, and int8 K/V with bf16
  scales. JAX holds bf16 as ml_dtypes arrays, the port as raw 16-bit words."""
  rng = np.random.default_rng(4)
  toks = rng.integers(1, 500, size=24).astype(np.int64)
  bf = lambda *s: rng.standard_normal(s).astype(np.float32).astype(ml_dtypes.bfloat16)  # noqa: E731
  kv = {"k": bf(2, 1, 20, 2, 8), "v": bf(2, 1, 20, 2, 8)}
  q8 = {"k": rng.integers(-127, 128, size=(2, 1, 16, 2, 8)).astype(np.int8),
        "v": rng.integers(-127, 128, size=(2, 1, 16, 2, 8)).astype(np.int8),
        "k_scale": bf(2, 1, 16, 2), "v_scale": bf(2, 1, 16, 2)}
  out = []
  for data, length in ((kv, 20), (q8, 16)):
    words = {n: a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a for n, a in data.items()}
    out.append((toks, length, data, words))
  return out


def test_pack_entry_and_digest_are_byte_identical_and_cross_import():
  for toks, length, jdata, pdata in _entries():
    jd, pd = j_kv.entry_digest(toks, length, jdata), p_kv.entry_digest(toks, length, pdata)
    assert jd == pd
    jblob = j_fabric.pack_entry({"toks": toks, "length": length, "data": jdata, "digest": jd})
    pblob = p_fabric.pack_entry({"toks": toks, "length": length, "data": pdata, "digest": pd})
    assert pblob == jblob
    # The port reads JAX's blob (bf16 as words again) and JAX the port's (bf16 as
    # ml_dtypes); both import with the digest recomputed and verified.
    pin, jin = p_fabric.unpack_entry(jblob), j_fabric.unpack_entry(pblob)
    for name, arr in pdata.items():
      assert pin["data"][name].dtype == arr.dtype and np.array_equal(pin["data"][name], arr)
      assert jin["data"][name].dtype == jdata[name].dtype
      assert jin["data"][name].tobytes() == jdata[name].tobytes()
    ps, js = p_kv.HostKVStore(1 << 20), j_kv.HostKVStore(1 << 20)
    assert ps.import_entry(SHARD, pin) > 0 and js.import_entry(JSHARD, jin) > 0
    assert ps.import_entry(SHARD, pin) == js.import_entry(JSHARD, jin)
    # Exports come back with the same digest and pack to the same blob again.
    pe, je = ps.export_entry(SHARD, toks), js.export_entry(JSHARD, toks)
    assert pe["digest"] == je["digest"] == jd
    assert p_fabric.pack_entry(pe) == j_fabric.pack_entry(je) == jblob
    entry, common = ps.match(SHARD, np.concatenate([toks, [7]]), 24)
    assert common == 24 and entry.source == "fabric"
    assert entry.digest == jd  # the verified digest is kept: exports hash nothing again
    # Manifests agree (the port names its words bfloat16).
    pm = p_server.manifest(ps, p_fabric.entry_key(SHARD, toks))
    assert pm == j_server.manifest(js, j_fabric.entry_key(JSHARD, toks))


def test_torn_and_tampered_blobs_are_refused_by_both():
  toks, length, jdata, pdata = _entries()[1]
  blob = p_fabric.pack_entry({"toks": toks, "length": length, "data": pdata,
                              "digest": p_kv.entry_digest(toks, length, pdata)})
  header = blob.index(b"}") + 1
  bad_dtype = blob.replace(b'"int8"', b'"int9"', 1)
  for torn in (b"NOTKV" + blob, blob[:6], blob[:16], blob[:header], blob[:-8], bad_dtype):
    for unpack in (p_fabric.unpack_entry, j_fabric.unpack_entry):
      with pytest.raises(ValueError):
        unpack(torn)
  flipped = bytearray(blob)
  flipped[-1] ^= 0xFF  # the last KV byte: it parses, its digest does not match
  for unpack, store, key in ((p_fabric.unpack_entry, p_kv.HostKVStore(1 << 20), SHARD),
                             (j_fabric.unpack_entry, j_kv.HostKVStore(1 << 20), JSHARD)):
    assert store.import_entry(key, unpack(bytes(flipped))) == 0 and len(store) == 0


def test_offer_directory_matches_jax(monkeypatch):
  """The same records and lookups under one injected clock: the same offer, coverage
  and expiry, namespaces kept apart."""
  now = [1000.0]
  monkeypatch.setattr(j_fabric.time, "monotonic", lambda: now[0])
  dirs = [(p_fabric.OfferDirectory(ttl_s=120.0, cap=3, clock=lambda: now[0]), SHARD, Shard("o", 0, 0, 1)),
          (j_fabric.OfferDirectory(ttl_s=120.0, cap=3), JSHARD, JShard("o", 0, 0, 1))]
  probe = np.arange(40, dtype=np.int64)

  def best(d, ctx, toks, limit):
    r = d.best(ctx, toks, limit)
    return None if r is None else (r[0].key, r[0].url, r[0].length, r[0].nbytes, r[1])

  script = [("rec", 0, probe[:16], 16, 100, "http://p1"), ("rec", 0, probe[:32], 24, 200, "http://p2/"),
            ("rec", 1, probe, 40, 300, "http://p3"), ("best", 0, probe, 39), ("best", 1, probe, 39),
            ("tick", 60.0), ("rec", 0, probe[:30], 30, 50, "http://p4"), ("best", 0, probe, 39),
            ("best", 0, probe, 20), ("tick", 70.0), ("best", 0, probe, 39), ("rec", 0, probe[:8], 8, 1, "u"),
            ("best", 0, probe, 39), ("tick", 200.0), ("best", 0, probe, 39)]
  outs = {0: [], 1: []}
  for op in script:
    if op[0] == "tick":
      now[0] += op[1]
      continue
    for i, (d, a, b) in enumerate(dirs):
      ctx = a if op[1] == 0 else b
      outs[i].append(d.record(ctx, *op[2:]) if op[0] == "rec" else (best(d, ctx, *op[2:]), len(d)))
  assert outs[0] == outs[1]
  assert outs[0][3][0][1] == "http://p2" and outs[0][-1] == (None, 0)


@pytest.mark.parametrize("fail_first", [True, False], ids=["one-drop-absorbed", "dead-peer"])
def test_probe_retry_matches_jax(fail_first, monkeypatch):
  for mod in (p_client, j_client):
    monkeypatch.setattr(mod.time, "sleep", lambda s: None)
  outs = []
  for mod in (p_client, j_client):
    client = mod.FabricClient(["http://peer"])
    calls = []

    def post(url, obj, calls=calls):
      calls.append(url)
      if not fail_first or len(calls) == 1:
        raise OSError("connection reset")
      return {"key": "k", "common": 7}
    client._post_json = post
    result = mod.FetchResult()
    resp = client._probe_peer("http://peer", {"toks": [1]}, result)
    outs.append((resp, len(calls), result.errors, client._peer_usable("http://peer")))
  assert outs[0] == outs[1]
  assert outs[0] == (({"key": "k", "common": 7}, 2, 0, True) if fail_first else (None, 2, 1, False))


# ------------------------------------------------------- across engines


def _set(monkeypatch, **env):
  for name, value in env.items():
    monkeypatch.setenv(name, str(value))


def _port(**kw):
  return TorchShardInferenceEngine(device="cpu", seed=0, **kw)


async def _generate(eng, shard, rid, prompt, chunks=2, size=8):
  tok, _ = await eng.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
  toks = [int(tok)]
  for _ in range(chunks):
    out = await eng.generate_chunk(rid, shard, toks[-1], size, temp=0.0, top_k=0)
    toks.extend(int(t) for t in np.asarray(out).reshape(-1))
  return toks


def _wire(client, store, server=p_server):
  """Point a FabricClient's transport at a sibling's host tier in this process: the
  server functions the API serves, the probe's answer through JSON as on the wire."""
  def post_json(url, body):
    assert url.endswith("/v1/kv/match")
    return json.loads(json.dumps(server.match_response(
      store, body["shard"], np.asarray(body["toks"], np.int64), int(body["limit"]))))

  def get_bytes(url):
    blob = server.serve_entry(store, url.rsplit("/", 1)[1].split("?", 1)[0])
    if blob is None:
      raise OSError("404")
    return blob
  client._post_json, client._get_bytes = post_json, get_bytes


async def _cold_b(kv_quant=None):
  eng = _port(kv_quant=kv_quant)
  eng._prefix_cache_max = 0
  out = await _generate(eng, SHARD, "cold", PROMPT_B)
  eng.executor.shutdown(wait=True)
  return out


async def _spilled_a(kv_quant=None):
  eng = _port(kv_quant=kv_quant)
  await _generate(eng, SHARD, "ra", PROMPT_A)
  eng._free_device_memory()
  assert len(eng._host_kv) == 1
  return eng


@pytest.mark.parametrize("paged,kv_quant,saved", [("0", None, 44), ("1", None, 32), ("1", "int8", 32),
                                                  ("0", "int8", 44)],
                         ids=["contiguous", "paged", "paged-int8", "contiguous-int8"])
async def test_cross_replica_fetch(paged, kv_quant, saved, monkeypatch):
  _set(monkeypatch, XOT_PAGED_KV=paged)
  want = await _cold_b(kv_quant)
  a = await _spilled_a(kv_quant)
  _set(monkeypatch, XOT_FABRIC_PEERS="http://peer-a")
  b = _port(kv_quant=kv_quant)
  _wire(b._fabric_client(), a._host_kv)
  assert await _generate(b, SHARD, "rb", PROMPT_B) == want
  assert (b._fabric_hits, b._fabric_errors, b._fabric_misses) == (1, 0, 0)
  entry, _ = a._host_kv.match(SHARD, PROMPT_B.reshape(-1), 47)
  assert b._fabric_bytes == entry.nbytes and b._host_kv_hits == 1
  assert b._host_hits_by_source == {"fabric": 1}
  assert b._prefix_hits == 1 and b._prefix_tokens_saved == saved
  if kv_quant:
    assert set(entry.data) == {"k", "v", "k_scale", "v_scale"}
  if paged == "1":
    assert b._unpage_calls == 0 and b._commit_copy_bytes == 0
    # The import is a host entry like a local one: a second request pays no transfer.
    await _generate(b, SHARD, "rb2", PROMPT_B)
    assert b._fabric_hits == 1
  for e in (a, b):
    e.executor.shutdown(wait=True)


@pytest.mark.parametrize("fault", ["unreachable", "tampered", "dead-peer"])
async def test_fabric_failures_prefill_cold(fault, monkeypatch):
  """A transfer that dies, a blob whose bytes lie, a peer that refuses every probe:
  counted as errors, nothing enters the store, and the request streams its cold
  tokens."""
  _set(monkeypatch, XOT_PAGED_KV=1)
  want = await _cold_b()
  a = await _spilled_a()
  _set(monkeypatch, XOT_FABRIC_PEERS="http://peer-a")
  b = _port()
  client = b._fabric_client()
  _wire(client, a._host_kv)
  real_get = client._get_bytes
  if fault == "unreachable":
    client._get_bytes = lambda url: (_ for _ in ()).throw(OSError("reset mid-transfer"))
  elif fault == "tampered":
    def flip(url):
      blob = bytearray(real_get(url))
      blob[-1] ^= 0xFF
      return bytes(blob)
    client._get_bytes = flip
  else:
    monkeypatch.setattr(p_client.time, "sleep", lambda s: None)
    client._post_json = lambda url, body: (_ for _ in ()).throw(OSError("refused"))
  assert await _generate(b, SHARD, "rb", PROMPT_B) == want
  assert b._fabric_errors == 1 and b._fabric_hits == 0 and b._fabric_bytes == 0
  assert b._host_kv_hits == 0 and len(b._host_kv_store()) == 0
  for e in (a, b):
    e.executor.shutdown(wait=True)


async def test_offer_resolves_without_probing_and_disabled_fabric_costs_nothing(monkeypatch):
  _set(monkeypatch, XOT_PAGED_KV=1)
  want = await _cold_b()
  a = await _spilled_a()
  assert a._fabric_client() is None and (a._fabric_hits, a._fabric_misses) == (0, 0)
  entry, _ = a._host_kv.match(SHARD, PROMPT_A.reshape(-1), 43)
  b = _port()
  await b._ensure_ctx(SHARD)
  assert b.fabric_offer(SHARD, PROMPT_A.reshape(-1), entry.length, entry.nbytes, "http://peer-a")
  client = b._fabric_client()
  _wire(client, a._host_kv)
  client._post_json = lambda url, body: pytest.fail("an offer hit must not probe")
  assert await b.prefetch_fabric_offer(SHARD, PROMPT_A.reshape(-1)) is True
  fetched = b._fabric_bytes
  assert b._fabric_hits == 1 and fetched == entry.nbytes
  assert await _generate(b, SHARD, "rb", PROMPT_B) == want
  assert b._fabric_bytes == fetched
  _set(monkeypatch, XOT_KV_HOST_BYTES=0)
  off = _port()
  assert off.fabric_offer(SHARD, PROMPT_A.reshape(-1), 32, 1, "http://x") is False
  for e in (a, b, off):
    e.executor.shutdown(wait=True)


async def test_prefill_export_handle_is_servable(monkeypatch):
  """`prefill_export` prefills into the host tier (its request cleared) and returns a
  handle; offering it at B imports the KV before B's request, which streams cold's
  tokens."""
  _set(monkeypatch, XOT_PAGED_KV=1)
  want = await _cold_b()
  a = _port()
  ctx = await a._ensure_ctx(SHARD)

  class _Tok:
    eos_token_id = 0

    def encode(self, prompt):
      assert prompt == "prompt a"
      return PROMPT_A.reshape(-1)
  ctx.tokenizer = _Tok()
  handle = await a.prefill_export(SHARD, "prompt a")
  assert handle["key"] == p_fabric.entry_key(SHARD, np.asarray(handle["tokens"], np.int64))
  assert handle["length"] == 32 and handle["nbytes"] > 0 and len(a._host_kv) == 1
  assert not any(r.startswith("fabric-prefill") for r in ctx.states)
  b = _port()
  await b._ensure_ctx(SHARD)
  assert b.fabric_offer(SHARD, handle["tokens"], handle["length"], handle["nbytes"], "http://peer-a")
  _wire(b._fabric_client(), a._host_kv)
  assert await b.prefetch_fabric_offer(SHARD, handle["tokens"]) is True
  assert await _generate(b, SHARD, "rb", PROMPT_B) == want
  assert b._fabric_hits == 1 and b._host_hits_by_source == {"fabric": 1}
  for e in (a, b):
    e.executor.shutdown(wait=True)


async def test_jax_engine_blob_imports_into_the_port(jax_weights, monkeypatch):  # noqa: F811
  """The entry a JAX engine spilled, served by JAX's `serve_entry` (its probe answered
  by JAX's `match_response`), is imported by a port engine on the same weights, which
  then streams its own cold prefill's greedy tokens."""
  _set(monkeypatch, XOT_PAGED_KV=1)
  want = await _cold_b()
  jeng = JAXShardInferenceEngine(dtype="float32")
  await _generate(jeng, JSHARD, "ra", PROMPT_A)
  jeng._free_device_memory()
  assert len(jeng._host_kv) == 1
  _set(monkeypatch, XOT_FABRIC_PEERS="http://jax-peer")
  b = _port()
  _wire(b._fabric_client(), jeng._host_kv, server=j_server)
  assert await _generate(b, SHARD, "rb", PROMPT_B) == want
  assert (b._fabric_hits, b._fabric_errors) == (1, 0) and b._prefix_tokens_saved == 32
  entry, _ = jeng._host_kv.match(JSHARD, PROMPT_B.reshape(-1), 47)
  assert b._fabric_bytes == entry.nbytes
  b.executor.shutdown(wait=True)


# ------------------------------------------------------------- over HTTP


async def test_fabric_over_http_and_the_prefill_role(monkeypatch):
  """A port API server is replica A: after a completion and a spill, B (XOT_FABRIC_PEERS
  naming A) probes /v1/kv/match and GETs the blob over HTTP, then streams cold's tokens;
  /v1/kv/{key} serves the manifest. Under XOT_FABRIC_ROLE=prefill A answers a
  completion with a kv.handle, which B pulls over HTTP through an offer; A's /metrics
  counts B's... and B's counters are what /metrics of an API over B would read."""
  _set(monkeypatch, XOT_PAGED_KV=1)
  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-model", MODEL, "--chatgpt-api-host", "127.0.0.1",
     "--chatgpt-api-port", "0", "--default-temp", "0", "--max-generate-tokens", "4"])
  node, a, _, api = port_main.build_node(args)
  server = await api.start("127.0.0.1", 0)
  base = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"
  words = " ".join(f"w{i % 50}" for i in range(60))
  body = {"model": MODEL, "max_tokens": 4, "messages": [{"role": "user", "content": words}]}
  loop = asyncio.get_running_loop()
  from tests.test_torch_router import _call
  call = lambda *x, **k: loop.run_in_executor(None, lambda: _call(*x, **k))  # noqa: E731
  try:
    assert (await call(base + "/v1/chat/completions", body))[0] == 200
    await a._run(a._free_device_memory)
    (ctx_key, toks), = a._host_kv.snapshot_keys()
    key = p_fabric.entry_key(ctx_key, toks)
    status, _, raw = await call(base + f"/v1/kv/{key}")
    man = json.loads(raw)
    assert status == 200 and man["key"] == key and man["n_toks"] == toks.shape[0]
    status, headers, blob = await call(base + f"/v1/kv/{key}?payload=1")
    assert status == 200 and headers["content-type"] == "application/octet-stream"
    assert p_fabric.unpack_entry(blob)["digest"] == man["digest"]

    prompt = np.concatenate([toks, [7, 8, 9]]).reshape(1, -1)
    cold = _port()
    cold._prefix_cache_max = 0
    want = await _generate(cold, SHARD, "c", prompt)
    _set(monkeypatch, XOT_FABRIC_PEERS=base)
    b = _port()
    assert await _generate(b, SHARD, "rb", prompt) == want
    assert (b._fabric_hits, b._fabric_errors) == (1, 0)
    assert b._fabric_bytes == a._host_kv.match(ctx_key, toks, toks.shape[0])[0].nbytes

    # The prefill role: a handle instead of a completion, pulled by an offer.
    _set(monkeypatch, XOT_FABRIC_ROLE="prefill")
    other = " ".join(f"w{(i * 7) % 50}" for i in range(60))
    status, _, raw = await call(base + "/v1/chat/completions",
                                {**body, "messages": [{"role": "user", "content": other}]})
    handle = json.loads(raw)
    assert status == 200 and handle["object"] == "kv.handle" and handle["model"] == MODEL
    _set(monkeypatch, XOT_FABRIC_ROLE="mixed", XOT_FABRIC_PEERS="")
    c = _port()
    await c._ensure_ctx(SHARD)
    assert c.fabric_offer(SHARD, handle["tokens"], handle["length"], handle["nbytes"], base)
    assert await c.prefetch_fabric_offer(SHARD, handle["tokens"]) is True
    htoks = np.asarray(handle["tokens"]).reshape(1, -1)
    assert await _generate(c, SHARD, "rc", htoks) == await _generate(cold, SHARD, "c2", htoks)
    assert c._fabric_hits == 1 and c._host_hits_by_source == {"fabric": 1}
    for e in (b, c, cold):
      e.executor.shutdown(wait=True)
  finally:
    server.close()
    await node.stop()
    a.executor.shutdown(wait=True)


async def test_a_short_common_head_is_not_fetched(monkeypatch):
  """A sibling entry that shares fewer than XOT_PREFIX_CACHE_MIN tokens with the prompt
  (a chat template's first words) is a miss, never a transfer: the restore would not
  use it. (JAX's engine fetches it and then restores none of it.)"""
  _set(monkeypatch, XOT_PAGED_KV=0)
  a = await _spilled_a()
  _set(monkeypatch, XOT_FABRIC_PEERS="http://peer-a")
  b = _port()
  client = b._fabric_client()
  _wire(client, a._host_kv)
  client._get_bytes = lambda url: pytest.fail("a short head must not be fetched")
  prompt = np.concatenate([PROMPT_A[:, :5], np.arange(200, 240).reshape(1, -1)], axis=1)
  await _generate(b, SHARD, "rb", prompt)
  assert (b._fabric_hits, b._fabric_errors, b._fabric_misses) == (0, 0, 1)
  for e in (a, b):
    e.executor.shutdown(wait=True)
