"""The port's host KV tier (kv_offload.HostKVStore, XOT_KV_HOST_BYTES), OOM recovery and
the prefetch of a queued prompt, against the JAX package's, on the CPU.

The store's put / match / drop / budget behaviour and `entry_digest` must equal the
JAX store's on the same numpy inputs, and `scatter_pages` the JAX one on the same
arena. The engines serve synthetic-tiny in fp32 on the JAX engine's weights, page 16:
after a forced `_free_device_memory` both spill the warm prefix to the host tier, a
later prompt sharing it restores it (into fresh pages or a snapshot, also across the
two layouts) and streams what a cold engine streams, with the hits and the bytes
spilled and fetched equal to the JAX engine's; the spilled bytes come back
byte-equal. Degrade paths fall back to a cold prefill and are counted: a torn entry or
one spilled under another cache config is dropped, a restore that races pool pressure
keeps its entry. A zero budget turns the tier off. An out-of-memory error inside a
serving call recovers and is answered as CacheExhausted, the dropped request raises
RequestStateLost, and the next request restores. `prefetch_host_prefix`,
POST /v1/prefetch (202) and the admission gate's on_queued hook restore a queued
prompt's prefix before it runs.
"""
import asyncio
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import jax_weights  # noqa: F401 (fixture)
from xotorch_tpu.inference.jax_engine import kv_offload as j_kv_offload
from xotorch_tpu.inference.jax_engine import paged_cache as j_paged_cache
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.models.registry import get_model_card as j_get_model_card
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.inference.engine import CacheExhausted, RequestStateLost
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine import engine as engine_mod
from xotorch_tpu_torch.inference.torch_engine import kv_offload, paged_cache
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.orchestration.flight import FlightRecorder

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
SHARD, JSHARD = Shard(MODEL, 0, 3, 4), JShard(MODEL, 0, 3, 4)
PROMPT_A = np.array([np.arange(44) % 250 + 1], dtype=np.int64)
# Shares A's 44 tokens, then diverges: the restore covers the common head (whole pages
# when paged) and only the rest prefills.
PROMPT_B = np.concatenate([PROMPT_A, np.array([[99, 98, 97, 96]])], axis=1)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  for name, value in (("XOT_DTYPE", "float32"), ("XOT_SEED", "7"), ("XOT_CACHE_LEN", "16"),
                      ("XOT_PREFIX_CACHE_MIN", "16"), ("XOT_KV_HOST_BYTES", str(64 << 20)),
                      ("XOT_KV_PAGE", "16"), ("XOT_KV_POOL_TOKENS", "512")):
    monkeypatch.setenv(name, value)
  with jax.default_matmul_precision("highest"):
    yield


def _set(monkeypatch, **env):
  for name, value in env.items():
    monkeypatch.setenv(name, str(value))


def _port():
  return TorchShardInferenceEngine(device="cpu", seed=0)


async def _generate(eng, shard, rid, prompt, chunks=2, size=8):
  tok, _ = await eng.infer_sample_tensor(rid, shard, prompt, temp=0.0, top_k=0)
  toks = [int(tok)]
  for _ in range(chunks):
    out = await eng.generate_chunk(rid, shard, toks[-1], size, temp=0.0, top_k=0)
    toks.extend(int(t) for t in np.asarray(out).reshape(-1))
  return toks


async def _cold_b(monkeypatch):
  _set(monkeypatch, XOT_PREFIX_CACHE=0)
  eng = _port()
  out = await _generate(eng, SHARD, "cold", PROMPT_B)
  eng.executor.shutdown(wait=True)
  _set(monkeypatch, XOT_PREFIX_CACHE=2)
  return out


def _host_counts(eng):
  return (eng._host_kv_hits, eng._host_spill_bytes, eng._host_fetch_bytes, eng._prefix_hits,
          eng._prefix_tokens_saved)


# ------------------------------------------------------------------ the store


def test_host_store_and_digest_match_jax():
  """The same puts, matches, drops and budget evictions on both stores leave the same
  entries, bytes and answers; entry_digest and common_prefix_len agree."""
  toks = [np.arange(64, dtype=np.int64) + 100 * i for i in range(3)]
  data = lambda fill: {"k": np.full((2, 1, 32, 2, 4), fill, np.float32),  # noqa: E731
                       "v": np.full((2, 1, 32, 2, 4), fill, np.float32)}
  one = sum(a.nbytes for a in data(0).values()) + toks[0].nbytes
  stores = [kv_offload.HostKVStore(2 * one + 64), j_kv_offload.HostKVStore(2 * one + 64)]
  evicted = [[], []]
  for s, log in zip(stores, evicted):
    s.observer = lambda n, b, log=log: log.append((n, b))

  def both(name, *args):
    outs = []
    for s in stores:
      r = getattr(s, name)(*args)
      if isinstance(r, tuple):
        r = (None if r[0] is None else (r[0].toks.tolist(), r[0].length, r[0].nbytes,
                                        float(r[0].data["k"].flat[0])), r[1])
      outs.append(r)
    assert outs[0] == outs[1], (name, outs)
    assert (stores[0].total_bytes, len(stores[0])) == (stores[1].total_bytes, len(stores[1]))
    return outs[0]

  assert both("put", "ctx", toks[0], data(1.0), 32) == one
  assert both("put", "ctx", toks[1], data(2.0), 32) == one
  assert both("match", "ctx", np.arange(80, dtype=np.int64), 79)[1] == 64
  assert both("match", "other", np.arange(80, dtype=np.int64), 79) == (None, 0)
  probe = np.arange(80, dtype=np.int64)
  probe[10] = 999
  assert both("match", "ctx", probe, 79)[1] == 10
  both("put", "ctx", toks[2], data(3.0), 32)  # evicts toks[1], the oldest after the match
  assert evicted[0] == evicted[1] == [(1, one)]
  assert both("match", "ctx", toks[1], 63) == (None, 0)
  both("put", "ctx", toks[0], data(9.0), 32)  # replace in place
  both("drop", "ctx", toks[2])
  assert both("drop_ctx", "ctx") == 1
  assert both("put", "ctx", toks[0], {"k": np.zeros((1 << 20,), np.float32)}, 32) == 0
  for length, d in ((32, data(1.5)), (7, {"k": np.arange(6, dtype=np.int8).reshape(2, 3)})):
    assert kv_offload.entry_digest(toks[0], length, d) == j_kv_offload.entry_digest(toks[0], length, d)
  for n in (0, 5, 64, 80):
    assert (kv_offload.common_prefix_len(toks[0], probe, n)
            == j_kv_offload.common_prefix_len(toks[0], probe, n))


def test_scatter_pages_and_host_copies_match_jax():
  """scatter_pages writes a canonical host entry into the given pages as JAX's does
  (every other page untouched), and to_host / from_host round a bf16 leaf's bits
  through numpy's uint16."""
  card = get_model_card(MODEL)["synthetic_config"]
  cfg, jcfg = config_from_hf_dict(card), j_config_from_hf_dict(j_get_model_card(MODEL)["synthetic_config"])
  rng = np.random.default_rng(3)
  pool = paged_cache.PagePool(cfg, 2, 10, 16, torch.float32)
  jpool = j_paged_cache.PagePool(jcfg, 2, 10, 16, jnp.float32)
  host = {n: rng.standard_normal((2, 1, 40, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
          for n in ("k", "v")}
  ids = [7, 2]  # 40 tokens of host KV; two whole pages are restored
  paged_cache.scatter_pages(pool.arena, host, ids)
  jpool.arena = j_paged_cache.scatter_pages(jpool.arena, host, np.asarray(ids, np.int32))
  for n in ("k", "v"):
    np.testing.assert_array_equal(pool.arena[n].numpy(), np.asarray(jpool.arena[n]))
  back = paged_cache.gather_pages(pool.arena, ids)
  np.testing.assert_array_equal(back["k"].numpy(), host["k"][:, :, :32])
  t = torch.randn(3, 5).to(torch.bfloat16)
  a = paged_cache.to_host(t)
  assert a.dtype == np.uint16
  assert torch.equal(paged_cache.from_host(a, torch.bfloat16, "cpu"), t)
  assert torch.equal(paged_cache.from_host(a, torch.float32, "cpu"), t.float())


# ----------------------------------------------- OOM recovery: spill, then drop


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_oom_spill_restores_warm_prefix_as_jax(paged, jax_weights, monkeypatch):
  """A forced _free_device_memory spills the warm prefix and drops everything else on
  both engines; the next prompt sharing it restores it and streams the cold stream,
  with the host tier's hits and bytes and the reuse counts equal to the JAX engine's;
  the dropped request raises RequestStateLost."""
  want_b = await _cold_b(monkeypatch)
  _set(monkeypatch, XOT_PAGED_KV=paged)
  got = {}
  for name, eng, shard in (("jax", JAXShardInferenceEngine(dtype="float32"), JSHARD),
                           ("port", _port(), SHARD)):
    await _generate(eng, shard, "ra", PROMPT_A)
    eng._free_device_memory()
    ctx = eng._ctx if name == "port" else eng._contexts[shard]
    assert not ctx.prefix_cache and ctx.page_pool is None and not ctx.states
    assert len(eng._host_kv) == 1 and eng._oom_count == 1 and eng._prefix_evictions == 1
    entry, common = eng._host_kv.match(shard, PROMPT_B.reshape(-1), PROMPT_B.shape[1] - 1)
    assert common == 44 and entry.length == (32 if paged == "1" else 44)
    assert await _generate(eng, shard, "rb", PROMPT_B) == want_b
    assert eng._host_fetch_bytes == entry.nbytes
    got[name] = _host_counts(eng)
    with pytest.raises(Exception, match="dropped by OOM recovery|evicted"):
      await eng.generate_chunk("ra", shard, 1, 4, temp=0.0)
    if name == "port":
      with pytest.raises(RequestStateLost):
        await eng.infer_sample_tensor("ra", shard, PROMPT_A, temp=0.0)
      if paged == "1":
        pool = ctx.page_pool
        restored = next(e for _, e in ctx.prefix_cache.values() if e["len"] == 32)
        assert ctx.states["rb"].pages.blocks[:2] == restored["pages"]
        # The restored entry, rb's table and rb's own entry hold the head pages.
        assert [pool.refcount(p) for p in restored["pages"]] == [3, 3]
        assert eng._commit_copy_bytes == 0
    eng.executor.shutdown(wait=True)
  assert got["port"] == got["jax"]


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_spill_and_restore_are_byte_equal(paged, monkeypatch):
  """What a spill copies out is what a restore puts back: the restored entry's KV (its
  pages, or its snapshot) is bit for bit the evicted one's over the covered tokens."""
  _set(monkeypatch, XOT_PAGED_KV=paged)
  eng = _port()
  await _generate(eng, SHARD, "ra", PROMPT_A)
  ctx = eng._ctx
  (toks, entry), = ctx.prefix_cache.values()
  if paged == "1":
    before = paged_cache.gather_pages(ctx.page_pool.arena, entry["pages"])
  else:
    before = {n: t.clone() for n, t in entry.items()}
  eng._free_device_memory()
  with torch.inference_mode():
    eng._host_promote(ctx, PROMPT_B.reshape(-1))
  (_, restored), = ctx.prefix_cache.values()
  after = (paged_cache.gather_pages(ctx.page_pool.arena, restored["pages"]) if paged == "1"
           else restored)
  for name in ("k", "v"):
    n = before[name].shape[2]
    assert torch.equal(after[name][:, :, :n], before[name])
  assert eng._host_kv_hits == 1 and eng._host_restore_fallbacks == 0
  eng.executor.shutdown(wait=True)


@pytest.mark.parametrize("spill_paged", ["0", "1"], ids=["contiguous-to-paged", "paged-to-contiguous"])
async def test_cross_layout_restore(spill_paged, monkeypatch):
  """The canonical host layout composes across cache layouts: an entry spilled by a
  contiguous engine restores into a paged engine's fresh pages and the reverse (cut
  to the whole pages the paged spill covered), both streaming the cold stream."""
  want_b = await _cold_b(monkeypatch)
  _set(monkeypatch, XOT_PAGED_KV=spill_paged)
  spiller = _port()
  await _generate(spiller, SHARD, "ra", PROMPT_A)
  spiller._free_device_memory()
  _set(monkeypatch, XOT_PAGED_KV=1 - int(spill_paged))
  eng = _port()
  eng._host_kv = spiller._host_kv  # one host tier, the same shard's namespace
  assert await _generate(eng, SHARD, "rb", PROMPT_B) == want_b
  assert eng._host_kv_hits == 1 and eng._prefix_tokens_saved == 32
  assert (eng._ctx.states["rb"].pages is not None) == (spill_paged == "0")
  for e in (spiller, eng):
    e.executor.shutdown(wait=True)


# ------------------------------------------------------------ degrade paths


async def test_restore_racing_pool_pressure_falls_back_cold(monkeypatch):
  """A restore that gets no pool pages prefills cold (the same tokens, no error), keeps
  its entry for later, and is counted."""
  want_b = await _cold_b(monkeypatch)
  _set(monkeypatch, XOT_PAGED_KV=1)
  eng = _port()
  await _generate(eng, SHARD, "ra", PROMPT_A)
  eng._free_device_memory()
  real = eng._pool_alloc
  blown = []

  def failing(ctx, pool, n):
    if not blown:  # the restore's allocation only
      blown.append(n)
      raise CacheExhausted("pool exhausted (injected during the restore)")
    return real(ctx, pool, n)
  monkeypatch.setattr(eng, "_pool_alloc", failing)
  assert await _generate(eng, SHARD, "rb", PROMPT_B) == want_b
  assert blown == [2]
  assert eng._host_kv_hits == 0 and eng._prefix_hits == 0
  assert len(eng._host_kv) == 1 and eng._host_restore_fallbacks == 1
  eng.executor.shutdown(wait=True)


@pytest.mark.parametrize("fault", ["torn", "int8-config"])
async def test_unusable_host_entry_is_dropped_and_prefills_cold(fault, monkeypatch):
  """A torn entry (its token axis cut short) and one spilled under another cache
  config (an int8 KV engine's, with scales) are dropped at restore time: the request
  prefills cold with the cold tokens, the tier never offers the entry again, and the
  fallback is counted."""
  want_b = await _cold_b(monkeypatch)
  _set(monkeypatch, XOT_PAGED_KV=1)
  if fault == "int8-config":
    _set(monkeypatch, XOT_KV_QUANT="int8")
  spiller = _port()
  await _generate(spiller, SHARD, "ra", PROMPT_A)
  spiller._free_device_memory()
  ((_, entry),) = list(spiller._host_kv._entries.items())
  if fault == "torn":
    entry.data = {name: arr[:, :, :8] for name, arr in entry.data.items()}
  else:
    assert set(entry.data) == {"k", "v", "k_scale", "v_scale"}
    monkeypatch.delenv("XOT_KV_QUANT")
  eng = _port()
  eng._host_kv = spiller._host_kv
  assert await _generate(eng, SHARD, "rb", PROMPT_B) == want_b
  assert eng._host_kv_hits == 0 and len(eng._host_kv) == 0
  assert eng._host_restore_fallbacks == 1
  for e in (spiller, eng):
    e.executor.shutdown(wait=True)


async def test_weight_change_drops_the_context_host_entries(monkeypatch):
  """_clear_prefix_cache (new weights) drops the context's host entries unspilled."""
  eng = _port()
  await _generate(eng, SHARD, "ra", PROMPT_A)
  eng._free_device_memory()
  assert len(eng._host_kv) == 1
  eng._clear_prefix_cache(eng._ctx)
  assert len(eng._host_kv) == 0
  eng.executor.shutdown(wait=True)


async def test_zero_budget_turns_the_tier_off(monkeypatch):
  """XOT_KV_HOST_BYTES=0: evictions destroy entries, no store is made, nothing is
  spilled or restored, and the next request prefills cold."""
  want_b = await _cold_b(monkeypatch)
  _set(monkeypatch, XOT_PAGED_KV=1, XOT_KV_HOST_BYTES=0)
  eng = _port()
  await _generate(eng, SHARD, "ra", PROMPT_A)
  eng._free_device_memory()
  assert eng._host_kv is None and eng._host_spill_bytes == 0 and eng.host_kv_stats() is None
  assert await _generate(eng, SHARD, "rb", PROMPT_B) == want_b
  assert eng._host_kv_hits == 0 and eng._prefix_hits == 0
  eng.executor.shutdown(wait=True)


# ------------------------------------------------- an OOM inside a serving call


async def test_device_oom_in_a_serving_call_recovers(monkeypatch):
  """torch.OutOfMemoryError out of a prefill is caught by _run: recovery spills the warm
  prefix, drops every state and the graphs, records engine.oom_recovery and freezes the
  flight recorder; the request gets CacheExhausted (the API's answer for a prompt the
  KV budget cannot hold), the dropped request RequestStateLost, and the next request a
  host-warm prefill. A load that runs out of memory raises RuntimeError instead."""
  want_b = await _cold_b(monkeypatch)
  eng = _port()
  eng.flight = FlightRecorder(node_id="n", capacity=256)
  await _generate(eng, SHARD, "ra", PROMPT_A)
  real = engine_mod.forward_sample
  fired = []

  def oom_once(*a, **kw):
    if not fired:
      fired.append(1)
      raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    return real(*a, **kw)
  monkeypatch.setattr(engine_mod, "forward_sample", oom_once)
  with pytest.raises(CacheExhausted, match="device memory exhausted.*1 prefix snapshots "
                                           r"\(1 spilled to host tier\), 2 request states"):
    await eng.infer_sample_tensor("big", SHARD, np.arange(3, 200)[None, :], temp=0.0, top_k=0)
  assert eng._oom_count == 1 and not eng._ctx.states and len(eng._host_kv) == 1
  with pytest.raises(RequestStateLost):
    await eng.generate_chunk("ra", SHARD, 1, 4, temp=0.0, top_k=0)
  assert await _generate(eng, SHARD, "rb", PROMPT_B) == want_b
  assert eng._host_kv_hits == 1
  events = [e["event"] for e in eng.flight.tail()]
  assert events.count("engine.oom_recovery") == 1 and eng.flight.snapshots()[0]["reason"] == "oom_recovery:1"

  def load_oom(*a, **kw):
    raise torch.OutOfMemoryError("CUDA out of memory")
  fresh = _port()
  monkeypatch.setattr(fresh, "_load_shard", load_oom)
  with pytest.raises(RuntimeError, match="device memory exhausted"):
    await fresh.ensure_shard(SHARD)
  for e in (eng, fresh):
    e.executor.shutdown(wait=True)


# ------------------------------------------------------------------ prefetch


class _Tokenizer:
  eos_token_id = 2

  def encode(self, prompt):
    return {"queued prompt b": PROMPT_B, "unrelated": np.full(5, 7)}[prompt].reshape(-1)

  def decode(self, ids):
    return " ".join(str(i) for i in ids)


async def test_prefetch_host_prefix_restores_before_the_request(jax_weights, monkeypatch):
  """prefetch_host_prefix on a queued prompt restores its spilled prefix before the
  request runs (as the JAX engine's does), so the request pays no further fetch; a miss
  and a shard that is not loaded are no-ops (a prefetch never loads a model)."""
  want_b = await _cold_b(monkeypatch)
  _set(monkeypatch, XOT_PAGED_KV=1)
  got = {}
  for name, eng, shard in (("jax", JAXShardInferenceEngine(dtype="float32"), JSHARD),
                           ("port", _port(), SHARD)):
    await _generate(eng, shard, "ra", PROMPT_A)
    eng._free_device_memory()
    ctx = eng._ctx if name == "port" else eng._contexts[shard]
    ctx.tokenizer = _Tokenizer()
    assert await eng.prefetch_host_prefix(shard, "queued prompt b") is True
    fetched = eng._host_fetch_bytes
    assert eng._host_kv_hits == 1 and len(ctx.prefix_cache) == 1
    assert await _generate(eng, shard, "rb", PROMPT_B) == want_b
    assert eng._host_fetch_bytes == fetched
    assert await eng.prefetch_host_prefix(shard, "unrelated") is False
    other = type(shard)(MODEL, 0, 1, 4)
    assert await eng.prefetch_host_prefix(other, "queued prompt b") is False
    got[name] = _host_counts(eng)
    eng.executor.shutdown(wait=True)
  assert got["port"] == got["jax"]


def _http(url, body):
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  try:
    with urllib.request.urlopen(req, timeout=120) as r:
      return r.status, json.loads(r.read())
  except urllib.error.HTTPError as e:
    return e.code, json.loads(e.read())


async def test_prefetch_route_and_admission_prefetch(monkeypatch):
  """POST /v1/prefetch answers 202 and restores the announced prompt's spilled prefix
  (its bad bodies 400, with the JAX handler's messages); a request that waits in the
  admission gate's queue has its prefix restored from the host tier before it is
  admitted, and then pays no fetch of its own."""
  _set(monkeypatch, XOT_PAGED_KV=1, XOT_MAX_INFLIGHT=1, XOT_ADMIT_QUEUE_DEPTH=4)
  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-model", MODEL, "--chatgpt-api-host", "127.0.0.1",
     "--chatgpt-api-port", "0", "--default-temp", "0", "--max-generate-tokens", "4"])
  node, eng, _, api = port_main.build_node(args)
  server = await api.start("127.0.0.1", 0)
  base = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"
  loop = asyncio.get_running_loop()
  call = lambda *a: loop.run_in_executor(None, _http, *a)  # noqa: E731
  words = lambda n, off=0: " ".join(f"w{(i + off) % 50}" for i in range(n))  # noqa: E731

  def body(text):
    return {"model": MODEL, "max_tokens": 4, "messages": [{"role": "user", "content": text}]}
  try:
    status, _ = await call(base + "/v1/chat/completions", body(words(60)))
    assert status == 200
    await eng._run(eng._free_device_memory)
    assert len(eng._host_kv) == 1
    for bad, message in (([1], "body must be a JSON object"), ({"model": MODEL},
                         "a non-empty `prompt` or `messages` list is required"),
                         ({"model": MODEL, "messages": "x"}, "messages must be a list of objects")):
      status, reply = await call(base + "/v1/prefetch", bad)
      assert status == 400 and reply["error"]["message"] == message
    status, reply = await call(base + "/v1/prefetch", body(words(60) + " and more"))
    assert status == 202 and reply == {"accepted": True, "model": MODEL}
    for _ in range(100):
      if eng._host_kv_hits:
        break
      await asyncio.sleep(0.02)
    assert eng._host_kv_hits == 1
    # The admission gate: one request holds the slot, the next queues and is prefetched.
    await eng._run(eng._free_device_memory)
    before = eng._host_fetch_bytes
    gate = node.admission
    held = asyncio.ensure_future(call(base + "/v1/chat/completions", body(words(30, off=7))))
    while gate.inflight < 1:
      await asyncio.sleep(0.005)
    fetch_at_admission = []
    real_acquire = gate.acquire

    async def noting(rid, on_queued=None):
      ok = await real_acquire(rid, on_queued=on_queued)
      fetch_at_admission.append(eng._host_fetch_bytes)
      return ok
    gate.acquire = noting
    queued = await call(base + "/v1/chat/completions", body(words(60) + " again"))
    assert (await held)[0] == 200 and queued[0] == 200
    assert eng._host_kv_hits == 2 and fetch_at_admission[0] > before
    assert eng._host_fetch_bytes == fetch_at_admission[0]
  finally:
    server.close()
    await node.stop()
    eng.executor.shutdown(wait=True)
