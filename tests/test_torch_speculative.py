"""Speculative decoding on the port (verify_draft, paged-native verify, the draft model,
the Node's prompt lookup) against the JAX package, on the CPU.

The twins of tests/test_speculative.py and of tests/test_paged_spec.py's engine and
Node tests: both packages serve the same transformers-written tiny llama in fp32. A
perfect draft is accepted whole with its bonus token, a wrong tail yields the agreeing
prefix and the model's own token, a wrong draft the bonus alone, and every stream is
sequential greedy decode's, token for token, on the JAX engine's and Node's as on the
port's (contiguous, paged-native at page 16, and XOT_PAGED_SPEC=0's gather). The paged
verify keeps the request on the arena (no gather, no commit copy) and gives the pages a
rejected tail took back to the pool. The draft model (the target itself: the perfect
drafter) proposes the greedy continuation, feeds only the suffix it has not seen, and
stands down under concurrency.
"""
import asyncio

import jax
import numpy as np
import pytest
import torch

from tests.test_model_equivalence import TINY_LLAMA_CFG, make_hf_checkpoint
from tests.test_speculative import _NoDiscovery, _NullServer
from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.orchestration.node import Node as JNode
from xotorch_tpu.orchestration.node import _lookup_draft as j_lookup_draft
from xotorch_tpu.topology.device_capabilities import DeviceCapabilities as JCaps
from xotorch_tpu.topology.device_capabilities import DeviceFlops as JFlops
from xotorch_tpu.topology.partitioning import RingMemoryWeightedPartitioningStrategy as JStrategy
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import registry
from xotorch_tpu_torch.orchestration.node import Node, _lookup_draft
from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy

torch.set_num_threads(2)

N = TINY_LLAMA_CFG["num_hidden_layers"]
FULL, JFULL = Shard("m", 0, N - 1, N), JShard("m", 0, N - 1, N)
PROMPT = np.array([[1, 5, 9, 200, 17, 3, 42]], dtype=np.int64)
# 15 tokens: at page 16 the prompt leaves the request mid-page, so the first verify
# crosses a page boundary and takes a fresh page.
PAGED_PROMPT = np.array([[1, 5, 9, 200, 17, 3, 42, 8, 77, 12, 140, 6, 31, 99, 4]], dtype=np.int64)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_SEED", "7")
  with jax.default_matmul_precision("highest"):
    yield


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
  return make_hf_checkpoint(tmp_path_factory.mktemp("spec"), TINY_LLAMA_CFG, seed=3)


def _paged_env(monkeypatch, **extra):
  for name, value in (("XOT_CACHE_LEN", "16"), ("XOT_KV_PAGE", "16"),
                      ("XOT_KV_POOL_TOKENS", "512"), *extra.items()):
    monkeypatch.setenv(name, str(value))


def _port(model_dir):
  return TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu", seed=0)


def _jax(model_dir):
  return JAXShardInferenceEngine(JLocalShardDownloader({"m": model_dir}), dtype="float32")


def _shard(eng):
  return FULL if isinstance(eng, TorchShardInferenceEngine) else JFULL


def _shutdown(*engines):
  for e in engines:
    e.executor.shutdown(wait=True)


async def _greedy(eng, rid, prompt, n):
  """Sequential one-token greedy decode: the stream every speculative run must give."""
  tok, _ = await eng.infer_sample_tensor(rid, _shard(eng), prompt, temp=0.0, top_k=0)
  seq = [int(tok)]
  for _ in range(n - 1):
    tok, _ = await eng.infer_sample_tensor(rid, _shard(eng), np.asarray([[seq[-1]]]), temp=0.0,
                                           top_k=0)
    seq.append(int(tok))
  return seq


def test_lookup_draft():
  """The port's prompt lookup drafts what JAX's does."""
  ctx = [1, 2, 7, 8, 9, 4, 5, 6, 0, 7, 8, 9]
  cases = [(ctx, 4, [4, 5, 6, 0]), ([3, 3, 3, 3, 3, 3], 3, [3, 3, 3]),
           ([1, 2, 3, 4, 5, 6, 7, 8], 4, []), ([1, 2], 4, []), (ctx, 1, [])]
  for context, k, want in cases:
    assert _lookup_draft(context, k) == j_lookup_draft(context, k) == want
  rng = np.random.default_rng(0)
  for _ in range(50):
    context = [int(t) for t in rng.integers(0, 6, size=int(rng.integers(4, 40)))]
    assert _lookup_draft(context, 5) == j_lookup_draft(context, 5)
  assert _lookup_draft(ctx, 4, window=3) == []


async def _verify_rounds(eng, prompt, ref):
  """test_speculative.py's three rounds: a perfect draft, a wrong tail, a wrong draft."""
  tok, _ = await eng.infer_sample_tensor("spec", _shard(eng), prompt, temp=0.0, top_k=0)
  got = [int(tok)]
  out = [await eng.verify_draft("spec", _shard(eng), got[-1], ref[1:4])]
  got.extend(out[-1])
  out.append(await eng.verify_draft("spec", _shard(eng), got[-1],
                                    [ref[5], (ref[6] + 1) % 250, (ref[6] + 2) % 250]))
  got.extend(out[-1])
  out.append(await eng.verify_draft("spec", _shard(eng), got[-1], [(ref[7] + 9) % 250, 1, 2]))
  got.extend(out[-1])
  return [list(o) for o in out], got


async def test_verify_draft_matches_sequential_greedy(model_dir):
  """Contiguous verify: the perfect draft yields ref[1:5], the wrong tail two tokens, the
  wrong draft the bonus alone; the port's rounds are the JAX engine's."""
  ref = await _greedy(_port(model_dir), "ref", PROMPT, 8)
  assert ref == await _greedy(_jax(model_dir), "ref", PROMPT, 8)
  port, jeng = _port(model_dir), _jax(model_dir)
  out, got = await _verify_rounds(port, PROMPT, ref)
  jout, _ = await _verify_rounds(jeng, PROMPT, ref)
  assert out == jout == [ref[1:5], ref[5:7], [ref[7]]]
  assert got == ref
  assert (port._spec_proposed, port._spec_accepted) == (jeng._spec_proposed, jeng._spec_accepted)
  assert port.spec_stats() is not None and 0.0 <= port.spec_stats()["accept_rate"] <= 1.0
  report = port.perf_report()["speculation"]
  assert report["proposed"] == 9 and report["accepted"] == 4
  _shutdown(port, jeng)


async def _paged_rounds(eng, ref):
  tok, _ = await eng.infer_sample_tensor("spec", _shard(eng), PAGED_PROMPT, temp=0.0, top_k=0)
  got = [int(tok)]
  for draft in (ref[1:4], [ref[5], (ref[6] + 1) % 250, (ref[6] + 2) % 250],
                [(ref[7] + 9) % 250, 1, 2]):
    got.extend(await eng.verify_draft("spec", _shard(eng), got[-1], draft))
  return got


@pytest.mark.parametrize("kernel", ["0", "1"], ids=["jax_gather", "jax_pallas"])
async def test_paged_verify_matches_contiguous(model_dir, monkeypatch, kernel):
  """Paged-native verify (the JAX side through its gather read and through its Pallas
  kernel in interpret mode): the rounds give sequential greedy's stream, the request
  stays page-backed with pages_for(pos) pages, and nothing is gathered or copied."""
  ref = await _greedy(_port(model_dir), "ref", PAGED_PROMPT, 8)
  _paged_env(monkeypatch, XOT_PAGED_KV="1")
  port = _port(model_dir)
  # JAX's engine reads XOT_PAGED_KERNEL at each call; the port's, built first, reads it
  # when it is built and refuses 0 (its paged path is always K3/K4).
  monkeypatch.setenv("XOT_PAGED_KERNEL", kernel)
  jeng = _jax(model_dir)
  got = await _paged_rounds(port, ref)
  assert got == await _paged_rounds(jeng, ref) == ref
  ctx = port._contexts[FULL]
  state, pool = ctx.states["spec"], ctx.page_pool
  assert state.cache is None and len(state.pages) == pool.pages_for(state.pos)
  assert port._unpage_calls == 0 and port._commit_copy_bytes == 0
  assert (port._spec_proposed, port._spec_accepted) == (9, 4)
  assert list(state.pages) == list(jeng._contexts[JFULL].states["spec"].pages)
  _shutdown(port, jeng)


async def test_paged_verify_page_boundary_and_rollback_decref(model_dir, monkeypatch):
  """A draft crossing a page boundary takes its fresh pages before any device work; the
  accepted prefix keeps pages_for(pos) and the rest go back to the free list, as on
  JAX; a decode chunk after the rollback stays greedy."""
  ref = await _greedy(_port(model_dir), "ref", PAGED_PROMPT, 8)
  _paged_env(monkeypatch, XOT_PAGED_KV="1")
  port, jeng = _port(model_dir), _jax(model_dir)
  seen = []
  for eng in (port, jeng):
    tok, _ = await eng.infer_sample_tensor("r", _shard(eng), PAGED_PROMPT, temp=0.0, top_k=0)
    ctx = eng._contexts[_shard(eng)]
    state, pool = ctx.states["r"], ctx.page_pool
    assert state.pos == 15 and len(state.pages) == 1
    free0 = pool.free_pages
    accepted = await eng.verify_draft("r", _shard(eng), int(tok), ref[1:4])
    assert list(accepted) == ref[1:5]
    assert state.pos == 19 and len(state.pages) == 2 and pool.free_pages == free0 - 1
    assert pool.refcount(state.pages[-1]) == 1
    accepted = await eng.verify_draft("r", _shard(eng), accepted[-1], [251, 252, 253])
    assert list(accepted) == [ref[5]]
    assert state.pos == 20 and len(state.pages) == 2 and pool.free_pages == free0 - 1
    got = ref[:6] + [int(t) for t in await eng.generate_chunk("r", _shard(eng), ref[5], 2, temp=0.0)]
    assert got == ref[:8]
    seen.append(list(state.pages))
  assert seen[0] == seen[1]
  assert port._unpage_calls == 0 and port._commit_copy_bytes == 0
  _shutdown(port, jeng)


async def test_paged_verify_pool_exhaustion_falls_back_to_plain_decode(model_dir, monkeypatch):
  """A pool that cannot give the verify bucket's fresh pages: verify returns None with
  the request's pages and position untouched, and plain decode goes on once the
  pressure clears."""
  _paged_env(monkeypatch, XOT_PAGED_KV="1", XOT_KV_POOL_TOKENS="64")
  port = _port(model_dir)
  tok, _ = await port.infer_sample_tensor("r", FULL, PAGED_PROMPT, temp=0.0, top_k=0)
  ctx = port._contexts[FULL]
  state, pool = ctx.states["r"], ctx.page_pool
  hold = pool.alloc(pool.free_pages)
  pages_before = list(state.pages)
  assert await port.verify_draft("r", FULL, int(tok), [1, 2, 3]) is None
  assert list(state.pages) == pages_before and state.pos == 15
  pool.decref(hold)
  assert len(await port.generate_chunk("r", FULL, int(tok), 2, temp=0.0)) == 2
  _shutdown(port)


def _caps(node):
  node.device_capabilities = JCaps("t", "c", 1024, JFlops(1, 2, 4))
  node.topology.update_node(node.id, node.device_capabilities)
  return node


async def _node_stream(eng, prompt, rid, max_tokens=24, others=()):
  """One request (and `others`, concurrently) through a Node's fused loop; returns each
  request's tokens. A JAX engine gets the JAX Node."""
  kw = dict(max_generate_tokens=max_tokens, default_sample_temp=0.0, decode_chunk_size=4)
  if isinstance(eng, TorchShardInferenceEngine):
    node = Node(f"n-{rid}", None, eng, None, RingMemoryWeightedPartitioningStrategy(), **kw)
    shard = Shard("m", 0, N - 1, N)
  else:
    node = _caps(JNode(f"n-{rid}", _NullServer(), eng, _NoDiscovery(), None, JStrategy(), **kw))
    shard = JShard("m", 0, N - 1, N)
  jobs = [(rid, prompt), *others]
  done = {r: asyncio.Event() for r, _ in jobs}
  out = {}

  def on_token(request_id, tokens, is_finished):
    out[request_id] = list(tokens)
    if is_finished and request_id in done:
      done[request_id].set()
  node.on_token.register("t").on_next(on_token)
  await asyncio.gather(*(node.process_prompt(shard, p, r) for r, p in jobs))
  await asyncio.wait_for(asyncio.gather(*(e.wait() for e in done.values())), timeout=120)
  if isinstance(node, Node):
    await node.stop()
  return out, node


async def test_node_speculative_stream_identical(model_dir, monkeypatch):
  """A repetitive prompt through the Nodes: with XOT_SPECULATE=6 the port streams what
  it streams without speculation and what the JAX Node streams with it, and the lookup
  really fired on both."""
  prompt = "a b c a b c a b c"
  want, _ = await _node_stream(_port(model_dir), prompt, "r")
  monkeypatch.setenv("XOT_SPECULATE", "6")
  port, jeng = _port(model_dir), _jax(model_dir)
  got, _ = await _node_stream(port, prompt, "r")
  jgot, _ = await _node_stream(jeng, prompt, "r")
  assert got == want == jgot
  assert port._spec_proposed > 0 and jeng._spec_proposed > 0
  assert (port._spec_proposed, port._spec_accepted) == (jeng._spec_proposed, jeng._spec_accepted)
  _shutdown(port, jeng)


def _register_card(monkeypatch):
  """A registry card for the local checkpoint, so that build_full_shard can address it
  as a draft model."""
  monkeypatch.setitem(registry.model_cards, "m",
                      {"layers": N, "repo": {"TorchShardInferenceEngine": "local"}})


async def test_draft_tokens_match_sequential_greedy(model_dir, monkeypatch):
  """The target as its own draft model proposes the sequential greedy continuation, also
  on a later round that feeds only the unseen suffix; clear_request drops the draft
  state (rid#draft) as well."""
  _register_card(monkeypatch)
  monkeypatch.setenv("XOT_DRAFT_MODEL", "m")
  ctx_tokens = [1, 5, 9, 200, 17, 3, 42]
  ref = await _greedy(_port(model_dir), "ref", np.asarray([ctx_tokens]), 6)
  eng = _port(model_dir)
  assert await eng.draft_tokens("r", ctx_tokens, 4) == ref[:4]
  assert await eng.draft_tokens("r", ctx_tokens + ref[:2], 4) == ref[2:6]
  assert eng._contexts[FULL].states["r#draft"].pos == len(ctx_tokens) + 2
  await eng.clear_request("r")
  for ctx in eng._contexts.values():
    assert "r#draft" not in ctx.states and "r" not in ctx.states
  _shutdown(eng)


async def test_draft_tokens_disabled_paths(model_dir, monkeypatch):
  """No draft model, an unknown one, or k < 2: [] (the caller falls back), never a
  raise; a model that fails to load pauses drafting for XOT_DRAFT_RETRY_S."""
  monkeypatch.delenv("XOT_DRAFT_MODEL", raising=False)
  assert await _port(model_dir).draft_tokens("r", [1, 2, 3], 4) == []
  monkeypatch.setenv("XOT_DRAFT_MODEL", "no-such-model")
  assert await _port(model_dir).draft_tokens("r", [1, 2, 3], 4) == []
  _register_card(monkeypatch)
  monkeypatch.setenv("XOT_DRAFT_MODEL", "m")
  assert await _port(model_dir).draft_tokens("r", [1, 2, 3], 1) == []
  broken = TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir / "missing"}),
                                     device="cpu", seed=0)
  assert await broken.draft_tokens("r", [1, 2, 3], 4) == []
  assert broken._draft_retry_at > 0


async def test_node_draft_model_stream_identical(model_dir, monkeypatch):
  """A non-repeating prompt with the target as its draft model: the stream is the
  no-speculation stream (and the JAX Node's with the same draft), and drafts were
  accepted: every round takes the whole draft and its bonus."""
  prompt = "one two three four five"
  want, _ = await _node_stream(_port(model_dir), prompt, "r", max_tokens=20)
  _register_card(monkeypatch)
  from xotorch_tpu.models import registry as jregistry
  monkeypatch.setitem(jregistry.model_cards, "m",
                      {"layers": N, "repo": {"JAXShardInferenceEngine": "local"}})
  monkeypatch.setenv("XOT_DRAFT_MODEL", "m")
  port, jeng = _port(model_dir), _jax(model_dir)
  got, _ = await _node_stream(port, prompt, "r", max_tokens=20)
  jgot, _ = await _node_stream(jeng, prompt, "r", max_tokens=20)
  assert got == want == jgot
  assert port._spec_accepted > 0 and port._spec_accepted == port._spec_proposed
  assert (port._spec_proposed, port._spec_accepted) == (jeng._spec_proposed, jeng._spec_accepted)
  _shutdown(port, jeng)


async def test_draft_model_stands_down_under_concurrency(model_dir, monkeypatch):
  """Two requests at once: no draft call is made while both are outstanding, and each
  stream equals its solo run without speculation."""
  solo = {}
  for rid, prompt in (("ra", "one two three"), ("rb", "four five six seven")):
    solo.update((await _node_stream(_port(model_dir), prompt, rid, max_tokens=12))[0])
  _register_card(monkeypatch)
  monkeypatch.setenv("XOT_DRAFT_MODEL", "m")
  eng = _port(model_dir)
  calls = []
  real = eng.draft_tokens
  holder = {}

  async def spy(rid, ctx_tokens, k):
    calls.append((rid, len(holder["node"].outstanding_requests)))
    return await real(rid, ctx_tokens, k)
  eng.draft_tokens = spy
  orig_init = Node.__init__

  def init(self, *a, **kw):
    orig_init(self, *a, **kw)
    holder["node"] = self
  monkeypatch.setattr(Node, "__init__", init)
  got, _ = await _node_stream(eng, "one two three", "ra", max_tokens=12,
                              others=[("rb", "four five six seven")])
  assert all(n_out <= 1 for _, n_out in calls), calls
  assert got == solo
  _shutdown(eng)


@pytest.mark.parametrize("kernel", ["0", "1"], ids=["jax_gather", "jax_pallas"])
async def test_node_paged_spec_stream_identical(model_dir, monkeypatch, kernel):
  """Paged speculative decode through the Node streams what contiguous speculative and
  paged plain decode stream (and the JAX Node's paged speculation), with no gather and
  no commit copy."""
  _paged_env(monkeypatch, XOT_PAGED_KV="0")
  prompt = "a b c a b c a b c"
  plain, _ = await _node_stream(_port(model_dir), prompt, "r")
  monkeypatch.setenv("XOT_SPECULATE", "6")
  contig = _port(model_dir)
  assert (await _node_stream(contig, prompt, "r"))[0] == plain and contig._spec_proposed > 0
  _paged_env(monkeypatch, XOT_PAGED_KV="1")
  paged = _port(model_dir)
  monkeypatch.setenv("XOT_PAGED_KERNEL", kernel)  # JAX's only: read at each JAX call
  jpaged = _jax(model_dir)
  got, _ = await _node_stream(paged, prompt, "r")
  jgot, _ = await _node_stream(jpaged, prompt, "r")
  assert got == plain == jgot
  assert paged._spec_proposed > 0 and paged._unpage_calls == 0 and paged._commit_copy_bytes == 0
  stats = paged.spec_stats()
  assert stats is not None and 0.0 <= stats["accept_rate"] <= 1.0
  _shutdown(contig, paged, jpaged)


async def test_paged_spec_off_restores_unpage_fallback(model_dir, monkeypatch):
  """XOT_PAGED_SPEC=0: a paged request is gathered back to a contiguous cache for its
  verify (xot_kv_unpage_total moves) and committed again at its next chunk; the stream
  is still contiguous speculation's, and the JAX engine's under the same knob."""
  _paged_env(monkeypatch, XOT_PAGED_KV="0", XOT_SPECULATE="6")
  prompt = "a b c a b c a b c"
  want, _ = await _node_stream(_port(model_dir), prompt, "r")
  _paged_env(monkeypatch, XOT_PAGED_KV="1", XOT_PAGED_SPEC="0")
  port, jeng = _port(model_dir), _jax(model_dir)
  got, _ = await _node_stream(port, prompt, "r")
  jgot, _ = await _node_stream(jeng, prompt, "r")
  assert got == want == jgot
  assert port._spec_proposed > 0 and port._unpage_calls > 0
  assert port._unpage_calls == jeng._unpage_calls
  _shutdown(port, jeng)
