"""The fused in-process ring of the port (models/generate.decode_chunk_ring,
forward_argmax_ring, decode_chunk_ring_batched; models/graphs.decode_ring / verify_ring;
the engine's generate_chunk_ring, verify_draft_ring and ring batcher; the Node's
_ring_fused_gen, _inprocess_chain and PROMPT_TOKENS_KEY) against the JAX package, on
the CPU.

The twins of tests/test_ring_fused.py: two or three Nodes in one process joined by
InProcessPeerHandles serve a transformers-written tiny llama (gemma-2 in one case) in
fp32; the fused ring's greedy stream equals a solo Node's and JAX's fused ring's, token
for token, and the decode makes no per-token hop. Below the Nodes, the functions are
held against JAX's: tokens exactly (greedy, or JAX's Gumbel noise injected), caches
within 1e-4 (fp32 sums in another order than XLA's). `EagerGraphCache` plays the card's
graph cache eagerly, so the ring's slab, static buffers, pad rows and its invalidation
with a segment's graphs run here too.
"""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model_equivalence import TINY_GEMMA2_CFG, TINY_LLAMA_CFG, make_hf_checkpoint
from tests.test_ring_fused import _generate as j_generate_stream
from tests.test_ring_fused import _ring as j_ring
from tests.test_ring_fused import _solo_tokens as j_solo_tokens
from tests.test_torch_graphs import EagerGraphCache, _jax_noise
from xotorch_tpu.models import generate as j_generate
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models.config import config_from_hf_dict as j_config_from_hf_dict
from xotorch_tpu.models.registry import get_model_card as j_get_model_card
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import generate, graphs, registry, transformer
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.registry import get_model_card
from xotorch_tpu_torch.models.weights import params_from_jax
from xotorch_tpu_torch.networking.inprocess import InProcessPeerHandle
from xotorch_tpu_torch.orchestration.node import Node
from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities, DeviceFlops
from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy

torch.set_num_threads(2)

N_LAYERS = TINY_LLAMA_CFG["num_hidden_layers"]
MODEL = "synthetic-tiny"
K = 6
TOP_K = 20


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_SEED", "7")
  with jax.default_matmul_precision("highest"):
    yield


@pytest.fixture()
def tiny_model_dir(tmp_path):
  return make_hf_checkpoint(tmp_path, TINY_LLAMA_CFG, seed=3)


def _caps():
  return DeviceCapabilities("test", "chip", 1024, DeviceFlops(1, 2, 4))


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


def _node(name, engine, max_tokens, chunk=4):
  node = Node(name, None, engine, None, RingMemoryWeightedPartitioningStrategy(),
              max_generate_tokens=max_tokens, default_sample_temp=0.0, decode_chunk_size=chunk)
  node.device_capabilities = _caps()
  return node


def _ring(model_dir, n_nodes, max_tokens, chunk=4, graph_cache=False):
  """n_nodes port Nodes in one process joined by InProcessPeerHandles."""
  nodes = [_node(f"ring-{i}", _engine(model_dir, graph_cache), max_tokens, chunk)
           for i in range(n_nodes)]
  for node in nodes:
    for other in nodes:
      node.topology.update_node(other.id, _caps())
    node.peers = [InProcessPeerHandle(o) for o in nodes if o is not node]
  return nodes


def _shutdown(nodes):
  for n in nodes:
    n.inference_engine.executor.shutdown(wait=True)


async def _generate(node, prompt_text, request_id, watch=(), n_layers=N_LAYERS, **prompt_kwargs):
  done = asyncio.Event()
  out = {}

  def on_token(rid, tokens, is_finished):
    if rid != request_id:
      return
    out["tokens"] = list(tokens)
    if is_finished:
      done.set()

  for n in (node, *watch):
    n.on_token.register(f"t-{n.id}-{request_id}").on_next(on_token)
  await node.process_prompt(Shard("m", 0, n_layers - 1, n_layers), prompt_text, request_id,
                            **prompt_kwargs)
  await asyncio.wait_for(done.wait(), timeout=120)
  for n in (node, *watch):
    n.on_token.deregister(f"t-{n.id}-{request_id}")
  return out["tokens"]


def _spy_ring_calls(nodes):
  calls = []
  for node in nodes:
    eng = node.inference_engine
    orig = eng.generate_chunk_ring

    def wrapped(*a, _orig=orig, **k):
      calls.append(a[0])
      return _orig(*a, **k)
    eng.generate_chunk_ring = wrapped
  return calls


async def _solo_tokens(model_dir, prompt, max_tokens, n_layers=N_LAYERS):
  solo = _node("solo", _engine(model_dir), max_tokens)
  solo.topology.update_node("solo", _caps())
  try:
    return await _generate(solo, prompt, "req-solo", n_layers=n_layers)
  finally:
    _shutdown([solo])


async def _jax_ring_tokens(model_dir, n_nodes, prompt, max_tokens, n_layers=N_LAYERS):
  nodes = j_ring(model_dir, n_nodes, max_tokens)
  return await j_generate_stream(nodes[0], prompt, "req-jax", watch=nodes[1:], n_layers=n_layers)


# ------------------------------------------------------------------ the functions


def _cfgs():
  return (j_config_from_hf_dict(j_get_model_card(MODEL)["synthetic_config"]),
          config_from_hf_dict(get_model_card(MODEL)["synthetic_config"]))


def _cut(tree, lo, hi, first, last, cfg):
  out = {"layers": {k: v[lo:hi] for k, v in tree["layers"].items()}}
  if first or (last and cfg.tie_word_embeddings):
    out["embed"] = tree["embed"]
  if last:
    out["final_norm"] = tree["final_norm"]
    if "lm_head" in tree:
      out["lm_head"] = tree["lm_head"]
  return out


def _ring_setup(cuts, lens, S=64):
  """JAX's and the port's params of each segment of `cuts` ([(lo, hi)] in ring order),
  and each request's prefilled caches on both sides: (jparams, pparams, jcaches,
  pcaches, last tokens, jcfg, cfg), caches indexed [segment][request]."""
  jcfg, cfg = _cfgs()
  jfull = j_transformer.init_random_params(jcfg, jcfg.num_layers, True, True,
                                           jax.random.PRNGKey(0), dtype=jnp.float32)
  jfull = jax.tree.map(np.asarray, jfull)
  n = len(cuts)
  jsegs = [_cut(jfull, lo, hi, i == 0, i == n - 1, cfg) for i, (lo, hi) in enumerate(cuts)]
  psegs = [params_from_jax(p, cfg) for p in jsegs]
  jsegs = [jax.tree.map(jnp.asarray, p) for p in jsegs]
  rng = np.random.default_rng(3)
  jcaches = [[] for _ in cuts]
  pcaches = [[] for _ in cuts]
  last = []
  for T in lens:
    toks = rng.integers(3, 256, size=(1, T)).astype(np.int32)
    jh, h = jnp.asarray(toks), torch.from_numpy(toks).long()
    for i, (lo, hi) in enumerate(cuts):
      jc = j_transformer.init_kv_cache(jcfg, hi - lo, 1, S, jnp.float32)
      pc = transformer.init_kv_cache(cfg, hi - lo, 1, S, torch.float32)
      jh, jc = j_transformer.forward_shard(jsegs[i], jh, jc, jnp.int32(0), jcfg, i == 0, False,
                                           start_layer=lo)
      h, pc = transformer.forward_shard(psegs[i], h, pc, 0, cfg, i == 0, False, start_layer=lo)
      jcaches[i].append(jc)
      pcaches[i].append(pc)
    logits = j_transformer.unembed(jsegs[-1], jh, jcfg)
    last.append(int(np.argmax(np.asarray(logits)[0, -1])))
  return jsegs, psegs, jcaches, pcaches, last, jcfg, cfg


@pytest.mark.parametrize("via", ["eager", "graph cache"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "gumbel"])
@pytest.mark.parametrize("cuts", [[(0, 2), (2, 4)], [(0, 1), (1, 3), (3, 4)]], ids=["2 segs", "3 segs"])
def test_decode_chunk_ring_matches_jax(cuts, sampled, via):
  """JAX's decode_chunk_ring (one request) against the port's, eagerly or as the ring
  graph's replays: identical tokens, greedy or with JAX's noise injected, and every
  segment's cache within 1e-4."""
  jsegs, psegs, jcaches, pcaches, last, jcfg, cfg = _ring_setup(cuts, [9])
  temp = 0.8 if sampled else 0.0
  key = jax.random.PRNGKey(5)
  noise = torch.from_numpy(_jax_noise(key, 1, cfg.vocab_size, K)) if sampled else None
  starts = tuple(lo for lo, _ in cuts)
  jtoks, jnew = j_generate.decode_chunk_ring(
    tuple(jsegs), jnp.asarray([[last[0]]], jnp.int32), tuple(c[0] for c in jcaches), jnp.int32(9),
    key, jcfg, K, temp, TOP_K, start_layers=starts)
  caches = [c[0] for c in pcaches]
  if via == "eager":
    got, _ = generate.decode_chunk_ring(psegs, torch.tensor([[last[0]]]), caches, 9, cfg, K, temp,
                                        TOP_K, start_layers=starts, gumbel=noise)
  else:
    got = graphs.decode_ring(EagerGraphCache("cpu"), psegs, [[c] for c in caches],
                             torch.tensor([[last[0]]]), torch.tensor([9]), cfg, K,
                             torch.tensor([temp]), TOP_K, start_layers=starts, gumbel=noise)
  np.testing.assert_array_equal(got.numpy(), np.asarray(jtoks))
  for c, jc in zip(caches, jnew):
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]), atol=1e-4)


@pytest.mark.parametrize("via", ["eager", "graph cache"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "gumbel"])
def test_decode_chunk_ring_batched_matches_jax(sampled, via):
  """Three requests at per-row positions padded to four rows through a two-segment
  ring: JAX's decode_chunk_ring_batched against the port's batched function and the
  ring graph (pad rows: zero caches with row 0's token, position and temperature)."""
  cuts = [(0, 2), (2, 4)]
  lens = (4, 11, 17)
  jsegs, psegs, jcaches, pcaches, last, jcfg, cfg = _ring_setup(cuts, lens)
  temp = 0.8 if sampled else 0.0
  key = jax.random.PRNGKey(11)
  noise = torch.from_numpy(_jax_noise(key, 4, cfg.vocab_size, K)) if sampled else None
  pos = np.array(lens, np.int32)
  jtoks, jsplit = j_generate.decode_chunk_ring_batched(
    tuple(jsegs), tuple(tuple(c) for c in jcaches), jnp.asarray(np.array(last, np.int32)[:, None]),
    jnp.asarray(pos), key, jcfg, K, jnp.full((3,), temp, jnp.float32), TOP_K, start_layers=(0, 2),
    pad_rows=1)
  toks_in = torch.tensor(last)[:, None]
  temps = torch.full((3,), temp)
  if via == "eager":
    got, split = generate.decode_chunk_ring_batched(psegs, pcaches, toks_in, torch.from_numpy(pos),
                                                    cfg, K, temps, TOP_K, start_layers=(0, 2),
                                                    pad_rows=1, gumbel=noise)
  else:
    got = graphs.decode_ring(EagerGraphCache("cpu"), psegs, pcaches, toks_in, torch.from_numpy(pos),
                             cfg, K, temps, TOP_K, start_layers=(0, 2), gumbel=noise)
    split = pcaches
  np.testing.assert_array_equal(got.numpy(), np.asarray(jtoks))
  for seg, jseg in zip(split, jsplit):
    for c, jc in zip(seg, jseg):
      np.testing.assert_allclose(c["v"].numpy(), np.asarray(jc["v"]), atol=1e-4)


@pytest.mark.parametrize("via", ["eager", "graph cache"])
def test_forward_argmax_ring_matches_jax(via):
  """[prev] + draft through a three-segment ring in one forward: JAX's argmax."""
  cuts = [(0, 1), (1, 3), (3, 4)]
  jsegs, psegs, jcaches, pcaches, last, jcfg, cfg = _ring_setup(cuts, [7])
  x = np.zeros((1, 16), np.int64)
  x[0, :5] = [last[0], 9, 31, 200, 4]
  jpreds, _ = j_generate.forward_argmax_ring(tuple(jsegs), jnp.asarray(x, jnp.int32),
                                             tuple(c[0] for c in jcaches), jnp.int32(7), jcfg,
                                             start_layers=(0, 1, 3))
  caches = [c[0] for c in pcaches]
  if via == "eager":
    preds, _ = generate.forward_argmax_ring(psegs, torch.from_numpy(x), caches, 7, cfg,
                                            start_layers=(0, 1, 3))
  else:
    preds = graphs.verify_ring(EagerGraphCache("cpu"), psegs, torch.from_numpy(x), caches, 7, cfg,
                               start_layers=(0, 1, 3))
  np.testing.assert_array_equal(preds[0, :5].numpy(), np.asarray(jpreds)[0, :5])


def test_ring_graphs_drop_with_a_segment_and_keep_their_own_slab():
  """The ring's cache is a dependent of every segment's: clearing one segment's graphs
  (a checkpoint load, an eviction, OOM recovery) drops the ring's programs and slab.
  The ring's slab is its own: a ring program never resizes a segment's slab, and a
  grown ring slab drops only ring programs."""
  seg_a, seg_b = EagerGraphCache("cpu"), EagerGraphCache("cpu")
  ring = EagerGraphCache("cpu")
  seg_a.dependents.add(ring)
  seg_b.dependents.add(ring)
  cuts = [(0, 2), (2, 4)]
  _, psegs, _, pcaches, last, _, cfg = _ring_setup(cuts, [5], S=32)
  seg_a.slab_views({"k": ((2, 1, 32, 2, 16), torch.float32)})
  slab_a = seg_a.slab
  graphs.decode_ring(ring, psegs, pcaches, torch.tensor([[last[0]]]), torch.tensor([5]), cfg, 2,
                     torch.tensor([0.0]), TOP_K, start_layers=(0, 2))
  assert len(ring.programs) == 1 and ring.slab is not None and seg_a.slab is slab_a
  # A longer cache: a new key over a grown slab; the old ring program goes with it.
  grown = [[{n: torch.cat([t, torch.zeros_like(t)], dim=2) for n, t in c[0].items()}] for c in pcaches]
  graphs.decode_ring(ring, psegs, grown, torch.tensor([[last[0]]]), torch.tensor([7]), cfg, 2,
                     torch.tensor([0.0]), TOP_K, start_layers=(0, 2))
  assert len(ring.programs) == 1 and seg_a.slab is slab_a
  seg_b.clear()
  assert not ring.programs and ring.slab is None


# ------------------------------------------------------------------ the Nodes


@pytest.mark.parametrize("graph_cache", [False, True], ids=["eager", "graph cache"])
async def test_ring2_fused_matches_solo(tiny_model_dir, graph_cache):
  """A two-partition fused ring: the greedy stream of a solo Node and of JAX's fused
  ring, the fused path taken, and no per-token hop in the decode (the only hops are
  the prefill's 3-D hidden states)."""
  max_tokens = 12
  want = await _solo_tokens(tiny_model_dir, "fused ring hello", max_tokens)
  assert await _jax_ring_tokens(tiny_model_dir, 2, "fused ring hello", max_tokens) == want
  nodes = _ring(tiny_model_dir, 2, max_tokens, graph_cache=graph_cache)
  calls = _spy_ring_calls(nodes)
  hops = []
  for node in nodes:
    orig = node.process_tensor

    async def spy(base_shard, tensor, request_id=None, inference_state=None, _orig=orig,
                  _node_id=node.id):
      hops.append((_node_id, tensor.ndim))
      return await _orig(base_shard, tensor, request_id, inference_state)
    node.process_tensor = spy
  try:
    got = await _generate(nodes[0], "fused ring hello", "req-ring2", watch=nodes[1:])
  finally:
    _shutdown(nodes)
  assert got == want and len(got) == max_tokens
  assert calls, "fused ring path was never taken"
  assert all(ndim == 3 for _, ndim in hops), f"per-token decode hops happened: {hops}"
  driver = next(n.inference_engine for n in nodes if n.inference_engine._ring_chunks)
  assert driver.ring_stats()["declines"] == {}
  if graph_cache:
    ring_caches = [gc for _, gc in driver._ring_graphs.values()]
    assert ring_caches and ring_caches[0].replays > 0


async def test_ring3_fused_matches_solo(tiny_model_dir):
  max_tokens = 9
  want = await _solo_tokens(tiny_model_dir, "three partitions", max_tokens)
  assert await _jax_ring_tokens(tiny_model_dir, 3, "three partitions", max_tokens) == want
  nodes = _ring(tiny_model_dir, 3, max_tokens)
  calls = _spy_ring_calls(nodes)
  try:
    got = await _generate(nodes[0], "three partitions", "req-ring3", watch=nodes[1:])
  finally:
    _shutdown(nodes)
  assert got == want and len(got) == max_tokens
  assert calls, "fused ring path was never taken"


async def test_ring_fused_overlap_hits(tiny_model_dir):
  """The next chunk dispatched ahead works across the ring: a generation long enough to
  climb the chunk ladder resolves at least one such chunk on the driving engine."""
  max_tokens = 24
  want = await _solo_tokens(tiny_model_dir, "overlap across the ring", max_tokens)
  nodes = _ring(tiny_model_dir, 2, max_tokens)
  try:
    got = await _generate(nodes[0], "overlap across the ring", "req-overlap", watch=nodes[1:])
  finally:
    _shutdown(nodes)
  assert got == want and len(got) == max_tokens
  assert sum(n.inference_engine._overlap_hits for n in nodes) > 0


async def test_ring_fused_respects_request_cap(tiny_model_dir):
  nodes = _ring(tiny_model_dir, 2, max_tokens=32)
  try:
    got = await _generate(nodes[0], "capped request", "req-cap", watch=nodes[1:], max_tokens=5)
  finally:
    _shutdown(nodes)
  assert len(got) == 5


async def test_ring_concurrent_requests_coalesce_and_match(tiny_model_dir):
  """Concurrent requests on one co-located ring coalesce into batched dispatches and
  every stream equals its solo run and JAX's fused ring's. The width check retries a
  bounded number of times: one request can finish before the other's prefill lands."""
  max_tokens = 24
  prompts = ["first concurrent prompt", "a different second prompt here"]
  solo = [await _solo_tokens(tiny_model_dir, p, max_tokens) for p in prompts]
  jnodes = j_ring(tiny_model_dir, 2, max_tokens)
  jres = await asyncio.gather(*(j_generate_stream(jnodes[0], p, f"jconc-{i}", watch=jnodes[1:])
                                for i, p in enumerate(prompts)))
  assert sorted(map(tuple, jres)) == sorted(map(tuple, solo))
  widths = []
  for attempt in range(3):
    nodes = _ring(tiny_model_dir, 2, max_tokens)
    for node in nodes:
      eng = node.inference_engine
      orig = eng._ring_batch_sync

      def recording(items, *a, _orig=orig):
        widths.append(len(items))
        return _orig(items, *a)
      eng._ring_batch_sync = recording
      for b in eng._ring_batchers.values():
        b.dispatch = recording
    try:
      results = await asyncio.gather(*(_generate(nodes[0], p, f"conc-{i}-{attempt}", watch=nodes[1:])
                                       for i, p in enumerate(prompts)))
    finally:
      _shutdown(nodes)
    assert sorted(map(tuple, results)) == sorted(map(tuple, solo))
    if widths and max(widths) >= 2:
      driver = next(n.inference_engine for n in nodes if n.inference_engine._ring_batch_dispatches)
      assert driver._ring_batch_rows >= 2 * driver._ring_batch_dispatches
      return
  raise AssertionError(f"ring chunks never coalesced in 3 attempts: {widths}")


async def test_ring_speculative_decoding(tiny_model_dir, monkeypatch):
  """Prompt lookup over a two-partition ring: the sampler drafts from prompt and output
  (the prompt's ids ride the first hop) and verifies through verify_draft_ring; the
  stream equals the solo run's and JAX's ring's, and drafts were proposed."""
  monkeypatch.setenv("XOT_SPECULATE", "4")
  max_tokens = 16
  prompt = "the cat sat on the mat the cat sat on the mat the cat"
  want = await _solo_tokens(tiny_model_dir, prompt, max_tokens)
  assert await _jax_ring_tokens(tiny_model_dir, 2, prompt, max_tokens) == want
  nodes = _ring(tiny_model_dir, 2, max_tokens)
  assert nodes[0].speculate_tokens == 4
  try:
    got = await _generate(nodes[0], prompt, "req-spec", watch=nodes[1:])
  finally:
    _shutdown(nodes)
  assert got == want
  assert sum(n.inference_engine._spec_proposed for n in nodes) > 0


async def test_ring3_speculation_prompt_tokens_reach_sampler(tiny_model_dir, monkeypatch):
  """On a three-partition ring the prompt's ids pass the middle peer untouched and only
  the sampler consumes them: drafting sees the prompt."""
  monkeypatch.setenv("XOT_SPECULATE", "4")
  max_tokens = 12
  prompt = "the cat sat on the mat the cat sat on the mat the cat"
  want = await _solo_tokens(tiny_model_dir, prompt, max_tokens)
  nodes = _ring(tiny_model_dir, 3, max_tokens)
  seen = {}
  for node in nodes:
    orig = node.process_tensor

    async def spy(base_shard, tensor, request_id=None, inference_state=None, _orig=orig, _n=node):
      if inference_state and "xot_prompt_tokens" in inference_state:
        seen.setdefault(_n.id, len(inference_state["xot_prompt_tokens"]))
      return await _orig(base_shard, tensor, request_id, inference_state)
    node.process_tensor = spy
  try:
    got = await _generate(nodes[0], prompt, "req-spec3", watch=nodes[1:])
  finally:
    _shutdown(nodes)
  assert got == want
  assert len(seen) == 2, seen  # the middle peer and the sampler received them
  assert sum(n.inference_engine._spec_proposed for n in nodes) > 0


async def test_ring_sampling_extras_fall_back_to_per_token(tiny_model_dir):
  """A request with OpenAI extras keeps the per-token ring: the fused path never runs,
  the request completes, and the decline is counted."""
  max_tokens = 4
  nodes = _ring(tiny_model_dir, 2, max_tokens)
  calls = _spy_ring_calls(nodes)
  try:
    got = await _generate(nodes[0], "extras request", "req-extras", watch=nodes[1:],
                          sampling={"logit_bias": {"7": 2.0}})
  finally:
    _shutdown(nodes)
  assert len(got) == max_tokens
  assert calls == []
  assert sum(n.ring_declines.get("extras", 0) for n in nodes) >= 1


async def test_ring2_fused_gemma2_matches_solo(tmp_path):
  """gemma-2 through the fused ring: the alternating windows go by absolute layer index
  (the second segment's schedule does not restart at zero), with the soft-caps and the
  query scale; the stream equals the solo Node's and JAX's ring's."""
  ng = TINY_GEMMA2_CFG["num_hidden_layers"]
  gdir = make_hf_checkpoint(tmp_path, TINY_GEMMA2_CFG, seed=9)
  max_tokens = 12
  prompt = "a b c d e f g h i j k l"  # longer than the window (4)
  want = await _solo_tokens(gdir, prompt, max_tokens, n_layers=ng)
  assert await _jax_ring_tokens(gdir, 2, prompt, max_tokens, n_layers=ng) == want
  nodes = _ring(gdir, 2, max_tokens)
  calls = _spy_ring_calls(nodes)
  try:
    got = await _generate(nodes[0], prompt, "req-g2ring", watch=nodes[1:], n_layers=ng)
  finally:
    _shutdown(nodes)
  assert got == want
  assert calls


async def test_ring_draft_model_speculation(tiny_model_dir, monkeypatch):
  """A draft model composes with the fused ring: the sampler drafts with its resident
  draft model and verify_draft_ring checks the whole draft through every partition; the
  stream equals the plain solo run's, and drafts were accepted."""
  max_tokens = 12
  want = await _solo_tokens(tiny_model_dir, "one two three four", max_tokens)
  monkeypatch.setitem(registry.model_cards, "m",
                      {"layers": N_LAYERS, "repo": {"TorchShardInferenceEngine": "local"}})
  monkeypatch.setenv("XOT_DRAFT_MODEL", "m")
  nodes = _ring(tiny_model_dir, 2, max_tokens)
  try:
    got = await _generate(nodes[0], "one two three four", "req-draft-ring", watch=nodes[1:])
  finally:
    _shutdown(nodes)
  assert got == want
  assert sum(n.inference_engine._spec_accepted for n in nodes) > 0
