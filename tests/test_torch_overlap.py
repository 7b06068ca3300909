"""Overlapped decode chunks (XOT_OVERLAP_CHUNKS, XOT_OVERLAP_BATCH) on the port's
engine against the JAX engine's, on the CPU.

The twins of tests/test_overlap_decode.py: both engines serve the same
transformers-written tiny llama in fp32 and are driven the way the Node's fused loop
drives them (the chunk ladder with the next size named). A solo chunk then dispatches
the next one ahead and the next call takes it or rolls it back; every stream must be
the overlap-off stream and the JAX engine's, and the hits and misses must be JAX's. A
mispredicted size, a segment forward, a verify, clear_request and OOM recovery each
find the committed position; near the cache's end capacity is judged by it. Sampled
streams (temperature 0.8) are compared between the port's own runs with the overlap on
and off: the two packages' generators differ. Logits are held to JAX's within 1e-4
(fp32), streams exactly.
"""
import asyncio

import jax
import numpy as np
import pytest
import torch

from tests.test_model_equivalence import TINY_LLAMA_CFG, make_hf_checkpoint
from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.engine import RequestStateLost
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine

torch.set_num_threads(2)

N = TINY_LLAMA_CFG["num_hidden_layers"]
FULL, JFULL = Shard("m", 0, N - 1, N), JShard("m", 0, N - 1, N)
PROMPT = np.array([[1, 5, 9, 200, 17, 33, 2, 8]], dtype=np.int64)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  with jax.default_matmul_precision("highest"):
    yield


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
  return make_hf_checkpoint(tmp_path_factory.mktemp("overlap"), TINY_LLAMA_CFG, seed=3)


def _port(model_dir):
  return TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu", seed=0)


def _jax(model_dir):
  return JAXShardInferenceEngine(JLocalShardDownloader({"m": model_dir}), dtype="float32")


def _shard(eng):
  return FULL if isinstance(eng, TorchShardInferenceEngine) else JFULL


async def _first(eng, rid, prompt=PROMPT):
  logits, _ = await eng.infer_tensor(rid, _shard(eng), prompt)
  return int(np.argmax(np.asarray(logits)[0, -1]))


async def _ladder(eng, rid, n_total, size=4, cap=16, temp=0.0, prompt=PROMPT, hint=True):
  """The Node's fused loop: the power-of-two ladder covering what remains, the next
  rung named as the size hint, surplus dropped."""
  toks = [await _first(eng, rid, prompt)]
  remaining = n_total
  while remaining > 0:
    this = min(size, 1 << (remaining - 1).bit_length())
    rem_after = remaining - this
    nxt = (min(min(size * 2, cap), 1 << (rem_after - 1).bit_length())
           if rem_after >= 1 and hint else None)
    out = await eng.generate_chunk(rid, _shard(eng), toks[-1], this, temp=temp, top_k=0,
                                   next_size=nxt)
    toks.extend(int(t) for t in out[:remaining])
    remaining -= len(out)
    size = min(size * 2, cap)
  return toks


def _shutdown(*engines):
  for e in engines:
    e.executor.shutdown(wait=True)


async def test_overlap_matches_sequential_greedy(model_dir, monkeypatch):
  """The ladder with the overlap on equals it with the overlap off and the JAX engine's,
  the chunks ahead resolve (hits, as many as JAX's), and off runs none ahead."""
  on, jon = _port(model_dir), _jax(model_dir)
  got, jgot = await _ladder(on, "r", 40), await _ladder(jon, "r", 40)
  assert on._overlap_hits >= 2 and (on._overlap_hits, on._overlap_misses) == (
    jon._overlap_hits, jon._overlap_misses)
  monkeypatch.setenv("XOT_OVERLAP_CHUNKS", "0")
  off = _port(model_dir)
  assert await _ladder(off, "r", 40) == got == jgot
  assert off._overlap_hits == off._overlap_misses == 0 and off._spec_next == {}
  _shutdown(on, jon, off)


async def test_mispredicted_size_rolls_back(model_dir):
  """A hint of 8, then a call for 2: the chunk ahead is discarded (a miss), the position
  rolled back, and the stream is sequential greedy's, as on JAX."""
  async def run(eng):
    toks = [await _first(eng, "r")]
    toks += [int(t) for t in await eng.generate_chunk("r", _shard(eng), toks[-1], 4, temp=0.0,
                                                      top_k=0, next_size=8)]
    toks += [int(t) for t in await eng.generate_chunk("r", _shard(eng), toks[-1], 2, temp=0.0,
                                                      top_k=0)]
    return toks
  port, jeng, ref = _port(model_dir), _jax(model_dir), _port(model_dir)
  got, jgot = await run(port), await run(jeng)
  assert port._overlap_misses >= 1 and port._overlap_misses == jeng._overlap_misses
  want = [await _first(ref, "o")]
  for size in (4, 2):
    want += [int(t) for t in await ref.generate_chunk("o", FULL, want[-1], size, temp=0.0, top_k=0)]
  assert got == jgot == want
  _shutdown(port, jeng, ref)


async def test_interleaved_segment_forward_discards_spec(model_dir):
  """A one-token forward between chunks supersedes the chunk ahead: its logits equal a
  never-overlapped engine's (1e-5) and the JAX engine's (1e-4)."""
  async def run(eng, hint):
    tok0 = await _first(eng, "r")
    chunk = [int(t) for t in await eng.generate_chunk("r", _shard(eng), tok0, 4, temp=0.0, top_k=0,
                                                      next_size=hint)]
    in_flight = "r" in eng._spec_next
    lg, _ = await eng.infer_tensor("r", _shard(eng), np.array([[chunk[-1]]], dtype=np.int64))
    return chunk, np.asarray(lg), in_flight, "r" in eng._spec_next
  port, jeng, ref = _port(model_dir), _jax(model_dir), _port(model_dir)
  chunk, lg, before, after = await run(port, 8)
  assert before and not after
  jchunk, jlg, _, _ = await run(jeng, 8)
  rchunk, rlg, rbefore, _ = await run(ref, None)
  assert not rbefore and chunk == rchunk == jchunk
  np.testing.assert_allclose(lg, rlg, atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(lg, jlg, atol=1e-4, rtol=1e-4)
  _shutdown(port, jeng, ref)


async def test_overlap_sampled_stream_reproduces(model_dir, monkeypatch):
  """Temperature 0.8: the chunk ahead draws from the engine's generator in the order
  the chunks run, so an all-hits run samples the overlap-off run's stream."""
  monkeypatch.setenv("XOT_SEED", "1234")
  on = TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu")
  got = await _ladder(on, "r", 24, temp=0.8)
  assert on._overlap_hits >= 1 and on._overlap_misses == 0
  monkeypatch.setenv("XOT_OVERLAP_CHUNKS", "0")
  off = TorchShardInferenceEngine(LocalShardDownloader({"m": model_dir}), device="cpu")
  assert await _ladder(off, "r", 24, temp=0.8) == got
  _shutdown(on, off)


async def test_cache_tail_uses_committed_pos(model_dir, monkeypatch):
  """Near max_cache_len capacity is the committed position's: the overlap drains as many
  tokens as the overlap off (and JAX) before CacheExhausted."""
  monkeypatch.setenv("XOT_CACHE_LEN", "16")
  monkeypatch.setenv("XOT_MAX_CACHE_LEN", "32")

  async def drain(eng):
    toks = [await _first(eng, "r")]
    try:
      while True:
        out = await eng.generate_chunk("r", _shard(eng), toks[-1], 8, temp=0.0, top_k=0,
                                       next_size=8)
        toks.extend(int(t) for t in out)
    except Exception as e:
      assert type(e).__name__ == "CacheExhausted"
      return toks
  port, jeng = _port(model_dir), _jax(model_dir)
  on, jon = await drain(port), await drain(jeng)
  assert port._overlap_hits >= 1
  monkeypatch.setenv("XOT_OVERLAP_CHUNKS", "0")
  off = _port(model_dir)
  assert on == await drain(off) == jon
  _shutdown(port, jeng, off)


PROMPTS = {"a": np.array([[1, 5, 9, 2]], dtype=np.int64),
           "b": np.array([[7, 3, 11]], dtype=np.int64),
           "c": np.array([[42, 17, 5, 9, 100, 3]], dtype=np.int64)}


async def test_batch_overlap_matches_solo_streams(model_dir, monkeypatch):
  """XOT_OVERLAP_BATCH=1: three requests coalesce in the batcher and the next batch runs
  ahead from this batch's last tokens. Every stream equals its solo run (and JAX's solo
  run), and a batch ahead resolved."""
  want = {}
  for rid, p in PROMPTS.items():
    solo, jsolo = _port(model_dir), _jax(model_dir)
    want[rid] = await _ladder(solo, rid, 24, cap=8, prompt=p, hint=False)
    assert want[rid] == await _ladder(jsolo, rid, 24, cap=8, prompt=p, hint=False)
    _shutdown(solo, jsolo)
  monkeypatch.setenv("XOT_OVERLAP_BATCH", "1")
  eng = _port(model_dir)
  got = await asyncio.gather(*(_ladder(eng, rid, 24, cap=8, prompt=p) for rid, p in PROMPTS.items()))
  assert eng._overlap_batch_hits >= 1, "the batch ahead never resolved"
  assert dict(zip(PROMPTS, got)) == want
  _shutdown(eng)


async def test_batch_overlap_membership_change_rolls_back(model_dir, monkeypatch):
  """One member finishes while a batch ahead is in flight: the other keeps its solo
  stream through the re-formed batches."""
  solo_a, solo_b = _port(model_dir), _port(model_dir)
  want_a = await _ladder(solo_a, "a", 40, cap=8, prompt=PROMPTS["a"], hint=False)
  want_b = await _ladder(solo_b, "b", 12, cap=8, prompt=PROMPTS["b"], hint=False)
  monkeypatch.setenv("XOT_OVERLAP_BATCH", "1")
  eng = _port(model_dir)
  got_a, got_b = await asyncio.gather(_ladder(eng, "a", 40, cap=8, prompt=PROMPTS["a"]),
                                      _ladder(eng, "b", 12, cap=8, prompt=PROMPTS["b"]))
  await eng.clear_request("b")
  assert (got_a, got_b) == (want_a, want_b)
  assert eng._contexts[FULL].batch_spec is None or "b" not in eng._contexts[FULL].batch_spec["rids"]
  _shutdown(solo_a, solo_b, eng)


async def test_verify_draft_with_spec_in_flight(model_dir):
  """A verify while a chunk runs ahead reads the committed position: the true greedy
  continuation as the draft is accepted whole with its bonus, and the combined stream
  equals plain greedy decode, on both engines."""
  solo = await _ladder(_port(model_dir), "s", 20, size=4, cap=4)

  async def run(eng):
    toks = [await _first(eng, "r")]
    toks += [int(t) for t in await eng.generate_chunk("r", _shard(eng), toks[-1], 4, temp=0.0,
                                                      top_k=0, next_size=4)]
    assert "r" in eng._spec_next
    draft = solo[len(toks):len(toks) + 3]
    accepted = await eng.verify_draft("r", _shard(eng), toks[-1], draft)
    assert accepted is not None and list(accepted)[:3] == draft
    toks += [int(t) for t in accepted]
    while len(toks) < len(solo):
      toks += [int(t) for t in await eng.generate_chunk("r", _shard(eng), toks[-1], 4, temp=0.0,
                                                        top_k=0, next_size=4)]
    return toks[:len(solo)]
  port, jeng = _port(model_dir), _jax(model_dir)
  assert await run(port) == solo == await run(jeng)
  _shutdown(port, jeng)


async def test_clear_request_drops_spec(model_dir):
  port = _port(model_dir)
  await port.generate_chunk("r", FULL, await _first(port, "r"), 4, temp=0.0, top_k=0, next_size=8)
  assert "r" in port._spec_next
  await port.clear_request("r")
  assert "r" not in port._spec_next and "r" not in port._contexts[FULL].states
  _shutdown(port)


async def test_oom_recovery_drops_inflight_spec(model_dir):
  """OOM recovery with a chunk ahead: the record goes with the states, and the request's
  next chunk fails loudly rather than starting over."""
  port = _port(model_dir)
  await port.generate_chunk("r", FULL, await _first(port, "r"), 4, temp=0.0, top_k=0, next_size=4)
  assert "r" in port._spec_next
  port._free_device_memory()
  assert port._spec_next == {}
  with pytest.raises(RequestStateLost):
    await port.generate_chunk("r", FULL, 1, 4, temp=0.0, top_k=0)
  _shutdown(port)
