"""The port's cost model (xotorch_tpu_torch/inference/torch_engine/costmodel.py) against
the JAX package's, and against the port's real tensors.

Every method of CostModel, on every card whose config the registry carries (the
synthetic cards, at their published widths), gemma-2-2b's published config, and the
JAX cost-model test's architecture configs, in every weight format and KV format, must
give JAX's integers exactly. The predicted resident weight bytes must equal the `nbytes`
of the port's own parameters in bf16, int8 and int4 (the JAX test's ground truth, on the
port's tensors), and the engine's attribution on the CPU must book exactly the cost
model's bytes and FLOPs for the dispatches it ran, without a device sync.
"""
import asyncio
import math

import numpy as np
import pytest
import torch

from xotorch_tpu.inference.jax_engine.costmodel import CostModel as JCostModel
from xotorch_tpu.inference.jax_engine.costmodel import PerfAttribution as JPerfAttribution
from xotorch_tpu.inference.jax_engine.costmodel import _Ewma as JEwma
from xotorch_tpu.models.config import config_from_hf_dict as j_config
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.costmodel import CostModel, PerfAttribution, _Ewma, dtype_width
from xotorch_tpu_torch.models.config import config_from_hf_dict
from xotorch_tpu_torch.models.quantize import quantize_params, quantized_bytes
from xotorch_tpu_torch.models.registry import model_cards
from xotorch_tpu_torch.models.transformer import init_kv_cache, init_random_params

from tests.test_costmodel import CONFIGS as JAX_TEST_CONFIGS

GEMMA_2_2B = {  # google/gemma-2-2b's published config.json (the widths chip_smoke serves)
  "model_type": "gemma2", "hidden_size": 2304, "intermediate_size": 9216,
  "num_attention_heads": 8, "num_key_value_heads": 4, "head_dim": 256,
  "num_hidden_layers": 26, "vocab_size": 256000, "max_position_embeddings": 8192,
  "sliding_window": 4096, "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
  "query_pre_attn_scalar": 256, "tie_word_embeddings": True,
}

CARD_CONFIGS = {**{name: card["synthetic_config"] for name, card in sorted(model_cards.items())
                   if card.get("synthetic_config")},
                "gemma-2-2b": GEMMA_2_2B,
                **{f"jax-test:{k}": v for k, v in JAX_TEST_CONFIGS.items()}}
FORMATS = (None, "int8", "int4")


def _pair(hf: dict, n_layers=None, first=True, last=True, start=0, **kw):
  cfg, jcfg = config_from_hf_dict(hf), j_config(hf)
  n = n_layers or cfg.num_layers
  return (CostModel(cfg, n, first, last, start_layer=start, **kw),
          JCostModel(jcfg, n, first, last, start_layer=start, **kw))


def _every_method(cm) -> dict:
  """Each public method of a CostModel at a spread of arguments, as plain ints."""
  out = {"n_params": cm.n_params(), "kv_write": cm.kv_write_bytes_per_token(),
         "collective": cm.collective_bytes_per_token(), "ceilings": cm.ceilings(3350.0),
         "ceilings_unknown_peak": cm.ceilings(None)}
  for fmt in FORMATS:
    out[f"weight_bytes[{fmt}]"] = cm.weight_bytes(fmt)
    out[f"weight_bytes_per_device[{fmt}]"] = cm.weight_bytes_per_device(fmt)
  out["weight_bytes[default]"] = cm.weight_bytes()
  for depth in (0, 1, 7, 127, 128, 129, 4095, 4097, 9000):
    out[f"kv_resident[{depth}]"] = cm.kv_resident_bytes(depth, batch=3)
    out[f"flops_decode[{depth}]"] = cm.decode_flops_per_token(depth)
    for paged, page, alloc in ((False, 128, None), (False, 128, 2048), (True, 16, None),
                               (True, 128, None)):
      out[f"kv_read[{depth},{paged},{page},{alloc}]"] = cm.kv_read_bytes_per_token(
        depth, alloc_tokens=alloc, paged=paged, page=page)
      out[f"kv_read_dev[{depth},{paged},{page},{alloc}]"] = cm.kv_read_bytes_per_token_per_device(
        depth, alloc_tokens=alloc, paged=paged, page=page)
      out[f"verify[{depth},{paged},{page},{alloc}]"] = cm.verify_dispatch_cost(
        5, depth, paged=paged, alloc_tokens=alloc, page=page)
  for tokens, chunk, start in ((1, 4096, 0), (17, 16, 0), (4100, 1024, 0), (300, 128, 900)):
    out[f"prefill[{tokens},{chunk},{start}]"] = cm.prefill_dispatch_cost(tokens, chunk, start)
    out[f"prefill_flops[{tokens},{start}]"] = cm.prefill_flops(tokens, start)
  rows = [(514, False, None), (3, True, None), (2000, False, 4096), (0, True, None)]
  for page in (16, 128):
    out[f"decode[{page}]"] = cm.decode_dispatch_cost(32, rows, page=page)
  return out


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_every_method_equals_jax(name, fmt, kv_quant):
  """Full model, then a two-shard split (the mid-ring and the last shard), at bf16 and
  fp32 widths and tp 1 and 2: every number equal to JAX's, as integers."""
  hf = CARD_CONFIGS[name]
  n = hf["num_hidden_layers"]
  for dtype_bytes in (2, 4):
    for tp in (1, 2):
      kw = dict(quantize=fmt, dtype_bytes=dtype_bytes, kv_quant=kv_quant, tp=tp)
      for shard in ((n, True, True, 0), (n // 2, True, False, 0), (n - n // 2, False, True, n // 2)):
        port, jax_cm = _pair(hf, *shard, **kw)
        got, want = _every_method(port), _every_method(jax_cm)
        assert got == want, f"{name} fmt={fmt} kv={kv_quant} dtype={dtype_bytes} tp={tp} {shard}"
        for value in got.values():
          for v in (value if isinstance(value, tuple) else (value,)):
            assert not isinstance(v, float) or v is None or math.isfinite(v)


DENSE_CASES = [(name, fmt) for name in ("synthetic-tiny", "synthetic-tiny-gemma2", "jax-test:llama",
                                        "jax-test:qwen2-bias", "jax-test:qwen3-qknorm",
                                        "jax-test:gemma2-tied-sandwich", "jax-test:int4-groups")
               for fmt in FORMATS]


@pytest.mark.parametrize("name,fmt", DENSE_CASES)
def test_weight_bytes_equal_the_ports_parameters(name, fmt):
  """The prediction equals the nbytes of the port's own resident tensors (random
  weights, then the port's quantizer), whole model and split into two shards."""
  hf = CARD_CONFIGS[name]
  cfg = config_from_hf_dict(hf)
  n = cfg.num_layers
  for layers, first, last, start in ((n, True, True, 0), (n // 2, True, False, 0),
                                     (n - n // 2, False, True, n // 2)):
    params = init_random_params(cfg, layers, first, last, seed=0, dtype=torch.bfloat16,
                                start_layer=start)
    if fmt:
      params = quantize_params(params, fmt, scale_dtype=torch.bfloat16)
    nbytes = sum(t.nbytes for t in _tensors(params))
    cm = CostModel(cfg, layers, first, last, quantize=fmt, dtype_bytes=2, start_layer=start)
    assert cm.weight_bytes() == quantized_bytes(params) == nbytes, (name, fmt, layers, first, last)
    if fmt is None:
      assert cm.n_params() == sum(t.numel() for t in _tensors(params))


def _tensors(tree):
  if isinstance(tree, torch.Tensor):
    yield tree
  elif isinstance(tree, dict):
    for v in tree.values():
      yield from _tensors(v)
  elif isinstance(tree, (list, tuple)):
    for v in tree:
      yield from _tensors(v)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_kv_resident_bytes_equal_the_ports_cache(kv_quant):
  cfg = config_from_hf_dict(CARD_CONFIGS["synthetic-tiny"])
  cache = init_kv_cache(cfg, cfg.num_layers, 2, 128, torch.bfloat16, kv_quant=kv_quant == "int8")
  cm = CostModel(cfg, cfg.num_layers, True, True, dtype_bytes=2, kv_quant=kv_quant)
  assert cm.kv_resident_bytes(128, batch=2) == sum(t.nbytes for t in cache.values())


def test_attribution_and_ewma_equal_jax():
  """PerfAttribution and _Ewma fed the same observations at the same instants give
  JAX's lanes, executables, gauges and compact (floats within 1e-9)."""
  port, jax_pa = PerfAttribution(ewma_s=5.0), JPerfAttribution(ewma_s=5.0)
  rng = np.random.default_rng(0)
  t = 1000.0
  for i in range(40):
    t += float(rng.uniform(0.001, 0.5))
    kind = "decode" if i % 3 else "prefill"
    kw = dict(secs=float(rng.uniform(1e-3, 0.1)), tokens=int(rng.integers(1, 64)),
              batch=int(rng.integers(1, 9)), hbm_bytes=int(rng.integers(1, 10**10)),
              flops=int(rng.integers(1, 10**12)), now=t)
    key = (kind, int(rng.integers(0, 3)))
    port.observe(key, kind, **kw)
    jax_pa.observe(key, kind, **kw)
  assert port.lanes() == jax_pa.lanes()
  assert port.executables() == jax_pa.executables()
  for a, b in ((port._ewma_bytes, jax_pa._ewma_bytes), (port._ewma_flops, jax_pa._ewma_flops),
               (port._ewma_tok["decode"], jax_pa._ewma_tok["decode"])):
    assert abs(a.rate - b.rate) <= 1e-9 * max(1.0, abs(b.rate))
    assert abs(a.peek(t + 3.0) - b.peek(t + 3.0)) <= 1e-9 * max(1.0, abs(b.rate))
  e, je = _Ewma(2.0), JEwma(2.0)
  for k in range(10):
    e.observe(k * 3.0, 0.01, 10.0 + k * 0.3)
    je.observe(k * 3.0, 0.01, 10.0 + k * 0.3)
  assert abs(e.rate - je.rate) <= 1e-9 * abs(je.rate)
  assert dtype_width("bfloat16") == 2 and dtype_width("float32") == 4


TINY = Shard("synthetic-tiny", 0, 3, 4)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_books_the_cost_models_bytes_without_a_sync(monkeypatch, paged):
  """A synthetic-tiny engine on the CPU serving one request (a 40-token prompt over
  two XOT_PREFILL_CHUNK segments, then three decode chunks): its prefill and decode
  lanes hold exactly the cost model's tokens, bytes and FLOPs for those dispatches, the
  dispatch classification covers every dispatch, and nothing calls
  torch.cuda.synchronize."""
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine

  def no_sync(*a, **kw):
    raise AssertionError("attribution must not synchronize the device")
  monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
  monkeypatch.setenv("XOT_PREFILL_CHUNK", "32")
  monkeypatch.setenv("XOT_PAGED_KV", "1" if paged else "0")
  monkeypatch.setenv("XOT_KV_PAGE", "16")
  monkeypatch.setenv("XOT_DECODE_BATCH", "1")

  async def drive():
    eng = TorchShardInferenceEngine(device="cpu", dtype="float32", seed=3)
    prompt = (np.arange(40, dtype=np.int64) % 200 + 3).reshape(1, -1)
    tok, _ = await eng.infer_sample_tensor("r", TINY, prompt, temp=0.0, top_k=0)
    pos, chunks = 40, []
    for n in (4, 8, 8):
      toks = await eng.generate_chunk("r", TINY, int(tok), n, temp=0.0, top_k=0)
      chunks.append((n, pos))
      pos += len(toks)
      tok = toks[-1]
    return eng, chunks

  eng, chunks = asyncio.run(drive())
  cm = eng._ctx.costmodel
  lanes = eng.perf_report()["lanes"]
  pre_bytes, pre_flops = cm.prefill_dispatch_cost(40, 32, start=0)
  assert lanes["prefill"] == {"dispatches": 1, "secs": lanes["prefill"]["secs"], "tokens": 40,
                              "hbm_bytes": pre_bytes, "flops": pre_flops}
  dec = [cm.decode_dispatch_cost(n, [(p, paged, None)], page=16) for n, p in chunks]
  assert lanes["decode"]["dispatches"] == 3
  assert lanes["decode"]["tokens"] == sum(n for n, _ in chunks)
  assert lanes["decode"]["hbm_bytes"] == sum(b for b, _ in dec)
  assert lanes["decode"]["flops"] == sum(f for _, f in dec)
  assert lanes["prefill"]["secs"] > 0 and lanes["decode"]["secs"] > 0
  assert eng._jit_first_dispatches + eng._jit_cached_dispatches == 4
  report = eng.perf_report()
  assert report["model"]["weight_bytes_predicted"] == report["model"]["weight_bytes_actual"]
  # Off the card the peaks are unknown: the utilization gauges read 0.0, as JAX's do.
  assert report["gauges"]["hbm_util_pct"] == 0.0 and report["gauges"]["mfu_pct"] == 0.0
  assert report["ceilings"]["hbm_gbps"] is None
