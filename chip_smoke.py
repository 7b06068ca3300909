#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (xotorch_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --kernels-only  # build the kernels and hold them against
                                          # their plain versions, then stop

Phases, in order; any failure exits nonzero and prints no result line:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
  2. build: compiles csrc/*.cu with nvcc for sm_90a, one process per source;
  3. kernels: each kernel at synthetic-llama-1b widths (Hq 32, Hkv 8, D 64) in bf16
     against its plain PyTorch version on the same inputs, with times of the kernel,
     the plain version and torch's scaled_dot_product_attention as a yardstick;
  4. model: a two-layer cut of synthetic-llama-1b at full width, prefill and decode
     through the kernels in bf16 on the card against the plain path in fp32 on the CPU;
  5. main path: the port's server (main.py) serving synthetic-llama-1b at full width
     and depth answers three /v1/chat/completions requests over HTTP, with both
     kernels' launch counters read around that run;
  6. the {"kernels": [...]} line, then the {"ok": true, ...} line last.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

HQ, HKV, D = 32, 8, 64  # synthetic-llama-1b attention widths
ATOL = 2e-2  # bf16 output rounding (2^-8 relative on |o| <= ~2) plus the plain
             # version's bf16 cast of the probabilities before P.V


def smi_line() -> str:
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


_L2_FLUSH = []


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
  """Mean device time of one call, from CUDA events around each call, with the
  50 MB L2 flushed before each: on the main path a layer's operands arrive cold,
  after the rest of the model's weights have streamed through."""
  import torch
  if not _L2_FLUSH:
    _L2_FLUSH.append(torch.empty(64 << 20, dtype=torch.uint8, device="cuda"))
  for _ in range(warmup):
    fn()
  events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(iters)]
  for start, end in events:
    _L2_FLUSH[0].zero_()
    start.record()
    fn()
    end.record()
  torch.cuda.synchronize()
  return sum(start.elapsed_time(end) for start, end in events) / iters


def bound(flops: float, nbytes: float):
  t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
  return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def visible(p: int, window: int) -> int:
  """Keys a query at absolute position p sees."""
  return p + 1 if window <= 0 else min(p + 1, window)


def check_kernels(torch, results: dict) -> None:
  import torch.nn.functional as F
  from xotorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention, flash_cached_attention_ref

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)

  def randn(*shape):
    return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

  def report(name, case, out, ref, ms, plain_ms, lib_ms, b_ms, b_by):
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-12)
    ok = math.isfinite(err) and err <= ATOL
    print(f"[{name}] {case}: max_abs_err={err:.3e} max_rel_err={rel:.3e} (atol {ATOL}) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
          f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{name} {case}: kernel disagrees with its plain version ({err})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by}

  # K1: prefill from position 0. T=1024 is the main path's first segment below.
  for T, window, softcap in ((512, 0, 0.0), (1024, 0, 0.0), (2048, 0, 0.0), (2048, 256, 50.0)):
    q, k, v = randn(1, T, HQ, D), randn(1, T, HKV, D), randn(1, T, HKV, D)
    out = flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, window=window, softcap=softcap)
    ms = time_ms(lambda: flash_attention(q, k, v, window=window, softcap=softcap))
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, window=window, softcap=softcap), iters=5)
    lib_ms = None
    if not softcap:
      qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
      if window:
        pos = torch.arange(T, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
      else:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
      lib_ms = time_ms(lib)
    pairs = sum(visible(t, window) for t in range(T))
    b_ms, b_by = bound(4.0 * HQ * D * pairs, 2.0 * (2 * q.numel() + k.numel() + v.numel()))
    case = f"B=1 T={T} window={window} softcap={softcap}"
    r = report("flash_attention", case, out, ref, ms, plain_ms, lib_ms, b_ms, b_by)
    if T == 1024 and not window:
      results["flash_attention"] = r

  # K2: decode steps and a chunked-prefill segment over a resident cache.
  # (B, T, S, q_start per row, window); the first case is the main path's decode shape.
  cases = (
    (1, 1, 2048, [640], 0),
    (1, 1, 4096, [4000], 0),
    (8, 1, 4096, [17, 300, 1023, 1024, 2047, 2500, 3333, 4095], 0),
    (1, 64, 4096, [1000], 0),
    (8, 1, 4096, [17, 300, 1023, 1024, 2047, 2500, 3333, 4095], 512),
    (1, 64, 4096, [1000], 256),
  )
  for B, T, S, starts, window in cases:
    q, kc, vc = randn(B, T, HQ, D), randn(B, S, HKV, D), randn(B, S, HKV, D)
    q_start = torch.tensor(starts, dtype=torch.int32, device=dev)
    out = flash_cached_attention(q, kc, vc, q_start, window=window)
    torch.cuda.synchronize()
    ref = flash_cached_attention_ref(q, kc, vc, q_start, window=window)
    ms = time_ms(lambda: flash_cached_attention(q, kc, vc, q_start, window=window))
    plain_ms = time_ms(lambda: flash_cached_attention_ref(q, kc, vc, q_start, window=window), iters=5)
    pos = q_start.long()[:, None] + torch.arange(T, device=dev)[None, :]  # [B, T]
    kv = torch.arange(S, device=dev)
    mask = kv[None, None, :] <= pos[:, :, None]
    if window:
      mask = mask & (kv[None, None, :] > pos[:, :, None] - window)
    mask = mask[:, None]  # [B, 1, T, S]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                              enable_gqa=True))
    pairs = sum(visible(s + t, window) for s in starts for t in range(T))
    cache_rows = sum(s + T - (max(0, s - window + 1) if window else 0) for s in starts)
    b_ms, b_by = bound(4.0 * HQ * D * pairs, 2.0 * 2 * q.numel() + 2.0 * 2 * cache_rows * HKV * D)
    case = f"B={B} T={T} S={S} q_start={starts if B == 1 else 'varied'} window={window}"
    r = report("flash_cached_attention", case, out, ref, ms, plain_ms, lib_ms, b_ms, b_by)
    if (B, T, S, window) == (1, 1, 2048, 0):
      results["flash_cached_attention"] = r

  # The other head widths the kernels are built for, at the registry's other
  # llama shapes (synthetic-llama-8b: D 128; synthetic-tiny: Hq 4, Hkv 2, D 16),
  # with ragged lengths, windows and softcaps: correctness only.
  for hq, hkv, d in ((32, 8, 128), (4, 2, 16)):
    for T, window, softcap in ((300, 0, 0.0), (300, 64, 30.0)):
      q, k, v = randn(2, T, hq, d), randn(2, T, hkv, d), randn(2, T, hkv, d)
      out = flash_attention(q, k, v, window=window, softcap=softcap)
      torch.cuda.synchronize()
      ref = flash_attention_ref(q, k, v, window=window, softcap=softcap)
      check_only("flash_attention", f"Hq={hq} Hkv={hkv} D={d} B=2 T={T} window={window} "
                 f"softcap={softcap}", out, ref)
    for T, starts, window in ((1, [0, 200, 511], 0), (20, [100, 37, 400], 50)):
      q, kc, vc = randn(3, T, hq, d), randn(3, 512 + 32, hkv, d), randn(3, 512 + 32, hkv, d)
      q_start = torch.tensor(starts, dtype=torch.int32, device=dev)
      out = flash_cached_attention(q, kc, vc, q_start, window=window, softcap=20.0)
      torch.cuda.synchronize()
      ref = flash_cached_attention_ref(q, kc, vc, q_start, window=window, softcap=20.0)
      check_only("flash_cached_attention", f"Hq={hq} Hkv={hkv} D={d} B=3 T={T} "
                 f"q_start={starts} window={window} softcap=20.0", out, ref)


def check_only(name, case, out, ref) -> None:
  err = (out.float() - ref.float()).abs().max().item()
  ok = math.isfinite(err) and err <= ATOL
  print(f"[{name}] {case}: max_abs_err={err:.3e} (atol {ATOL}) {'ok' if ok else 'FAIL'}",
        flush=True)
  if not ok:
    raise AssertionError(f"{name} {case}: kernel disagrees with its plain version ({err})")


def check_model(torch) -> None:
  """A two-layer cut of synthetic-llama-1b at full width: prefill (K1) and decode
  (K2) in bf16 on the card against the plain path in fp32 on the CPU, same weights."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, init_random_params

  cfg = dataclasses.replace(
    config_from_hf_dict(get_model_card("synthetic-llama-1b")["synthetic_config"]), num_layers=2)
  dev = torch.device("cuda")
  params = init_random_params(cfg, 2, True, True, seed=0, dtype=torch.bfloat16, device=dev)
  params_cpu = {k: ({kk: vv.float().cpu() for kk, vv in v.items()} if isinstance(v, dict)
                    else v.float().cpu()) for k, v in params.items()}
  tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 100))
  x = torch.as_tensor(tokens, device=dev)
  x_cpu = torch.as_tensor(tokens)
  cache = init_kv_cache(cfg, 2, 1, 256, torch.bfloat16, dev)
  cache_cpu = init_kv_cache(cfg, 2, 1, 256, torch.float32, "cpu")
  worst = 0.0
  with torch.inference_mode():
    logits, _ = forward_shard(params, x, cache, 0, cfg, True, True, use_flash=True)
    ref, _ = forward_shard(params_cpu, x_cpu, cache_cpu, 0, cfg, True, True)
    steps = [(logits[0, -8:].float().cpu(), ref[0, -8:])]
    tok = int(ref[0, -1].argmax())
    for i in range(8):
      step = torch.tensor([[tok]])
      logits, _ = forward_shard(params, step.to(dev), cache, 100 + i, cfg, True, True,
                                use_flash_decode=True)
      ref, _ = forward_shard(params_cpu, step, cache_cpu, 100 + i, cfg, True, True)
      steps.append((logits[0].float().cpu(), ref[0]))
      tok = int(ref[0, -1].argmax())
  for got, want in steps:
    if not bool(torch.isfinite(got).all()):
      raise AssertionError("model: non-finite logits on the card")
    worst = max(worst, ((got - want).abs().max() / want.abs().max()).item())
  # bf16 weights are shared; the card keeps activations in bf16 over two layers.
  print(f"[model] 2-layer synthetic-llama-1b cut, prefill 100 + decode 8: max logit error "
        f"{worst:.3e} of the logits' range (limit 5e-2) {'ok' if worst < 5e-2 else 'FAIL'}", flush=True)
  if not worst < 5e-2:
    raise AssertionError(f"model: card logits disagree with the CPU reference ({worst})")


def http_json(url: str, body=None, timeout: float = 300.0):
  import urllib.request
  req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=timeout) as resp:
    return json.loads(resp.read())


def http_stream(url: str, body, timeout: float = 300.0):
  """POST a streaming completion; returns (events, seconds to the first content,
  seconds to the last content)."""
  import urllib.request
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  t0 = time.perf_counter()
  first = last = None
  events = []
  with urllib.request.urlopen(req, timeout=timeout) as resp:
    for raw in resp:
      line = raw.decode().strip()
      if not line.startswith("data: "):
        continue
      data = line[len("data: "):]
      if data == "[DONE]":
        break
      ev = json.loads(data)
      events.append(ev)
      if any(c.get("delta", {}).get("content") for c in ev.get("choices", [])):
        last = time.perf_counter() - t0
        first = last if first is None else first
  return events, first, last


async def profile_decode(torch, engine, model: str, classname: str, card: str) -> None:
  """Where a decode chunk's time goes: 32 greedy tokens after a 514-token prompt,
  under torch.profiler (CUDA activity). Prints the wall time, the share of it the
  card spent in kernels, and the kernels by device time."""
  if engine.device.type != "cuda":
    print("[profile] no card: busy share not measured", flush=True)
    return
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  from xotorch_tpu_torch.models.registry import build_full_shard

  shard = build_full_shard(model, classname)
  tok, _ = await engine.infer_sample_tensor("profile", shard, np.ones((1, 514), np.int64),
                                            temp=0.0, top_k=0)
  toks = await engine.generate_chunk("profile", shard, tok, 8, temp=0.0)  # warm
  n = 32
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    await engine.generate_chunk("profile", shard, int(toks[-1]), n, temp=0.0)
    wall_ms = (time.perf_counter() - t0) * 1e3
  await engine.clear_request("profile")
  rows = []
  for evt in prof.key_averages():
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
      us = getattr(evt, "self_cuda_time_total", 0)
    if us > 0:
      rows.append((us / 1e3, evt.key, evt.count))
  if not rows:
    print("[profile] the trace holds no device time: busy share not measured", flush=True)
    return
  rows.sort(reverse=True)
  busy = sum(r[0] for r in rows)
  launches = sum(r[2] for r in rows)
  print(f"[profile] decode {n} tokens after a 514-token prompt: wall {wall_ms:.2f} ms "
        f"({n / wall_ms * 1e3:.1f} tok/s under the profiler), kernels {busy:.2f} ms = "
        f"{100 * busy / wall_ms:.1f}% busy, {100 - 100 * busy / wall_ms:.1f}% idle, "
        f"{launches / n:.0f} device kernels per token ({card})", flush=True)
  for ms, name, count in rows[:10]:
    print(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<5d} {name[:90]}", flush=True)


def drive_main_path(torch, card: str, device: str = "cuda",
                    model: str = "synthetic-llama-1b") -> dict:
  """The port's server on `model` (synthetic-llama-1b: bf16, full width and depth,
  on the card) answers three chat completions over HTTP. Returns the kernels'
  launch counts. (`device` and `model` let the same phase be rehearsed on the CPU
  with a small card.)"""
  import asyncio
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.models.registry import build_full_shard, get_model_card
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention

  os.environ["XOT_PREFILL_CHUNK"] = "1024"  # so the long prompt runs K2's T > 1 path
  args = port_main.build_parser().parse_args(
    ["--device", device, "--default-model", model, "--chatgpt-api-host", "127.0.0.1",
     "--chatgpt-api-port", "0", "--chatgpt-api-response-timeout", "600"])
  node, engine, classname, api = port_main.build_node(args)
  words = lambda n: " ".join(f"w{i % 97}" for i in range(n))
  requests = [  # (label, body)
    ("512-word prompt, 64 tokens", {"model": model, "temperature": 0, "max_tokens": 64,
                                    "messages": [{"role": "user", "content": words(512)}]}),
    ("streaming, 64 tokens", {"model": model, "max_tokens": 64, "stream": True,
                              "stream_options": {"include_usage": True},
                              "messages": [{"role": "user", "content": words(300)}]}),
    ("1500-word prompt (> XOT_PREFILL_CHUNK 1024), 32 tokens",
     {"model": model, "temperature": 0, "max_tokens": 32,
      "messages": [{"role": "user", "content": words(1500)}]}),
  ]

  async def drive():
    server = await api.start("127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    loop = asyncio.get_running_loop()
    try:
      t0 = time.perf_counter()
      await engine.ensure_shard(build_full_shard(model, classname))
      print(f"[main] {model} loaded (random {engine.dtype} weights on {device}) in "
            f"{time.perf_counter() - t0:.1f} s", flush=True)
      health = await loop.run_in_executor(None, http_json, base + "/healthcheck")
      listed = await loop.run_in_executor(None, http_json, base + "/v1/models")
      if health.get("status") != "ok" or model not in [m["id"] for m in listed["data"]]:
        raise AssertionError(f"main: healthcheck {health} / models {listed}")
      # Warm-up: each request once with 2 tokens, so the measured run below pays no
      # first-use costs (lazy CUDA module loading, cuBLAS heuristics per shape).
      t0 = time.perf_counter()
      for _, body in requests:
        warm = {**body, "max_tokens": 2, "stream": False}
        await loop.run_in_executor(None, http_json, base + "/v1/chat/completions", warm)
      print(f"[main] warm-up: 3 requests in {time.perf_counter() - t0:.2f} s", flush=True)
      flash_attention.launches = 0
      flash_cached_attention.launches = 0
      decoded = 0
      for label, body in requests:
        url = base + "/v1/chat/completions"
        t0 = time.perf_counter()
        if body.get("stream"):
          events, first, last = await loop.run_in_executor(None, http_stream, url, body)
          usage = events[-1].get("usage") or {}
          finish = [c["finish_reason"] for e in events for c in e.get("choices", [])
                    if c.get("finish_reason")]
          n = usage.get("completion_tokens", 0)
          rate = (n - 1) / (last - first) if n > 1 and last > first else float("nan")
          timing = f"TTFT {first * 1e3:.1f} ms, decode {rate:.1f} tok/s"
        else:
          resp = await loop.run_in_executor(None, http_json, url, body)
          n = resp["usage"]["completion_tokens"]
          finish = [resp["choices"][0]["finish_reason"]]
          timing = f"end to end {(time.perf_counter() - t0) * 1e3:.1f} ms"
        want = body["max_tokens"]
        ok = n == want and finish == ["length"]
        print(f"[main] {label}: {n} tokens, finish {finish}, {timing} ({card}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
          raise AssertionError(f"main: {label} returned {n} tokens ({finish}), wanted {want}")
        decoded += n - 1  # the first token comes from the prefill
      counts = (decoded, flash_attention.launches, flash_cached_attention.launches)
      await profile_decode(torch, engine, model, classname, card)
      return counts
    finally:
      server.close()
      await server.wait_closed()
      await node.stop()

  decoded, k1, k2 = asyncio.run(drive())
  engine.executor.shutdown(wait=True)
  layers = get_model_card(model)["layers"]
  print(f"[main] launches: flash_attention {k1}, flash_cached_attention {k2} "
        f"({decoded} decoded tokens x {layers} layers = {decoded * layers})", flush=True)
  if k1 < 3 * layers or k2 < layers * decoded:
    raise AssertionError(f"main: kernel launches too few (K1 {k1}, K2 {k2})")
  return {"flash_attention": k1, "flash_cached_attention": k2}


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--kernels-only", action="store_true",
                      help="stop after holding the kernels against their plain versions")
  args = parser.parse_args(argv)

  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
    return 2
  if not os.path.isdir(os.path.join(ROOT, "xotorch_tpu_torch", "csrc")):
    print(f"chip_smoke: no xotorch_tpu_torch package beside {__file__}", file=sys.stderr)
    return 2
  sys.path.insert(0, ROOT)

  # Phase 1: device.
  card = smi_line()
  print(card, flush=True)
  print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  # Phase 2: build.
  from xotorch_tpu_torch.ops import _build
  secs = _build.load_all(verbose=True)
  print(f"build: {secs:.1f} s for {', '.join(_build.KERNELS)}", flush=True)

  # Phase 3: kernels against their plain versions.
  results: dict = {}
  check_kernels(torch, results)
  if args.kernels_only:
    print(f"kernels ok on {card}", flush=True)
    return 0

  # Phase 4: the model through the kernels against the plain path.
  check_model(torch)

  # Phase 5: the main path, with the launch counters read around it.
  launches = drive_main_path(torch, card)

  # Phase 6: results.
  meta = {
    "flash_attention": ("xotorch_tpu_torch/csrc/flash_attention.cu",
                        "xotorch_tpu/ops/flash_attention.py:54"),
    "flash_cached_attention": ("xotorch_tpu_torch/csrc/flash_decode.cu",
                               "xotorch_tpu/ops/flash_decode.py:62"),
  }
  kernels = []
  for name, (source, replaces) in meta.items():
    r = results[name]
    kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
