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
     the plain version and torch's scaled_dot_product_attention as a yardstick (the
     paged kernels K3/K4 over shuffled page tables, page 128); their int8-cache
     variants K2q, K3q and K4q at the same cases over K/V quantized with the port's
     quantizer, rows' scales spread over 64x, each also bit for bit against its bf16
     twin over the dequantized operands (SDPA over that view as the yardstick); the quantized
     GEMVs K5, K5v4 and K6 at the four projection shapes, rows 1 and 8, with one bf16
     torch.matmul over the pre-dequantized weight as their yardstick; then K1, K4 and
     K4q at the edges of their tensor-core tiles (T off the 16-row tile, groups 1 and
     8, K1 at D 32 and under each XOT_FLASH_BLOCK_Q/_K setting, K4 segments from
     mid-page, window edges mid-tile), and K2, K2q, K3 and K3q at the edges of their
     split-K decode plan (lengths 1, a split -1..+2 and S, windows that empty whole
     splits, B=8 at lengths 1-4095, D 16-128, groups 1-16, pages 16 and 128), with each
     wrapper run once under torch.cuda.set_sync_debug_mode("error"), correctness and
     the int8 twins' bit identity only; then K5, K5v4 and K6 beyond the main path
     (check_gemv_edges: llama-3.1-8B's and 70B's projections, ragged column tiles and
     k-steps, one group, K5 and K5v4 at groups of 32 and 64 values where splits cut
     groups, rows 1, 3 and 8), repeated calls identical, K6's outputs that differ from
     its plain version counted, and each GEMV wrapper once under
     set_sync_debug_mode("error"). The softcapped, windowed cases (K1w, K2qw, K3w, K3q)
     are timed beside one compiled flex_attention call, held against the plain version
     first. Every attention case runs through one case body (attention_case). Then
     the attention kernels at gemma-2-2b's widths (check_gemma_kernels: Hq 8, Hkv 4,
     D 256, window 4096, softcap 50, scale 1/16, queries scaled by 8 so that scores
     reach the softcap): K1/K1w at T 1024 and 4608, K2/K2w/K2q decoding at S 8192
     from 4500 and a 512-query segment, K3/K3w/K3q and K4/K4w/K4q at page 128, each
     held within 2^-6 of its largest |output| and timed beside its plain version, its
     bound and one compiled flex_attention (SDPA without a softcap), with controls:
     the kernel run with its softcap or its window dropped must miss that limit; every
     kernel at D 256 and D 32 with scale 0.1 (a dropped scale a control too), pages 16
     and 128; each D 256 wrapper once under set_sync_debug_mode("error");
  4. model: a two-layer cut of synthetic-llama-1b at full width, prefill and decode
     through the kernels in bf16 on the card against the plain path in fp32 on the
     CPU: contiguous (K1, K2), then paged (K4 prefill, K3 decode at B=3), then with
     int4 weights through K5 and K5v4 and int8 weights through K6, each kernel call
     also held against its plain version on its own inputs, and a control with one
     group of every contraction dropped that the limit must catch; then with an int8
     KV cache, contiguous (K1, K2q) and paged (K4q, K3q), every K2q/K3q/K4q call held
     against its plain version, and a control with the K and V scales swapped;
  5. main path: the port's server (main.py) serving synthetic-llama-1b at full width
     and depth answers three /v1/chat/completions requests over HTTP, with K1's and
     K2's launch counters read around that run, then one decode under the profiler;
  6. concurrent, paged: a fresh server with XOT_PAGED_KV=1 answers eight concurrent
     streaming requests (64-2000 words, 64 tokens each) through the batcher and the
     page pool: per-request TTFT and decode rate, aggregate tok/s, batch widths, K3's
     and K4's launches against decode steps and prefill segments, pool pages (0 left
     in use), then one B=8 decode chunk under the profiler;
  7. concurrent, contiguous: the same with XOT_PAGED_KV=0 (stacked caches, K1/K2),
     and the share of greedy tokens that agree with the paged phase;
  8. quantized serving: fresh servers with XOT_QUANTIZE=int4 (K5), int4 with
     XOT_INT4_V=4 (K5v4) and int8 with XOT_INT8_KERNEL=1 (K6) answer the main path's
     three requests, each kernel's launches equal to 7 projections x 16 layers x the
     decode steps; each then decodes 32 steps at B=1 and B=8 under the profiler (one
     device kernel in the trace for each call of the wrapper), as
     does the engine alone on the int8 default path (no kernel); then the concurrent
     paged phase's eight requests with int4 weights (K5 launches against decode
     steps), one projection's host time by route, and the five formats' B=1 decode
     steps taken in turn, with bf16 weights over an int8 KV cache as a sixth;
  9. int8 KV cache: a fresh server with --kv-quantize int8 answers the main path's
     three requests (K1 = 16 x fresh prefills, K2q = 16 x (decode steps + segments at
     pos > 0), no K2), decodes 32 steps at B=1 and B=8 under the profiler beside bf16
     (the kernels a step the quantizing writes add), then the eight concurrent
     requests on an int8 page arena (K4q, K3q launches against segments and steps,
     0 pages left, bytes a token against bf16's);
  10. ring, one process: two Nodes (main.build_node, manual discovery, the TCP
     transport on 127.0.0.1), each with its own engine on the card, serve
     synthetic-llama-1b split 8/8 and answer the main path's three requests through
     process_prompt: temperature-0 tokens equal to phase 5's, K1 = 16 x fresh
     prefills and K2 = 16 x (decode steps + segments at pos > 0) summed over both
     engines, every hidden-state hop bfloat16 at 2 x T x 2048 bytes; TTFT, decode
     rate, hop times and wire bytes a decode step;
  11. ring, two processes: two `python -m xotorch_tpu_torch.main` peers with a manual
     config naming both and --wait-for-peers 1; the three requests go to the API of
     the peer holding layers 8-15 (each prompt forwarded to layers 0-7's owner) and
     the first also to the other peer's; temperature-0 streams equal to phase 5's
     (read from the sampler peer's DEBUG=2 log; the other runs at DEBUG=1), TTFT and
     decode rate beside phase 5's (DEBUG=0), SendTensor frames a decode step; both
     children stopped, exit 0, none left;
  12. gemma-2-2b from a checkpoint on disk: a gemma-2-2b-shaped HF checkpoint (the
     published config.json of google/gemma-2-2b, seeded random bf16 weights written by
     the port's save_shard_params as two safetensors files and an index, 5.2 GB, and a
     word-level tokenizer) in a temporary seed directory; a two-layer cut of it (layer 0
     windowed, layer 1 global) read by load_shard_params, a 4200-token prefill (past
     the 4096 window) and 4 decode steps through K1/K1w and K2/K2w in bf16 on the card
     against the plain path in fp32 on the CPU (the last 64 positions' logits and each
     step's); then the port's server started with --models-seed-dir (seeding XOT_HOME,
     then the downloader's offline fast path) serving gemma2-2b at full width and
     depth answers the main path's three requests and a 4100-word prompt (its prompt
     and generation pass 4096 positions): K1 = 26 x prefills from 0 outside the scan,
     K2 = 26 x (decode steps + segments at pos > 0 + every scanned segment), half of
     each windowed, TTFT and decode rate, a B=1
     decode chunk under the profiler; the same on a fresh server with XOT_PAGED_KV=1 (K4 = 26 x segments, K3 = 26 x decode
     steps, half windowed, 0 pages left) and the share of temperature-0 tokens the two
     servers agree on; the 4100-word prompt's four leading whole segments go through
     one prefill_scan group (K2, or K4 paged), its last segment through
     forward_sample; the checkpoint deleted at the end;
  13. fused decode: every serving phase above decodes through CUDA-graph replays of one
     captured step (models/graphs.py) and prefills a long prompt's leading whole
     segments through captured prefill_scan groups; this phase holds those programs
     against the eager body (models/generate) on synthetic-llama-1b at full width and
     depth in the five decode formats (bf16, int4 K5, int4 K5v4, int8 K6, bf16 over an
     int8 KV cache) and gemma-2-2b's shape in bf16: 64 graph-replayed steps give the
     eager body's tokens and cache bit for bit at B=1 and B=8 (gemma B=1), contiguous
     (K2/K2q) and paged (K3/K3q), at temperature 0, and with injected Gumbel noise (B=8
     contiguous in every format, paged in bf16; gemma both), the kernels' counters
     reading layers x steps (7 x layers x steps for a GEMV kernel) for the replays;
     then eager against graph, 4 rounds in turn (contiguous B=1 and B=8 in every
     format, paged in bf16, gemma B=1 both): wall ms, device ms and the idle share a
     step, device kernels a step; two fresh graph caches with generators seeded alike
     sampling the same tokens (another seed others); the slab copies' device time; the
     captures, their seconds and the graph pool and slab bytes; a 4096-token prompt
     through prefill_scan against the per-segment loop (hidden states within
     PREFILL_REL_LIMIT) and the engine's TTFT with XOT_SCAN_PREFILL 1 and 0;
  14. sampling extras: OpenAI's seed, logit_bias, presence/frequency penalties,
     min_p, logprobs, stop and n over HTTP on fresh synthetic-llama-1b servers at full
     width and depth (check_sampling_extras): a ban of -100 moves the temperature-0
     first token and +100 on one id makes every token that id; min_p 1 gives the greedy
     stream (parting only where another token's bf16 logit ties the top one); 16 greedy tokens' logprobs and top 5 within 2e-2 of fp32 log-softmax of the
     eager forward's logits; seed 7 reproduces its stream on the same server (the seeded
     graph's generator re-seeded between replays) and on a fresh one, seed 8 and an n 2
     sibling differ; a stop string from the greedy stream with frequency_penalty 2 cuts
     that answer before it (finish "stop", decode steps under max_tokens); plain n 4 coalesces in the batcher;
     frequency_penalty 2 runs on the paged server (K4, K3); graph replays equal the eager
     decode_chunk from the same counts bit for bit over two ladder chunks, contiguous and
     paged; TPOT of an extras request against a plain one at B=1 in turns, the device ms
     the extras add to a step, the captures they add. (Phase 12's gemma-2-2b server
     answers one request with logprobs 3 and a logit_bias, held against the log-softmax
     of its softcapped logits.)
  15. the {"kernels": [...]} line (attention launches include phases 12's and 14's),
     then the {"ok": true, ...} line last.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

HQ, HKV, D = 32, 8, 64  # synthetic-llama-1b attention widths
ATOL = 2e-2  # bf16 output rounding (2^-8 relative on |o| <= ~2) plus the plain
             # version's bf16 cast of the probabilities before P.V


def smi_line() -> str:
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase_env(**env):
  """Set XOT_* knobs for one phase and restore the environment after it."""
  saved = {k: os.environ.get(k) for k in env}
  os.environ.update(env)
  try:
    yield
  finally:
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v


_L2_FLUSH = []


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
  """Mean device time of one call, from CUDA events around each call, with the
  50 MB L2 flushed before each: on the main path a layer's operands arrive cold,
  after the rest of the model's weights have streamed through. A short spin on the
  card after the flush keeps it busy while the host enqueues the call, so a kernel
  of a few microseconds is not timed with the host's launch latency. The garbage
  collector is off while the calls are issued: a collection that outlasts the spin
  (more likely after a compile) would put the host's pause inside one timed call."""
  import torch
  if not _L2_FLUSH:
    _L2_FLUSH.append(torch.empty(64 << 20, dtype=torch.uint8, device="cuda"))
  for _ in range(warmup):
    fn()
  events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(iters)]
  gc.disable()
  try:
    for start, end in events:
      _L2_FLUSH[0].zero_()
      torch.cuda._sleep(1_000_000)  # ~0.5 ms at the H100's clock
      start.record()
      fn()
      end.record()
    torch.cuda.synchronize()
  finally:
    gc.enable()
  return sum(start.elapsed_time(end) for start, end in events) / iters


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
  t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
  return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def report(name, case, out, ref, ms, plain_ms, lib_ms, b_ms, b_by, limit=ATOL):
  err = (out.float() - ref.float()).abs().max().item()
  rel = err / max(ref.float().abs().max().item(), 1e-12)
  ok = math.isfinite(err) and err <= limit
  print(f"[{name}] {case}: max_abs_err={err:.3e} max_rel_err={rel:.3e} (limit {limit:.3e}) "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
        f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{name} {case}: kernel disagrees with its plain version ({err})")
  return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": b_ms, "bound_by": b_by}


def flex_ms(torch, case, q, k, v, q_pos, lens, window, softcap, ref, scale=None, limit=ATOL):
  """The library time of a softcapped case: one torch.compile'd flex_attention call (a
  yardstick the port never calls) over q [B, T, Hq, D] and bf16 K/V [B, S, Hkv, D],
  with softcap * tanh(score / softcap) as its score_mod and the keys in
  (p - window, p] below each row's length `lens` as its block mask, GQA, at `scale`
  (None: 1/sqrt(D)). The block mask, the compile and a check of the output against
  `ref` (the kernel's plain version) within `limit` stay outside the timed window."""
  from torch.nn.attention.flex_attention import create_block_mask, flex_attention
  B, T, S = q.shape[0], q.shape[1], k.shape[1]

  def score_mod(score, b, h, qi, ki):
    return torch.tanh(score / softcap) * softcap

  def mask_mod(b, h, qi, ki):
    p = q_pos[b, qi]
    return (ki <= p) & (ki > p - window) & (ki < lens[b])

  mask = create_block_mask(mask_mod, B, None, T, S, device="cuda")
  torch._dynamo.reset()  # a fresh compile per case: past 8 shapes dynamo would run it eager
  fn = torch.compile(flex_attention, dynamic=False)
  qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
  call = lambda: fn(qt, kt, vt, score_mod=score_mod, block_mask=mask, scale=scale,
                    enable_gqa=True)
  check_only("flex_attention", case, call().transpose(1, 2), ref, limit)
  return time_ms(call)


def sdpa_ms(torch, q, k, v, q_pos, lens, window, scale=None, causal=False):
  """The library time of a case without a softcap: one scaled_dot_product_attention
  call (a yardstick the port never calls) over bf16 K/V [B, S, Hkv, D], is_causal for
  a segment over its own keys from position 0, else masked to the keys each query at
  q_pos [B, T] sees below its row's length `lens`."""
  import torch.nn.functional as F
  qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
  if causal:
    return time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale,
                                                          enable_gqa=True))
  kv = torch.arange(k.shape[1], device=q.device)
  mask = (kv[None, None, :] <= q_pos[:, :, None]) & (kv[None, None, :] < lens[:, None, None])
  if window:
    mask = mask & (kv[None, None, :] > q_pos[:, :, None] - window)
  m = mask[:, None]
  return time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, scale=scale,
                                                        enable_gqa=True))


class Widths(NamedTuple):
  """A model's attention widths for the kernel cases. `scale` None is the kernels'
  default, 1/sqrt(D). `q_mul` scales the queries so that scores reach a softcap.
  `strict` holds each case to rel_limit instead of ATOL and runs its controls."""
  hq: int
  hkv: int
  d: int
  tag: str = ""
  scale: Optional[float] = None
  q_mul: float = 1.0
  strict: bool = False

  def queries(self, q):
    return q if self.q_mul == 1.0 else (q.float() * self.q_mul).to(q.dtype)

  def controls(self, window: int, softcap: float):
    """(feature, overrides): the kernel run with that feature dropped, which a strict
    case must tell from its plain version."""
    out = [("softcap", {"softcap": 0.0})] if softcap else []
    if window:
      out.append(("window", {"window": 0}))
    if self.scale is not None and self.scale != self.d ** -0.5:
      out.append(("scale", {"scale": None}))
    return out


LLAMA_1B = Widths(HQ, HKV, D)


def rel_limit(ref) -> float:
  """A strict case's limit: 2^-6 of the largest |output|, four bf16 steps at the top
  of the output's range (the kernels read at most 2^-7.1 of it). It follows the
  outputs where ATOL's |o| <= ~2 does not hold: a decode over 4000 keys of unit
  normals reads |o| <= 0.1, a peaked softmax up to the largest |v|."""
  return 2.0 ** -6 * ref.float().abs().max().item()


def attention_case(torch, w, name, case, call, ref_call, q, view, q_pos, lens, window,
                   softcap, row_bytes, twin=None, timed=True, causal=False):
  """One attention-kernel case. `call(**overrides)` launches the kernel and `ref_call()`
  runs its plain version on the same inputs; the output is held within ATOL, or within
  rel_limit for strict widths, whose controls (the kernel with its softcap, window or
  non-default scale dropped, Widths.controls) must each miss that limit. An int8 case's
  output also equals `twin()`, its bf16 twin over the dequantized operands, bit for bit.
  A timed case adds the kernel's and the plain version's times, the library yardstick
  (flex_ms with a softcap, else sdpa_ms, over `view`, the bf16 K/V [B, S, Hkv, D]) and
  the bound from the keys each query at q_pos [B, T] sees and the cache rows that
  covers (`row_bytes` a row), and returns report's dict."""
  out = call()
  torch.cuda.synchronize()
  ref = ref_call()
  limit = rel_limit(ref) if w.strict else ATOL
  if w.strict:
    for label, over in w.controls(window, softcap):
      err = (call(**over).float() - ref.float()).abs().max().item()
      ok = err > limit
      print(f"[{name}] {case}: control, {label} dropped: max_abs_err={err:.3e} (limit "
            f"{limit:.3e}) {'misses it, as it must' if ok else 'FAIL: within it'}", flush=True)
      if not ok:
        raise AssertionError(f"{name} {case}: a kernel with its {label} dropped passes")
  if twin is not None:
    same = torch.equal(out, twin())
    print(f"[{name}] {case}: bit-identical to its bf16 twin over the dequantized operands: "
          f"{same}", flush=True)
    if not same:
      raise AssertionError(f"{name} {case}: differs from its bf16 twin over the dequantized "
                           "operands (a scale or code read from the wrong place)")
  if not timed:
    check_only(name, case, out, ref, limit)
    return None
  ms = time_ms(call)
  plain_ms = time_ms(ref_call, iters=5)
  k, v = view
  if softcap:
    lib = flex_ms(torch, f"{name} {case}", q, k, v, q_pos, lens, window or (1 << 30), softcap,
                  ref, w.scale, limit)
  else:
    lib = sdpa_ms(torch, q, k, v, q_pos, lens, window, w.scale, causal)
  qp = q_pos.long().cpu()
  seen = (qp + 1).clamp(max=window) if window else qp + 1
  first = (qp[:, 0] - window + 1).clamp(min=0) if window else 0
  rows = (qp[:, -1] + 1 - first).sum().item()
  b_ms, b_by = bound(4.0 * w.hq * w.d * seen.sum().item(), 2.0 * 2 * q.numel() + rows * row_bytes)
  return report(name, case, out, ref, ms, plain_ms, lib, b_ms, b_by, limit)


def k1_case(torch, w, draw, B, T, window, softcap, timed=True):
  """K1 (flash_attention): B rows of T positions from 0 over their own K/V."""
  from xotorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
  q, k, v = w.queries(draw(B, T, w.hq, w.d)), draw(B, T, w.hkv, w.d), draw(B, T, w.hkv, w.d)
  kw = dict(window=window, softcap=softcap, scale=w.scale)
  q_pos = torch.arange(T, device=q.device)[None].expand(B, T)
  return attention_case(torch, w, "flash_attention",
                        f"{w.tag}B={B} T={T} window={window} softcap={softcap}",
                        lambda **o: flash_attention(q, k, v, **{**kw, **o}),
                        lambda: flash_attention_ref(q, k, v, **kw), q, (k, v), q_pos,
                        torch.full((B,), T, device=q.device), window, softcap,
                        4.0 * w.hkv * w.d, timed=timed, causal=not window)


def k2_case(torch, w, draw, gen, B, T, S, starts, window, softcap, int8=False, timed=True):
  """K2 (flash_cached_attention), or K2q over the cache quantized with spread_quantize
  and `gen`: row b's T queries from q_start starts[b] over an S-slot cache."""
  from xotorch_tpu_torch.ops.flash_decode import (dequantize_kv, flash_cached_attention,
                                                  flash_cached_attention_ref)
  q, kc, vc = w.queries(draw(B, T, w.hq, w.d)), draw(B, S, w.hkv, w.d), draw(B, S, w.hkv, w.d)
  q_start = torch.tensor(starts, dtype=torch.int32, device=q.device)
  kw = dict(window=window, softcap=softcap, scale=w.scale)
  name, view, twin, row_bytes = "flash_cached_attention", (kc, vc), None, 4.0 * w.hkv * w.d
  if int8:
    (kc, ks), (vc, vs) = spread_quantize(torch, gen, kc), spread_quantize(torch, gen, vc)
    kw.update(k_scale=ks, v_scale=vs)
    view = dequantize_kv(kc, vc, ks, vs, torch.bfloat16)
    twin = lambda: flash_cached_attention(q, *view, q_start, window=window, softcap=softcap,
                                          scale=w.scale)
    name, row_bytes = "flash_cached_attention_int8", 2.0 * w.hkv * (w.d + 2)
  q_pos = q_start.long()[:, None] + torch.arange(T, device=q.device)[None]
  case = (f"{w.tag}B={B} T={T} S={S} q_start={starts if B == 1 else 'varied'} window={window} "
          f"softcap={softcap}")
  return attention_case(torch, w, name, case,
                        lambda **o: flash_cached_attention(q, kc, vc, q_start, **{**kw, **o}),
                        lambda: flash_cached_attention_ref(q, kc, vc, q_start, **kw), q, view,
                        q_pos, q_pos[:, -1] + 1, window, softcap, row_bytes, twin, timed)


def paged_case(torch, w, draw, gen, lengths, page, T, window, softcap, int8=False, timed=True):
  """K3 (paged_decode_attention, T == 1) or K4 (paged_prefill_attention), or K3q/K4q
  over the arena quantized with spread_quantize and `gen`: row b holds lengths[b]
  positions on shuffled pages of `page` slots, its last T the queries."""
  from xotorch_tpu_torch.ops.flash_decode import dequantize_kv
  from xotorch_tpu_torch.ops.paged_attention import (gather_paged_view, paged_decode_attention,
                                                     paged_decode_attention_ref,
                                                     paged_prefill_attention,
                                                     paged_prefill_attention_ref)
  q, kp, vp, table, lens = paged_inputs(torch, draw, lengths, page, w.hq, w.hkv, w.d, T=T)
  q = w.queries(q)
  fn, ref_fn = ((paged_decode_attention, paged_decode_attention_ref) if T == 1
                else (paged_prefill_attention, paged_prefill_attention_ref))
  kw = dict(window=window, softcap=softcap, scale=w.scale)
  name, twin, row_bytes = fn.__name__, None, 4.0 * w.hkv * w.d
  if int8:
    (kp, ks), (vp, vs) = spread_quantize(torch, gen, kp), spread_quantize(torch, gen, vp)
    kw.update(k_scale_pages=ks, v_scale_pages=vs)
    twin = lambda: fn(q, *dequantize_kv(kp, vp, ks, vs, torch.bfloat16), table, lens,
                      window=window, softcap=softcap, scale=w.scale)
    name, row_bytes = name + "_int8", 2.0 * w.hkv * (w.d + 2)
  view = gather_paged_view(kp, vp, table, kw.get("k_scale_pages"), kw.get("v_scale_pages"),
                           torch.bfloat16)
  q_pos = (lens.long() - T)[:, None] + torch.arange(T, device=q.device)[None]
  shown = lengths if len(lengths) <= 3 else f"{lengths[0]}-{lengths[-1]}"
  case = (f"{w.tag}B={len(lengths)} T={T} lengths={shown} page={page} window={window} "
          f"softcap={softcap}")
  return attention_case(torch, w, name, case,
                        lambda **o: fn(q, kp, vp, table, lens, **{**kw, **o}),
                        lambda: ref_fn(q, kp, vp, table, lens, **kw), q, view, q_pos, lens,
                        window, softcap, row_bytes, twin, timed)


def check_kernels(torch, results: dict) -> None:
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention, flash_cached_attention_ref

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)

  def randn(*shape):
    return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)
  seg_randn = seeded_randn(torch, SEGMENT_SEED)

  # K1: prefill from position 0. T=1024 is the main path's first segment below.
  for T, window, softcap in ((512, 0, 0.0), (1024, 0, 0.0), (2048, 0, 0.0), (2048, 256, 50.0)):
    r = k1_case(torch, LLAMA_1B, randn, 1, T, window, softcap)
    if T == 1024 and not window:
      results["flash_attention"] = r

  # K2: decode steps and a chunked-prefill segment over a resident cache.
  # (B, T, S, q_start per row, window); the first case is the main path's decode shape.
  cases = (
    (1, 1, 2048, [640], 0),
    (1, SEGMENT_T, 2048, [1024], 0),  # the main path's second segment (see SEGMENT_T)
    (1, 1, 4096, [4000], 0),
    (8, 1, 4096, [17, 300, 1023, 1024, 2047, 2500, 3333, 4095], 0),
    (1, 64, 4096, [1000], 0),
    (8, 1, 4096, [17, 300, 1023, 1024, 2047, 2500, 3333, 4095], 512),
    (1, 64, 4096, [1000], 256),
  )
  for B, T, S, starts, window in cases:
    draw = seg_randn if T == SEGMENT_T else randn
    r = k2_case(torch, LLAMA_1B, draw, None, B, T, S, starts, window, 0.0)
    if (B, T, S, window) == (1, 1, 2048, 0):
      results["flash_cached_attention"] = r
  # K2's segment rows a block (XOT_FD_BLOCK_Q, 64 or 128) at the main path's second segment.
  q, kc, vc = seg_randn(1, SEGMENT_T, HQ, D), seg_randn(1, 2048, HKV, D), seg_randn(1, 2048, HKV, D)
  q_start = torch.tensor([1024], dtype=torch.int32, device=dev)
  ref = flash_cached_attention_ref(q, kc, vc, q_start)
  for block_q in (64, 128):
    with phase_env(XOT_FD_BLOCK_Q=str(block_q)):
      call = lambda: flash_cached_attention(q, kc, vc, q_start)
      case = f"XOT_FD_BLOCK_Q={block_q} T={SEGMENT_T} S=2048 q_start=[1024]"
      check_only("flash_cached_attention", case, call(), ref)
      print(f"[flash_cached_attention] {case}: ms={time_ms(call):.4f}", flush=True)

  check_paged_kernels(torch, results, randn)
  check_int8_kv_kernels(torch, results, randn)
  check_tile_edges(torch, randn)
  check_split_edges(torch, randn)

  # The other head widths the kernels are built for, at the registry's other
  # llama shapes (synthetic-llama-8b: D 128; synthetic-tiny: Hq 4, Hkv 2, D 16),
  # with ragged lengths, windows and softcaps: correctness only.
  for hq, hkv, d in ((32, 8, 128), (4, 2, 16)):
    w = Widths(hq, hkv, d, f"Hq={hq} Hkv={hkv} D={d} ")
    for T, window, softcap in ((300, 0, 0.0), (300, 64, 30.0)):
      k1_case(torch, w, randn, 2, T, window, softcap, timed=False)
    for T, starts, window in ((1, [0, 200, 511], 0), (20, [100, 37, 400], 50)):
      k2_case(torch, w, randn, None, 3, T, 512 + 32, starts, window, 20.0, timed=False)


# The 1502-token request's second segment on the main path (XOT_PREFILL_CHUNK 1024):
# T=478 at q_start 1024, timed for K2 and K2q. Its inputs come from a generator of
# their own, so the cases drawn after it keep the inputs of runs before it was added
# (the absolute ATOL assumes |o| <= ~2, and other draws can put one output in [4, 8),
# where a bf16 step is 2^-5).
SEGMENT_T, SEGMENT_SEED = 478, 478


def seeded_randn(torch, seed: int):
  """A bf16 standard-normal sampler on the card over a generator seeded with `seed`."""
  gen = torch.Generator(device="cuda")
  gen.manual_seed(seed)
  return lambda *shape: torch.randn(*shape, generator=gen, device="cuda",
                                    dtype=torch.float32).to(torch.bfloat16)


def paged_inputs(torch, randn, kv_rows, page, hq, hkv, d, T=1):
  """One layer's arena [P, page, Hkv, D] whose rows' pages are shuffled across it (page
  0, the scratch page, holds garbage too), the int32 page table and row lengths, and
  q [B, T, Hq, D]. kv_rows[b] is row b's occupied length."""
  B = len(kv_rows)
  maxp = max(-(-n // page) for n in kv_rows)
  P = sum(-(-n // page) for n in kv_rows) + 8
  perm = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(P)) + 1).tolist()
  table = torch.zeros(B, maxp, dtype=torch.int32)
  used = 0
  for b, n in enumerate(kv_rows):
    k = -(-n // page)
    table[b, :k] = torch.tensor(perm[used:used + k], dtype=torch.int32)
    used += k
  q, kp, vp = randn(B, T, hq, d), randn(P, page, hkv, d), randn(P, page, hkv, d)
  return (q, kp, vp, table.to(q.device),
          torch.tensor(kv_rows, dtype=torch.int32, device=q.device))


def check_paged_kernels(torch, results: dict, randn) -> None:
  """K3 and K4 at synthetic-llama-1b widths (page 128) over shuffled page tables
  against their plain versions, timed beside one SDPA call over a pre-gathered
  contiguous view (the gather excluded), or one compiled flex_attention with a
  softcap; then the other head widths and page 16."""
  # K3: decode steps. (lengths per row, window, softcap); the second case is the
  # concurrent phase's shape (eight rows at ragged depths).
  ragged = [100, 300, 700, 1000, 1500, 2200, 3000, 4000]
  for lengths, window, softcap in (([640], 0, 0.0), (ragged, 0, 0.0), (ragged, 512, 50.0)):
    r = paged_case(torch, LLAMA_1B, randn, None, lengths, 128, 1, window, softcap)
    if lengths is ragged and not window:
      results["paged_decode_attention"] = r

  # K4: prefill segments. (T, kv_valid per row, window); the first is the concurrent
  # phase's first segment of a long prompt.
  for T, valid, window in ((1024, [1024], 0), (512, [1536], 0), (300, [700, 1900], 0),
                           (512, [1536], 256)):
    r = paged_case(torch, LLAMA_1B, randn, None, valid, 128, T, window, 0.0)
    if (T, window) == (1024, 0):
      results["paged_prefill_attention"] = r

  # The other head widths (synthetic-llama-8b: D 128; synthetic-tiny: Hq 4, Hkv 2,
  # D 16) at both page sizes, with windows and softcaps: correctness only.
  for hq, hkv, d in ((32, 8, 128), (4, 2, 16)):
    w = Widths(hq, hkv, d, f"Hq={hq} Hkv={hkv} D={d} ")
    for pg in (16, 128):
      for window, softcap in ((0, 0.0), (50, 20.0)):
        paged_case(torch, w, randn, None, [1, 200, 511], pg, 1, window, softcap, timed=False)
        paged_case(torch, w, randn, None, [20, 137, 420], pg, 20, window, softcap, timed=False)


def spread_quantize(torch, gen, x):
  """x [..., Hkv, D] with each (position, head) row scaled by 2^u, u uniform in [-6, 0]
  (so the rows' scales spread over 64x), quantized as the engine writes an int8 cache:
  (codes, bf16 scales)."""
  from xotorch_tpu_torch.models.transformer import _quantize_kv
  u = torch.rand(*x.shape[:-1], 1, generator=gen, device=x.device)
  return _quantize_kv(x * torch.exp2(-6.0 * u).to(x.dtype), torch.bfloat16)


def check_int8_kv_kernels(torch, results: dict, randn) -> None:
  """K2q, K3q and K4q at K2's, K3's and K4's cases over random bf16 K/V quantized
  with the port's quantizer, against their plain versions (dequantize, then attend)
  on the same inputs at ATOL; timed beside one SDPA call over the pre-dequantized
  bf16 view (a yardstick the port never calls). Bound bytes: the visible rows' int8
  codes and bf16 scales, q and o. Each (position, head) row of K and V is first
  scaled by its own 2^u, u uniform in [-6, 0], so the rows' scales spread over 64x
  and a scale read from another row or head changes the result; values stay within
  the unit normal's, so ATOL's bf16 reasoning holds. Every case is also held, bit
  for bit, against its bf16 twin (K2, K3, K4) over the cache or arena dequantized
  beforehand: the int8 kernels stage code x scale rounded once to bf16, the value
  the twin reads, and then run the twin's arithmetic. Then the other head widths and
  page 16, correctness and bit identity only."""
  gen = torch.Generator(device="cuda")
  gen.manual_seed(4)
  seg_gen = torch.Generator(device="cuda")
  seg_gen.manual_seed(SEGMENT_SEED)
  seg_randn = seeded_randn(torch, SEGMENT_SEED + 1)

  # K2q: the main path's decode shape first, then K2's other cases.
  varied = [17, 300, 1023, 1024, 2047, 2500, 3333, 4095]
  for B, T, S, starts, window, softcap in ((1, 1, 2048, [640], 0, 0.0),
                                           (1, SEGMENT_T, 2048, [1024], 0, 0.0),
                                           (8, 1, 4096, varied, 0, 0.0),
                                           (1, 64, 4096, [1000], 0, 0.0),
                                           (8, 1, 4096, varied, 512, 50.0)):
    draw, g = (seg_randn, seg_gen) if T == SEGMENT_T else (randn, gen)
    r = k2_case(torch, LLAMA_1B, draw, g, B, T, S, starts, window, softcap, int8=True)
    if (B, T, S, window) == (1, 1, 2048, 0):
      results["flash_cached_attention_int8"] = r

  # K3q: (lengths per row, window, softcap) at page 128; the second case is the
  # concurrent phase's shape.
  ragged = [100, 300, 700, 1000, 1500, 2200, 3000, 4000]
  for lengths, window, softcap in (([640], 0, 0.0), (ragged, 0, 0.0), (ragged, 512, 50.0)):
    r = paged_case(torch, LLAMA_1B, randn, gen, lengths, 128, 1, window, softcap, int8=True)
    if lengths is ragged and not window:
      results["paged_decode_attention_int8"] = r

  # K4q: (T, kv_valid per row, window); the first is the concurrent phase's first
  # segment of a long prompt.
  for T, valid, window in ((1024, [1024], 0), (512, [1536], 256)):
    r = paged_case(torch, LLAMA_1B, randn, gen, valid, 128, T, window, 0.0, int8=True)
    if (T, window) == (1024, 0):
      results["paged_prefill_attention_int8"] = r

  # The other head widths (synthetic-llama-8b: D 128; synthetic-tiny: Hq 4, Hkv 2,
  # D 16), both page sizes, windows and softcaps: correctness and bit identity only.
  for hq, hkv, d in ((32, 8, 128), (4, 2, 16)):
    w = Widths(hq, hkv, d, f"Hq={hq} Hkv={hkv} D={d} ")
    k2_case(torch, w, randn, gen, 3, 20, 544, [100, 37, 400], 50, 20.0, int8=True, timed=False)
    for pg in (16, 128):
      for window, softcap in ((0, 0.0), (50, 20.0)):
        paged_case(torch, w, randn, gen, [1, 200, 511], pg, 1, window, softcap, int8=True,
                   timed=False)
        paged_case(torch, w, randn, gen, [20, 137, 420], pg, 20, window, softcap, int8=True,
                   timed=False)


def check_tile_edges(torch, randn) -> None:
  """K1, K4 and K4q where their tiles cut the work: T off the 16-row mma tile (1, 15,
  17, 65), groups 1 (Hq = Hkv = 8), 8 (Hq 64, Hkv 8) and 3 (a 16-row tile splits a
  position), K1 at D 32, K4 segments that
  start mid-page at page 16 and 128, windows whose lower edge falls mid-tile, and K1
  under each of its four tile settings (XOT_FLASH_BLOCK_Q / _K in {64, 128}, timed at
  T=1024 as well). Correctness at ATOL against the plain versions; every K4q case also
  bit for bit against K4 over the dequantized arena."""
  from xotorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
  from xotorch_tpu_torch.ops.flash_decode import dequantize_kv
  from xotorch_tpu_torch.ops.paged_attention import (paged_prefill_attention,
                                                     paged_prefill_attention_int8,
                                                     paged_prefill_attention_ref)
  for hq, hkv, d in ((8, 8, 64), (64, 8, 64), (24, 8, 64), (16, 4, 32)):
    for T in (1, 15, 17, 65, 300):
      for window, softcap in ((0, 0.0), (37, 30.0)):
        q, k, v = randn(2, T, hq, d), randn(2, T, hkv, d), randn(2, T, hkv, d)
        out = flash_attention(q, k, v, window=window, softcap=softcap)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, window=window, softcap=softcap)
        check_only("flash_attention", f"Hq={hq} Hkv={hkv} D={d} B=2 T={T} window={window} "
                   f"softcap={softcap}", out, ref)
  for block_q in (64, 128):
    for block_k in (64, 128):
      with phase_env(XOT_FLASH_BLOCK_Q=str(block_q), XOT_FLASH_BLOCK_K=str(block_k)):
        for T, window, softcap in ((300, 37, 30.0), (1024, 0, 0.0)):
          q, k, v = randn(1, T, HQ, D), randn(1, T, HKV, D), randn(1, T, HKV, D)
          call = lambda: flash_attention(q, k, v, window=window, softcap=softcap)
          out = call()
          torch.cuda.synchronize()
          ref = flash_attention_ref(q, k, v, window=window, softcap=softcap)
          case = (f"XOT_FLASH_BLOCK_Q={block_q} XOT_FLASH_BLOCK_K={block_k} T={T} "
                  f"window={window} softcap={softcap}")
          check_only("flash_attention", case, out, ref)
          if T == 1024:
            print(f"[flash_attention] {case}: ms={time_ms(call):.4f}", flush=True)

  gen = torch.Generator(device="cuda")
  gen.manual_seed(5)
  for hq, hkv in ((8, 8), (64, 8), (24, 8)):
    for T in (1, 15, 17, 65):
      for pg in (16, 128):
        for window, softcap in ((0, 0.0), (37, 30.0)):
          valid = [T, T + 7, T + 250]  # segments from 0, and from mid-page
          q, kp, vp, table, lens = paged_inputs(torch, randn, valid, pg, hq, hkv, D, T=T)
          out = paged_prefill_attention(q, kp, vp, table, lens, window=window, softcap=softcap)
          torch.cuda.synchronize()
          ref = paged_prefill_attention_ref(q, kp, vp, table, lens, window=window,
                                            softcap=softcap)
          case = (f"Hq={hq} Hkv={hkv} D={D} page={pg} T={T} kv_valid={valid} window={window} "
                  f"softcap={softcap}")
          check_only("paged_prefill_attention", case, out, ref)
          (kq, ks), (vq, vs) = spread_quantize(torch, gen, kp), spread_quantize(torch, gen, vp)
          out8 = paged_prefill_attention_int8(q, kq, vq, ks, vs, table, lens, window=window,
                                              softcap=softcap)
          torch.cuda.synchronize()
          ref8 = paged_prefill_attention_ref(q, kq, vq, table, lens, window=window,
                                             softcap=softcap, k_scale_pages=ks, v_scale_pages=vs)
          check_only("paged_prefill_attention_int8", case, out8, ref8)
          twin = paged_prefill_attention(q, *dequantize_kv(kq, vq, ks, vs, torch.bfloat16), table,
                                         lens, window=window, softcap=softcap)
          if not torch.equal(out8, twin):
            raise AssertionError(f"paged_prefill_attention_int8 {case}: differs from K4 over "
                                 "the dequantized arena")
  print("[paged_prefill_attention_int8] tile edges: every case bit-identical to K4 over the "
        "dequantized arena", flush=True)


def check_split_edges(torch, randn) -> None:
  """K2, K2q, K3 and K3q where the split-K decode plan cuts the cache: rows whose
  length is 1, a split's keys -1, +0, +1 and +2, and S; the same under a window that
  leaves whole splits empty (with a softcap); B=8 at lengths 1 to 4095; head_dim 16,
  32 (K2), 64 and 128; q heads per kv head 1, 4 and 8, and 16 for K2; pages 16 and 128
  for K3. The splits come from the plan the wrappers use (flash_decode.split_plan, this
  card's SM count). Every case at ATOL against its plain version, and each int8 twin
  bit for bit against its bf16 twin over the dequantized operands. Then one call of
  each wrapper under torch.cuda.set_sync_debug_mode("error"): a wrapper that read a
  device tensor back to the host would raise."""
  from xotorch_tpu_torch.ops.flash_decode import (decode_blocks, dequantize_kv,
                                                  flash_cached_attention,
                                                  flash_cached_attention_int8,
                                                  flash_cached_attention_ref, split_plan)
  from xotorch_tpu_torch.ops.paged_attention import (SPLIT_KEYS, paged_decode_attention,
                                                     paged_decode_attention_int8,
                                                     paged_decode_attention_ref)
  dev = torch.device("cuda")
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  gen = torch.Generator(device=dev)
  gen.manual_seed(6)
  bf = torch.bfloat16

  def same(name, case, out8, twin):
    if not torch.equal(out8, twin):
      raise AssertionError(f"{name} {case}: differs from its bf16 twin over the dequantized "
                           "operands")

  def edges(B, hkv, S, max_keys):
    """The keys a split of the plan at (B, hkv, S), and lengths 1, that -1 .. +2, and S."""
    _, kps = split_plan(B, hkv, S, sms, max_keys)
    return kps, [1, kps - 1, kps, kps + 1, kps + 2, S]

  # K2 / K2q: (Hq, Hkv, D), groups 1, 4, 8, 16 at D 64, then D 128, 32 and 16.
  S = 2048
  _, block_k = decode_blocks()
  for hq, hkv, d in ((8, 8, 64), (32, 8, 64), (64, 8, 64), (128, 8, 64), (32, 8, 128),
                     (16, 4, 32), (8, 2, 16)):
    kps, lengths = edges(6, hkv, S, block_k)
    for window, softcap in ((0, 0.0), (kps // 2 + 3, 30.0)):
      cases = [(lengths, window, softcap)]
      if (hq, hkv, d) == (32, 8, 64):
        cases.append(([1, 2, 64, 65, 1000, 2048, 2049, 4095], window, softcap))
      for lens, win, cap in cases:
        B, S_ = len(lens), max(S, max(lens))
        q_start = torch.tensor([n - 1 for n in lens], dtype=torch.int32, device=dev)
        q, kc, vc = randn(B, 1, hq, d), randn(B, S_, hkv, d), randn(B, S_, hkv, d)
        case = (f"Hq={hq} Hkv={hkv} D={d} S={S_} lengths={lens} window={win} softcap={cap} "
                f"({split_plan(B, hkv, S_, sms, block_k)[0]} splits)")
        out = flash_cached_attention(q, kc, vc, q_start, window=win, softcap=cap)
        torch.cuda.synchronize()
        check_only("flash_cached_attention", case, out,
                   flash_cached_attention_ref(q, kc, vc, q_start, window=win, softcap=cap))
        (kq, ks), (vq, vs) = spread_quantize(torch, gen, kc), spread_quantize(torch, gen, vc)
        out8 = flash_cached_attention_int8(q, kq, vq, ks, vs, q_start, window=win, softcap=cap)
        torch.cuda.synchronize()
        check_only("flash_cached_attention_int8", case, out8,
                   flash_cached_attention_ref(q, kq, vq, q_start, window=win, softcap=cap,
                                              k_scale=ks, v_scale=vs))
        same("flash_cached_attention_int8", case, out8,
             flash_cached_attention(q, *dequantize_kv(kq, vq, ks, vs, bf), q_start, window=win,
                                    softcap=cap))

  # K3 / K3q: (Hq, Hkv, D), groups 1, 4, 8 at D 64, then D 128 and 16; pages 16 and 128.
  for hq, hkv, d in ((8, 8, 64), (32, 8, 64), (64, 8, 64), (32, 8, 128), (8, 2, 16)):
    for pg in (16, 128):
      kps, lengths = edges(6, hkv, S, SPLIT_KEYS)
      for window, softcap in ((0, 0.0), (kps // 2 + 3, 30.0)):
        cases = [lengths]
        if (hq, hkv, d) == (32, 8, 64):
          cases.append([1, 2, 64, 65, 1000, 2048, 2049, 4095])
        for lens in cases:
          q, kp, vp, table, ln = paged_inputs(torch, randn, lens, pg, hq, hkv, d)
          case = (f"Hq={hq} Hkv={hkv} D={d} page={pg} lengths={lens} window={window} "
                  f"softcap={softcap} "
                  f"({split_plan(len(lens), hkv, table.shape[1] * pg, sms, SPLIT_KEYS)[0]} splits)")
          out = paged_decode_attention(q, kp, vp, table, ln, window=window, softcap=softcap)
          torch.cuda.synchronize()
          check_only("paged_decode_attention", case, out,
                     paged_decode_attention_ref(q, kp, vp, table, ln, window=window,
                                                softcap=softcap))
          (kq, ks), (vq, vs) = spread_quantize(torch, gen, kp), spread_quantize(torch, gen, vp)
          out8 = paged_decode_attention_int8(q, kq, vq, ks, vs, table, ln, window=window,
                                             softcap=softcap)
          torch.cuda.synchronize()
          check_only("paged_decode_attention_int8", case, out8,
                     paged_decode_attention_ref(q, kq, vq, table, ln, window=window,
                                                softcap=softcap, k_scale_pages=ks,
                                                v_scale_pages=vs))
          same("paged_decode_attention_int8", case, out8,
               paged_decode_attention(q, *dequantize_kv(kq, vq, ks, vs, bf), table, ln,
                                      window=window, softcap=softcap))
  print("[split edges] every K2q and K3q case bit-identical to its bf16 twin over the "
        "dequantized operands", flush=True)

  # No wrapper reads a device tensor back: each runs once with syncs raising.
  q, kc, vc = randn(2, 1, HQ, D), randn(2, S, HKV, D), randn(2, S, HKV, D)
  q_start = torch.tensor([100, 2000], dtype=torch.int32, device=dev)
  (kq, ks), (vq, vs) = spread_quantize(torch, gen, kc), spread_quantize(torch, gen, vc)
  pq, kp, vp, table, ln = paged_inputs(torch, randn, [100, 2000], 128, HQ, HKV, D)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    flash_cached_attention(q, kc, vc, q_start)
    flash_cached_attention_int8(q, kq, vq, ks, vs, q_start)
    paged_decode_attention(pq, kp, vp, table, ln)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  print("[split edges] flash_cached_attention(_int8) and paged_decode_attention ran with "
        "torch.cuda.set_sync_debug_mode('error'): no host read of a device tensor", flush=True)


def check_only(name, case, out, ref, limit=ATOL) -> None:
  err = (out.float() - ref.float()).abs().max().item()
  ok = math.isfinite(err) and err <= limit
  print(f"[{name}] {case}: max_abs_err={err:.3e} (limit {limit:.3e}) {'ok' if ok else 'FAIL'}",
        flush=True)
  if not ok:
    raise AssertionError(f"{name} {case}: kernel disagrees with its plain version ({err})")


# synthetic-llama-1b's projections: (slot, in, out).
QUANT_SHAPES = (("wq/wo", 2048, 2048), ("wk/wv", 2048, 512), ("w_gate/w_up", 2048, 8192),
                ("w_down", 8192, 2048))
QUANT_REL_TOL = 2.0 ** -7  # two bf16 roundings at the top of the output's range


def check_quant_kernels(torch, results: dict) -> None:
  """K5, K5v4 and K6 at the four projection shapes of synthetic-llama-1b, rows 1 and
  8, against their plain versions on the same card inputs. Tolerance: 2^-7 of the
  output's largest magnitude. The plain versions compute in fp32 and round to bf16
  once; K6 and K5v4 quantize the activations with the same recipe bit for bit, so
  only the order of fp32 sums (K5, K5v4) and the final rounding can differ. The
  library yardstick is one torch.matmul of h by the same weight dequantized to bf16
  beforehand: it reads 2x (int8) or 4x (int4) the weight bytes, and the port never
  calls it. Two calls on the same inputs must give identical outputs; K6 prints how
  many outputs differ from its plain version. Then the edge shapes (check_gemv_edges)."""
  from xotorch_tpu_torch.models.quantize import (dequantize_tensor, dequantize_tensor_grouped,
                                                 quantize_tensor, quantize_tensor_grouped)
  from xotorch_tpu_torch.ops.int4_matmul import (int4_w4a8_matmul, int4_w4a8_matmul_ref,
                                                 int4_w4a16_matmul, int4_w4a16_matmul_ref)
  from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul, int8_rowquant_matmul_ref

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev)
  gen.manual_seed(3)
  for slot, K, N in QUANT_SHAPES:
    w = torch.randn(1, K, N, generator=gen, device=dev) * 0.02
    q8, s8 = quantize_tensor(w[0], 0)
    q4, s4 = quantize_tensor_grouped(w)
    q4, s4 = q4[0], s4[0]
    dense8 = dequantize_tensor(q8, s8, 0)
    dense4 = dequantize_tensor_grouped(q4[None], s4[None])[0]
    del w
    G = s4.shape[0]
    for rows in (1, 8):
      h = torch.randn(rows, K, generator=gen, device=dev).to(torch.bfloat16)
      io = 2 * rows * (K + N)  # h read, out written (bf16)
      cases = (  # name, kernel, plain, operands, bytes, peak, yardstick weight
        ("int4_w4a16_matmul", int4_w4a16_matmul, int4_w4a16_matmul_ref, (q4, s4),
         io + K * N // 2 + 2 * G * N, PEAK_BF16_FLOPS, dense4),
        ("int4_w4a8_matmul", int4_w4a8_matmul, int4_w4a8_matmul_ref, (q4, s4),
         io + K * N // 2 + 2 * G * N, PEAK_INT8_OPS, dense4),
        ("int8_rowquant_matmul", int8_rowquant_matmul, int8_rowquant_matmul_ref, (q8, s8),
         io + K * N + 2 * N, PEAK_INT8_OPS, dense8),
      )
      for name, fn, ref_fn, ops, nbytes, peak, dense in cases:
        out = fn(h, *ops)
        torch.cuda.synchronize()
        if not torch.equal(out, fn(h, *ops)):
          raise AssertionError(f"{name} {slot} rows={rows}: two calls on the same inputs differ")
        ref = ref_fn(h, *ops)
        if name == "int8_rowquant_matmul":
          print(f"[{name}] {slot} {K}->{N} rows={rows}: {k6_differ(torch, out, ref, ref_fn, h, ops)}",
                flush=True)
        ms = time_ms(lambda: fn(h, *ops))
        plain_ms = time_ms(lambda: ref_fn(h, *ops), iters=5)
        lib_ms = time_ms(lambda: torch.matmul(h, dense))
        b_ms, b_by = bound(2.0 * rows * K * N, nbytes, peak)
        atol = QUANT_REL_TOL * ref.float().abs().max().item()
        r = report(name, f"{slot} {K}->{N} rows={rows}", out, ref, ms, plain_ms, lib_ms, b_ms, b_by,
                   limit=atol)
        if (slot, rows) == ("w_gate/w_up", 1):
          results[name] = r
  gemv_step_us(torch)
  check_gemv_edges(torch)


def gemv_step_us(torch, layers: int = 16) -> None:
  """K5, K5v4 and K6 at one decode row as a decode step meets them: each
  synthetic-llama-1b projection shape `layers` times back to back, a distinct random
  weight each time (one a layer), h resident, no L2 flush, CUDA events around three
  such runs. Once on the one-row kernel (tile 0) and once on the cluster kernels' plan
  (what rows 2-8 take), through the C entry points. Prints device us a call per shape,
  and for a layer's 7 projections on each side and on the launch plan's choice at one
  row (gemv_plan: the one-row kernel for K <= 4096): the measurement behind that
  threshold (PERF.md, Findings on K5 and K6, and on K5v4)."""
  from xotorch_tpu_torch.ops import _build
  from xotorch_tpu_torch.ops.int8_matmul import gemv_plan
  lib = _build.load("quant_matvec")
  dev = torch.device("cuda")
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  stream = torch.cuda.current_stream().cuda_stream
  gen = torch.Generator(device=dev)
  gen.manual_seed(9)
  bf = torch.bfloat16
  entry = {"K6": lib.xot_w8a8_matvec_bf16, "K5": lib.xot_w4a16_matvec_bf16,
           "K5v4": lib.xot_w4a8_matvec_bf16}
  for fmt, fn in entry.items():
    parts, layer = [], {"one-row": 0.0, "cluster": 0.0, "plan": 0.0}
    for slot, K, N in QUANT_SHAPES:
      if fmt == "K6":
        ws = [torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
              for _ in range(layers)]
        scs = [torch.rand(N, generator=gen, device=dev).to(bf) for _ in range(layers)]
      else:
        ws = [torch.randint(0, 256, (K // 128, 64, N), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8) for _ in range(layers)]
        scs = [torch.rand(K // 128, N, generator=gen, device=dev).to(bf) for _ in range(layers)]
      h = torch.randn(1, K, generator=gen, device=dev).to(bf)
      out = torch.empty(1, N, dtype=bf, device=dev)
      us = {}
      for label, (tile, splits) in (("one-row", (0, 1)), ("cluster", gemv_plan(8, K, N, sms))):
        def run():
          for w, sc in zip(ws, scs):
            gs = () if fmt == "K6" else (128,)
            rc = fn(h.data_ptr(), w.data_ptr(), sc.data_ptr(), out.data_ptr(), 1, K, N, *gs,
                    tile, splits, stream)
            _build.check(rc, f"gemv_step_us {fmt} {slot} tile={tile} splits={splits}")
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # the host enqueues the runs while the card sleeps
        start.record()
        for _ in range(3):
          run()
        end.record()
        torch.cuda.synchronize()
        us[label] = start.elapsed_time(end) / 3 / layers * 1e3
      chosen = "one-row" if gemv_plan(1, K, N, sms)[0] == 0 else "cluster"
      for label in ("one-row", "cluster"):
        layer[label] += us[label] * (1 if slot == "w_down" else 2)
      layer["plan"] += us[chosen] * (1 if slot == "w_down" else 2)
      parts.append(f"{slot} {us['one-row']:.2f} / {us['cluster']:.2f} (plan: {chosen})")
      del ws, scs
    print(f"[gemv step] {fmt} at one row, device us a call over {layers} layers back to back, "
          f"one-row / cluster kernels: " + ", ".join(parts) + f"; a layer's 7 projections "
          f"{layer['one-row']:.2f} / {layer['cluster']:.2f}, on the plan {layer['plan']:.2f} "
          f"({smi_line()})", flush=True)


# K5, K5v4 and K6 beyond the main path: llama-3.1-8B's and 70B's projections, column
# tiles and k-steps cut ragged, one group, h on a 4-byte boundary, and gemma-2-2b's
# projections (so that --quantize on its checkpoint meets no unplanned shape). (label,
# in, out, h offset in bf16 elements from a 16-byte boundary).
GEMV_EDGES = (("8B wq/wo", 4096, 4096, 0), ("8B wk/wv", 4096, 1024, 0),
              ("8B gate/up", 4096, 14336, 0), ("8B down", 14336, 4096, 0),
              ("70B wq/wo", 8192, 8192, 0), ("70B wk/wv", 8192, 1024, 0),
              ("70B gate/up", 8192, 28672, 0), ("70B down", 28672, 8192, 0),
              ("N=4", 2048, 4, 0), ("N=36, ragged tile", 2048, 36, 0),
              ("N=2052, ragged tile", 2048, 2052, 0), ("one group", 128, 2048, 0),
              ("one group, N=36", 128, 36, 0), ("ragged last k-step (K6)", 2052, 36, 0),
              ("h 4-byte aligned", 2048, 512, 2),
              ("gemma-2-2b wq", 2304, 2048, 0), ("gemma-2-2b wk/wv", 2304, 1024, 0),
              ("gemma-2-2b wo", 2048, 2304, 0), ("gemma-2-2b gate/up", 2304, 9216, 0),
              ("gemma-2-2b down", 9216, 2304, 0))


# K5 and K5v4 at groups of 32 and 64 values (label, in, out, group size): at K = 384
# the cluster kernels' 8 splits of 12 k-steps cut groups of 64 (splits start at k-steps
# 1, 3, 4, 6, 7, 9, 10) and each group of 32 is one 16-packed-row chunk; at K = 2048 a
# 128-row tile holds 8 or 4 groups; at 4096 x 4096 the 128-column tile flushes a group
# every chunk. Rows 1 at K <= 4096 take the one-row kernels, at these group sizes too.
GEMV_GROUP_EDGES = (("gs 32, 8 splits", 384, 36, 32), ("gs 64, splits cut groups", 384, 36, 64),
                    ("gs 32", 2048, 36, 32), ("gs 64", 2048, 36, 64),
                    ("8B wq/wo, gs 32", 4096, 4096, 32), ("8B wq/wo, gs 64", 4096, 4096, 64))


def k6_differ(torch, out, ref, ref_fn, h, ops) -> str:
  """How many of K6's outputs differ from its plain version, on the card and on a CPU
  copy of the inputs. The arithmetic is exact, so 0 is expected against the CPU; the
  card's plain version may round its activation scale otherwise (PERF.md, Findings on K5 and K6)."""
  cpu = ref_fn(h.cpu(), *(o.cpu() for o in ops)).to(out.device)
  return (f"{int((out != ref).sum())} of {out.numel()} outputs differ from the plain version "
          f"on the card, {int((out != cpu).sum())} from it on the CPU (exact arithmetic)")


def check_gemv_edges(torch) -> None:
  """K5, K5v4 and K6 at GEMV_EDGES, then K5 and K5v4 at GEMV_GROUP_EDGES, rows 1, 3
  and 8, on random codes and scales: each within 2^-7 of its plain version's range, two
  calls identical, and K6's outputs that differ from its plain version counted
  (k6_differ). K5 and K5v4 need K a multiple of their 128-value group in GEMV_EDGES,
  so they skip the ragged k-step. Then K5, K5v4 and K6 once each under
  torch.cuda.set_sync_debug_mode("error"): no wrapper reads a device tensor back."""
  from xotorch_tpu_torch.ops.int4_matmul import (int4_w4a8_matmul, int4_w4a8_matmul_ref,
                                                 int4_w4a16_matmul, int4_w4a16_matmul_ref)
  from xotorch_tpu_torch.ops.int8_matmul import (gemv_plan, int8_rowquant_matmul,
                                                 int8_rowquant_matmul_ref)
  dev = torch.device("cuda")
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  gen = torch.Generator(device=dev)
  gen.manual_seed(7)
  bf = torch.bfloat16
  cases = ([(label, K, N, off, 128, True) for label, K, N, off in GEMV_EDGES]
           + [(label, K, N, 0, gsz, False) for label, K, N, gsz in GEMV_GROUP_EDGES])
  for label, K, N, off, gsz, with_k6 in cases:
    kernels = []
    if with_k6:
      w8 = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
      ws = (torch.rand(N, generator=gen, device=dev) * 0.02 + 0.005).to(bf)
      kernels.append(("int8_rowquant_matmul", int8_rowquant_matmul, int8_rowquant_matmul_ref,
                      (w8, ws)))
    if K % gsz == 0:
      pk = torch.randint(0, 256, (K // gsz, gsz // 2, N), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
      gs = (torch.rand(K // gsz, N, generator=gen, device=dev) * 0.02 + 0.005).to(bf)
      kernels += [("int4_w4a16_matmul", int4_w4a16_matmul, int4_w4a16_matmul_ref, (pk, gs)),
                  ("int4_w4a8_matmul", int4_w4a8_matmul, int4_w4a8_matmul_ref, (pk, gs))]
    if gsz != 128:
      label = f"{label} ({gsz}-value groups)"
    for rows in (1, 3, 8):
      flat = torch.randn(rows * K + off, generator=gen, device=dev).to(bf)
      h = flat[off:].view(rows, K)
      for name, fn, ref_fn, ops in kernels:
        out = fn(h, *ops)
        torch.cuda.synchronize()
        if not torch.equal(out, fn(h, *ops)):
          raise AssertionError(f"{name} {label} rows={rows}: two calls on the same inputs differ")
        ref = ref_fn(h, *ops)
        tile, splits = gemv_plan(rows, K, N, sms)
        plan = f"tile {tile}, {splits} splits" if tile else "one-row kernel"
        case = f"{label} {K}->{N} rows={rows} ({plan})"
        err = (out.float() - ref.float()).abs().max().item()
        atol = QUANT_REL_TOL * ref.float().abs().max().item()
        ok = math.isfinite(err) and err <= atol
        extra = ""
        if name == "int8_rowquant_matmul":
          extra = "; " + k6_differ(torch, out, ref, ref_fn, h, ops)
        print(f"[{name}] edge {case}: max_abs_err={err:.3e} (atol {atol:.3e}){extra} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
          raise AssertionError(f"{name} {case}: kernel disagrees with its plain version ({err})")
    del kernels
  print("[gemv edges] every K5/K5v4/K6 case within 2^-7 of its range, repeated calls identical",
        flush=True)
  # Why the card's plain K6 can differ from the kernel: its activation scale max / 127.
  x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(0)) * 100
  card = (x.to(dev) / 127.0).cpu()
  print(f"[gemv edges] fp32 x / 127.0 on the card differs from the CPU's in "
        f"{int((card != x / 127.0).sum())} of {x.numel()} values, x * (1 / 127.0) on the CPU "
        f"in {int((x * (1 / 127.0) != x / 127.0).sum())}", flush=True)
  K, N = 2048, 512
  h = torch.randn(8, K, generator=gen, device=dev).to(bf)
  w8 = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
  ws = torch.rand(N, generator=gen, device=dev).to(bf)
  pk = torch.randint(0, 256, (K // 128, 64, N), generator=gen, device=dev,
                     dtype=torch.int32).to(torch.uint8)
  gs = torch.rand(K // 128, N, generator=gen, device=dev).to(bf)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    int8_rowquant_matmul(h, w8, ws)
    int4_w4a16_matmul(h, pk, gs)
    int4_w4a8_matmul(h, pk, gs)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  print("[gemv edges] int8_rowquant_matmul, int4_w4a16_matmul and int4_w4a8_matmul ran with "
        "torch.cuda.set_sync_debug_mode('error'): no host read of a device tensor", flush=True)


def cpu_copy(torch, params):
  """The same tree on the CPU, floating leaves in fp32, quantized codes as they are."""
  if isinstance(params, dict):
    return {k: cpu_copy(torch, v) for k, v in params.items()}
  return params.float().cpu() if params.is_floating_point() else params.cpu()


def _drop_first_group(torch, params):
  """A control: `params` with the first 128 values of every projection's contraction
  dropped (int4: group 0's scale zeroed; int8: the first 128 weight rows zeroed), as
  a GEMV kernel that lost one of its k-slices would compute. Other leaves shared."""
  layers = dict(params["layers"])
  for slot in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
    if slot + "_gscale" in layers:
      layers[slot + "_gscale"] = layers[slot + "_gscale"].clone()
      layers[slot + "_gscale"][:, 0] = 0
    else:
      layers[slot] = layers[slot].clone()
      layers[slot][:, :128] = 0
  return {**params, "layers": layers}


def check_model(torch, fmt=None, env=None, kernel=None, limit=5e-2) -> None:
  """A two-layer cut of synthetic-llama-1b at full width: prefill (K1) and decode
  (K2) in bf16 on the card against the plain path in fp32 on the CPU, same weights.
  With `fmt` the weights are quantized on the card first and `env` routes the decode
  projections: on the card through `kernel`, whose launches are counted (7 a layer
  a step), on the CPU through the same function's plain version. `limit` bounds the
  largest logit error as a share of the logits' range.

  With `fmt` two more checks hold the kernel itself: each of its 112 calls in the
  decode steps matches its plain version on the same card inputs, the model's own
  activations, within 2^-7 of the output's range (as in the kernel phase); and a
  control decodes the same steps with one 128-value group of every contraction
  dropped (`_drop_first_group`), which must exceed `limit`."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.quantize import quantize_params
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, init_random_params
  from xotorch_tpu_torch.ops.int4_matmul import int4_w4a8_matmul_ref, int4_w4a16_matmul_ref
  from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul_ref

  cfg = dataclasses.replace(
    config_from_hf_dict(get_model_card("synthetic-llama-1b")["synthetic_config"]), num_layers=2)
  dev = torch.device("cuda")
  params = init_random_params(cfg, 2, True, True, seed=0, dtype=torch.bfloat16, device=dev)
  if fmt:
    params = quantize_params(params, fmt, scale_dtype=torch.bfloat16, inplace=True)
  params_cpu = cpu_copy(torch, params)
  tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 100))
  x = torch.as_tensor(tokens, device=dev)
  x_cpu = torch.as_tensor(tokens)
  cache_cpu = init_kv_cache(cfg, 2, 1, 256, torch.float32, "cpu")
  plain = {"int4_w4a16_matmul": int4_w4a16_matmul_ref, "int4_w4a8_matmul": int4_w4a8_matmul_ref,
           "int8_rowquant_matmul": int8_rowquant_matmul_ref}.get(getattr(kernel, "__name__", ""))
  wrapper = "int8_rowquant_matmul" if fmt == "int8" else "int4_grouped_matmul"
  call_err, original = [], getattr(transformer, wrapper)

  def held(h, w, scale, *variant):
    out = original(h, w, scale, *variant)
    ref = plain(h, w, scale).float()
    call_err.append(((out.float() - ref).abs().max() / ref.abs().max()).item())
    return out

  def card_run(decode_params):
    """Card logits of the prefill's last 8 positions, then of 8 decode steps that
    feed the reference's greedy tokens; the kernel's launches in the steps."""
    cache = init_kv_cache(cfg, 2, 1, 256, torch.bfloat16, dev)
    logits, _ = forward_shard(params, x, cache, 0, cfg, True, True, use_flash=True)
    out = [logits[0, -8:].float().cpu()]
    before = kernel.launches if kernel else 0
    for i, tok in enumerate(fed):
      logits, _ = forward_shard(decode_params, torch.tensor([[tok]], device=dev), cache, 100 + i,
                                cfg, True, True, use_flash_decode=True)
      out.append(logits[0].float().cpu())
    return out, (kernel.launches - before if kernel else 0)

  with phase_env(**(env or {})), torch.inference_mode():
    ref, _ = forward_shard(params_cpu, x_cpu, cache_cpu, 0, cfg, True, True)
    want, fed = [ref[0, -8:]], []
    for i in range(8):
      fed.append(int(want[-1][-1].argmax()))
      ref, _ = forward_shard(params_cpu, torch.tensor([[fed[-1]]]), cache_cpu, 100 + i, cfg,
                             True, True)
      want.append(ref[0])
    if fmt:
      setattr(transformer, wrapper, held)
    try:
      got, launched = card_run(params)
    finally:
      setattr(transformer, wrapper, original)
    control = card_run(_drop_first_group(torch, params))[0] if fmt else None

  def error(logits):
    if not all(bool(torch.isfinite(g).all()) for g in logits):
      raise AssertionError("model: non-finite logits on the card")
    return max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(logits, want))

  worst = error(got)
  caught = control is None or error(control) > limit
  calls_ok = not fmt or (len(call_err) == 7 * 2 * 8 and max(call_err) <= QUANT_REL_TOL)
  # bf16 weights are shared; the card keeps activations in bf16 over two layers.
  what = "" if not fmt else f", {fmt} weights, {env} ({kernel.__name__} x{launched})"
  ok = worst < limit and caught and calls_ok and (not kernel or launched == 7 * 2 * 8)
  print(f"[model] 2-layer synthetic-llama-1b cut{what}, prefill 100 + decode 8: max logit error "
        f"{worst:.3e} of the logits' range (limit {limit:g})"
        + ("" if not fmt else
           f"; {len(call_err)} kernel calls against the plain version on their card inputs: "
           f"worst {max(call_err):.3e} of the output's range (limit 2^-7); control, one 128-value "
           f"group of every decode contraction dropped: {error(control):.3e} "
           f"({'caught' if caught else 'NOT caught'})")
        + f" {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"model: card logits disagree with the CPU reference ({worst}), a kernel "
                         f"call with its plain version, the control passed, or the kernel ran "
                         f"{launched} times, not 112")


def check_paged_model(torch) -> None:
  """The same two-layer full-width cut through the paged path: three requests at
  different depths (prompts of 100, 37 and 260 tokens) prefill into one page arena
  over shuffled page tables (one K4 segment each), then decode 8 tokens together,
  B=3 at per-row positions (K3), in bf16 on the card against the plain path in fp32
  on the CPU, same weights."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.models.transformer import forward_shard, init_random_params
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention

  cfg = dataclasses.replace(
    config_from_hf_dict(get_model_card("synthetic-llama-1b")["synthetic_config"]), num_layers=2)
  dev = torch.device("cuda")
  params = init_random_params(cfg, 2, True, True, seed=0, dtype=torch.bfloat16, device=dev)
  params_cpu = cpu_copy(torch, params)
  rng = np.random.default_rng(1)
  lengths, steps, page, P = (100, 37, 260), 8, 128, 16
  prompts = [rng.integers(0, cfg.vocab_size, size=(1, n)) for n in lengths]
  ids = (rng.permutation(P - 1) + 1).tolist()
  table = np.zeros((3, 4), np.int32)
  for b, n in enumerate(lengths):
    k = -(-(n + steps) // page)
    table[b, :k], ids = ids[:k], ids[k:]
  shape = (2, P, page, cfg.num_kv_heads, cfg.head_dim)
  arena = {n: torch.zeros(shape, dtype=torch.bfloat16, device=dev) for n in ("k", "v")}
  arena_cpu = {n: torch.zeros(shape) for n in ("k", "v")}
  table_dev, table_cpu = torch.as_tensor(table, device=dev), torch.as_tensor(table)
  k3, k4 = paged_decode_attention.launches, paged_prefill_attention.launches
  pairs, toks = [], []
  with torch.inference_mode():
    for b, x in enumerate(prompts):
      got, _ = forward_shard(params, torch.as_tensor(x, device=dev), arena, 0, cfg, True, True,
                             page_table=table_dev[b:b + 1])
      want, _ = forward_shard(params_cpu, torch.as_tensor(x), arena_cpu, 0, cfg, True, True,
                              page_table=table_cpu[b:b + 1])
      pairs.append((got[0, -8:].float().cpu(), want[0, -8:]))
      toks.append(int(want[0, -1].argmax()))
    pos = torch.tensor(lengths, dtype=torch.int32)
    for i in range(steps):
      step = torch.tensor(toks)[:, None]
      got, _ = forward_shard(params, step.to(dev), arena, pos.to(dev) + i, cfg, True, True,
                             page_table=table_dev)
      want, _ = forward_shard(params_cpu, step, arena_cpu, pos + i, cfg, True, True,
                              page_table=table_cpu)
      pairs.extend((got[b, -1].float().cpu(), want[b, -1]) for b in range(3))
      toks = [int(want[b, -1].argmax()) for b in range(3)]
  worst = 0.0
  for got, want in pairs:
    if not bool(torch.isfinite(got).all()):
      raise AssertionError("paged model: non-finite logits on the card")
    worst = max(worst, ((got - want).abs().max() / want.abs().max()).item())
  k3, k4 = paged_decode_attention.launches - k3, paged_prefill_attention.launches - k4
  ok = worst < 5e-2 and k3 == 2 * steps and k4 == 2 * 3
  print(f"[model] 2-layer synthetic-llama-1b cut, paged (page 128): prefill 100/37/260 (K4 x{k4}) "
        f"+ decode 8 at B=3 (K3 x{k3}): max logit error {worst:.3e} of the logits' range "
        f"(limit 5e-2) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"paged model: card logits disagree with the CPU reference ({worst}) "
                         f"or the kernels did not run (K3 {k3}, K4 {k4})")


KV8_LIMIT = 5e-2  # the int8-KV cuts: the exact paths' limit, see check_int8_kv_model


def check_int8_kv_model(torch, limit: float = KV8_LIMIT, device: str = "cuda",
                        model: str = "synthetic-llama-1b") -> None:
  """The two-layer full-width cut with an int8 KV cache, in bf16 on the card against
  the plain path in fp32 on the CPU (same weights, same flags, so the CPU's first
  segment also attends its fresh K/V): contiguous, a 100-token prefill from 0 (K1), a
  40-token segment at 100 and 8 decode steps (K2q); paged, prompts of 100, 37 and 260
  tokens into one int8 arena over shuffled page tables (K4q), then 8 decode steps at
  B=3 (K3q). Every K2q/K3q/K4q call is held against its plain version on its own card
  inputs at ATOL. `limit` bounds the largest logit error as a share of the logits'
  largest magnitude, at the bf16 cuts' 5e-2: the card's bf16 K/V and the CPU's fp32
  K/V can take different int8 codes near a step of the grid, which the cuts measured
  at about 2e-2; a control decodes the same steps with each call's K and V scales
  swapped, which must exceed it. (`device` and `model` let it be rehearsed
  on the CPU with a small card.)"""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.inference.torch_engine.paged_cache import PagePool
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, init_random_params
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention_int8, flash_cached_attention_ref
  from xotorch_tpu_torch.ops.paged_attention import (paged_decode_attention_int8,
                                                     paged_decode_attention_ref,
                                                     paged_prefill_attention_int8,
                                                     paged_prefill_attention_ref)

  cfg = dataclasses.replace(config_from_hf_dict(get_model_card(model)["synthetic_config"]),
                            num_layers=2)
  dev = torch.device(device)
  params = init_random_params(cfg, 2, True, True, seed=0, dtype=torch.bfloat16, device=dev)
  params_cpu = cpu_copy(torch, params)
  rng = np.random.default_rng(2)
  x = rng.integers(0, cfg.vocab_size, size=(1, 140))
  lengths, steps, page, P = (100, 37, 260), 8, 128, 16
  prompts = [rng.integers(0, cfg.vocab_size, size=(1, n)) for n in lengths]
  ids = (rng.permutation(P - 1) + 1).tolist()
  table = np.zeros((3, 4), np.int32)
  for b, n in enumerate(lengths):
    k = -(-(n + steps) // page)
    table[b, :k], ids = ids[:k], ids[k:]

  # Each attention call of the transformer, wrapped: its int8 operands held against
  # the plain version on the same inputs (card runs), or its scales swapped (control).
  plain = {"flash_cached_attention": (flash_cached_attention_ref, "k_scale", "v_scale"),
           "paged_decode_attention": (paged_decode_attention_ref, "k_scale_pages", "v_scale_pages"),
           "paged_prefill_attention": (paged_prefill_attention_ref, "k_scale_pages", "v_scale_pages")}
  original = {name: getattr(transformer, name) for name in plain}
  mode = {"swap": False, "hold": False}
  call_err = []

  def wrapped(name):
    ref_fn, ks, vs = plain[name]

    def call(*a, **kw):
      if mode["swap"]:
        kw = {**kw, ks: kw[vs], vs: kw[ks]}
      out = original[name](*a, **kw)
      if mode["hold"]:
        ref = ref_fn(*a, **kw)
        call_err.append((out.float() - ref.float()).abs().max().item())
      return out
    return call

  def contiguous(p, dev_, dtype, fed):
    """Logits of the prefill's last 8 positions, the segment's last 8, then 8 decode
    steps that feed `fed` (the reference's greedy tokens, taken as it runs)."""
    cache = init_kv_cache(cfg, 2, 1, 256, dtype, dev_, kv_quant=True)
    xs = torch.as_tensor(x, device=dev_)
    logits, _ = forward_shard(p, xs[:, :100], cache, 0, cfg, True, True, use_flash=True)
    out = [logits[0, -8:].float().cpu()]
    logits, _ = forward_shard(p, xs[:, 100:], cache, 100, cfg, True, True, use_flash_decode=True)
    out.append(logits[0, -8:].float().cpu())
    for i in range(steps):
      if len(fed) == i:
        fed.append(int(out[-1][-1].argmax()))
      logits, _ = forward_shard(p, torch.tensor([[fed[i]]], device=dev_), cache, 140 + i, cfg, True,
                                True, use_flash_decode=True)
      out.append(logits[0].float().cpu())
    return out

  def paged(p, dev_, dtype, fed):
    arena = PagePool(cfg, 2, P, page, dtype=dtype, device=dev_, kv_quant=True).arena
    tb = torch.as_tensor(table, device=dev_)
    out, last = [], []
    for b, prompt in enumerate(prompts):
      logits, _ = forward_shard(p, torch.as_tensor(prompt, device=dev_), arena, 0, cfg, True, True,
                                page_table=tb[b:b + 1])
      out.append(logits[0, -8:].float().cpu())
      last.append(int(logits[0, -1].argmax()))
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev_)
    for i in range(steps):
      if len(fed) == i:
        fed.append(last)
      logits, _ = forward_shard(p, torch.tensor(fed[i], device=dev_)[:, None], arena, pos + i, cfg,
                                True, True, page_table=tb)
      out.extend(logits[b, -1].float().cpu() for b in range(3))
      last = [int(logits[b, -1].argmax()) for b in range(3)]
    return out

  def error(got, want):
    if not all(bool(torch.isfinite(g).all()) for g in got):
      raise AssertionError("int8-KV model: non-finite logits on the card")
    return max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))

  kernels = (flash_attention, flash_cached_attention_int8, paged_decode_attention_int8,
             paged_prefill_attention_int8)
  with torch.inference_mode():
    for name in plain:
      setattr(transformer, name, wrapped(name))
    try:
      for label, run, want_launches in (
          ("contiguous", contiguous, {"flash_attention": 2, "flash_cached_attention_int8": 2 * (1 + steps)}),
          ("paged", paged, {"paged_prefill_attention_int8": 2 * 3,
                            "paged_decode_attention_int8": 2 * steps})):
        fed = []
        want = run(params_cpu, "cpu", torch.float32, fed)
        before = {k.__name__: k.launches for k in kernels}
        mode["hold"], call_err[:] = True, []
        got = run(params, dev, torch.bfloat16, fed)
        mode["hold"] = False
        launched = {k.__name__: k.launches - before[k.__name__] for k in kernels
                    if k.launches != before[k.__name__]}
        mode["swap"] = True
        control = run(params, dev, torch.bfloat16, fed)
        mode["swap"] = False
        worst, caught = error(got, want), error(control, want)
        ok = (worst < limit and caught > limit and launched == want_launches
              and len(call_err) == sum(want_launches.values()) - want_launches.get("flash_attention", 0)
              and max(call_err) <= ATOL)
        print(f"[model] 2-layer {model} cut, int8 KV, {label}: max logit error "
              f"{worst:.3e} of the logits' range (limit {limit:g}); launches {launched}; "
              f"{len(call_err)} int8 kernel calls against their plain versions on their card inputs: "
              f"worst {max(call_err):.3e} (atol {ATOL}); control, K and V scales swapped: "
              f"{caught:.3e} ({'caught' if caught > limit else 'NOT caught'}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
          raise AssertionError(f"int8-KV model ({label}): card logits disagree with the CPU reference "
                               f"({worst}), a kernel call with its plain version, the control "
                               f"passed ({caught}), or the launches were {launched}")
    finally:
      for name, fn in original.items():
        setattr(transformer, name, fn)


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


async def profile_decode(torch, engine, model: str, classname: str, card: str,
                         batch: int = 1, tag: str = "profile", focus: str = "",
                         wrapper=None) -> dict:
  """Where a decode chunk's time goes: 32 greedy tokens for each of `batch` requests
  after a 514-token prompt (one batched dispatch when batch > 1), timed once alone
  and once under torch.profiler (CUDA activity). Prints both wall times, the share
  of the profiled one the card spent in kernels, the share of kernels whose name
  holds `focus`, and the kernels by device time. With `wrapper` (a kernel wrapper
  with a launch counter), fails unless the trace holds one `focus` kernel for each of
  the wrapper's launches in the profiled chunk (at most 10 % fewer: the trace drops
  events). Returns the numbers."""
  if engine.device.type != "cuda":
    print(f"[{tag}] no card: busy share not measured", flush=True)
    return {}
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  from xotorch_tpu_torch.models.registry import build_full_shard

  shard = build_full_shard(model, classname)
  rids = [f"profile{i}" for i in range(batch)]
  toks = {}
  for rid in rids:
    toks[rid], _ = await engine.infer_sample_tensor(rid, shard, np.ones((1, 514), np.int64),
                                                    temp=0.0, top_k=0)

  async def chunk(n):  # every row in the same event-loop pass: one batched dispatch
    outs = await asyncio.gather(*(engine.generate_chunk(rid, shard, int(toks[rid]), n, temp=0.0)
                                  for rid in rids))
    toks.update((rid, int(o[-1])) for rid, o in zip(rids, outs))

  await chunk(8)  # warm
  n = 32
  t0 = time.perf_counter()
  await chunk(n)  # the same chunk without the profiler, and with no HTTP client running
  plain_ms = (time.perf_counter() - t0) * 1e3
  batcher = engine._ctx.batcher
  before = (batcher.dispatches, batcher.rows)
  called = wrapper.launches if wrapper is not None else 0
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    await chunk(n)
    wall_ms = (time.perf_counter() - t0) * 1e3
  called = wrapper.launches - called if wrapper is not None else 0
  widths = f"{batcher.dispatches - before[0]} dispatch(es), {batcher.rows - before[1]} rows"
  for rid in rids:
    await engine.clear_request(rid)
  rows = []
  for evt in prof.key_averages():
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
      us = getattr(evt, "self_cuda_time_total", 0)
    if us > 0:
      rows.append((us / 1e3, evt.key, evt.count))
  if not rows:
    print(f"[{tag}] the trace holds no device time: busy share not measured", flush=True)
    return {}
  rows.sort(reverse=True)
  busy = sum(r[0] for r in rows)
  launches = sum(r[2] for r in rows)
  focus_ms = sum(r[0] for r in rows if focus and focus in r[1])
  out = {"tok_s": batch * n / plain_ms * 1e3, "step_ms": plain_ms / n, "busy_pct": 100 * busy / wall_ms,
         "kernels_per_step": launches / n, "focus_pct": 100 * focus_ms / busy,
         "device_ms": busy / n}
  print(f"[{tag}] B={batch} ({widths}), decode {n} tokens per row after a 514-token prompt: "
        f"{plain_ms:.2f} ms without the profiler ({out['tok_s']:.1f} tok/s); "
        f"wall {wall_ms:.2f} ms ({batch * n / wall_ms * 1e3:.1f} tok/s under the profiler), "
        f"kernels {busy:.2f} ms = {out['busy_pct']:.1f}% busy, "
        f"{100 - out['busy_pct']:.1f}% idle, {out['kernels_per_step']:.0f} device kernels per step, "
        f"{out['device_ms']:.3f} device ms per step"
        + (f", {focus} {focus_ms:.3f} ms = {out['focus_pct']:.1f}% of device time" if focus else "")
        + f" ({card})", flush=True)
  if wrapper is not None:
    # The trace drops events (CUPTI: up to 2.5 % of a chunk's kernels in one run), so the
    # count may fall short of the calls; a second kernel of this name a call would read
    # twice the calls.
    focus_count = sum(r[2] for r in rows if focus in r[1])
    ok = 0.9 * called <= focus_count <= called
    print(f"[{tag}] B={batch}: {focus_count} {focus} kernels in the trace for {called} "
          f"{wrapper.__name__} calls: one kernel a projection {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
      raise AssertionError(f"{tag}: {focus_count} {focus} kernels for {called} calls")
  # The ten longest kernels, and the split-K decode merge wherever it ranks.
  for i, (ms, name, count) in enumerate(rows):
    if i < 10 or "merge_splits" in name:
      print(f"[{tag}]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<5d} {name[:90]}", flush=True)
  return out


def main_requests(model: str):
  """The main path's three chat completions: (label, body)."""
  words = lambda n: " ".join(f"w{i % 97}" for i in range(n))
  return [
    ("512-word prompt, 64 tokens", {"model": model, "temperature": 0, "max_tokens": 64,
                                    "messages": [{"role": "user", "content": words(512)}]}),
    ("streaming, 64 tokens", {"model": model, "max_tokens": 64, "stream": True,
                              "stream_options": {"include_usage": True},
                              "messages": [{"role": "user", "content": words(300)}]}),
    # Streamed, so the client reads its TTFT: a first segment of 1024 through K1.
    ("1500-word prompt (> XOT_PREFILL_CHUNK 1024), 32 tokens, streaming",
     {"model": model, "temperature": 0, "max_tokens": 32, "stream": True,
      "stream_options": {"include_usage": True},
      "messages": [{"role": "user", "content": words(1500)}]}),
  ]


def drive_main_path(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b",
                    kernels=None, env=None, tag: str = "main", profiles=(1,),
                    focus: str = "", cli=(), wrapper=None, requests=None, after=None) -> dict:
  """The port's server on `model` (synthetic-llama-1b: full width and depth, on the
  card) answers three chat completions over HTTP, with `env` (XOT_* knobs, e.g. the
  quantized formats) set for the phase and `cli` (e.g. `--kv-quantize int8`) added
  to its command line (`--models-seed-dir` seeds XOT_HOME first, as main.py does).
  `requests` replaces the three (main_requests). Every counter of `kernels` (default K1,
  K2), its windowed launches too, is set to 0 just
  before the three requests and read just after; then a decode chunk runs under the
  profiler at each batch size of `profiles` (with `wrapper`, held to one `focus` kernel
  a call of it); then `after(engine, node, api, base_url)` (a coroutine), if given, while the
  server still runs. Returns the launch counts, the decode
  steps the batcher ran for the three requests, the tokens each request streamed,
  each request's timing line, the profiles, the windowed launches, the page pool's
  occupancy once the requests are done (None without a pool), the served tokenizer's
  class, each request's prompt tokens and what `after` returned. (`device` and `model` let the same phase be rehearsed on the CPU
  with a small card.)"""
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.models.registry import build_full_shard
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention

  kernels = kernels or (flash_attention, flash_cached_attention)
  env = {"XOT_PAGED_KV": "0",
         "XOT_PREFILL_CHUNK": "1024",  # so the long prompt runs K2's T > 1 path
         **(env or {})}
  with phase_env(**env):
    args = port_main.build_parser().parse_args(
      ["--device", device, "--default-model", model, "--chatgpt-api-host", "127.0.0.1",
       "--chatgpt-api-port", "0", "--chatgpt-api-response-timeout", "600", *cli])
    if args.models_seed_dir:
      asyncio.run(port_main.seed_models(args.models_seed_dir))
    node, engine, classname, api = port_main.build_node(args)
    requests = requests or main_requests(model)
    # The request ids the node serves, in order, and the tokens it streams for each.
    served, tokens_of = [], {}
    serve_prompt = node.process_prompt

    async def traced(base_shard, prompt, request_id=None, *a, **kw):
      served.append(request_id)
      return await serve_prompt(base_shard, prompt, request_id, *a, **kw)
    node.process_prompt = traced
    node.on_token.register("chip-smoke-main").on_next(
      lambda rid, toks, finished: tokens_of.__setitem__(rid, list(toks)))

    async def drive():
      server = await api.start("127.0.0.1", 0)
      port = server.sockets[0].getsockname()[1]
      base = f"http://127.0.0.1:{port}"
      loop = asyncio.get_running_loop()
      try:
        t0 = time.perf_counter()
        await engine.ensure_shard(build_full_shard(model, classname))
        source = engine._ctx.model_dir or "random"
        print(f"[{tag}] {model} loaded ({source} {engine.dtype} weights, quantize={engine.quantize}, "
              f"kv_quant={engine.kv_quant}, on {device}) in {time.perf_counter() - t0:.1f} s", flush=True)
        health = await loop.run_in_executor(None, http_json, base + "/healthcheck")
        listed = await loop.run_in_executor(None, http_json, base + "/v1/models")
        if health.get("status") != "ok" or model not in [m["id"] for m in listed["data"]]:
          raise AssertionError(f"{tag}: healthcheck {health} / models {listed}")
        # Warm-up: each request once with 2 tokens, so the measured run below pays no
        # first-use costs (lazy CUDA module loading, cuBLAS heuristics per shape).
        t0 = time.perf_counter()
        for _, body in requests:
          warm = {**body, "max_tokens": 2, "stream": False}
          await loop.run_in_executor(None, http_json, base + "/v1/chat/completions", warm)
        print(f"[{tag}] warm-up: {len(requests)} requests in {time.perf_counter() - t0:.2f} s",
              flush=True)
        batcher = engine._ctx.batcher
        batcher.dispatches = batcher.rows = batcher.steps = 0
        served.clear()
        for k in kernels:
          k.launches = k.windowed_launches = 0
        decoded = 0
        timings, prompt_tokens = [], []
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
            usage = resp["usage"]
            n = usage["completion_tokens"]
            finish = [resp["choices"][0]["finish_reason"]]
            timing = f"end to end {(time.perf_counter() - t0) * 1e3:.1f} ms"
          timings.append(timing)
          prompt_tokens.append(usage.get("prompt_tokens", 0))
          want = body["max_tokens"]
          ok = n == want and finish == ["length"]
          print(f"[{tag}] {label}: {n} tokens, finish {finish}, {timing} ({card}) "
                f"{'ok' if ok else 'FAIL'}", flush=True)
          if not ok:
            raise AssertionError(f"{tag}: {label} returned {n} tokens ({finish}), wanted {want}")
          decoded += n - 1  # the first token comes from the prefill
        counts = {k.__name__: k.launches for k in kernels}
        windowed = {k.__name__: k.windowed_launches for k in kernels}
        steps = batcher.steps
        streamed = [tokens_of.get(rid, []) for rid in served]
        await wait_idle(engine)
        pool = engine.page_pool_stats()
        profiled = {}
        for b in profiles:
          profiled[b] = await profile_decode(torch, engine, model, classname, card, batch=b,
                                             tag=tag, focus=focus, wrapper=wrapper)
        extra = None if after is None else await after(engine, node, api, base)
        return (counts, decoded, steps, streamed, profiled, timings, windowed, pool, prompt_tokens,
                extra)
      finally:
        server.close()
        await server.wait_closed()
        await node.stop()

    try:
      (counts, decoded, steps, streamed, profiled, timings, windowed, pool,
       prompt_tokens, extra) = asyncio.run(drive())
    finally:
      engine.executor.shutdown(wait=True)
  print(f"[{tag}] launches: {counts} ({decoded} decoded tokens, {steps} decode steps)", flush=True)
  return {"launches": counts, "decoded": decoded, "steps": steps, "tokens": streamed,
          "profiles": profiled, "timings": timings, "windowed": windowed, "pool": pool,
          "tokenizer": type(engine.tokenizer).__name__, "prompt_tokens": prompt_tokens,
          "after": extra}


def quant_phases():
  """(format, knobs, kernel wrapper, what its kernels' names hold in the profile) of
  each quantized serving phase: int4 through K5, int4 with XOT_INT4_V=4 through K5v4,
  int8 with XOT_INT8_KERNEL=1 through K6 (each launches its one-row kernel,
  w4a16_kernel / w4a8_kernel / w8a8_kernel, at one row over K <= 4096, its cluster
  kernel otherwise)."""
  from xotorch_tpu_torch.ops.int4_matmul import int4_w4a8_matmul, int4_w4a16_matmul
  from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul
  return (("int4", {}, int4_w4a16_matmul, "w4a16_"),
          ("int4", {"XOT_INT4_V": "4"}, int4_w4a8_matmul, "w4a8_"),
          ("int8", {"XOT_INT8_KERNEL": "1"}, int8_rowquant_matmul, "w8a8_"))


def drive_quantized(torch, card: str, fmt: str, env: dict, kernel, focus: str,
                    device: str = "cuda", model: str = "synthetic-llama-1b") -> dict:
  """A fresh server with XOT_QUANTIZE=`fmt` and `env` answers the main path's three
  requests; every decode step's 7 projections a layer go through `kernel`, so its
  launches must equal 7 x layers x the decode steps. Then B=1 and B=8 profiles."""
  from xotorch_tpu_torch.models.registry import get_model_card
  tag = f"{fmt} {kernel.__name__}" + (" XOT_INT4_V=4" if env.get("XOT_INT4_V") == "4" else "")
  run = drive_main_path(torch, card, device=device, model=model, kernels=(kernel,),
                        env={"XOT_QUANTIZE": fmt, **env}, tag=tag, profiles=(1, 8), focus=focus,
                        wrapper=kernel if device == "cuda" else None)
  layers = get_model_card(model)["layers"]
  launched, want = run["launches"][kernel.__name__], 7 * layers * run["steps"]
  ok = launched == want and run["steps"] >= run["decoded"]
  print(f"[{tag}] {kernel.__name__} launches {launched} = 7 projections x {layers} layers x "
        f"{run['steps']} decode steps ({want}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{tag}: {launched} launches of {kernel.__name__}, wanted {want}")
  return run


def drive_engine_alone(torch, card: str, env: dict, tag: str, focus: str = "",
                       model: str = "synthetic-llama-1b") -> dict:
  """The engine without a server, built under `env`: B=1 and B=8 profiles only."""
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import TORCH
  with phase_env(**env):
    engine = TorchShardInferenceEngine(device="cuda", seed=0)
    try:
      async def drive():
        return {b: await profile_decode(torch, engine, model, TORCH, card, batch=b, tag=tag,
                                        focus=focus) for b in (1, 8)}
      return asyncio.run(drive())
    finally:
      engine.executor.shutdown(wait=True)


def projection_host_us(torch, card: str) -> dict:
  """Host time of one decode projection (rows 1, synthetic-llama-1b's wk, 2048->512)
  through transformer._linear, by route: the microseconds the host takes to enqueue
  200 calls while the card sleeps (so it neither drains nor waits), per call."""
  from xotorch_tpu_torch.models.quantize import quantize_tensor, quantize_tensor_grouped
  from xotorch_tpu_torch.models.transformer import QuantRoute, _linear

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev)
  gen.manual_seed(5)
  w = torch.randn(2048, 512, generator=gen, device=dev) * 0.02
  q8, s8 = quantize_tensor(w, 0)
  q4, s4 = quantize_tensor_grouped(w[None])
  h = torch.randn(1, 1, 2048, generator=gen, device=dev).to(torch.bfloat16)
  int4 = {"wk": q4[0], "wk_gscale": s4[0]}
  int8 = {"wk": q8, "wk_scale": s8}
  cases = {"bf16 (h @ w)": ({"wk": w.to(torch.bfloat16)}, QuantRoute()),
           "int4 K5": (int4, QuantRoute(int4_kernel=True)),
           "int4 K5v4": (int4, QuantRoute(int4_kernel=True, int4_variant=4)),
           "int8 K6": (int8, QuantRoute(int8_kernel=True)),
           "int8 default path": (int8, QuantRoute())}
  out = {}
  with torch.inference_mode():
    for label, (layer, route) in cases.items():
      best = float("inf")
      for _ in range(5):
        _linear(layer, "wk", h, route)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # ~25 ms of work ahead of the 200 calls
        t0 = time.perf_counter()
        for _ in range(200):
          _linear(layer, "wk", h, route)
        best = min(best, (time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
      out[label] = best
  print("[host] one decode projection's host time, best of 5 x 200 calls: "
        + ", ".join(f"{k} {v:.1f} us" for k, v in out.items())
        + f"; x112 a step: " + ", ".join(f"{k} {v * 112 / 1e3:.2f} ms" for k, v in out.items())
        + f" ({card})", flush=True)
  return out


def alternate_formats(torch, card: str, rounds: int = 4, n: int = 32,
                      model: str = "synthetic-llama-1b") -> dict:
  """The engine alone in each weight format, and with bf16 weights over an int8 KV
  cache, all resident at once, decoding `n`
  greedy tokens at B=1 after a 514-token prompt, the formats taking turns for
  `rounds` rounds, so that host drift over the call falls on every format alike.
  Returns each format's wall ms per step, round by round."""
  import numpy as np
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import TORCH, build_full_shard

  formats = {"bf16": {}, "int4 K5": {"XOT_QUANTIZE": "int4"},
             "int4 K5v4": {"XOT_QUANTIZE": "int4", "XOT_INT4_V": "4"},
             "int8 K6": {"XOT_QUANTIZE": "int8", "XOT_INT8_KERNEL": "1"},
             "int8 default path": {"XOT_QUANTIZE": "int8", "XOT_INT8_KERNEL": "0"},
             "bf16, int8 KV (K2q)": {"XOT_KV_QUANT": "int8"}}
  shard = build_full_shard(model, TORCH)
  engines = {}
  for label, env in formats.items():
    with phase_env(XOT_PAGED_KV="0", **env):
      engines[label] = TorchShardInferenceEngine(device="cuda", seed=0)

  async def drive():
    last, steps = {}, {label: [] for label in engines}
    for label, engine in engines.items():
      last[label], _ = await engine.infer_sample_tensor("alt", shard, np.ones((1, 514), np.int64),
                                                        temp=0.0, top_k=0)
      out = await engine.generate_chunk("alt", shard, int(last[label]), 8, temp=0.0)  # warm
      last[label] = int(np.asarray(out).reshape(-1)[-1])
    for _ in range(rounds):
      for label, engine in engines.items():
        t0 = time.perf_counter()
        out = await engine.generate_chunk("alt", shard, last[label], n, temp=0.0)
        steps[label].append((time.perf_counter() - t0) * 1e3 / n)
        last[label] = int(np.asarray(out).reshape(-1)[-1])
    for engine in engines.values():
      await engine.clear_request("alt")
    return steps

  try:
    steps = asyncio.run(drive())
  finally:
    for engine in engines.values():
      engine.executor.shutdown(wait=True)
  for label, ms in steps.items():
    print(f"[alternate] {label}: B=1 wall ms a step, {rounds} rounds of {n} taken in turn: "
          + ", ".join(f"{m:.2f}" for m in ms) + f"; median {sorted(ms)[len(ms) // 2]:.2f} ({card})",
          flush=True)
  return steps


CONCURRENT_WORDS = (64, 128, 256, 300, 514, 1000, 1502, 2000)


def drive_concurrent(torch, card: str, paged: bool, device: str = "cuda",
                     model: str = "synthetic-llama-1b", max_tokens: int = 64,
                     env=None, quant_kernel=None) -> dict:
  """A fresh server (XOT_PAGED_KV as `paged`, XOT_PREFILL_CHUNK 1024, and `env`, e.g.
  XOT_QUANTIZE, while it is built) answers eight concurrent streaming chat
  completions of 64 to 2000 words, half at temperature 0 and half at 0.6, after one
  unmeasured warm-up pass of the same eight. The batcher coalesces their decode
  chunks; with `quant_kernel` every decode step's 7 projections a layer must go
  through it. Then one B=8 decode chunk under the profiler. Returns the kernels'
  launch counts over the measured pass and each temperature-0 request's tokens."""
  from concurrent.futures import ThreadPoolExecutor
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.models.registry import build_full_shard, get_model_card
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention

  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention_int8
  from xotorch_tpu_torch.ops.paged_attention import (paged_decode_attention_int8,
                                                     paged_prefill_attention_int8)

  env = env or {}
  kv8 = env.get("XOT_KV_QUANT") == "int8"
  tag = (("paged" if paged else "contiguous") + (f" {env['XOT_QUANTIZE']}" if "XOT_QUANTIZE" in env else "")
         + (" int8-KV" if kv8 else ""))
  os.environ["XOT_PAGED_KV"] = "1" if paged else "0"
  os.environ["XOT_PREFILL_CHUNK"] = "1024"
  args = port_main.build_parser().parse_args(
    ["--device", device, "--default-model", model, "--chatgpt-api-host", "127.0.0.1",
     "--chatgpt-api-port", "0", "--chatgpt-api-response-timeout", "600"])
  with phase_env(**env):  # the engine reads its knobs when it is built
    node, engine, classname, api = port_main.build_node(args)
  layers = get_model_card(model)["layers"]
  bodies = [{"model": model, "max_tokens": max_tokens, "stream": True,
             "temperature": 0.0 if i % 2 == 0 else 0.6, "stream_options": {"include_usage": True},
             "messages": [{"role": "user", "content": " ".join(f"w{j % 97}" for j in range(n))}]}
            for i, n in enumerate(CONCURRENT_WORDS)]
  # The request id the API gives each prompt, and the tokens the node streams for it.
  prompt_of, tokens_of = {}, {}
  serve_prompt = node.process_prompt

  async def traced(base_shard, prompt, request_id=None, *a, **kw):
    prompt_of[request_id] = prompt
    return await serve_prompt(base_shard, prompt, request_id, *a, **kw)
  node.process_prompt = traced
  node.on_token.register("chip-smoke").on_next(
    lambda rid, toks, finished: tokens_of.__setitem__(rid, list(toks)))
  kernels = (flash_attention, flash_cached_attention, paged_decode_attention,
             paged_prefill_attention, flash_cached_attention_int8, paged_decode_attention_int8,
             paged_prefill_attention_int8) + ((quant_kernel,) if quant_kernel else ())
  # The attention kernels of this cache format, and the counters that must stay 0.
  own = "_int8" if kv8 else ""
  other = "" if kv8 else "_int8"

  async def drive():
    server = await api.start("127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/v1/chat/completions"
    loop = asyncio.get_running_loop()
    pool = ThreadPoolExecutor(max_workers=len(bodies))
    try:
      await engine.ensure_shard(build_full_shard(model, classname))

      async def all_at_once(bs):
        return await asyncio.gather(*(loop.run_in_executor(pool, http_stream, url, b) for b in bs))

      t0 = time.perf_counter()
      await all_at_once([{**b, "max_tokens": 8} for b in bodies])
      print(f"[{tag}] warm-up: 8 concurrent requests in {time.perf_counter() - t0:.2f} s", flush=True)
      await wait_idle(engine)
      batcher = engine._ctx.batcher
      batcher.dispatches = batcher.rows = batcher.steps = 0
      if paged:
        engine._ctx.page_pool.peak_pages_in_use = engine._ctx.page_pool.pages_in_use
      prompt_of.clear()
      for k in kernels:
        k.launches = 0
      t0 = time.perf_counter()
      results = await all_at_once(bodies)
      wall = time.perf_counter() - t0
      counts = {k.__name__: k.launches for k in kernels}
      dispatches, rows, steps = batcher.dispatches, batcher.rows, batcher.steps
      total, segments = 0, 0
      for body, (events, first, last) in zip(bodies, results):
        usage = events[-1].get("usage") or {}
        finish = [c["finish_reason"] for e in events for c in e.get("choices", [])
                  if c.get("finish_reason")]
        n = usage.get("completion_tokens", 0)
        total += n
        segments += -(-usage.get("prompt_tokens", 0) // 1024)
        rate = (n - 1) / (last - first) if n > 1 and last > first else float("nan")
        ok = n == max_tokens and finish == ["length"]
        words = len(body["messages"][0]["content"].split())
        print(f"[{tag}] {words}-word prompt ({usage.get('prompt_tokens')} tokens), temperature "
              f"{body['temperature']}: {n} tokens, finish {finish}, TTFT {first * 1e3:.1f} ms, "
              f"decode {rate:.1f} tok/s ({card}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
          raise AssertionError(f"{tag}: {words}-word request returned {n} tokens ({finish})")
      await wait_idle(engine)
      stats = engine.page_pool_stats()
      print(f"[{tag}] 8 concurrent requests: {total} tokens in {wall:.3f} s = {total / wall:.1f} "
            f"tok/s aggregate; batcher {dispatches} dispatches, mean width {rows / dispatches:.2f}, "
            f"{steps} decode steps; launches {counts}; pool {stats} ({card})", flush=True)
      if rows / dispatches <= 1:
        raise AssertionError(f"{tag}: the batcher never coalesced (mean width {rows / dispatches})")
      idle = [n + other for n in ("flash_cached_attention", "paged_decode_attention",
                                  "paged_prefill_attention")]
      idle += (["flash_cached_attention" + own] if paged
               else ["paged_decode_attention" + own, "paged_prefill_attention" + own])
      if any(counts[n] for n in idle):
        raise AssertionError(f"{tag}: launches {counts}: {idle} should not run")
      if paged:
        k3, k4 = counts["paged_decode_attention" + own], counts["paged_prefill_attention" + own]
        if k3 != steps * layers or k4 != segments * layers:
          raise AssertionError(f"{tag}: launches {counts} disagree with {steps} decode steps and "
                               f"{segments} prefill segments x {layers} layers")
        if stats["pages_in_use"] != 0:
          raise AssertionError(f"{tag}: {stats['pages_in_use']} pool pages left in use")
      elif counts["flash_cached_attention" + own] < steps * layers:
        raise AssertionError(f"{tag}: launches {counts} disagree with {steps} decode steps")
      if quant_kernel and counts[quant_kernel.__name__] != 7 * layers * steps:
        raise AssertionError(f"{tag}: {quant_kernel.__name__} ran {counts[quant_kernel.__name__]} "
                             f"times, not 7 x {layers} layers x {steps} decode steps")
      bytes_per_token = None
      if paged:
        arena_pool = engine._ctx.page_pool
        bytes_per_token = (sum(t.numel() * t.element_size() for t in arena_pool.arena.values())
                           / (arena_pool.num_pages * arena_pool.page_size))
        print(f"[{tag}] page arena: {bytes_per_token:.0f} bytes per token over {layers} layers "
              f"({', '.join(f'{n} {t.dtype}' for n, t in arena_pool.arena.items())})", flush=True)
      profiled = await profile_decode(torch, engine, model, classname, card, batch=len(bodies))
      by_words = sorted(prompt_of, key=lambda rid: len(prompt_of[rid].split()))
      greedy = {CONCURRENT_WORDS[i]: tokens_of[rid] for i, rid in enumerate(by_words)
                if bodies[i]["temperature"] == 0.0}
      return counts, greedy, profiled, bytes_per_token
    finally:
      pool.shutdown(wait=True)
      server.close()
      await server.wait_closed()
      await node.stop()

  counts, greedy, profiled, bytes_per_token = asyncio.run(drive())
  engine.executor.shutdown(wait=True)
  return {"launches": counts, "greedy": greedy, "profile": profiled,
          "bytes_per_token": bytes_per_token}


async def wait_idle(engine, timeout: float = 30.0) -> None:
  """Wait until the node's end-of-request cleanups have run on the engine (the
  client sees a stream end before its request's state is cleared)."""
  t_end = time.perf_counter() + timeout
  while engine._ctx.states and time.perf_counter() < t_end:
    await asyncio.sleep(0.05)
  await engine._run(lambda: None)


RING_IDS = ("ring-b", "ring-a")  # equal memories: the ring orders its peers by id,
                                 # descending, so ring-b holds the first half of the layers


def write_ring_config(path: str, ports: dict, caps: dict) -> None:
  """The manual discovery config that names the ring's peers, on 127.0.0.1."""
  with open(path, "w") as f:
    json.dump({"peers": {i: {"address": "127.0.0.1", "port": port, "device_capabilities": caps}
                         for i, port in ports.items()}}, f)


def greedy_streams_agree(tag: str, main_run: dict, streams: dict) -> None:
  """Every temperature-0 request's tokens, {main_requests index: tokens}, must equal the
  single-peer main path's for the same request."""
  for j, (label, body) in enumerate(main_requests("synthetic-llama-1b")):
    if body.get("temperature") != 0 or j not in streams:
      continue
    want, got = main_run["tokens"][j], streams[j]
    same = sum(a == b for a, b in zip(want, got))
    ok = got == want
    print(f"[{tag}] {label}: {same}/{len(want)} temperature-0 tokens equal the single-peer "
          f"main path's {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: {label} streamed {got}, the main path {want}")


def drive_ring_inprocess(torch, card: str, main_run: dict, device: str = "cuda",
                         model: str = "synthetic-llama-1b") -> dict:
  """Phase 10: two Nodes in this process, each with its own engine on `device`, built by
  main.build_node with manual discovery and linked by the TCP transport on 127.0.0.1,
  serve `model` split in two. The main path's three requests enter at the owner of
  layer 0 through process_prompt. Holds K1's and K2's launches to the main path's
  formulas summed over both engines (K1 = layers x fresh prefills, K2 = layers x
  (decode steps + segments at pos > 0)), every hidden-state hop to bf16 at 2 x T x
  hidden bytes, and the temperature-0 streams to the main path's. Returns the hop and
  wire figures."""
  import tempfile
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.api.chatgpt_api import build_prompt
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer
  from xotorch_tpu_torch.models.registry import build_base_shard
  from xotorch_tpu_torch.networking.tcp import peer_handle as tcp_peer_handle
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.topology.device_capabilities import device_capabilities_sync
  from xotorch_tpu_torch.utils.helpers import find_available_port

  tag = "ring, 1 process"
  kernels = (flash_attention, flash_cached_attention)
  hops = []  # (the tensor's descriptor, frame bytes on the wire) of every SendTensor
  real_encode = tcp_peer_handle.encode_message

  def recording(fields, tensors=None):
    frame = real_encode(fields, tensors)
    if fields.get("rpc") == "SendTensor":
      header_len = int.from_bytes(frame[4:8], "big")
      hops.append((json.loads(frame[8:8 + header_len])["tensors"]["tensor"], 4 + len(frame)))
    return frame

  with phase_env(XOT_PAGED_KV="0", XOT_PREFILL_CHUNK="1024"), tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "ring.json")
    ports = {i: find_available_port("127.0.0.1") for i in RING_IDS}
    write_ring_config(path, ports, device_capabilities_sync().to_dict())
    built = {}
    for i in RING_IDS:
      args = port_main.build_parser().parse_args(
        ["--device", device, "--default-model", model, "--node-id", i, "--node-host", "127.0.0.1",
         "--node-port", str(ports[i]), "--discovery-module", "manual",
         "--discovery-config-path", path])
      built[i] = port_main.build_node(args)
    nodes = {i: b[0] for i, b in built.items()}
    engines = {i: b[1] for i, b in built.items()}
    classname = built[RING_IDS[0]][2]
    tokenizer = DummyTokenizer()

    async def serve(node, base, prompt: str, rid: str, body: dict) -> dict:
      done = asyncio.Event()
      out = {"tokens": [], "first": None, "last": None}
      t0 = time.perf_counter()

      def on_token(r, toks, finished):
        if r != rid:
          return
        out["tokens"] = list(toks)
        if toks and out["first"] is None:
          out["first"] = time.perf_counter() - t0
        if finished:
          out["last"] = time.perf_counter() - t0
          done.set()
      node.on_token.register(rid).on_next(on_token)
      await node.process_prompt(base, prompt, rid, max_tokens=body["max_tokens"],
                                temperature=body.get("temperature"))
      await asyncio.wait_for(done.wait(), 600)
      node.on_token.deregister(rid)
      error = node.request_errors.pop(rid, None)
      if error is not None:
        raise AssertionError(f"{tag}: request {rid} failed: {error}")
      return out

    async def drive():
      try:
        t0 = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(*(n.start(wait_for_peers=1) for n in nodes.values())), 120)
        base = build_base_shard(model, classname)
        layers = {i: nodes[i].get_current_shard(base) for i in RING_IDS}
        half = base.n_layers // 2
        if [(s.start_layer, s.end_layer) for s in layers.values()] != [(0, half - 1), (half, base.n_layers - 1)]:
          raise AssertionError(f"{tag}: layers {layers}")
        await asyncio.gather(*(engines[i].ensure_shard(layers[i]) for i in RING_IDS))
        print(f"[{tag}] {RING_IDS[0]} layers 0-{half - 1}, {RING_IDS[1]} layers {half}-"
              f"{base.n_layers - 1} on {device}, started and loaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        before = {i: port_main.wire_counts(nodes[i]) for i in RING_IDS}
        hops.clear()
        for k in kernels:
          k.launches = 0
        runs, fresh, segments, steps = [], 0, 0, 0
        for j, (label, body) in enumerate(main_requests(model)):
          prompt = build_prompt(tokenizer, body["messages"])
          out = await serve(nodes[RING_IDS[0]], base, prompt, f"ring-inprocess-{j}", body)
          fresh += 1
          segments += (len(tokenizer.encode(prompt)) - 1) // 1024
          steps += len(out["tokens"]) - 1
          runs.append((label, body, out))
        counts = {k.__name__: k.launches for k in kernels}
        wire = {}
        for i in RING_IDS:
          for method, row in port_main.wire_counts(nodes[i]).items():
            was = before[i].get(method, [0, 0, 0])
            acc = wire.setdefault(method, [0, 0, 0])
            for c in range(3):
              acc[c] += row[c] - was[c]
        hop_s = sorted(s for n in nodes.values() for p in n.peers for m, s in p.hop_seconds
                       if m == "SendTensor")
        return runs, counts, fresh, segments, steps, wire, hop_s, base.n_layers, engines[RING_IDS[0]].cfg.hidden_size
      finally:
        for n in nodes.values():
          await n.stop()

    tcp_peer_handle.encode_message = recording
    try:
      runs, counts, fresh, segments, steps, wire, hop_s, n_layers, hidden = asyncio.run(drive())
    finally:
      tcp_peer_handle.encode_message = real_encode
      for e in engines.values():
        e.executor.shutdown(wait=True)

  streams = {}
  for j, (label, body, out) in enumerate(runs):
    n = len(out["tokens"])
    rate = (n - 1) / (out["last"] - out["first"]) if n > 1 else float("nan")
    ok = n == body["max_tokens"]
    print(f"[{tag}] {label}: {n} tokens, TTFT {out['first'] * 1e3:.1f} ms, decode {rate:.1f} tok/s "
          f"(main path: {main_run['timings'][j]}) ({card}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: {label} returned {n} tokens, wanted {body['max_tokens']}")
    streams[j] = out["tokens"]
  greedy_streams_agree(tag, main_run, streams)
  want = {"flash_attention": n_layers * fresh, "flash_cached_attention": n_layers * (steps + segments)}
  ok = counts == want
  print(f"[{tag}] launches over both engines {counts}: K1 = {n_layers} layers x {fresh} fresh "
        f"prefills, K2 = {n_layers} x ({steps} decode steps + {segments} segment at pos > 0) "
        f"({want}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{tag}: launches {counts}, wanted {want}")
  hidden_hops = [(d, b) for d, b in hops if len(d["shape"]) == 3]
  bad = [d for d, _ in hidden_hops
         if d["dtype"] != "bfloat16" or d["nbytes"] != 2 * d["shape"][1] * hidden or d["shape"][0] != 1]
  prefill = [(d, b) for d, b in hidden_hops if d["shape"][1] > 1]
  decode = [(d, b) for d, b in hops if d["shape"][1] == 1]
  ok = not bad and len(prefill) == fresh and len(decode) == 2 * steps
  print(f"[{tag}] hidden-state hops: {len(hidden_hops)}, every one bfloat16 at 2 x T x {hidden} "
        f"bytes ({len(prefill)} prefill hops of {', '.join(str(d['shape'][1]) for d, _ in prefill)} "
        f"positions, {len(decode)} decode-step hops for {steps} steps: hidden state and token) "
        f"{'ok' if ok and not bad else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{tag}: hops {bad or [d for d, _ in hops]}")
  tokens = steps + fresh
  calls = {m: row[0] for m, row in wire.items() if row[0]}
  decode_bytes = sum(b for _, b in decode)
  result_bytes = wire.get("SendResult", [0, 0, 0])[1]
  acks = sum(wire[m][2] for m in ("SendTensor", "SendResult") if m in wire)
  figures = {
    "hops_per_step": len(decode) / max(steps, 1),
    "hop_bytes_per_step": decode_bytes / max(steps, 1),
    "results_per_token": calls.get("SendResult", 0) / tokens,
    "result_bytes_per_token": result_bytes / tokens,
    "ack_bytes_per_step": acks / max(steps, 1),
    "hop_ms_median": 1e3 * hop_s[len(hop_s) // 2] if hop_s else float("nan"),
    "hop_ms_max": 1e3 * hop_s[-1] if hop_s else float("nan"),
  }
  print(f"[{tag}] wire a decode step: {figures['hops_per_step']:.2f} SendTensor frames, "
        f"{figures['hop_bytes_per_step']:.0f} bytes; a sampled token: "
        f"{figures['results_per_token']:.2f} SendResult frames, "
        f"{figures['result_bytes_per_token']:.0f} bytes; acks {figures['ack_bytes_per_step']:.0f} "
        f"bytes a step; SendTensor to ack median {figures['hop_ms_median']:.3f} ms, max "
        f"{figures['hop_ms_max']:.3f} ms (the prefill hops); calls {calls} ({card})", flush=True)
  return figures


def drive_ring_processes(torch, card: str, main_run: dict, device: str = "cuda",
                         model: str = "synthetic-llama-1b", timeout: float = 240.0) -> dict:
  """Phase 11: two `python -m xotorch_tpu_torch.main` peers, each its own process with
  its own CUDA context, found by manual discovery over one config naming both, with
  their own node and API ports and --wait-for-peers 1. The main path's three requests
  go to the API of the peer that holds the last layers (so each prompt is forwarded
  to the owner of layer 0) and the first one also to the other peer's API. The
  temperature-0 streams must equal the main path's: the sampler peer runs at DEBUG=2,
  which logs each sampled token with its request id (so its rates include that log
  line a token), the other at DEBUG=1; each reports its TCP traffic at shutdown. Both children are stopped with SIGTERM and must exit 0; none is left."""
  import signal
  import re
  import tempfile
  from xotorch_tpu_torch.topology.device_capabilities import device_capabilities_sync
  from xotorch_tpu_torch.utils.helpers import find_available_port

  tag = "ring, 2 processes"
  requests = main_requests(model)
  procs, logs, texts = {}, {}, {}
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "ring.json")
    node_ports = {i: find_available_port("127.0.0.1") for i in RING_IDS}
    api_ports = {i: find_available_port("127.0.0.1") for i in RING_IDS}
    write_ring_config(path, node_ports, device_capabilities_sync().to_dict())
    env = {**os.environ, "XOT_PAGED_KV": "0", "XOT_PREFILL_CHUNK": "1024", "PYTHONUNBUFFERED": "1"}
    bases = {i: f"http://127.0.0.1:{api_ports[i]}" for i in RING_IDS}
    results = []
    try:
      t0 = time.perf_counter()
      for i in RING_IDS:
        logs[i] = os.path.join(tmp, f"{i}.log")
        cmd = [sys.executable, "-m", "xotorch_tpu_torch.main", "--device", device,
               "--default-model", model, "--node-id", i, "--node-host", "127.0.0.1",
               "--node-port", str(node_ports[i]), "--chatgpt-api-host", "127.0.0.1",
               "--chatgpt-api-port", str(api_ports[i]), "--chatgpt-api-response-timeout", "600",
               "--discovery-module", "manual", "--discovery-config-path", path,
               "--wait-for-peers", "1"]
        with open(logs[i], "w") as log:
          debug = "2" if i == RING_IDS[1] else "1"
          procs[i] = subprocess.Popen(cmd, cwd=ROOT, env={**env, "DEBUG": debug}, stdout=log,
                                      stderr=subprocess.STDOUT)
      pending = set(RING_IDS)
      while pending:
        for i in sorted(pending):
          if procs[i].poll() is not None:
            raise AssertionError(f"{tag}: {i} exited {procs[i].returncode} while starting")
          try:
            if http_json(bases[i] + "/healthcheck", timeout=5).get("status") == "ok":
              pending.discard(i)
          except OSError:
            pass
        if time.perf_counter() - t0 > timeout:
          raise AssertionError(f"{tag}: {sorted(pending)} not serving after {timeout:.0f} s")
        time.sleep(0.25)
      print(f"[{tag}] both peers serving in {time.perf_counter() - t0:.1f} s", flush=True)
      url = bases[RING_IDS[1]] + "/v1/chat/completions"
      for _, body in requests:  # first-use costs out of the measured run, as on the main path
        http_json(url, {**body, "max_tokens": 2, "stream": False})
      plan = [(RING_IDS[1], j) for j in range(len(requests))] + [(RING_IDS[0], 0)]
      for target, j in plan:
        label, body = requests[j]
        url = bases[target] + "/v1/chat/completions"
        t1 = time.perf_counter()
        if body.get("stream"):
          events, first, last = http_stream(url, body)
          rid = events[0]["id"][len("chatcmpl-"):]
          n = (events[-1].get("usage") or {}).get("completion_tokens", 0)
          rate = (n - 1) / (last - first) if n > 1 and last > first else float("nan")
          timing = f"TTFT {first * 1e3:.1f} ms, decode {rate:.1f} tok/s"
        else:
          resp = http_json(url, body)
          rid = resp["id"][len("chatcmpl-"):]
          n = resp["usage"]["completion_tokens"]
          timing = f"end to end {(time.perf_counter() - t1) * 1e3:.1f} ms"
        results.append((target, j, rid, n, timing))
    finally:
      for p in procs.values():
        if p.poll() is None:
          p.send_signal(signal.SIGTERM)
      for p in procs.values():
        try:
          p.wait(timeout=60)
        except subprocess.TimeoutExpired:
          p.kill()
          p.wait(timeout=60)
      for i, log in logs.items():
        with open(log) as f:
          texts[i] = f.read()
  alive = [i for i, p in procs.items() if p.poll() is None]
  codes = {i: p.returncode for i, p in procs.items()}
  ok = not alive and all(c == 0 for c in codes.values())
  print(f"[{tag}] children stopped: exit codes {codes}, none left {'ok' if ok else 'FAIL'}",
        flush=True)
  if not ok:
    tails = "\n".join(f"--- {i}\n{t[-3000:]}" for i, t in texts.items())
    raise AssertionError(f"{tag}: children left {alive}, exit codes {codes}\n{tails}")
  # The sampler peer (the last layers) logs "[<request id>] token <id> (<n> so far)".
  tokens_of = {}
  for rid, tok in re.findall(r"^\[([0-9a-f-]+)\] token (\d+) \(\d+ so far\)$", texts[RING_IDS[1]], re.M):
    tokens_of.setdefault(rid, []).append(int(tok))
  for target, j, rid, n, timing in results:
    label, body = requests[j]
    got = tokens_of.get(rid, [])
    ok = n == body["max_tokens"] == len(got)
    print(f"[{tag}] {label} into {target}'s API: {n} tokens, {timing} (main path: "
          f"{main_run['timings'][j]}) ({card}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: {label} into {target}: {n} tokens, {len(got)} logged\n"
                           f"{texts[RING_IDS[1]][-3000:]}")
    if body.get("temperature") == 0:
      greedy_streams_agree(f"{tag}, into {target}", main_run, {j: got})
  wire = {}
  for i, text in texts.items():
    found = re.findall(r"^wire (\S+): (\{.*\})$", text, re.M)
    if not found:
      raise AssertionError(f"{tag}: {i} reported no wire counts")
    wire[i] = json.loads(found[-1][1])
  prompts = len(requests) + len(plan)
  steps = sum(n - 1 for *_, n, _ in results) + len(requests)  # the warm-up's 2 tokens: one step each
  sent = sum(row[0] for w in wire.values() for m, row in w.items() if m == "SendTensor")
  print(f"[{tag}] over both children's lives: {sent} SendTensor frames for {prompts} prompts "
        f"and {steps} decode steps = {(sent - prompts) / max(steps, 1):.2f} a step; wire "
        f"{json.dumps(wire)} ({card})", flush=True)
  return {"wire": wire}


# gemma-2-2b (google/gemma-2-2b, its published config.json): the family that puts the
# windowed, softcapped kernels and head_dim 256 on a serving path.
GEMMA_CONFIG = {
  "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2", "attention_bias": False,
  "attention_dropout": 0.0, "attn_logit_softcapping": 50.0, "bos_token_id": 2,
  "cache_implementation": "hybrid", "eos_token_id": 1, "final_logit_softcapping": 30.0,
  "head_dim": 256, "hidden_act": "gelu_pytorch_tanh", "hidden_activation": "gelu_pytorch_tanh",
  "hidden_size": 2304, "initializer_range": 0.02, "intermediate_size": 9216,
  "max_position_embeddings": 8192, "num_attention_heads": 8, "num_hidden_layers": 26,
  "num_key_value_heads": 4, "pad_token_id": 0, "query_pre_attn_scalar": 256,
  "rms_norm_eps": 1e-06, "rope_theta": 10000.0, "sliding_window": 4096,
  "torch_dtype": "float32", "use_cache": True, "vocab_size": 256000,
}
GEMMA_CARD = "gemma2-2b"  # its registry card; the repo directory is google--gemma-2-2b-it
GEMMA_WINDOW, GEMMA_SOFTCAP = 4096, 50.0
# The kernel cases at gemma-2-2b's attention widths and scale (query_pre_attn_scalar
# 256). Its queries are scaled by 8, so scores spread with a deviation of 8 and the
# largest of a few thousand reach 30, where the softcap of 50 bends them: dropping the
# softcap, or reading a window's keys past its edge, moves the output far beyond the
# limit.
GEMMA_2B = Widths(8, 4, 256, "gemma-2-2b Hq=8 Hkv=4 D=256 ", 256.0 ** -0.5, 8.0, True)
GEMMA_LONG_WORDS = 4100  # a prompt past the window: its last positions see 4096 keys on
                         # the windowed layers, all of them on the global ones


def check_gemma_kernels(torch) -> None:
  """K1-K4 and their int8 variants at gemma-2-2b's widths (GEMMA_2B: Hq 8, Hkv 4, D 256,
  the query_pre_attn_scalar scale 1/16, softcap 50 on every layer, window 4096 on the
  windowed ones), each against its plain version within rel_limit, with controls: the
  kernel run with its softcap or its window dropped must miss that limit. Timed beside
  the plain version, the bound and one compiled flex_attention (SDPA for the one case
  without a softcap): K1/K1w at T 1024 and 4608; K2/K2w/K2q decoding at S 8192 from
  4500 (the window bites) and a 512-query segment; K3/K3w/K3q and K4/K4w/K4q at page
  128. Then every kernel at D 256 and D 32 (which K3/K4 lacked) with scale 0.1, not
  the default 1/sqrt(D), so a dropped scale is a control too, pages 16 and 128
  (correctness and controls), and each D 256 wrapper once under
  torch.cuda.set_sync_debug_mode("error")."""
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention
  w, cap, win = GEMMA_2B, GEMMA_SOFTCAP, GEMMA_WINDOW
  draw = seeded_randn(torch, 256)
  gen = torch.Generator(device="cuda")
  gen.manual_seed(256)

  for T, window, softcap in ((1024, 0, 0.0), (1024, 0, cap), (4608, 0, cap), (4608, win, cap)):
    k1_case(torch, w, draw, 1, T, window, softcap)
  for T, start, window in ((1, 4500, win), (1, 4500, 0), (512, 4096, win)):
    for int8 in (False, True):
      k2_case(torch, w, draw, gen, 1, T, 8192, [start], window, cap, int8)
  for T, n in ((1, 4501), (512, 4608)):
    for window, int8 in ((0, False), (0, True), (win, False)):
      paged_case(torch, w, draw, gen, [n], 128, T, window, cap, int8)

  for d in (256, 32):
    sw = w._replace(d=d, scale=0.1, tag=f"gemma-2-2b Hq=8 Hkv=4 D={d} scale=0.1 ")
    for window, softcap in ((0, 0.0), (50, 10.0)):
      k1_case(torch, sw, draw, 2, 300, window, softcap, timed=False)
      for int8 in (False, True):
        for T, starts in ((1, [0, 200, 511]), (20, [100, 37, 400])):
          k2_case(torch, sw, draw, gen, 3, T, 544, starts, window, softcap, int8, timed=False)
        for pg in (16, 128):
          for T, lengths in ((1, [1, 200, 511]), (20, [20, 137, 420])):
            paged_case(torch, sw, draw, gen, lengths, pg, T, window, softcap, int8, timed=False)

  # Each D 256 wrapper once with host reads of device tensors refused.
  hq, hkv, d, page = w.hq, w.hkv, w.d, 128
  q1, qs = draw(1, 1, hq, d), draw(1, 64, hq, d)
  kc, vc = draw(1, 8192, hkv, d), draw(1, 8192, hkv, d)
  (kq, ks), (vq, vs) = spread_quantize(torch, gen, kc), spread_quantize(torch, gen, vc)
  start = torch.tensor([4500], dtype=torch.int32, device=q1.device)
  q, kp, vp, table, lens = paged_inputs(torch, draw, [4501], page, hq, hkv, d)
  (kpq, ksp), (vpq, vsp) = spread_quantize(torch, gen, kp), spread_quantize(torch, gen, vp)
  kw = dict(window=win, softcap=cap, scale=w.scale)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    flash_attention(qs, kc[:, :64].contiguous(), vc[:, :64].contiguous(), **kw)
    for qq in (q1, qs):
      flash_cached_attention(qq, kc, vc, start, **kw)
      flash_cached_attention(qq, kq, vq, start, k_scale=ks, v_scale=vs, **kw)
    paged_decode_attention(q, kp, vp, table, lens, **kw)
    paged_decode_attention(q, kpq, vpq, table, lens, k_scale_pages=ksp, v_scale_pages=vsp, **kw)
    paged_prefill_attention(q, kp, vp, table, lens, **kw)
    paged_prefill_attention(q, kpq, vpq, table, lens, k_scale_pages=ksp, v_scale_pages=vsp, **kw)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  print(f"[gemma kernels] K1, K2, K2q, K3, K3q, K4 and K4q at D=256 ran with "
        f"torch.cuda.set_sync_debug_mode('error'): no host read of a device tensor", flush=True)


def write_gemma_checkpoint(torch, model_dir, device: str = "cuda") -> float:
  """A gemma-2-2b-shaped HF checkpoint in `model_dir`: the published config, seeded
  random bf16 weights written by the port's own save_shard_params as two files (layers
  0-12 with the tied embedding, layers 13-25 with the final norm) plus
  model.safetensors.index.json, and a word-level tokenizer (write_word_tokenizer).
  Returns its GB on disk."""
  from pathlib import Path
  from xotorch_tpu_torch.inference.shard import Shard
  from xotorch_tpu_torch.models import weights
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.transformer import init_random_params
  model_dir = Path(model_dir)
  model_dir.mkdir(parents=True, exist_ok=True)
  cfg = config_from_hf_dict(GEMMA_CONFIG)
  n = cfg.num_layers
  weight_map = {}
  for i, (start, end) in enumerate(((0, n // 2 - 1), (n // 2, n - 1))):
    shard = Shard(GEMMA_CARD, start, end, n)
    params = init_random_params(cfg, end - start + 1, shard.is_first_layer, shard.is_last_layer,
                                seed=0, dtype=torch.bfloat16, device=device, start_layer=start)
    if not shard.is_first_layer:
      params.pop("embed")  # tied: written once, with the first shard
    name = f"model-{i + 1:05d}-of-00002.safetensors"
    weights.save_shard_params(params, cfg, shard, model_dir / name)
    del params
    weight_map.update((t, name) for t in weights._read_header(model_dir / name)[0])
  total = sum((model_dir / f).stat().st_size for f in set(weight_map.values()))
  (model_dir / "model.safetensors.index.json").write_text(
    json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
  (model_dir / "config.json").write_text(json.dumps(GEMMA_CONFIG))
  write_word_tokenizer(model_dir, cfg.vocab_size)
  return total / 1e9


def write_word_tokenizer(model_dir, vocab_size: int) -> None:
  """A word-level tokenizer over the whole vocabulary (tokenizer.json and
  tokenizer_config.json): gemma's special tokens at its ids (<eos> 1, <bos> 2), the
  requests' words w0-w96 and the chat roles, then t<id> for every other id, so every
  sampled id decodes to text. With `transformers` the engine and the API build it;
  without, they serve the DummyTokenizer and the config's eos (one token a word
  either way, plus the roles)."""
  special = ["<pad>", "<eos>", "<bos>", "<unk>"]
  words = special + [f"w{i}" for i in range(97)] + ["user", "assistant", "system", ":"]
  vocab = {t: i for i, t in enumerate(words)}
  vocab.update((f"t{i}", i) for i in range(len(words), vocab_size))
  (model_dir / "tokenizer.json").write_text(json.dumps({
    "version": "1.0", "truncation": None, "padding": None, "normalizer": None,
    "added_tokens": [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False, "special": True} for t in special],
    "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None, "decoder": None,
    "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}))
  (model_dir / "tokenizer_config.json").write_text(json.dumps({
    "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<bos>", "eos_token": "<eos>",
    "unk_token": "<unk>", "pad_token": "<pad>", "model_max_length": 8192}))


def check_gemma_model(torch, model_dir, limit: float = 5e-2, T: int = 4200,
                      device: str = "cuda") -> None:
  """Two layers of the gemma-2-2b checkpoint at full width, read by load_shard_params:
  layer 0 windowed (4096), layer 1 global. A T-token prefill (past the window, so it
  bites) through K1/K1w and four decode steps through K2/K2w in bf16 on the card,
  against the plain path in fp32 on the CPU on the same checkpoint: the last 64
  positions' logits (the 256000-row unembedding of every position would cost the CPU
  minutes), then each step's, within `limit` of the logits' range; K1 and K2 launched
  once a layer a call, half of them windowed."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.inference.shard import Shard
  from xotorch_tpu_torch.models.config import load_model_config
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, unembed
  from xotorch_tpu_torch.models.weights import load_shard_params
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  cfg = dataclasses.replace(load_model_config(model_dir), num_layers=2)
  shard = Shard(GEMMA_CARD, 0, 1, 2)
  tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(1, T))
  steps = 4

  def run(device, dtype, **kw):
    params = load_shard_params(model_dir, cfg, shard, dtype=dtype, device=device)
    cache = init_kv_cache(cfg, 2, 1, T + steps, dtype, device)
    h, _ = forward_shard(params, torch.as_tensor(tokens, device=device), cache, 0, cfg, True,
                         False, use_flash=bool(kw))
    out = [unembed(params, h[:, -64:], cfg)[0].float().cpu()]
    for i in range(steps):
      tok = torch.tensor([[int(tokens[0, i])]], device=device)
      logits, _ = forward_shard(params, tok, cache, T + i, cfg, True, True,
                                use_flash_decode=bool(kw))
      out.append(logits[0].float().cpu())
    return out

  with torch.inference_mode():
    t0 = time.perf_counter()
    want = run("cpu", torch.float32)
    cpu_s = time.perf_counter() - t0
    for k in (flash_attention, flash_cached_attention):
      k.launches = k.windowed_launches = 0
    got = run(device, torch.bfloat16, kernels=True)
  if not all(bool(torch.isfinite(g).all()) for g in got):
    raise AssertionError("gemma model: non-finite logits on the card")
  worst = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
  launched = {k.__name__: (k.launches, k.windowed_launches)
              for k in (flash_attention, flash_cached_attention)}
  ok = (worst < limit and launched["flash_attention"] == (2, 1)
        and launched["flash_cached_attention"] == (2 * steps, steps))
  print(f"[gemma model] 2-layer gemma-2-2b cut from the checkpoint (layer 0 window 4096, layer 1 "
        f"global), prefill {T} + decode {steps}: max logit error {worst:.3e} of the logits' range "
        f"(limit {limit:g}) over the last 64 positions and each step; launches (all, windowed) "
        f"{launched}; the CPU's fp32 path took {cpu_s:.1f} s {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"gemma model: error {worst} or launches {launched}")


def gemma_requests(model: str):
  """The main path's three requests, then a prompt past the window (temperature 0,
  streamed): its prompt and generation pass 4096 positions."""
  words = " ".join(f"w{i % 97}" for i in range(GEMMA_LONG_WORDS))
  return main_requests(model) + [
    (f"{GEMMA_LONG_WORDS}-word prompt (past the 4096 window), 64 tokens, streaming",
     {"model": model, "temperature": 0, "max_tokens": 64, "stream": True,
      "stream_options": {"include_usage": True}, "messages": [{"role": "user", "content": words}]})]


def drive_gemma(torch, card: str, device: str = "cuda") -> dict:
  """Phase 12: gemma-2-2b at full width and depth from an HF checkpoint on disk. Writes
  the checkpoint into a seed directory (write_gemma_checkpoint), holds a two-layer cut
  of it against the CPU (check_gemma_model), then serves it through main.py's entry
  points: a server started with --models-seed-dir (the seeding path, then the
  downloader's offline fast path out of XOT_HOME) answers gemma_requests with K1's and
  K2's counters read around them (K1 = 26 x prefills from 0 outside the scan, K2 = 26
  x (decode steps + segments at pos > 0 + the 4100-word prompt's four scanned
  segments), each half windowed) and one B=1 decode chunk under the
  profiler, then a fresh server with XOT_PAGED_KV=1
  the same (K4 = 26 x segments, K3 = 26 x decode steps, half windowed, 0 pages left),
  and the share of temperature-0 tokens the two agree on (bf16: not asserted). The
  contiguous server also answers one request with logprobs and a logit_bias, held
  against the log-softmax of its softcapped logits (gemma_extras). The
  checkpoint is deleted at the end. Returns the phase's launches by wrapper. (`device`
  lets the phase be rehearsed on the CPU with a small GEMMA_CONFIG.)"""
  import shutil
  import tempfile
  from pathlib import Path
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention
  layers = GEMMA_CONFIG["num_hidden_layers"]
  tmp = Path(tempfile.mkdtemp(prefix="xot-gemma-"))
  try:
    seed = tmp / "seed"
    model_dir = seed / "google--gemma-2-2b-it"
    t0 = time.perf_counter()
    gb = write_gemma_checkpoint(torch, model_dir, device)
    print(f"[gemma] checkpoint written by save_shard_params: {gb:.2f} GB in two safetensors files "
          f"and an index, in {time.perf_counter() - t0:.1f} s", flush=True)
    check_gemma_model(torch, model_dir, device=device)
    requests = gemma_requests(GEMMA_CARD)
    runs = {}
    with phase_env(XOT_HOME=str(tmp / "home")):
      for tag, env, kernels, cli, profiles in (
          ("gemma", {}, (flash_attention, flash_cached_attention), ("--models-seed-dir", str(seed)),
           (1,)),
          ("gemma paged", {"XOT_PAGED_KV": "1"}, (paged_prefill_attention, paged_decode_attention),
           (), ())):
        t0 = time.perf_counter()
        after = None
        if tag == "gemma":
          after = lambda *a: gemma_extras(torch, *a, card)  # noqa: E731
        run = drive_main_path(torch, card, device=device, model=GEMMA_CARD, kernels=kernels,
                              env=env, tag=tag, profiles=profiles, cli=cli, requests=requests,
                              focus="flash_cached_", after=after)
        runs[tag] = run
        segments = [-(-n // 1024) for n in run["prompt_tokens"]]
        # JAX's routing: a prompt with two or more whole segments before its last one
        # prefills them through prefill_scan (every segment through K2, the from-zero
        # one too), then its last through forward_sample; others take K1 for the first
        # segment and K2 for each later one.
        scanned = [(n - 1) // 1024 >= 2 for n in run["prompt_tokens"]]
        counts, steps = run["launches"], run["steps"]
        if tag == "gemma":
          if model_dir.exists() or not (tmp / "home" / "models" / model_dir.name).is_dir():
            raise AssertionError("gemma: --models-seed-dir did not move the checkpoint into XOT_HOME")
          k1 = sum(not sc for sc in scanned)
          k2 = sum(sg if sc else sg - 1 for sg, sc in zip(segments, scanned))
          want = {"flash_attention": layers * k1, "flash_cached_attention": layers * (steps + k2)}
          formula = (f"K1 = {layers} x {k1} prefills from 0 outside the scan, K2 = {layers} x "
                     f"({steps} decode steps + {k2} segments: at pos > 0, and every segment of "
                     f"{sum(scanned)} scanned prompt(s))")
        else:
          want = {"paged_prefill_attention": layers * sum(segments),
                  "paged_decode_attention": layers * steps}
          formula = (f"K4 = {layers} x {sum(segments)} segments, K3 = {layers} x {steps} decode "
                     f"steps")
        windowed = run["windowed"]
        pool = run["pool"]
        ok = (counts == want and all(2 * windowed[k] == counts[k] for k in counts)
              and steps >= run["decoded"] and (pool is None) == (tag == "gemma")
              and (pool is None or pool["pages_in_use"] == 0))
        print(f"[{tag}] launches {counts}: {formula} ({want}); prompt tokens "
              f"{run['prompt_tokens']}; tokenizer {run['tokenizer']}; pool {pool}; served in "
              f"{time.perf_counter() - t0:.1f} s with the load {'ok' if ok else 'FAIL'}", flush=True)
        print(f"[{tag}] windowed launches {windowed}: half of each ({card})", flush=True)
        if not ok:
          raise AssertionError(f"{tag}: launches {counts} (windowed {windowed}), wanted {want}; "
                               f"pool {pool}")
    same = total = 0
    for i, (_, body) in enumerate(requests):
      if body.get("temperature") == 0:
        a, b = runs["gemma"]["tokens"][i], runs["gemma paged"]["tokens"][i]
        same += sum(x == y for x, y in zip(a, b))
        total += max(len(a), len(b))
    print(f"[gemma paged] temperature-0 tokens the paged and contiguous servers agree on: "
          f"{same}/{total} = {100 * same / max(total, 1):.1f}% (bf16; not asserted)", flush=True)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  launches = {}
  for run in runs.values():
    launches.update(run["launches"])
  return launches


# ------------------------------------------------------------------ phase 13: fused decode

FUSED_FORMATS = (("bf16", {}), ("int4 K5", {"XOT_QUANTIZE": "int4"}),
                 ("int4 K5v4", {"XOT_QUANTIZE": "int4", "XOT_INT4_V": "4"}),
                 ("int8 K6", {"XOT_QUANTIZE": "int8", "XOT_INT8_KERNEL": "1"}),
                 ("bf16, int8 KV (K2q)", {"XOT_KV_QUANT": "int8"}))
FUSED_STEPS = 64  # decode steps a parity chunk runs, eager body against graph replays
FUSED_PAGE = 128
# The scan prefill against the per-segment loop over a 4096-token prompt: the two take
# different kernels for the from-zero segment (K2 against K1), so bf16 rounds at other
# places and the difference grows through 16 layers; both are held to the largest
# |hidden state| within the model cuts' limit.
PREFILL_REL_LIMIT = 5e-2


class FusedModel(NamedTuple):
  label: str
  cfg: object
  params: dict
  route: object
  kv_quant: bool
  dtype: object
  layers: int


def fused_model(torch, label: str, env: dict, card_config: dict, layers: int,
                device: str = "cuda", dtype=None) -> FusedModel:
  """Seeded random weights of `card_config` at full width in the format `env` asks
  (quantized on the device as the engine quantizes them), with the quantized route
  the engine takes under `env`."""
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.quantize import quantize_params
  from xotorch_tpu_torch.models.transformer import init_random_params, quant_route
  dtype = dtype or torch.bfloat16
  cfg = config_from_hf_dict(card_config)
  params = init_random_params(cfg, layers, True, True, seed=0, dtype=dtype, device=device)
  with phase_env(**env):
    if env.get("XOT_QUANTIZE"):
      params = quantize_params(params, env["XOT_QUANTIZE"], scale_dtype=dtype, inplace=True)
    route = quant_route(device == "cuda")
  return FusedModel(label, cfg, params, route, env.get("XOT_KV_QUANT") == "int8", dtype, layers)


def fused_batch(torch, m: FusedModel, B: int, paged: bool, device: str = "cuda", S: int = 2048,
                seed: int = 0):
  """B requests prefilled from seeded random prompts of 100 + 37 b tokens (K1, or K4 on
  the page arena), on contiguous caches of S slots or in one page pool. Returns
  (caches, or (arena, page table), last tokens [B, 1], positions [B])."""
  from xotorch_tpu_torch.inference.torch_engine.paged_cache import PagePool
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache
  gen = torch.Generator(device=device)
  gen.manual_seed(seed)
  lens = [100 + 37 * b for b in range(B)]
  state, table = [], None
  if paged:
    per = -(-S // FUSED_PAGE)
    pool = PagePool(m.cfg, m.layers, 1 + B * per, FUSED_PAGE, dtype=m.dtype, device=device,
                    kv_quant=m.kv_quant)
    width = 1 << (per - 1).bit_length()
    table = torch.zeros((B, width), dtype=torch.int32)
    for b in range(B):
      table[b, :per] = torch.tensor(pool.alloc(per), dtype=torch.int32)
    table = table.to(device)
    state = (pool.arena, table)
  last = []
  for b, n in enumerate(lens):
    prompt = torch.randint(3, m.cfg.vocab_size, (1, n), generator=gen, device=device)
    if paged:
      logits, _ = forward_shard(m.params, prompt, state[0], 0, m.cfg, True, True,
                                page_table=table[b:b + 1], route=m.route)
    else:
      cache = init_kv_cache(m.cfg, m.layers, 1, S, m.dtype, device, kv_quant=m.kv_quant)
      logits, _ = forward_shard(m.params, prompt, cache, 0, m.cfg, True, True, use_flash=True,
                                route=m.route)
      state.append(cache)
    last.append(logits[0, -1].argmax())
  toks = torch.stack(last)[:, None].to(torch.int64)
  return state, toks, torch.tensor(lens, dtype=torch.int32, device=device)


def _clone_state(state, paged: bool):
  if paged:
    arena, table = state
    return {n: t.clone() for n, t in arena.items()}, table
  return [{n: t.clone() for n, t in c.items()} for c in state]


def _decode_kernels(m: FusedModel, paged: bool):
  """The wrappers a decode step of `m` launches: (the attention kernel, the
  projections' GEMV kernel or None)."""
  from xotorch_tpu_torch.ops import flash_decode, int4_matmul, int8_matmul, paged_attention
  attn = {(False, False): flash_decode.flash_cached_attention,
          (False, True): flash_decode.flash_cached_attention_int8,
          (True, False): paged_attention.paged_decode_attention,
          (True, True): paged_attention.paged_decode_attention_int8}[(paged, m.kv_quant)]
  gemv = None
  if "wq_gscale" in m.params["layers"] and m.route.int4_kernel:
    gemv = int4_matmul.int4_w4a8_matmul if m.route.int4_variant == 4 else int4_matmul.int4_w4a16_matmul
  elif "wq_scale" in m.params["layers"] and m.route.int8_kernel:
    gemv = int8_matmul.int8_rowquant_matmul
  return attn, gemv


def fused_chunk(m: FusedModel, state, toks, pos, n: int, temps, top_k: int, paged: bool,
                gc=None, gumbel=None, generator=None):
  """One decode chunk of `n` steps: the eager body (models/generate) when `gc` is None,
  else graph replays (models/graphs). Returns ([B, n] tokens, the state after it)."""
  from xotorch_tpu_torch.models import generate, graphs
  B = toks.shape[0]
  pad = (1 << (B - 1).bit_length()) - B
  kw = dict(route=m.route, gumbel=gumbel, generator=generator)
  if paged:
    arena, table = state
    if gc is None:
      out, _ = generate.decode_chunk_paged(m.params, arena, table, toks, pos, m.cfg, n, temps,
                                           top_k, pad_rows=pad, **kw)
    else:
      out, _ = graphs.decode_paged(gc, m.params, arena, table, toks, pos, m.cfg, n, temps, top_k,
                                   **kw)
    return out, state
  if gc is None:
    out, split = generate.decode_chunk_batched(m.params, state, toks, pos, m.cfg, n, temps, top_k,
                                               use_flash_decode=True, pad_rows=pad, **kw)
    return out, split
  out, _ = graphs.decode_contiguous(gc, m.params, state, toks, pos, m.cfg, n, temps, top_k, **kw)
  return out, state


def fused_parity(torch, m: FusedModel, B: int, paged: bool, sampled: bool, card: str,
                 make_cache, device: str = "cuda", steps: int = FUSED_STEPS):
  """The graph path's tokens and cache (or arena) against the eager body's, bit for
  bit, over `steps` steps from the same prefilled state: temperature 0, or 0.8 with
  top_k 35 and the same injected Gumbel noise. The kernels' counters, set to 0 just
  before the graph chunk, must read layers x steps for the attention kernel (half of
  them windowed where the model slides) and 7 x layers x steps for a GEMV kernel.
  Returns the graph cache."""
  from xotorch_tpu_torch.models.graphs import counted_wrappers
  from xotorch_tpu_torch.ops.sampling import gumbel_noise
  state, toks, pos = fused_batch(torch, m, B, paged, device)
  eager_state = _clone_state(state, paged)
  Bb = 1 << (B - 1).bit_length()
  temps = torch.full((B,), 0.8 if sampled else 0.0, device=device)
  top_k = 35 if sampled else 0
  noise = None
  if sampled:
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    noise = gumbel_noise((steps, Bb, m.cfg.vocab_size), gen, device)
  want, eager_state = fused_chunk(m, eager_state, toks, pos, steps, temps, top_k, paged,
                                  gumbel=noise)
  gc = make_cache()
  for fn in counted_wrappers():
    fn.launches = 0
    fn.windowed_launches = 0
  got, state = fused_chunk(m, state, toks, pos, steps, temps, top_k, paged, gc=gc, gumbel=noise)
  counts = {fn.__name__: (fn.launches, fn.windowed_launches) for fn in counted_wrappers()
            if fn.launches}
  attn, gemv = _decode_kernels(m, paged)
  windows = sum(bool(m.cfg.layer_window(i)) for i in range(m.layers)) if m.cfg.uses_sliding_window else 0
  want_counts = {attn.__name__: (m.layers * steps, windows * steps)}
  if gemv is not None:
    want_counts[gemv.__name__] = (7 * m.layers * steps, 0)
  if device != "cuda":  # on the CPU no kernel launches
    want_counts = {}
  same_tokens = torch.equal(got, want)
  if paged:
    same_cache = all(torch.equal(state[0][n], eager_state[0][n]) for n in state[0])
    kv_bytes = sum(t.numel() * t.element_size() for t in state[0].values())
  else:
    same_cache = all(torch.equal(c[n], e[n]) for c, e in zip(state, eager_state) for n in c)
    kv_bytes = sum(t.numel() * t.element_size() for c in state for t in c.values())
  ok = same_tokens and same_cache and counts == want_counts
  differ = (got != want).sum().item()
  print(f"[fused] {m.label} B={B} {'paged' if paged else 'contiguous'} "
        f"{'sampled (injected noise, t 0.8, top_k 35)' if sampled else 'temperature 0'}: "
        f"{steps} graph-replayed steps against the eager body: tokens "
        f"{'identical' if same_tokens else f'{differ} of {got.numel()} differ'}, cache "
        f"{'identical' if same_cache else 'DIFFERS'}; launches {counts} (want {want_counts}); "
        f"{gc.captures} capture(s), {gc.replays} replays; graph pool {gc.pool_bytes / 1e6:.1f} "
        f"MB, slab {gc.slab_bytes / 1e6:.1f} MB beside {kv_bytes / 1e6:.1f} MB of KV "
        f"({'arena' if paged else 'caches'}) ({card}) {'ok' if ok else 'FAIL'}",
        flush=True)
  if not ok:
    raise AssertionError(f"fused {m.label} B={B} paged={paged} sampled={sampled}: tokens "
                         f"{same_tokens}, cache {same_cache}, launches {counts} vs {want_counts}")
  return gc


def fused_seeded(torch, m: FusedModel, card: str, make_cache, device: str = "cuda",
                 steps: int = FUSED_STEPS) -> None:
  """The engine's sampling noise on the graph path: two runs from one prefilled B=8
  state, each with a fresh graph cache and a fresh generator seeded alike (registered
  with the captured step), sample the same tokens at temperature 0.8, top_k 35; a third
  seed samples others. Whether the eager body with that seed draws the same noise is
  printed, not asserted (the graph's generator state is its own scheme)."""
  state, toks, pos = fused_batch(torch, m, 8, False, device)
  temps = torch.full((8,), 0.8, device=device)
  runs = []
  for seed, gc in ((7, make_cache()), (7, make_cache()), (8, make_cache()), (7, None)):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out, _ = fused_chunk(m, _clone_state(state, False), toks, pos, steps, temps, 35, False,
                         gc=gc, generator=gen)
    runs.append(out)
  ok = torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
  print(f"[fused] {m.label} B=8 sampled from the generator (t 0.8, top_k 35), {steps} "
        f"steps: two fresh graph caches seeded alike "
        f"{'agree' if torch.equal(runs[0], runs[1]) else 'DIFFER'}, another seed "
        f"{'differs' if not torch.equal(runs[0], runs[2]) else 'AGREES'}; the eager body with "
        f"the same seed {'agrees' if torch.equal(runs[0], runs[3]) else 'differs'} (not "
        f"asserted) ({card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"fused {m.label}: seeded graph sampling not reproducible")


def _profile_chunk(torch, run) -> tuple:
  """(wall ms, device busy ms, device kernels) of one call of `run` under the profiler;
  busy None when the trace holds no device time."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
  busy = kernels = 0
  for evt in prof.key_averages():
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
      us = getattr(evt, "self_cuda_time_total", 0)
    if us > 0:
      busy += us / 1e3
      kernels += evt.count
  return wall, (busy if kernels else None), kernels


def fused_timing(torch, m: FusedModel, B: int, paged: bool, card: str, make_cache,
                 device: str = "cuda", rounds: int = 4, n: int = 16) -> dict:
  """Eager body against graph replays, `rounds` rounds taken in turn (eager, then
  graph) from the same prefilled state, greedy chunks of `n` steps each: wall ms a
  step (host clock, synchronised); then one chunk of each under the profiler: device
  busy ms a step, device kernels a step and the idle share of the profiled wall time.
  Returns the numbers."""
  state, toks, pos = fused_batch(torch, m, B, paged, device)
  runs = {"eager": [_clone_state(state, paged), toks, pos.clone(), None],
          "graph": [state, toks, pos.clone(), make_cache()]}
  temps = torch.zeros((B,), device=device)

  def chunk(label):
    st = runs[label]
    out, st[0] = fused_chunk(m, st[0], st[1], st[2], n, temps, 0, paged, gc=st[3])
    st[1], st[2] = out[:, -1:].contiguous(), st[2] + n

  chunk("graph")  # the capture
  chunk("eager")
  walls = {"eager": [], "graph": []}
  for _ in range(rounds):
    for label in ("eager", "graph"):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      chunk(label)
      torch.cuda.synchronize()
      walls[label].append((time.perf_counter() - t0) * 1e3 / n)
  out = {}
  for label in ("eager", "graph"):
    wall, busy, kernels = _profile_chunk(torch, lambda: chunk(label))
    med = sorted(walls[label])[len(walls[label]) // 2]
    out[label] = {"wall_ms": med, "walls": walls[label],
                  "device_ms": None if busy is None else busy / n,
                  "idle_pct": None if busy is None else 100 * (1 - busy / wall),
                  "kernels": kernels / n}
  e, g = out["eager"], out["graph"]
  fmt = lambda v, f: "not measured" if v is None else format(v, f) + ("%" if f == ".1f" else "")
  print(f"[fused] {m.label} B={B} {'paged' if paged else 'contiguous'}: wall ms a step, "
        f"{rounds} rounds of {n} in turn: eager " + ", ".join(f"{w:.3f}" for w in e["walls"])
        + " / graph " + ", ".join(f"{w:.3f}" for w in g["walls"])
        + f"; median eager {e['wall_ms']:.3f} graph {g['wall_ms']:.3f} "
        f"({e['wall_ms'] / g['wall_ms']:.2f}x); device ms a step eager "
        f"{fmt(e['device_ms'], '.3f')} graph {fmt(g['device_ms'], '.3f')}; idle eager "
        f"{fmt(e['idle_pct'], '.1f')} graph {fmt(g['idle_pct'], '.1f')}; device kernels a "
        f"step eager {e['kernels']:.0f} graph {g['kernels']:.0f} ({card})", flush=True)
  return out


def slab_copy_ms(torch, m: FusedModel, card: str, device: str = "cuda") -> dict:
  """Device ms of one chunk's stack into the slab and split out of it (CUDA events,
  mean of 10) at B=1 and B=8 over caches of 2048 slots: what a contiguous chunk pays
  besides its replays."""
  from xotorch_tpu_torch.models import graphs
  from xotorch_tpu_torch.models.transformer import init_kv_cache
  out = {}
  for B in (1, 8):
    caches = [init_kv_cache(m.cfg, m.layers, 1, 2048, m.dtype, device, kv_quant=m.kv_quant)
              for _ in range(B)]
    gc = graphs.GraphCache(device)
    slab = gc.slab_views(graphs.slab_leaves(caches[0], B))
    times = {}
    for label, fn in (("stack", lambda: graphs.stack_into(slab, caches)),
                      ("split", lambda: graphs.split_from(slab, caches))):
      fn()
      start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(10):
        fn()
      end.record()
      torch.cuda.synchronize()
      times[label] = start.elapsed_time(end) / 10
    nbytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
    out[B] = times
    print(f"[fused] {m.label} slab copies at B={B}, S=2048 ({nbytes / 1e6:.1f} MB of caches): "
          f"stack {times['stack']:.3f} ms, split {times['split']:.3f} ms a chunk, "
          f"{2 * nbytes / (times['stack'] * 1e-3) / 1e9:.0f} GB/s read+write on the stack "
          f"({card})", flush=True)
  return out


def fused_prefill(torch, m: FusedModel, card: str, device: str = "cuda", T: int = 4096,
                  chunk: int = 1024) -> dict:
  """A T-token prompt in segments of `chunk`: prefill_scan as graph replays (one group
  of T / chunk, every segment through K2) against the per-segment loop (the first
  segment through K1, the rest through K2): last-layer hidden states of every position
  within PREFILL_REL_LIMIT of the largest |hidden state|, and the device ms of each
  (CUDA events, after a warm-up that captures)."""
  from xotorch_tpu_torch.models import graphs
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache
  gen = torch.Generator(device=device)
  gen.manual_seed(3)
  x = torch.randint(3, m.cfg.vocab_size, (1, T), generator=gen, device=device)
  gc = graphs.GraphCache(device)

  def loop():
    cache = init_kv_cache(m.cfg, m.layers, 1, T, m.dtype, device, kv_quant=m.kv_quant)
    hs = []
    for off in range(0, T, chunk):
      h, _ = forward_shard(m.params, x[:, off:off + chunk], cache, off, m.cfg, True, False,
                           use_flash=off == 0, use_flash_decode=off > 0, route=m.route)
      hs.append(h)
    return torch.cat(hs, dim=1)

  def scan():
    cache = init_kv_cache(m.cfg, m.layers, 1, T, m.dtype, device, kv_quant=m.kv_quant)
    return graphs.prefill(gc, m.params, x, cache, 0, m.cfg, chunk, route=m.route, want_hidden=True)

  ms = {}
  outs = {}
  for label, fn in (("loop", loop), ("scan", scan)):
    outs[label] = fn()  # the scan's first call captures
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
      fn()
    end.record()
    torch.cuda.synchronize()
    ms[label] = start.elapsed_time(end) / 3
  ref = outs["loop"].float()
  err = (outs["scan"].float() - ref).abs().max().item()
  rel = err / max(ref.abs().max().item(), 1e-12)
  ok = math.isfinite(rel) and rel <= PREFILL_REL_LIMIT and gc.captures == 1
  print(f"[fused] prefill {T} tokens in segments of {chunk}: prefill_scan (one graph of "
        f"{T // chunk} segments through K2) against the per-segment loop (K1, then K2): "
        f"max_rel_err {rel:.3e} (limit {PREFILL_REL_LIMIT:.0e}); {ms['scan']:.3f} ms against "
        f"{ms['loop']:.3f} ms ({card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"fused prefill: rel err {rel} (captures {gc.captures})")
  return {"rel": rel, "ms": ms}


def fused_ttft(torch, card: str, rounds: int = 4, T: int = 4096,
               model: str = "synthetic-llama-1b") -> dict:
  """The engine's time to first token over a T-token prompt at XOT_PREFILL_CHUNK 1024,
  XOT_SCAN_PREFILL 1 (the leading three segments through one captured scan group of
  2 and one of 1, the last through forward_sample) against 0 (segment by segment, K1
  first), taken in turn for `rounds` rounds after one unmeasured round each."""
  import numpy as np
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import TORCH, build_full_shard
  shard = build_full_shard(model, TORCH)
  prompt = np.random.default_rng(4).integers(3, 120000, size=(1, T))
  with phase_env(XOT_PAGED_KV="0", XOT_PREFILL_CHUNK="1024"):
    engine = TorchShardInferenceEngine(device="cuda", seed=0)

  async def drive():
    await engine.ensure_shard(shard)
    ttft = {"1": [], "0": []}
    toks = {}
    for i in range(rounds + 1):
      for scan in ("1", "0"):
        with phase_env(XOT_SCAN_PREFILL=scan, XOT_PREFILL_CHUNK="1024"):
          t0 = time.perf_counter()
          toks[scan], _ = await engine.infer_sample_tensor(f"ttft{i}{scan}", shard, prompt,
                                                           temp=0.0, top_k=0)
          if i:
            ttft[scan].append((time.perf_counter() - t0) * 1e3)
        await engine.clear_request(f"ttft{i}{scan}")
    return ttft, toks

  try:
    ttft, toks = asyncio.run(drive())
  finally:
    engine.executor.shutdown(wait=True)
  print(f"[fused] TTFT of a {T}-token prompt, segments of 1024, {rounds} rounds in turn: "
        f"XOT_SCAN_PREFILL=1 " + ", ".join(f"{t:.1f}" for t in ttft["1"]) + " ms / =0 "
        + ", ".join(f"{t:.1f}" for t in ttft["0"]) + f" ms; medians "
        f"{sorted(ttft['1'])[rounds // 2]:.1f} against {sorted(ttft['0'])[rounds // 2]:.1f} ms; "
        f"first tokens {toks['1']} / {toks['0']} (bf16, K2 against K1 for the first segment: "
        f"not asserted) ({card})", flush=True)
  return ttft


def check_fused(torch, card: str, device: str = "cuda", make_cache=None,
                model: str = "synthetic-llama-1b", gemma: bool = True,
                steps: int = FUSED_STEPS, rounds: int = 4) -> dict:
  """Phase 13: the fused decode programs. synthetic-llama-1b at full width and depth in
  the five decode formats, and gemma-2-2b's shape in bf16: graph replays against the
  eager body (fused_parity) at B=1 and B=8 (gemma B=1), contiguous and paged, at
  temperature 0, and with injected noise at B=8 (paged in bf16 only: the sampler is
  the same code over either cache); eager against graph timing (fused_timing;
  paged in bf16 and gemma);
  the slab copies' device time; the capture count, seconds and graph pool, slab and KV
  bytes; prefill_scan against the per-segment loop and the engine's TTFT both ways.
  (`device`, `make_cache`, `model` and `gemma` let it be rehearsed on the CPU with a
  small card and an eager stand-in for the graph cache.)"""
  from xotorch_tpu_torch.models import graphs
  from xotorch_tpu_torch.models.registry import get_model_card
  make_cache = make_cache or (lambda: graphs.GraphCache(device))
  card_cfg = get_model_card(model)["synthetic_config"]
  layers = card_cfg["num_hidden_layers"]
  dtype = torch.bfloat16 if device == "cuda" else torch.float32
  caches, timing = [], {}
  totals = {"caches": 0, "captures": 0, "seconds": 0.0, "pool": 0, "slab": 0}

  def tracked():
    caches.append(make_cache())
    return caches[-1]

  def release():
    """Fold the model's graph caches into the totals, then drop them: their slabs and
    graph pools are not held through the next model's captures."""
    for c in caches:
      totals["caches"] += 1
      totals["captures"] += c.captures
      totals["seconds"] += c.capture_seconds
      totals["pool"] = max(totals["pool"], c.pool_bytes)
      totals["slab"] = max(totals["slab"], c.slab_bytes)
    caches.clear()

  t0 = time.perf_counter()
  for label, env in FUSED_FORMATS:
    m = fused_model(torch, label, env, card_cfg, layers, device, dtype)
    for paged in (False, True):
      for B in (1, 8):
        fused_parity(torch, m, B, paged, False, card, tracked, device, steps)
      # Injected noise at B=8: contiguous in every format, paged in bf16 (the sampler
      # is the same code over either cache).
      if not paged or label == "bf16":
        fused_parity(torch, m, 8, paged, True, card, tracked, device, steps)
      # Eager against graph: contiguous in every format, paged in bf16.
      if device == "cuda" and (not paged or label == "bf16"):
        for B in (1, 8):
          timing[(label, paged, B)] = fused_timing(torch, m, B, paged, card, tracked, device,
                                                   rounds)
    if label == "bf16":
      fused_seeded(torch, m, card, tracked, device, steps)
    if device == "cuda" and label in ("bf16", "bf16, int8 KV (K2q)"):
      slab_copy_ms(torch, m, card, device)
    if device == "cuda" and label == "bf16":
      fused_prefill(torch, m, card, device)
    release()
    del m
    gc.collect()
    if device == "cuda":
      torch.cuda.empty_cache()
  if gemma:
    m = fused_model(torch, "gemma-2-2b bf16", {}, GEMMA_CONFIG, GEMMA_CONFIG["num_hidden_layers"],
                    device, dtype)
    for paged in (False, True):
      fused_parity(torch, m, 1, paged, False, card, tracked, device, steps)
      fused_parity(torch, m, 1, paged, True, card, tracked, device, steps)
      if device == "cuda":
        timing[("gemma-2-2b bf16", paged, 1)] = fused_timing(torch, m, 1, paged, card, tracked,
                                                             device, rounds)
    release()
    del m
    gc.collect()
  captures, seconds = totals["captures"], totals["seconds"]
  pool, slab = totals["pool"], totals["slab"]
  print(f"[fused] {captures} graphs captured over {totals['caches']} graph caches in "
        f"{seconds:.2f} s ({seconds / max(captures, 1) * 1e3:.1f} ms a capture, warm-up "
        f"excluded, the synchronize and cache release before it included); the largest cache's "
        f"graph pool {pool / 1e6:.1f} MB and slab {slab / 1e6:.1f} MB ({card})", flush=True)
  ttft = fused_ttft(torch, card, rounds) if device == "cuda" else {}
  print(f"[fused] phase 13 took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
  return {"timing": timing, "captures": captures, "capture_s": seconds, "pool_bytes": pool,
          "slab_bytes": slab, "ttft": ttft}


# ------------------------------------------------------------------ phase 14: sampling extras

EXTRAS_WORDS = 200  # prompt words of the extras phase's requests
EXTRAS_LP_LIMIT = 2e-2  # a reported logprob against fp32 log-softmax of the eager forward
EXTRAS_LADDER = (8, 16)  # the eager/graph parity's two chunks
# An extras request (logit bias, both penalties, 5 logprobs), as the API's fields.
EXTRAS_FIELDS = {"logit_bias": {"1000": 2.0}, "presence_penalty": 0.5, "frequency_penalty": 0.5,
                 "logprobs": True, "top_logprobs": 5}


def extras_body(model: str, words: int = EXTRAS_WORDS, **fields) -> dict:
  return {"model": model, "messages": [{"role": "user", "content": " ".join(
    f"w{i % 89}" for i in range(words))}], **fields}


def word_tokenizer():
  """The DummyTokenizer with a decode that names each id (" w<id>"): the API's text then
  shows the token ids, so stop strings and logprob items can be held to the ids the
  engine sampled."""
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer

  class WordIds(DummyTokenizer):
    def decode(self, tokens) -> str:
      return "".join(f" w{int(t)}" for t in tokens)
  return WordIds()


def lp_reference(torch, engine, prompt_ids, tokens, bias=None):
  """fp32 log-softmax, plus `bias` {id: value}, of the eager forward's logits at each
  generated token's position ([len(tokens), V]), computed as the server computed them:
  the served params, the prompt padded to the engine's bucket and prefilled (K1) on a
  cache of the engine's initial length, the unembedding on its last real position, then
  one eager decode step (K2) a token (gemma's logits softcapped)."""
  from xotorch_tpu_torch.inference.torch_engine.engine import _bucket
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, unembed
  ctx = engine._ctx
  cache = init_kv_cache(ctx.cfg, ctx.shard.get_layer_count(), 1, ctx.cache_len, engine.dtype,
                        engine.device)
  kw = dict(cfg=ctx.cfg, is_first=True, route=engine.quant_route)
  n = len(prompt_ids)
  x = torch.zeros((1, _bucket(n)), dtype=torch.int64, device=engine.device)
  x[0, :n] = torch.tensor(list(prompt_ids), dtype=torch.int64)
  h, _ = forward_shard(ctx.params, x, cache, 0, is_last=False, use_flash=True, **kw)
  rows = [unembed(ctx.params, h[:, n - 1:n], ctx.cfg)[0, -1]]
  for i, t in enumerate(tokens[:-1]):
    x = torch.tensor([[int(t)]], dtype=torch.int64, device=engine.device)
    logits, _ = forward_shard(ctx.params, x, cache, n + i, is_last=True, use_flash_decode=True,
                              **kw)
    rows.append(logits[0, -1])
  rows = torch.stack(rows).float()
  for t, v in (bias or {}).items():
    rows[:, int(t)] += float(v)
  return torch.log_softmax(rows, dim=-1)


async def prompt_ids(engine, api, model: str, body: dict) -> list:
  """The token ids the engine prefilled for `body`: the API's prompt, the engine's
  tokenizer."""
  prompt, _ = await api._request_prompt(model, body["messages"], None)
  return (await engine.encode(engine.shard, prompt)).tolist()


def check_logprob_items(torch, tag: str, items: list, tokens: list, ref, k: int, card: str) -> float:
  """The API's logprob items against the reference rows: each sampled token's logprob,
  and its top k (sorted, the sampled one first by value) against the reference's top k,
  within EXTRAS_LP_LIMIT. Returns the largest error."""
  if len(items) != len(tokens):
    raise AssertionError(f"{tag}: {len(items)} logprob items for {len(tokens)} tokens")
  errors = []
  for i, (item, tok) in enumerate(zip(items, tokens)):
    tops = [t["logprob"] for t in item["top_logprobs"]]
    if len(tops) != k or tops != sorted(tops, reverse=True) or tops[0] != item["logprob"]:
      raise AssertionError(f"{tag}: token {i}: top_logprobs {tops} (logprob {item['logprob']})")
    want = torch.topk(ref[i], k).values.tolist()
    errors.append(max([abs(item["logprob"] - float(ref[i, tok]))]
                      + [abs(a - b) for a, b in zip(tops, want)]))
  worst = max(errors)
  ok = worst <= EXTRAS_LP_LIMIT
  print(f"[{tag}] {len(items)} tokens' logprobs and top {k} against fp32 log-softmax of the "
        f"eager forward's logits: largest error {worst:.2e} (limit {EXTRAS_LP_LIMIT}); top {k} "
        f"sorted, the sampled token first ({card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{tag}: logprobs off the reference by token: "
                         + ", ".join(f"{e:.2e}" for e in errors))
  return worst


async def gemma_extras(torch, engine, node, api, base: str, card: str) -> dict:
  """Phase 12's gemma-2-2b server (its contiguous one) answers one request with
  logprobs, top_logprobs 3 and a logit_bias (-100 on the temperature-0 first token, +4 on
  another): the first token moves, and each reported logprob is held against the fp32
  log-softmax of the eager forward's softcapped logits with the bias added."""
  loop = asyncio.get_running_loop()
  body = extras_body(GEMMA_CARD, words=64, temperature=0, max_tokens=12, logprobs=True,
                     top_logprobs=3)
  tokens = {}
  node.on_token.register("chip-smoke-gemma-extras").on_next(
    lambda rid, toks, fin: tokens.__setitem__(rid, list(toks)))
  url = base + "/v1/chat/completions"
  plain = await loop.run_in_executor(None, http_json, url, body)
  first = tokens[plain["id"][len("chatcmpl-"):]][0]
  bias = {str(first): -100.0, "1000": 4.0}
  resp = await loop.run_in_executor(None, http_json, url, {**body, "logit_bias": bias})
  got = tokens[resp["id"][len("chatcmpl-"):]]
  if got[0] == first:
    raise AssertionError(f"gemma extras: the banned token {first} came first")
  ids = await prompt_ids(engine, api, GEMMA_CARD, body)
  ref = await engine._run(lp_reference, torch, engine, ids, got, bias)
  items = resp["choices"][0]["logprobs"]["content"]
  return {"max_err": check_logprob_items(torch, "gemma extras", items, got[:len(items)], ref, 3,
                                         card)}


def extras_parity(torch, engine, card: str, paged: bool, make_cache, device: str) -> None:
  """frequency_penalty 2 at temperature 0 on the served params: graph replays over the
  static extras buffers (models/graphs) against the eager decode_chunk (models/generate)
  from one prefilled state (fused_batch: K1, or K4 on the page arena) and the same counts,
  over two ladder chunks (EXTRAS_LADDER): tokens, counts and cache or arena bit for bit,
  and the decode kernel's counter (K2, or K3) reading layers x steps for the replays."""
  from xotorch_tpu_torch.models import generate, graphs
  ctx = engine._ctx
  m = FusedModel("bf16", ctx.cfg, ctx.params, engine.quant_route, engine.kv_quant is not None,
                 engine.dtype, ctx.shard.get_layer_count())
  state, toks, pos = fused_batch(torch, m, 1, paged, device)
  counts0 = torch.zeros((1, ctx.cfg.vocab_size), dtype=torch.int32, device=device)
  counts0[0, toks[0, 0]] = 1  # the prefill's token, counted as the engine counts it
  temps = torch.zeros((1,), device=device)
  attn, _ = _decode_kernels(m, paged)
  gc = make_cache()
  runs = {}
  for label in ("eager", "graph"):
    st, tok, p, counts, outs = _clone_state(state, paged), toks, pos.clone(), counts0.clone(), []
    attn.launches = 0
    for n in EXTRAS_LADDER:
      if label == "eager":
        kw = dict(counts=counts, frequency=2.0, route=m.route)
        if paged:
          out, _, counts = generate.decode_chunk_paged(m.params, st[0], st[1], tok, p, m.cfg, n,
                                                       temps, 0, **kw)
        else:
          out, st, counts = generate.decode_chunk_batched(m.params, st, tok, p, m.cfg, n, temps, 0,
                                                          use_flash_decode=True, **kw)
      else:
        ex = graphs.SamplerExtras(counts=counts, presence=torch.zeros((1,), device=device),
                                  frequency=torch.full((1,), 2.0, device=device))
        if paged:
          out, _ = graphs.decode_paged(gc, m.params, st[0], st[1], tok, p, m.cfg, n, temps, 0,
                                       route=m.route, extras=ex)
        else:
          out, _ = graphs.decode_contiguous(gc, m.params, st, tok, p, m.cfg, n, temps, 0,
                                            route=m.route, extras=ex)
      outs.append(out)
      tok, p = out[:, -1:].contiguous(), p + n
    runs[label] = (st, counts, torch.cat(outs, dim=1), attn.launches)
  (est, ecounts, etoks, _), (gst, gcounts, gtoks, launches) = runs["eager"], runs["graph"]
  steps = sum(EXTRAS_LADDER)
  same_toks = torch.equal(etoks, gtoks)
  same_counts = torch.equal(ecounts, gcounts) and int(gcounts.sum()) == 1 + steps
  if paged:
    same_cache = all(torch.equal(est[0][n], gst[0][n]) for n in gst[0])
  else:
    same_cache = all(torch.equal(a[n], b[n]) for a, b in zip(est, gst) for n in b)
  want = m.layers * steps if device == "cuda" else 0
  ok = same_toks and same_counts and same_cache and launches == want
  print(f"[extras] frequency_penalty 2, temperature 0, {'paged' if paged else 'contiguous'}: "
        f"chunks {EXTRAS_LADDER} of graph replays against the eager decode_chunk from the same "
        f"counts: tokens {'identical' if same_toks else 'DIFFER'}, counts "
        f"{'identical' if same_counts else 'DIFFER'} ({int(gcounts.sum())} counted), "
        f"{'arena' if paged else 'cache'} {'identical' if same_cache else 'DIFFERS'}; "
        f"{attn.__name__} launches {launches} for the replays (want {want}); {gc.captures} "
        f"capture(s) ({card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"extras parity paged={paged}: tokens {same_toks}, counts {same_counts}, "
                         f"cache {same_cache}, launches {launches} vs {want}")


async def extras_step_ms(torch, engine, card: str, n: int = 32) -> dict:
  """The device ms a decode step takes for a plain request and for an extras one
  (EXTRAS_FIELDS) at B=1: one chunk of `n` greedy steps each under the profiler, after a
  200-token prompt and a warm chunk."""
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  from xotorch_tpu_torch.api.chatgpt_api import ChatGPTAPI
  shard = engine.shard
  out = {}
  for label, s in (("plain", None), ("extras", ChatGPTAPI._parse_sampling(EXTRAS_FIELDS).sampling)):
    rid = f"extras-profile-{label}"
    tok, _ = await engine.infer_sample_tensor(rid, shard, np.ones((1, 200), np.int64), temp=0.0,
                                              top_k=0, **({"sampling": s} if s else {}))
    toks = await engine.generate_chunk(rid, shard, int(tok), 8, temp=0.0, top_k=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      await engine.generate_chunk(rid, shard, int(toks[-1]), n, temp=0.0, top_k=0)
      torch.cuda.synchronize()
      wall = (time.perf_counter() - t0) * 1e3
    await engine.clear_request(rid)
    busy = kernels = 0
    for evt in prof.key_averages():
      us = getattr(evt, "self_device_time_total", None)
      if us is None:
        us = getattr(evt, "self_cuda_time_total", 0)
      if us > 0:
        busy += us / 1e3
        kernels += evt.count
    out[label] = busy / n if kernels else None
    print(f"[extras] {label} B=1 chunk of {n} under the profiler: wall {wall / n:.3f} ms a step, "
          + ("device time not measured" if not kernels else f"{busy / n:.3f} device ms a step")
          + f", {kernels / n:.0f} device kernels a step ({card})", flush=True)
  if out["plain"] is not None and out["extras"] is not None:
    print(f"[extras] the extras add {out['extras'] - out['plain']:.3f} device ms a step at B=1 "
          f"({card})", flush=True)
  return out


def extras_server(torch, env: dict, device: str, model: str, drive):
  """A fresh server (main.build_node) on `model` under `env`, with the word-id tokenizer
  in its API; returns `await drive(engine, node, api, base_url, tokens, steps)`: `tokens`
  the node's streams by request id, `steps` ([1]) the decode steps the engine ran."""
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.models.registry import build_full_shard
  with phase_env(XOT_PREFILL_CHUNK="1024", **env):
    args = port_main.build_parser().parse_args(
      ["--device", device, "--default-model", model, "--chatgpt-api-host", "127.0.0.1",
       "--chatgpt-api-port", "0", "--chatgpt-api-response-timeout", "600"])
    node, engine, classname, api = port_main.build_node(args)
    api._tokenizers[model] = word_tokenizer()
    tokens, steps = {}, [0]
    node.on_token.register("chip-smoke-extras").on_next(
      lambda rid, toks, fin: tokens.__setitem__(rid, list(toks)))
    decode = engine._decode_batch_sync

    def counted(ctx, items, *a):
      res = decode(ctx, items, *a)
      steps[0] += len(res[0])
      return res
    engine._decode_batch_sync = counted

    async def run():
      server = await api.start("127.0.0.1", 0)
      base = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"
      try:
        await engine.ensure_shard(build_full_shard(model, classname))
        return await drive(engine, node, api, base, tokens, steps)
      finally:
        server.close()
        await server.wait_closed()
        await node.stop()

    try:
      return asyncio.run(run())
    finally:
      engine.executor.shutdown(wait=True)


def check_sampling_extras(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b",
                          make_cache=None, rounds: int = 4) -> dict:
  """Phase 14: OpenAI's sampling extras served end to end, over HTTP, on fresh servers of
  `model` (contiguous, a second fresh one, paged), each check failing the run: logit_bias
  (-100 on the temperature-0 first token moves it; +100 on one id makes every token that
  id), min_p 1 at temperature 1 taking at every token its row's largest logit in the eager
  forward fed that stream (an exact tie allowed), 16 greedy tokens' logprobs and
  top_logprobs 5 within EXTRAS_LP_LIMIT of fp32 log-softmax of the eager forward's logits
  (sorted, the sampled token first), seed 7 at temperature 1 reproduced on the same server
  (its graph's generator re-seeded between replays) and on a fresh one while seed 8
  differs and n 2 with seed 7 gives two streams, frequency_penalty 2 moving the greedy
  stream and a stop string from that stream cutting its answer before it (finish
  "stop") with the engine's decode steps below max_tokens, plain n 4 at temperature 0.6
  coalescing in the batcher (mean width > 1), frequency_penalty 2 and logprobs through
  the paged server (K4 prefill, K3 decode); graph replays against the eager decode_chunk
  with the same counts bit for bit, contiguous and paged (extras_parity). K1/K2
  (contiguous) and K4/K3 (paged) counters are set to 0 before a server's requests and
  read after them, before any reference runs, and held exactly to layers x prefills and
  layers x decode steps. Then, on the card: TPOT of an extras request
  (EXTRAS_FIELDS) against a plain one at B=1, `rounds` rounds in turn; the device ms the
  extras add to a step (extras_step_ms); the captures the requests added. Returns the
  launches and the numbers. (`device`, `model` and `make_cache` let it be rehearsed on
  the CPU with synthetic-tiny and an eager stand-in for the graph cache.)"""
  from xotorch_tpu_torch.models import graphs
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention
  make_cache = make_cache or (lambda: graphs.GraphCache(device))
  t_phase = time.perf_counter()
  cuda = device == "cuda"
  url = "/v1/chat/completions"
  out: dict = {"launches": {}}

  def need(ok: bool, what: str) -> None:
    print(f"[extras] {what} ({card}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"extras: {what}")

  def asker(base, tokens):
    loop = asyncio.get_running_loop()

    async def ask(**fields):
      """POST one completion; (the response, the node's token list of each choice)."""
      resp = await loop.run_in_executor(None, http_json, base + url, extras_body(model, **fields))
      rid = resp["id"][len("chatcmpl-"):]
      n = fields.get("n", 1)
      return resp, [tokens[rid]] if n == 1 else [tokens[f"{rid}#{i}"] for i in range(n)]
    return ask

  def counted_launches(kernels, prefills: int, decoded: int, tag: str) -> dict:
    """The prefill and decode kernels' counts, held exactly to layers x prefills (one
    segment each) and layers x decode steps (none on the CPU, where no kernel runs)."""
    counts = {k.__name__: k.launches for k in kernels}
    layers = get_model_card(model)["synthetic_config"]["num_hidden_layers"] if cuda else 0
    want = {kernels[0].__name__: layers * prefills, kernels[1].__name__: layers * decoded}
    need(counts == want, f"{tag} launches {counts}: {layers} x {prefills} prefills and "
                         f"{layers} x {decoded} decode steps ({want})")
    return counts

  async def contiguous(engine, node, api, base, tokens, steps):
    ask = asker(base, tokens)
    kernels = (flash_attention, flash_cached_attention)
    await ask(temperature=0, max_tokens=2)  # warm-up
    gcache = engine._ctx.graphs
    before = (gcache.captures, gcache.capture_seconds) if gcache else (0, 0.0)
    for k in kernels:
      k.launches = 0
    steps[0] = 0
    V = engine.cfg.vocab_size
    _, [greedy] = await ask(temperature=0, max_tokens=32)
    _, [banned] = await ask(temperature=0, max_tokens=8, logit_bias={str(greedy[0]): -100})
    need(banned[0] != greedy[0], f"logit_bias -100 on the greedy first token {greedy[0]}: "
                                 f"the first token is {banned[0]}")
    forced = next(t for t in (1000, V // 2, V // 2 + 1) if t < V and t != greedy[0])
    _, [pinned] = await ask(temperature=0.8, max_tokens=16, logit_bias={str(forced): 100})
    need(pinned == [forced] * 16, f"logit_bias +100 on id {forced} at temperature 0.8: "
                                  f"{pinned.count(forced)}/16 tokens that id")
    _, [minp] = await ask(temperature=1.0, max_tokens=32, min_p=1)
    resp, [lp_toks] = await ask(temperature=0, max_tokens=16, logprobs=True, top_logprobs=5)
    items = resp["choices"][0]["logprobs"]["content"]
    need(lp_toks == greedy[:16] and [int(i["token"].strip()[1:]) for i in items] == lp_toks,
         "logprobs 5 at temperature 0: the greedy tokens, one item each naming it")
    seeded = [(await ask(temperature=1.0, max_tokens=32, seed=s))[1][0] for s in (7, 7, 8)]
    need(seeded[0] == seeded[1] != seeded[2], "seed 7 twice on one server, temperature 1 (the "
         "seeded graph's generator re-seeded between replays): the same stream; seed 8 another")
    out["seed7"] = seeded[0]
    _, pair = await ask(temperature=1.0, max_tokens=32, seed=7, n=2)
    need(pair[0] != pair[1], "n 2 with seed 7: two different streams")
    _, [pen] = await ask(temperature=0, max_tokens=32, frequency_penalty=2)
    need(pen != greedy, f"frequency_penalty 2 at temperature 0: {len(set(pen))} distinct tokens of "
                        f"32, the plain greedy stream {len(set(greedy))}")
    out["penalty_tokens"] = pen
    # A stop string from that stream (a random model's plain greedy stream repeats a few
    # tokens, so the stop would show at once): tokens 3 and 4.
    text = word_tokenizer().decode(pen)
    stop = word_tokenizer().decode(pen[3:5]).strip()
    decode_steps = steps[0]
    resp, _ = await ask(temperature=0, max_tokens=64, frequency_penalty=2, stop=[stop])
    choice = resp["choices"][0]
    used = steps[0] - decode_steps
    need(choice["message"]["content"] == text[:text.find(stop)] and choice["finish_reason"] == "stop"
         and used < 63, f"stop {stop!r} from the penalized greedy stream: the answer cut before it "
         f"({len(choice['message']['content'])} of {len(text)} characters), finish "
         f"{choice['finish_reason']!r}, {used} decode steps for max_tokens 64")
    b = engine._ctx.batcher
    dispatches, rows = b.dispatches, b.rows
    await ask(temperature=0.6, max_tokens=32, n=4)
    width = (b.rows - rows) / max(1, b.dispatches - dispatches)
    need(width > 1, f"plain n 4 at temperature 0.6: mean batch width {width:.2f} in the batcher")
    # Prefills: ten requests' and the n siblings' (2 + 4); decode steps the engine ran.
    await wait_idle(engine)
    out["launches"].update(counted_launches(kernels, 16, steps[0], "contiguous server"))
    # The references run K1 and K2 through the same wrappers: only after the counts.
    ids = await prompt_ids(engine, api, model, extras_body(model))
    # min_p 1 keeps the tokens at the largest probability: each token of the stream must
    # sit at its row's largest logit in the eager forward fed that stream (an exact
    # bf16 tie with another id allowed: then the noise picks one).
    ref = await engine._run(lp_reference, torch, engine, ids, minp)
    top = ref.max(dim=-1).values
    off = [i for i, t in enumerate(minp) if ref[i, t] != top[i]]
    tied = sum(int((ref[i] == top[i]).sum()) > 1 for i in range(len(minp)))
    part = next((i for i, (a, b) in enumerate(zip(minp, greedy)) if a != b), None)
    need(not off, f"min_p 1 at temperature 1: {len(minp) - len(off)}/{len(minp)} tokens at their "
                  f"row's largest logit ({tied} rows with a tie for it; the greedy stream "
                  f"{'kept throughout' if part is None else f'left at token {part}'})")
    ref = await engine._run(lp_reference, torch, engine, ids, lp_toks)
    out["lp_err"] = check_logprob_items(torch, "extras", items, lp_toks, ref, 5, card)
    if cuda:
      tpot = {"plain": [], "extras": []}
      loop = asyncio.get_running_loop()
      for _ in range(rounds):
        for label in ("plain", "extras"):
          body = extras_body(model, temperature=0, max_tokens=64, stream=True,
                             **(EXTRAS_FIELDS if label == "extras" else {}))
          _, first, last = await loop.run_in_executor(None, http_stream, base + url, body)
          tpot[label].append((last - first) / 63 * 1e3)
      med = {k: sorted(v)[len(v) // 2] for k, v in tpot.items()}
      print(f"[extras] TPOT at B=1 over 64 tokens, {rounds} rounds in turn: plain "
            + ", ".join(f"{v:.3f}" for v in tpot["plain"]) + " / extras (bias, penalties, "
            + "5 logprobs) " + ", ".join(f"{v:.3f}" for v in tpot["extras"])
            + f" ms; median plain {med['plain']:.3f}, extras {med['extras']:.3f} ms ({card})",
            flush=True)
      out["tpot_ms"] = med
      out["step_device_ms"] = await extras_step_ms(torch, engine, card)
    if gcache:
      out["captures"] = (gcache.captures - before[0], gcache.capture_seconds - before[1])
      print(f"[extras] the phase's requests on this server captured {out['captures'][0]} "
            f"graph(s) in {out['captures'][1]:.2f} s ({card})", flush=True)
    await wait_idle(engine)
    await engine._run(extras_parity, torch, engine, card, False, make_cache, device)
    return out

  async def fresh(engine, node, api, base, tokens, steps):
    return (await asker(base, tokens)(temperature=1.0, max_tokens=32, seed=7))[1][0]

  async def paged(engine, node, api, base, tokens, steps):
    ask = asker(base, tokens)
    kernels = (paged_prefill_attention, paged_decode_attention)
    await ask(temperature=0, max_tokens=2)
    for k in kernels:
      k.launches = 0
    steps[0] = 0
    _, [pen] = await ask(temperature=0, max_tokens=32, frequency_penalty=2)
    resp, [lp_toks] = await ask(temperature=0, max_tokens=16, logprobs=True, top_logprobs=5,
                                presence_penalty=1)
    items = resp["choices"][0]["logprobs"]["content"]
    need(len(items) == 16 and engine.page_pool_stats() is not None,
         "paged server: frequency_penalty 2 and a logprobs request answered from the page pool")
    await wait_idle(engine)
    launches = counted_launches(kernels, 2, steps[0], "paged server")
    same = sum(a == b for a, b in zip(pen, out["penalty_tokens"]))
    print(f"[extras] paged frequency_penalty 2 tokens the contiguous server shares: {same}/32 "
          f"(bf16: not asserted) ({card})", flush=True)
    await wait_idle(engine)
    await engine._run(extras_parity, torch, engine, card, True, make_cache, device)
    return launches

  extras_server(torch, {"XOT_PAGED_KV": "0"}, device, model, contiguous)
  seed7 = extras_server(torch, {"XOT_PAGED_KV": "0"}, device, model, fresh)
  need(seed7 == out["seed7"], "seed 7 at temperature 1 on a fresh server: the first server's "
                              "stream")
  out["launches"].update(extras_server(torch, {"XOT_PAGED_KV": "1"}, device, model, paged))
  print(f"[extras] phase 14 took {time.perf_counter() - t_phase:.1f} s; launches "
        f"{out['launches']} ({card})", flush=True)
  return out


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
  started = time.perf_counter()
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
  check_quant_kernels(torch, results)
  check_gemma_kernels(torch)
  if args.kernels_only:
    print(f"kernels ok on {card}", flush=True)
    return 0

  # Phase 4: the model through the kernels against the plain path.
  check_model(torch)
  check_paged_model(torch)
  check_int8_kv_model(torch)
  for fmt, env, kernel, _ in quant_phases():
    # force: the card's decode rows through the kernel, the CPU's through its plain
    # version. K5v4 and K6 quantize their activations to int8, bf16 ones on the card
    # and fp32 ones on the CPU: a value near a step of the int8 grid takes another
    # code on each side, an error of max|a|/127 where bf16 alone rounds at 2^-9 of
    # the value. Rounding the CPU's activations to bf16 first did not narrow it
    # (PERF.md), so their cuts get twice the exact kernels' limit; the kernel calls
    # themselves are held at 2^-7 and the control reads far above the limit.
    knob = "XOT_INT4_KERNEL" if fmt == "int4" else "XOT_INT8_KERNEL"
    a8 = kernel.__name__ != "int4_w4a16_matmul"
    check_model(torch, fmt, {**env, knob: "force"}, kernel, limit=1e-1 if a8 else 5e-2)

  # Phase 5: the main path, with the launch counters read around it.
  main_run = drive_main_path(torch, card, focus="flash_cached_")
  launches = dict(main_run["launches"])
  k1, k2 = launches["flash_attention"], launches["flash_cached_attention"]
  if k1 < 3 * 16 or k2 < 16 * main_run["decoded"]:
    raise AssertionError(f"main: kernel launches too few (K1 {k1}, K2 {k2})")

  # Phases 6 and 7: eight concurrent requests on the page pool (K4 prefill, K3
  # decode), then on stacked contiguous caches (K1/K2).
  paged = drive_concurrent(torch, card, paged=True)
  launches.update((k, paged["launches"][k])
                  for k in ("paged_decode_attention", "paged_prefill_attention"))
  contiguous = drive_concurrent(torch, card, paged=False)
  same = total = 0
  for words, toks in paged["greedy"].items():
    other = contiguous["greedy"][words]
    same += sum(a == b for a, b in zip(toks, other))
    total += len(toks)
  print(f"[concurrent] temperature-0 tokens the paged and contiguous phases agree on: "
        f"{same}/{total} = {100 * same / max(total, 1):.1f}% (bf16: streams may part at a "
        f"near-tie; not asserted)", flush=True)

  # Phase 8: quantized serving. Fresh servers under XOT_QUANTIZE answer the main
  # path's three requests through K5, K5v4 and K6 (launches = 7 x 16 x decode steps),
  # then the int8 default path (no kernel) runs in the engine alone.
  rates = {"bf16": {**main_run["profiles"], 8: contiguous["profile"]}}
  for fmt, env, kernel, focus in quant_phases():
    run = drive_quantized(torch, card, fmt, env, kernel, focus)
    launches.update(run["launches"])
    rates[f"{fmt} {kernel.__name__}"] = run["profiles"]
  rates["int8 default path"] = drive_engine_alone(
    torch, card, {"XOT_QUANTIZE": "int8", "XOT_INT8_KERNEL": "0"}, "int8 default path")
  for label, prof in rates.items():
    cells = ", ".join(f"B={b}: {p['tok_s']:.1f} tok/s ({p['step_ms']:.2f} ms a step, "
                      f"{100 - p['busy_pct']:.1f}% idle, kernel {p['focus_pct']:.1f}%)"
                      for b, p in prof.items() if p)
    print(f"[quantized] {label}: {cells or 'not measured'} ({card})", flush=True)
  # The concurrent paged phase's eight requests with int4 weights: K4 prefill, K3
  # decode and K5 on several live rows and pad rows of the page pool.
  from xotorch_tpu_torch.ops.int4_matmul import int4_w4a16_matmul
  drive_concurrent(torch, card, paged=True, env={"XOT_QUANTIZE": "int4"},
                   quant_kernel=int4_w4a16_matmul)
  # Where a quantized step's host time goes: one projection's host cost by route,
  # then the formats' B=1 steps taken in turn.
  projection_host_us(torch, card)
  alternate_formats(torch, card)

  # Phase 9: the int8 KV cache. A fresh server with --kv-quantize int8 answers the main
  # path's three requests: K1 for each fresh prefill (over the fresh K/V), K2q for every
  # decode step and for the 1502-token prompt's second segment, no K2. Then the engine
  # alone decodes 32 steps at B=1 and B=8 under the profiler, and the eight concurrent
  # requests run on an int8 page arena (K4q prefill, K3q decode).
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention, flash_cached_attention_int8
  kv = drive_main_path(torch, card, kernels=(flash_attention, flash_cached_attention,
                                             flash_cached_attention_int8),
                       tag="int8 kv", profiles=(1, 8), focus="flash_cached_",
                       cli=("--kv-quantize", "int8"))
  counted = kv["launches"]
  want = {"flash_attention": 16 * 3, "flash_cached_attention": 0,
          "flash_cached_attention_int8": 16 * (kv["steps"] + 1)}
  ok = counted == want and kv["steps"] >= kv["decoded"]
  print(f"[int8 kv] launches {counted}: K1 = 16 layers x 3 fresh prefills, K2q = 16 x "
        f"({kv['steps']} decode steps + 1 segment at pos > 0), no K2 ({want}) "
        f"{'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"int8 kv: launches {counted}, wanted {want}")
  launches["flash_cached_attention_int8"] = counted["flash_cached_attention_int8"]
  same = total = 0
  for i, body in enumerate(main_requests("synthetic-llama-1b")):
    if body[1].get("temperature") == 0:
      a, b = main_run["tokens"][i], kv["tokens"][i]
      same += sum(x == y for x, y in zip(a, b))
      total += max(len(a), len(b))
  print(f"[int8 kv] temperature-0 tokens the int8-KV server shares with the bf16 main path: "
        f"{same}/{total} = {100 * same / max(total, 1):.1f}% (not asserted)", flush=True)
  for label, prof in (("bf16 KV", rates["bf16"]), ("int8 KV", kv["profiles"])):
    cells = ", ".join(f"B={b}: {p['device_ms']:.3f} device ms a step, {p['kernels_per_step']:.0f} "
                      f"kernels a step, {100 - p['busy_pct']:.1f}% idle, {p['step_ms']:.2f} wall ms"
                      for b, p in sorted(prof.items()) if p)
    print(f"[int8 kv] {label}: {cells or 'not measured'} ({card})", flush=True)
  # K2q replaces K2 one for one, so the kernels a step int8 KV adds are its writes':
  # the quantizer's eager ops and two more copies a layer.
  added = {b: kv["profiles"][b]["kernels_per_step"] - rates["bf16"][b]["kernels_per_step"]
           for b in (1, 8) if kv["profiles"].get(b) and rates["bf16"].get(b)}
  print(f"[int8 kv] quantize on write: {added} more device kernels a step than bf16 KV "
        f"({card})", flush=True)
  paged8 = drive_concurrent(torch, card, paged=True, env={"XOT_KV_QUANT": "int8"})
  launches.update((k, paged8["launches"][k])
                  for k in ("paged_decode_attention_int8", "paged_prefill_attention_int8"))
  print(f"[int8 kv] page arena bytes per token: int8 {paged8['bytes_per_token']:.0f} against bf16 "
        f"{paged['bytes_per_token']:.0f} ({card})", flush=True)

  # Phases 10 and 11: the token ring. Two peers hold half the layers each and pass
  # bf16 hidden states over TCP, first as two Nodes in this process (launches counted
  # over both engines, every hop's dtype and size read), then as two processes started
  # the way a user starts them; both must stream the main path's temperature-0 tokens.
  drive_ring_inprocess(torch, card, main_run)
  drive_ring_processes(torch, card, main_run)

  # Phase 12: gemma-2-2b from an HF checkpoint on disk, at full width and depth: its
  # attention kernels' launches join the main path's in the results line.
  for name, n in drive_gemma(torch, card).items():
    launches[name] += n

  # Phase 13: the fused decode programs (CUDA graphs) against the eager body, their
  # timing, and the scan prefill against the per-segment loop.
  print(f"[time] phases 1-12: {time.perf_counter() - started:.1f} s", flush=True)
  check_fused(torch, card)

  # Phase 14: OpenAI's sampling extras through the API, the engine and the decode graphs;
  # its attention launches join the results line.
  for name, n in check_sampling_extras(torch, card)["launches"].items():
    launches[name] += n
  print(f"[time] phases 1-14: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 15: results.
  meta = {
    "flash_attention": ("xotorch_tpu_torch/csrc/flash_attention.cu",
                        "xotorch_tpu/ops/flash_attention.py:54"),
    "flash_cached_attention": ("xotorch_tpu_torch/csrc/flash_decode.cu",
                               "xotorch_tpu/ops/flash_decode.py:62"),
    "paged_decode_attention": ("xotorch_tpu_torch/csrc/paged_attention.cu",
                               "xotorch_tpu/ops/paged_attention.py:129"),
    "paged_prefill_attention": ("xotorch_tpu_torch/csrc/paged_attention.cu",
                                "xotorch_tpu/ops/paged_attention.py:276"),
    "int4_w4a16_matmul": ("xotorch_tpu_torch/csrc/quant_matvec.cu",
                          "xotorch_tpu/ops/int4_matmul.py:46"),
    "int4_w4a8_matmul": ("xotorch_tpu_torch/csrc/quant_matvec.cu",
                         "xotorch_tpu/ops/int4_matmul.py:122"),
    "int8_rowquant_matmul": ("xotorch_tpu_torch/csrc/quant_matvec.cu",
                             "xotorch_tpu/ops/int8_matmul.py:43"),
    "flash_cached_attention_int8": ("xotorch_tpu_torch/csrc/flash_decode.cu",
                                    "xotorch_tpu/ops/flash_decode.py:62 (quant=True)"),
    "paged_decode_attention_int8": ("xotorch_tpu_torch/csrc/paged_attention.cu",
                                    "xotorch_tpu/ops/paged_attention.py:129 (quant=True)"),
    "paged_prefill_attention_int8": ("xotorch_tpu_torch/csrc/paged_attention.cu",
                                     "xotorch_tpu/ops/paged_attention.py:276 (quant=True)"),
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
