"""Time K2q's int8-KV main-path decode case (B=1, T=1, S=2048, q_start 640, Hq 32,
Hkv 8, D 64, rows' scales spread as chip_smoke.spread_quantize spreads them) in a
fresh process, then right after
chip_smoke.check_paged_kernels and again 10 s later, with chip_smoke.time_ms; also
the host time of one wrapper call. The mode picks what that phase's yardsticks do:

    python3 scripts/k2q_timing_probe.py fresh     # no check_paged_kernels
    python3 scripts/k2q_timing_probe.py asis      # flex_ms as it is
    python3 scripts/k2q_timing_probe.py noreset   # torch._dynamo.reset() a no-op
    python3 scripts/k2q_timing_probe.py noflex    # no flex_attention compile at all

Needs one NVIDIA GPU; it builds the kernels first, as chip_smoke.py does."""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch
import chip_smoke as cs
from xotorch_tpu_torch.ops import _build
from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention

mode = sys.argv[1]
_build.load_all()
if mode == "noreset":
  torch._dynamo.reset = lambda: None
elif mode == "noflex":
  cs.flex_ms = lambda *a, **k: None

randn = cs.seeded_randn(torch, 0)
qg = torch.Generator(device="cuda")
qg.manual_seed(4)
q, k, v = randn(1, 1, 32, 64), randn(1, 2048, 8, 64), randn(1, 2048, 8, 64)
(kc, ks), (vc, vs) = cs.spread_quantize(torch, qg, k), cs.spread_quantize(torch, qg, v)
qs = torch.tensor([640], dtype=torch.int32, device="cuda")
call = lambda: flash_cached_attention(q, kc, vc, qs, k_scale=ks, v_scale=vs)
bf = lambda: flash_cached_attention(q, k, v, qs)

def readings(tag):
  a = [round(cs.time_ms(call), 4) for _ in range(3)]
  b = [round(cs.time_ms(bf), 4) for _ in range(2)]
  torch.cuda.synchronize()
  t = time.perf_counter()
  for _ in range(50):
    call()
  host = (time.perf_counter() - t) / 50 * 1e3
  torch.cuda.synchronize()
  print(f"[diag {mode}] {tag}: K2q ms {a}  K2 ms {b}  host ms a K2q call {host:.4f}", flush=True)

readings("fresh process")
if mode != "fresh":
  t = time.time()
  cs.check_paged_kernels(torch, {}, randn)
  print(f"[diag {mode}] check_paged_kernels {time.time() - t:.1f} s", flush=True)
  readings("right after check_paged_kernels")
  time.sleep(10)
  readings("10 s later")
