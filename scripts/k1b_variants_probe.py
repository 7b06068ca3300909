"""K1b's tile shapes and register placement tried side by side on the card.

Writes variants of csrc/flash_attention_bwd.cu (textual substitutions of its shape
constants) into xotorch_tpu_torch/build/k1b_variants/, builds each with nvcc
(`-Xptxas -v`: registers and spills printed) in parallel, and times each at the training
shapes (synthetic-llama-1b at B 4, T 511; D 128; gemma-2-2b's D 256 with its softcap, and
windowed) with each of its two kernels' share under the profiler, every variant held
within 2^-6 of the plain version's largest |value|:

    python3 scripts/k1b_variants_probe.py
"""
import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from xotorch_tpu_torch.ops import _build  # noqa: E402
from xotorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd_ref  # noqa: E402

Q_REG64 = ("static constexpr bool Q_REG = D <= 32;", "static constexpr bool Q_REG = D <= 64;")
KV_SMEM64 = ("static constexpr bool KV_REG = D <= 64;", "static constexpr bool KV_REG = D <= 32;")
MIN3 = ("__launch_bounds__(DkdvShape<D>::THREADS)",
        "__launch_bounds__(DkdvShape<D>::THREADS, D <= 64 ? 3 : 1)")
KB32 = ("static constexpr int KB = 64;", "static constexpr int KB = 32;")
QR32 = ("static constexpr int QR = D <= 64 ? 64 : 32;", "static constexpr int QR = 32;")
ROWS128 = ("static constexpr int ROWS = 64;", "static constexpr int ROWS = 128;")
VARIANTS = {
  "as built": [],
  "dQ: Q, dO fragments in registers at D 64": [Q_REG64],
  "dK/dV: K, V fragments from shared memory at D 64": [KV_SMEM64],
  "dK/dV: K, V from shared memory, 3 blocks an SM at D <= 64": [KV_SMEM64, MIN3],
  "dK/dV: 32 keys a block": [KB32],
  "dK/dV: 32 keys a block, 32-row tiles": [KB32, QR32],
  "dQ: 128 rows a block": [ROWS128],
}
CASES = [(cs.LLAMA_1B, 4, 511, 0, 0.0), (cs.Widths(32, 8, 128, "D=128 "), 2, 512, 0, 0.0),
         (cs.GEMMA_2B, 4, 511, 0, cs.GEMMA_SOFTCAP), (cs.GEMMA_2B, 2, 512, 256, cs.GEMMA_SOFTCAP)]


def build_variants(out_dir: str) -> dict:
  """{variant: loaded entry point}, after printing each build's registers and spills."""
  src = open(os.path.join(_build.CSRC_DIR, "flash_attention_bwd.cu")).read()
  os.makedirs(out_dir, exist_ok=True)
  procs = {}
  for i, (name, reps) in enumerate(VARIANTS.items()):
    s = src
    for old, new in reps:
      if s.count(old) != 1:
        raise AssertionError(f"variant {name!r}: {old!r} is not in the source once")
      s = s.replace(old, new)
    cu, so = os.path.join(out_dir, f"v{i}.cu"), os.path.join(out_dir, f"v{i}.so")
    with open(cu, "w") as f:
      f.write(s)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC_DIR),
           "-o", so, cu]
    procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  fns = {}
  for name, (so, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode != 0:
      raise RuntimeError(f"variant {name!r}: nvcc exited {proc.returncode}\n{log}")
    print(f"[variant] {name}: " + "; ".join(f"{k} {r} regs, spills {a}/{b} B"
                                           for k, r, a, b in cs.ptxas_registers(log)), flush=True)
    fn = ctypes.CDLL(so).xot_flash_attention_bwd_bf16
    fn.argtypes = _build.SIGNATURES["flash_attention_bwd"]["xot_flash_attention_bwd_bf16"]
    fn.restype = ctypes.c_int
    fns[name] = fn
  return fns


def main() -> None:
  print(cs.smi_line(), flush=True)
  cs.set_peaks(torch.cuda.get_device_name(0))
  fns = build_variants(os.path.join(_build.BUILD_DIR, "k1b_variants"))
  draw = cs.seeded_randn(torch, 5)
  for w, B, T, window, softcap in CASES:
    q = w.queries(draw(B, T, w.hq, w.d))
    k, v, dout = draw(B, T, w.hkv, w.d), draw(B, T, w.hkv, w.d), draw(B, T, w.hq, w.d)
    scale = w.scale if w.scale is not None else w.d ** -0.5
    out, lse = flash_attention(q, k, v, window=window, softcap=softcap, scale=w.scale, lse=True)
    ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), dout.float(), window=window,
                                  softcap=softcap, scale=w.scale)
    limits = [cs.BWD_REL * r.abs().max().item() for r in ref]
    case = f"{w.tag}B={B} T={T} window={window} softcap={softcap}"
    for name, fn in fns.items():
      dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
      delta = torch.empty_like(lse)
      args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
              lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
              B, T, w.hq, w.hkv, w.d, window, scale, softcap)
      call = lambda: _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), name)
      call()
      torch.cuda.synchronize()
      worst = max((g.float() - r).abs().max().item() / l for g, r, l in zip((dq, dk, dv), ref, limits))
      if not worst <= 1.0:
        raise AssertionError(f"variant {name!r} {case}: {worst:.2f} of the limit")
      ms = cs.time_ms(call)
      split = cs.kernel_split_ms(torch, call, ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")) or {}
      print(f"[variant] {case}, {name}: {ms:.4f} ms (profiler, warm: dQ kernel "
            f"{split.get('flash_bwd_dq_kernel', math.nan):.4f}, dK/dV kernel "
            f"{split.get('flash_bwd_dkdv_kernel', math.nan):.4f}); {worst:.2f} of the limit", flush=True)


if __name__ == "__main__":
  main()
