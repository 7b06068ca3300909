"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface. On first use it is compiled with
nvcc for Hopper (`sm_90a`) into a shared library under `xotorch_tpu_torch/build/`
(listed in .gitignore) and loaded with ctypes. Sources may include the shared headers
`csrc/*.cuh` (`attention_mma.cuh`: the tensor-core tile core of K1, K2's segments and
K4/K4q; `decode_split.cuh`: the split-K decode core of K2/K2q and K3/K3q). The
library's file name carries a hash of its source, of every header and of the flags, so
an edited kernel or header is rebuilt and a stale library is never loaded.

Pointers and the stream travel as `ctypes.c_void_p` (a plain int would be cut to 32
bits); every entry point returns a cudaError_t value, and `check` raises on nonzero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
KERNELS = ("flash_attention", "flash_attention_bwd", "flash_decode", "paged_attention",
           "quant_matvec")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points, by source name.
SIGNATURES = {
  "flash_attention": {
    "xot_flash_attention_bf16": [P, P, P, P, P, I, I, I, I, I, I, I, I, F, F, P],
  },
  "flash_attention_bwd": {
    "xot_flash_attention_bwd_bf16": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, P],
  },
  "flash_decode": {
    "xot_flash_cached_attention_bf16": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, F, P],
    "xot_flash_cached_attention_kv8": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, F,
                                       P],
  },
  "paged_attention": {
    "xot_paged_decode_attention_bf16": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, F, P],
    "xot_paged_prefill_attention_bf16": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, F, P],
    "xot_paged_decode_attention_kv8": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F,
                                       F, P],
    "xot_paged_prefill_attention_kv8": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, F,
                                        P],
  },
  "quant_matvec": {
    "xot_w8a8_matvec_bf16": [P, P, P, P, I, I, I, I, I, P],
    "xot_w4a8_matvec_bf16": [P, P, P, P, I, I, I, I, I, I, P],
    "xot_w4a16_matvec_bf16": [P, P, P, P, I, I, I, I, I, I, P],
  },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
LOGS: Dict[str, str] = {}  # nvcc's output by source, from builds made in this process


def nvcc_path() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  default = "/usr/local/cuda/bin/nvcc"
  if os.path.exists(default):
    return default
  raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
  h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
  for header in sorted(CSRC_DIR.glob("*.cuh")):
    h.update(header.name.encode() + b"\0" + header.read_bytes())
  h.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS, verbose: bool = False) -> List[Path]:
  """Compile every named source that has no current library, one nvcc process per
  source, all started together. Returns the library paths. Raises with nvcc's output
  when a build fails."""
  names = list(names)
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  procs = []
  for name in names:
    out = _lib_path(name)
    if out.exists():
      continue
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) + [
      "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    procs.append((name, out, tmp, subprocess.Popen(
      cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  failed = []
  for name, out, tmp, proc in procs:
    log, _ = proc.communicate()
    if proc.returncode != 0:
      failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
      continue
    LOGS[name] = log
    if verbose and log:
      print(f"[nvcc {name}]\n{log}")
    os.replace(tmp, out)
  if failed:
    raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
  return [_lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
  """The loaded library for csrc/<name>.cu, built first if needed."""
  lib = _libs.get(name)
  if lib is not None:
    return lib
  with _lock:
    lib = _libs.get(name)
    if lib is None:
      path, = build([name])
      lib = ctypes.CDLL(str(path))
      for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
      _libs[name] = lib
  return lib


def load_all(verbose: bool = False) -> float:
  """Build every kernel in parallel and load them. Returns the seconds it took."""
  t0 = time.perf_counter()
  build(KERNELS, verbose=verbose)
  for name in KERNELS:
    load(name)
  return time.perf_counter() - t0


def check(rc: int, what: str) -> None:
  if rc != 0:
    raise RuntimeError(f"{what}: CUDA error {rc}")
