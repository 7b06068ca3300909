"""Time the kernel build: one nvcc process a unit, all started together, as
ops/_build.py builds. Three layouts in turn: every csrc/*.cu whole; the sources of
_build.PARTS in their parts (-DXOT_PART=i, the package's build); and those sources
split further, one unit an entry point (the others cut from a copy). Prints each unit's
seconds and each layout's longest.

  python3 scripts/build_probe.py   # on a machine with the CUDA toolkit
"""
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from xotorch_tpu_torch.ops import _build  # noqa: E402


def only(src: str, keep: set) -> str:
  """The source with every extern "C" entry point but those in `keep` cut out, each
  with its part's `#if` guard."""
  cuts = []
  for m in re.finditer(r'(?m)^extern "C" int (\w+)\(', src):
    if m.group(1) in keep:
      continue
    start, end = m.start(), src.index("\n}\n", m.end()) + 3
    guard = src.rfind("\n", 0, start - 1) + 1
    if src.startswith("#if ", guard):
      start = guard
    if src.startswith("#endif\n", end):
      end += len("#endif\n")
    cuts.append((start, end))
  for start, end in reversed(cuts):
    src = src[:start] + src[end:]
  return src


def run(units, tag: str) -> None:
  """units: (label, source text, extra flags); compiled side by side."""
  d = tempfile.mkdtemp(prefix="xot-build-probe-")
  try:
    for h in _build.CSRC_DIR.glob("*.cuh"):
      shutil.copy(h, d)
    procs = []
    t0 = time.perf_counter()
    for label, src, flags in units:
      path = os.path.join(d, label + ".cu")
      with open(path, "w") as f:
        f.write(src)
      cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
             os.path.join(d, label + ".so"), path]
      procs.append((label, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    done = {}
    while len(done) < len(procs):
      for label, p in procs:
        if label not in done and p.poll() is not None:
          done[label] = (time.perf_counter() - t0, p.returncode, p.stdout.read()[-400:])
      time.sleep(0.2)
    for label, (t, rc, log) in sorted(done.items(), key=lambda x: x[1][0]):
      print(f"[{tag}] {label}: {t:.1f} s rc {rc} {log if rc else ''}", flush=True)
    print(f"[{tag}] longest: {max(v[0] for v in done.values()):.1f} s", flush=True)
  finally:
    shutil.rmtree(d, ignore_errors=True)


def main() -> None:
  src = {n: (_build.CSRC_DIR / f"{n}.cu").read_text() for n in _build.KERNELS}
  print(subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                       text=True).stdout.strip().splitlines()[-1], f"{os.cpu_count()} cores",
        flush=True)
  run([(n, s, []) for n, s in src.items()], "whole")
  whole = [(n, src[n], []) for n in _build.KERNELS if n not in _build.PARTS]
  run(whole + [(f"{n}.{i}", src[n], [f"-DXOT_PART={i}"]) for n in _build.PARTS
               for i in range(len(_build.PARTS[n]))], "parts")
  run(whole + [(fn, only(src[n], {fn}), []) for n in _build.PARTS
               for fn in _build.SIGNATURES[n]], "entry points")


if __name__ == "__main__":
  main()
