"""The port's multi-host seam (parallel/multihost.py): tests/test_multihost.py's
two-process test on torch.distributed.

Two REAL processes join one gloo process group over a local TCP port from the
environment contract (XOT_COORDINATOR, XOT_NUM_PROCESSES, XOT_PROCESS_ID), build the
group's mesh, and all-reduce a tensor whose value proves the sum crossed the process
boundary. Opt out with XOT_MULTIHOST_TEST=0 where a sandbox cannot bind local ports,
as JAX's test does.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.skipif(
  os.getenv("XOT_MULTIHOST_TEST", "1") == "0",
  reason="sandbox cannot bind local ports (XOT_MULTIHOST_TEST=0)",
)

WORKER = textwrap.dedent("""
  import os, sys
  sys.path.insert(0, os.environ["XOT_REPO"])
  import torch
  from xotorch_tpu_torch.parallel.multihost import (all_reduce, init_multihost, is_coordinator,
                                                    multihost_requested, slice_mesh)

  assert multihost_requested()
  n_proc, rank = init_multihost()
  assert n_proc == 2, n_proc
  assert rank == int(os.environ["XOT_PROCESS_ID"]), rank
  assert is_coordinator() == (rank == 0)
  assert init_multihost() == (n_proc, rank)  # idempotent
  mesh = slice_mesh()
  assert mesh.shape == {"dp": 2}, mesh.shape
  # Each process contributes its rank + 1: only a sum across both gives 3.
  got = all_reduce(torch.tensor([rank + 1.0]))
  assert float(got) == 3.0, got
  print(f"rank {rank}: all-reduce over {n_proc} processes ok", flush=True)
""")


def test_two_process_slice_mesh():
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
  env_base = {
    **os.environ,
    "XOT_REPO": os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "XOT_COORDINATOR": f"127.0.0.1:{port}",
    "XOT_NUM_PROCESSES": "2",
    "CUDA_VISIBLE_DEVICES": "",
  }
  procs = []
  for rank in (0, 1):
    env = {**env_base, "XOT_PROCESS_ID": str(rank)}
    procs.append(subprocess.Popen([sys.executable, "-c", WORKER], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  outs = []
  for p in procs:
    try:
      out, _ = p.communicate(timeout=120)
    except subprocess.TimeoutExpired:
      p.kill()
      out, _ = p.communicate()
    outs.append(out)
  for rank, (p, out) in enumerate(zip(procs, outs)):
    assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    assert "all-reduce over 2 processes ok" in out, out
