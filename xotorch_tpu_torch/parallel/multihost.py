"""Multi-host seam: co-hosted processes form one process group.

The port of xotorch_tpu/parallel/multihost.py. The slice membership comes from the
environment (the launcher knows it):

  XOT_COORDINATOR   host:port of process 0 (presence turns the seam on)
  XOT_NUM_PROCESSES total processes
  XOT_PROCESS_ID    this process's rank

`init_multihost` joins `torch.distributed`'s default group over TCP from those three
(gloo on the CPU, NCCL when CUDA is present); XOT_MULTIHOST=1 alone takes torch's
`env://`, whose MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK a launcher sets. After
it, `slice_mesh` builds a mesh over every process's devices and `all_reduce` sums across
the processes. The serving engine does not use that mesh, as JAX's does not: JAX's
`_serving_mesh` spans `jax.local_devices()` and every rank of its main.py builds its own
engine and Node, so each rank serves over its own devices as a peer of the ring
(main.py joins the group first). A serving mesh across processes would be a feature
JAX lacks; `slice_mesh` and `all_reduce` are the seam for one.

Simulatable without hardware: two CPU processes on one local port form a two-process
group and all-reduce across the process boundary (tests/test_torch_multihost.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from xotorch_tpu_torch.parallel.mesh import Mesh, make_mesh
from xotorch_tpu_torch.utils import knobs


def multihost_requested() -> bool:
  """The seam turns on explicitly, by a coordinator address or XOT_MULTIHOST, never
  implicitly (a laptop must not hang waiting for a phantom coordinator)."""
  return bool(knobs.get_str("XOT_COORDINATOR", None)) or knobs.get_bool("XOT_MULTIHOST")


def _backend() -> str:
  return "nccl" if torch.cuda.is_available() else "gloo"


def init_multihost() -> Tuple[int, int]:
  """Join the process group from the environment contract above. Returns
  (process_count, process_index). Idempotent: a second call reports the group."""
  import torch.distributed as dist

  if dist.is_initialized():
    return dist.get_world_size(), dist.get_rank()
  coordinator = knobs.get_str("XOT_COORDINATOR", None)
  backend = _backend()
  if coordinator:
    rank = knobs.get_int("XOT_PROCESS_ID")
    if backend == "nccl":
      torch.cuda.set_device(_rank_device(rank))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=knobs.get_int("XOT_NUM_PROCESSES"), rank=rank)
  else:
    dist.init_process_group(backend, init_method="env://")
  return dist.get_world_size(), dist.get_rank()


def _rank_device(rank: int) -> torch.device:
  """Rank `rank`'s device: the card init_multihost gives it under NCCL (ranks of one
  host numbered over its cards), the CPU under gloo."""
  if _backend() == "nccl":
    return torch.device("cuda", rank % torch.cuda.device_count())
  return torch.device("cpu")


def slice_mesh(axis_sizes: Optional[dict] = None) -> Mesh:
  """A mesh over the whole group's devices, one per process in rank order (default one
  'dp' axis over them). Every process builds the same mesh; a process drives only its
  own positions and the group's collectives join them (`all_reduce`)."""
  import torch.distributed as dist

  world = dist.get_world_size()
  axes = dict(axis_sizes) if axis_sizes else {"dp": world}
  return make_mesh(axes, [_rank_device(r) for r in range(world)])


def all_reduce(x: torch.Tensor) -> torch.Tensor:
  """The sum of `x` over every process of the group (torch.distributed's all-reduce
  on this process's device), in place; returns x."""
  import torch.distributed as dist

  dist.all_reduce(x, op=dist.ReduceOp.SUM)
  return x


def is_coordinator() -> bool:
  """Rank 0 owns the ring-facing Node; the other ranks are workers."""
  import torch.distributed as dist

  return not dist.is_initialized() or dist.get_rank() == 0
