"""The mesh's collectives, written out where GSPMD inserts JAX's.

One process drives every position of a local mesh (parallel/mesh.py), so a collective
is a function from the list of per-position pieces to the list of results, one per
target device: each piece is copied to the target's device (a no-op where it already
lies there, a peer copy between cards) and combined there in rank order, so every
target computes the same bits and the result does not depend on how the mesh's
positions map to devices. A target device that repeats computes once and every
position on it shares the result.

- `all_reduce`: the sum of the pieces, accumulated in fp32 from rank 0 up and cast
  back to the pieces' dtype (after the row-parallel `wo`, `w_down` and the experts'
  combine);
- `all_gather`: the pieces concatenated along a dimension in rank order (the
  hidden-split embedding rows, the vocab-split logits, the sequence chunks);
- `send_next`: each piece moved to the next position of a ring, the last to the
  first (JAX's `ppermute` with perm i -> i + 1; ring attention's rotation);
- `reduce_scatter`: the sum of the pieces cut along a dimension, each target given
  its part (ZeRO-1's gradient of a dp slice, parallel/zero.py).

Training sums the gradients of a replicated leaf's copies with `all_reduce`, once per
distinct tensor (parallel/mesh.leaf_blocks): on a virtual mesh the positions of one
device share one tensor, whose gradient already holds every position's term.

NCCL's collectives come with a four-card cell. A process group (parallel/multihost.py)
changes nothing here: each rank's serving mesh spans its own devices, as JAX's does, and
only multihost.all_reduce crosses processes, through torch.distributed.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


def all_reduce(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
  """sum(parts) in rank order on each of `devices`."""
  done: Dict[torch.device, torch.Tensor] = {}
  out = []
  for d in devices:
    if d not in done:
      acc = parts[0].to(device=d, dtype=torch.float32)
      for x in parts[1:]:
        acc = acc + x.to(device=d, dtype=torch.float32)
      done[d] = acc.to(parts[0].dtype)
    out.append(done[d])
  return out


def all_gather(parts: Sequence[torch.Tensor], devices: Sequence[torch.device],
               dim: int) -> List[torch.Tensor]:
  """The pieces concatenated along `dim` in rank order, on each of `devices`."""
  done: Dict[torch.device, torch.Tensor] = {}
  out = []
  for d in devices:
    if d not in done:
      done[d] = torch.cat([x.to(d) for x in parts], dim=dim)
    out.append(done[d])
  return out


def send_next(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
  """Position i's piece moved to position i + 1 (the last to the first)."""
  n = len(parts)
  return [parts[(i - 1) % n].to(devices[i]) for i in range(n)]


def reduce_scatter(parts: Sequence[torch.Tensor], targets: Sequence[Tuple[int, torch.device]],
                   dim: int, n: int) -> List[torch.Tensor]:
  """sum(parts) in rank order, cut into `n` equal parts along `dim`: for each target
  (part index, device), that part on that device."""
  sums = all_reduce(parts, [d for _, d in targets])
  size = parts[0].shape[dim] // n
  return [s.narrow(dim, c * size, size) for (c, _), s in zip(targets, sums)]
