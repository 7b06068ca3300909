"""AdamW over a local mesh's parameter pieces, and ZeRO-1: its moments split over dp.

The port of xotorch_tpu/parallel/zero.py (`zero1_spec`, `zero1_shard_opt_state`,
`zero1_constraint`, `moment_bytes_per_device`), with the optimizer the port's eager
step needs around it. JAX places each moment leaf with a 'dp' entry and lets XLA insert
the reduce-scatter and all-gather; the port writes them out (parallel/collectives.py).

`MeshAdamW` steps a MeshParams' trainable leaves in place, with train/lora.adamw's
settings (optax.adamw's defaults). Its `leaves` are what autograd differentiates: every
distinct piece tensor of those leaves (parallel/mesh.leaf_blocks). A step sums each
block's gradient over its distinct copies (a replicated norm or adapter on distinct
cards; along dp, a tp slice), in rank order and in fp32, and every copy steps its own
moments with that one sum, so the copies stay equal. On a virtual mesh a block has one
tensor, whose gradient already holds every position's term.

ZeRO-1 (Rajbhandari et al., 2019): each moment leaf takes its parameter's spec plus dp
on the first unsharded dimension that dp divides (`zero1_spec`). Each dp index then
keeps AdamW state for its slice alone, a leaf tensor of its own (a copy of the slice,
not a view: `torch.optim.AdamW` steps leaves), takes its slice of the summed gradient
(`collectives.reduce_scatter`), steps it, and the updated slices are gathered back into
the pieces in place (`copy_`: a captured graph reads the parameters at their addresses).
Leaves with no divisible dimension keep whole moments. The step's arithmetic is
elementwise, so the split changes no bit of the result.

`moment_bytes_per_device` counts what mesh position 0 holds. JAX counts the bytes on
its first device; on a virtual mesh every position is one torch device, so a count per
device could not shrink there.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from xotorch_tpu_torch.parallel.collectives import all_gather, all_reduce, reduce_scatter
from xotorch_tpu_torch.parallel.mesh import (Mesh, MeshParams, Spec, _at, _restrict_spec,
                                             global_shape, leaf_blocks, spec_for_param)


def zero1_spec(name: str, shape: Sequence[int], mesh: Mesh) -> Spec:
  """The spec of one moment leaf: the parameter's own (mesh-restricted) spec plus 'dp'
  on the first unsharded dimension whose size dp divides."""
  ndim = len(shape)
  base = _restrict_spec(spec_for_param(name, ndim), mesh, tuple(shape))
  entries = list(base) + [None] * (ndim - len(base))
  dp = mesh.shape.get("dp", 1)
  if dp > 1:
    for i, e in enumerate(entries[:ndim]):
      if e is None and shape[i] % dp == 0:
        entries[i] = "dp"
        break
  return tuple(entries[:ndim])


class MeshAdamW:
  """AdamW over the leaves `paths` of `mp`, stepped in place (see the module's
  docstring), its moments laid out as their parameters; `zero1_shard_opt_state` lays
  them out as ZeRO-1 does."""

  def __init__(self, mp: MeshParams, paths: Sequence[Sequence[str]], lr: float):
    self.mesh = mp.mesh
    self.lr = lr
    self.paths = [tuple(p) for p in paths]
    self.shapes = [global_shape(mp, p) for p in self.paths]
    self.dtypes = [_at(mp.tree, p).dtype for p in self.paths]
    self.param_specs = [_at(mp.specs, p) for p in self.paths]
    self.blocks = [leaf_blocks(mp, p) for p in self.paths]
    self.leaves = [t for blocks in self.blocks for b in blocks for t in b.tensors]
    self._lay_out(False, 0, None)

  # ------------------------------------------------------------------ layout

  def _lay_out(self, zero: bool, count: int, moments: Optional[Tuple[list, list]]) -> None:
    """Build the stepped tensors: per block, (dp chunk, tensor) pairs. Whole moments
    (one per distinct copy, the copy itself stepped) without ZeRO; with it, one slice
    leaf per dp chunk and device holding the block. `moments` (whole leaves) or zeros
    fill their state."""
    from xotorch_tpu_torch.train.lora import ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY
    dp = self.mesh.axis_size("dp")
    self.zero = bool(zero) and dp > 1
    self.moment_specs: List[Spec] = []
    self.zero_dims: List[Optional[int]] = []
    self.shards: List[List[List[Tuple[int, torch.Tensor]]]] = []
    stepped = []
    for path, shape, spec, blocks in zip(self.paths, self.shapes, self.param_specs, self.blocks):
      mspec = zero1_spec(path[-1], shape, self.mesh) if self.zero else tuple(spec)
      dim = mspec.index("dp") if "dp" in mspec else None
      self.moment_specs.append(mspec)
      self.zero_dims.append(dim)
      per_block = []
      for b in blocks:
        if dim is None:
          sl = [(0, t) for t in b.tensors]
        else:
          size = shape[dim] // dp
          sl = []
          for c in range(dp):
            holders = []
            for p in b.positions:
              d = self.mesh.devices[p]
              if self.mesh.coord(p, "dp") == c and d not in holders:
                holders.append(d)
            for d in holders:
              src = next(t for t in b.tensors if t.device == d)
              sl.append((c, src.detach().narrow(dim, c * size, size).clone()))
        per_block.append(sl)
        stepped.extend(t for _, t in sl)
      self.shards.append(per_block)
    self.optimizer = torch.optim.AdamW(stepped, lr=self.lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                                       weight_decay=ADAMW_WEIGHT_DECAY)
    self._stepped = stepped
    self.load_moments(count, *(moments if moments is not None else (None, None)))

  def _chunk(self, i: int, whole: torch.Tensor, c: int) -> torch.Tensor:
    dim = self.zero_dims[i]
    if dim is None:
      return whole
    size = self.shapes[i][dim] // self.mesh.axis_size("dp")
    return whole.narrow(dim, c * size, size)

  # -------------------------------------------------------------------- step

  def apply(self, grads: Sequence[torch.Tensor]) -> None:
    """One AdamW step with `grads` (one per tensor of `leaves`): each block's gradient
    summed over its distinct copies in rank order, each stepped tensor given its part,
    then ZeRO's slices gathered back into every copy."""
    dp = self.mesh.axis_size("dp")
    by_id = {id(t): g for t, g in zip(self.leaves, grads)}
    for i, blocks in enumerate(self.blocks):
      n = dp if self.zero_dims[i] is not None else 1
      for b, sl in zip(blocks, self.shards[i]):
        parts = [by_id[id(t)] for t in b.tensors]
        got = reduce_scatter(parts, [(c, t.device) for c, t in sl], self.zero_dims[i] or 0, n)
        for (_, t), g in zip(sl, got):
          t.grad = g.to(t.dtype)
    self.optimizer.step()
    for t in self._stepped:
      t.grad = None
    if not self.zero:
      return
    for i, blocks in enumerate(self.blocks):
      if self.zero_dims[i] is None:
        continue
      for b, sl in zip(blocks, self.shards[i]):
        for t in b.tensors:
          chunks = {}
          for c, s in sl:
            if c not in chunks or s.device == t.device:
              chunks[c] = s
          whole = all_gather([chunks[c] for c in sorted(chunks)], [t.device],
                             self.zero_dims[i])[0]
          t.copy_(whole)

  # ------------------------------------------------------------------ moments

  def step_count(self) -> int:
    st = self.optimizer.state.get(self._stepped[0], {}) if self._stepped else {}
    return int(st["step"]) if "step" in st else 0

  def whole_moments(self) -> Tuple[int, List[torch.Tensor], List[torch.Tensor]]:
    """(step count, first moments, second moments), each a whole leaf on the CPU in the
    order of `paths`: each block's moments (a ZeRO state's slices concatenated) written
    at its place in the leaf."""
    ms, vs = [], []
    for i, blocks in enumerate(self.blocks):
      m = torch.zeros(self.shapes[i], dtype=self.dtypes[i])
      v = torch.zeros(self.shapes[i], dtype=self.dtypes[i])
      for b, sl in zip(blocks, self.shards[i]):
        first: Dict[int, torch.Tensor] = {}
        for c, t in sl:
          first.setdefault(c, t)
        for whole, key in ((m, "exp_avg"), (v, "exp_avg_sq")):
          parts = [self.optimizer.state[first[c]][key].cpu() for c in sorted(first)]
          dim = self.zero_dims[i]
          whole[b.index] = torch.cat(parts, dim) if dim is not None else parts[0]
      ms.append(m)
      vs.append(v)
    return self.step_count(), ms, vs

  def load_moments(self, count: int, ms: Optional[Sequence[torch.Tensor]],
                   vs: Optional[Sequence[torch.Tensor]]) -> None:
    """Set every stepped tensor's state from whole moment leaves (zeros when None), its
    step count `count`."""
    for i, blocks in enumerate(self.blocks):
      for b, sl in zip(blocks, self.shards[i]):
        for c, t in sl:
          st = {"step": torch.tensor(float(count), dtype=torch.float32)}
          for key, src in (("exp_avg", ms), ("exp_avg_sq", vs)):
            if src is None:
              st[key] = torch.zeros_like(t)
            else:
              part = self._chunk(i, src[i][b.index], c)
              st[key] = part.to(device=t.device, dtype=t.dtype).clone()
          self.optimizer.state[t] = st


def zero1_shard_opt_state(opt_state: MeshAdamW, mesh: Mesh) -> MeshAdamW:
  """The optimizer with its moments split over 'dp' (ZeRO-1), its state carried over;
  call it once after building the optimizer on the placed params."""
  if opt_state.mesh is not mesh:
    raise ValueError(f"zero1_shard_opt_state: the optimizer's mesh {opt_state.mesh} is not {mesh}")
  count, ms, vs = opt_state.whole_moments()
  opt_state._lay_out(True, count, (ms, vs))
  return opt_state


def zero1_constraint(mesh: Mesh):
  """An (optimizer -> optimizer) function for make_train_step's `opt_sharding_fn`: it
  re-asserts the ZeRO-1 layout on the step's output state (JAX's sharding constraint;
  the port's eager state stays where it was put, so after the first call it returns
  the optimizer as it is)."""
  def constrain(opt_state: MeshAdamW) -> MeshAdamW:
    return opt_state if opt_state.zero else zero1_shard_opt_state(opt_state, mesh)

  return constrain


def moment_bytes_per_device(opt_state: MeshAdamW) -> int:
  """Bytes of optimizer moments that mesh position 0 holds: the moments of the blocks it
  reads, under ZeRO only its dp index's slices."""
  mesh = opt_state.mesh
  dev0, c0 = mesh.devices[0], mesh.coord(0, "dp")
  total = 0
  for i, blocks in enumerate(opt_state.blocks):
    for b, sl in zip(blocks, opt_state.shards[i]):
      if 0 not in b.positions:
        continue
      for c, t in sl:
        if t.device == dev0 and (opt_state.zero_dims[i] is None or c == c0):
          st = opt_state.optimizer.state[t]
          total += sum(st[k].numel() * st[k].element_size() for k in ("exp_avg", "exp_avg_sq"))
          break
  return total
