"""Device mesh and sharding rules: the intra-peer parallelism layer.

The port of xotorch_tpu/parallel/mesh.py. A peer that owns several devices serves its
layer-range shard over a local mesh: ONE process drives every position, as JAX's
single controller drives `jax.local_devices()`. Where JAX annotates placements and lets
GSPMD insert the collectives, the port splits each parameter and cache into one piece
per mesh position with JAX's partition rules (`spec_for_param`, `cache_spec`) and writes
the collectives out (parallel/collectives.py) at the places JAX's `_tp_constraint` pins:
an all-reduce after the row-parallel `wo`, `w_down` and the experts' combine, an
all-gather of the hidden-split embedding and of the vocab-split logits.

Axes:
  dp — data parallel (batch)
  tp — tensor parallel (attention heads / ffn columns, Megatron-style)
  sp — sequence parallel (ring attention over the prompt's positions; ops/ring_attention)
  ep — expert parallel (MoE experts)

A mesh is a list of `torch.device`s reshaped into named axes, row-major in the order
the axes are given. `local_devices` lists the devices one process may drive: every
CUDA card, or the CPU once; XOT_VIRTUAL_DEVICES=N repeats the engine's one device N
times instead, the port's counterpart of XLA's --xla_force_host_platform_device_count
(the JAX tests' eight virtual CPU devices). Nothing here asks whether two positions
share a device: a copy to a position's device is a no-op when the tensor already lies
there, and a piece cut for one device is reused, never cut again, by every position on
that device.

Layouts:
  - parameters: `shard_params` gives a `MeshParams`, the mesh and one param tree per
    position, each leaf that position's slice under `spec_for_param` (the int4 grouped
    layout's out axis on column slots and group axis on row slots, a group axis that
    does not divide replicating, as `_int4_shape_guard` decides);
  - caches: `shard_cache` splits a {leaf: [L, B, S, Hkv, D]} cache (or a page arena)
    over tp along the kv heads into ONE flat dict whose leaves are the pieces, named
    `piece_name(leaf, j)` ("k", "k@1", ...): every leaf-wise operation the engine does
    on a cache (grow, stack, page copies, host spills) then runs on each piece as it
    is, and `cache_piece(cache, j)` is position j's own cache. Piece j lies on the
    device of the mesh's first position with tp index j; positions that differ only
    along ep or sp share it (the cache is replicated there in JAX).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from xotorch_tpu_torch.models.quantize import _INT4_LAYER_SLOTS
from xotorch_tpu_torch.utils import knobs

Spec = Tuple[Optional[str], ...]
Params = Dict[str, Any]

AXES = ("dp", "ep", "sp", "tp")


def _canonical(device) -> torch.device:
  """A device with its index: `cuda` names the current card, as a tensor's `.device`
  does, so devices compare and hash the way tensors report them."""
  device = torch.device(device)
  if device.type == "cuda" and device.index is None:
    return torch.device("cuda", torch.cuda.current_device())
  return device


def local_devices(device=None) -> List[torch.device]:
  """The devices one process drives: XOT_VIRTUAL_DEVICES=N > 0 repeats `device` (the
  engine's; the CPU by default) N times; else every CUDA card when `device` is on CUDA
  (torch.cuda.device_count()), or `device` once."""
  device = _canonical(device if device is not None else "cpu")
  n = knobs.get_int("XOT_VIRTUAL_DEVICES")
  if n > 0:
    return [device] * n
  if device.type == "cuda":
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
  return [device]


class Mesh:
  """Named axes over a list of devices, row-major in the order of `axis_sizes`."""

  def __init__(self, axis_sizes: Dict[str, int], devices: Sequence):
    for name in axis_sizes:
      if name not in AXES:
        raise ValueError(f"mesh axis {name!r}: the axes are {AXES}")
    self.axis_names = tuple(axis_sizes)
    self.shape = {name: int(n) for name, n in axis_sizes.items()}
    self.devices = [_canonical(d) for d in devices]
    if len(self.devices) != math.prod(self.shape.values()):
      raise ValueError(f"mesh {self.shape} needs {math.prod(self.shape.values())} devices, "
                       f"got {len(self.devices)}")

  @property
  def size(self) -> int:
    return len(self.devices)

  def axis_size(self, name: str) -> int:
    """The size of axis `name`, 1 when the mesh lacks it."""
    return self.shape.get(name, 1)

  def coords(self, p: int) -> Dict[str, int]:
    """Position p's index along every axis the mesh has."""
    out = {}
    for name in reversed(self.axis_names):
      p, out[name] = divmod(p, self.shape[name])
    return {name: out[name] for name in self.axis_names}

  def coord(self, p: int, name: str) -> int:
    """Position p's index along `name` (0 when the mesh lacks it)."""
    return self.coords(p).get(name, 0)

  def positions(self, **fixed: int) -> List[int]:
    """The positions whose coordinates equal `fixed` (absent axes count as 0), in mesh
    order."""
    return [p for p in range(self.size)
            if all(self.coord(p, name) == i for name, i in fixed.items())]

  def key(self) -> tuple:
    """A hashable identity: the axes, their sizes and the devices (graph-cache keys)."""
    return (tuple(self.shape.items()), tuple(str(d) for d in self.devices))

  def __repr__(self) -> str:
    return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(axis_sizes: Dict[str, int], devices: Optional[Sequence] = None) -> Mesh:
  """A mesh with named axes from {axis: size} over the first prod(sizes) of `devices`
  (local_devices() by default). Axes of size 1 are kept."""
  devices = list(devices if devices is not None else local_devices())
  total = math.prod(axis_sizes.values())
  if total > len(devices):
    raise ValueError(f"Mesh {axis_sizes} needs {total} devices, have {len(devices)}")
  return Mesh(dict(axis_sizes), devices[:total])


# ------------------------------------------------------------------ partition rules

_COL_SLOTS = ("wq", "wk", "wv", "w_gate", "w_up")

_RULES: Dict[str, Spec] = {
  "attn_norm": (None, None), "mlp_norm": (None, None),
  "post_attn_norm": (None, None), "post_mlp_norm": (None, None),
  "wq": (None, None, "tp"), "wk": (None, None, "tp"), "wv": (None, None, "tp"),
  "wo": (None, "tp", None),
  "w_gate": (None, None, "tp"), "w_up": (None, None, "tp"), "w_down": (None, "tp", None),
  "bq": (None, "tp"), "bk": (None, "tp"), "bv": (None, "tp"),
  "q_norm": (None, None), "k_norm": (None, None),
  "router": (None, None, None),
  "we_gate": (None, "ep", None, "tp"),
  "we_up": (None, "ep", None, "tp"),
  "we_down": (None, "ep", "tp", None),
  "embedding": (None, "tp"),
  "final_norm": (None,),
  "lm_head": (None, "tp"),
  # int8 weight-only scales: one per OUTPUT channel, following the base tensor's out
  # axis with the contraction axis dropped.
  "wq_scale": (None, "tp"), "wk_scale": (None, "tp"), "wv_scale": (None, "tp"),
  "wo_scale": (None, None),
  "w_gate_scale": (None, "tp"), "w_up_scale": (None, "tp"), "w_down_scale": (None, None),
  "we_gate_scale": (None, "ep", "tp"), "we_up_scale": (None, "ep", "tp"),
  "we_down_scale": (None, "ep", None),
  # The per-vocab-row embedding scale replicates (the int8 table shards hidden).
  "embedding_scale": (None,),
  "lm_head_scale": ("tp",),
}


def spec_for_param(name: str, ndim: Optional[int] = None) -> Optional[Spec]:
  """The partition spec of one named parameter in the stacked layout: a tuple with an
  axis name or None per dimension; None for a name no rule covers (replicated).
  Megatron layout: qkv/gate/up column-parallel over tp, o/down row-parallel; norms
  replicated; MoE experts over ep. At rank 4 a dense int4 slot is the grouped layout
  [L, G, gs/2, out]: column slots shard out, row slots the GROUP axis."""
  if ndim == 4 and name in _INT4_LAYER_SLOTS:
    return (None, None, None, "tp") if name in _COL_SLOTS else (None, "tp", None, None)
  if name.endswith("_gscale"):
    base = name[: -len("_gscale")]
    return (None, None, "tp") if base in _COL_SLOTS else (None, "tp", None)
  return _RULES.get(name)


def _int4_shape_guard(name: str, leaf) -> Optional[Tuple[int, ...]]:
  """The shape to check for divisibility, ONLY for the int4 grouped layouts: their
  group axis legitimately degrades (G=1 on tiny models) and replicates. Every other
  parameter must divide (the engine builds only meshes whose tp divides every dense
  dimension), and a split that does not raises."""
  is_int4_dense = getattr(leaf, "ndim", None) == 4 and name in _INT4_LAYER_SLOTS
  if is_int4_dense or name.endswith("_gscale"):
    return tuple(leaf.shape)
  return None


def _restrict_spec(spec: Optional[Spec], mesh: Mesh,
                   shape: Optional[Tuple[int, ...]] = None) -> Spec:
  """Drop axis names the mesh lacks (an absent axis means replicated there); with
  `shape` (int4 grouped layouts only), also an axis the dimension does not divide."""
  if spec is None:
    return ()
  out = []
  for i, ax in enumerate(spec):
    if ax not in mesh.shape:
      out.append(None)
    elif shape is not None and i < len(shape) and shape[i] % mesh.shape[ax] != 0:
      out.append(None)
    else:
      out.append(ax)
  return tuple(out)


def _walk(tree: Params, fn, path: Tuple[str, ...] = ()) -> Params:
  return {k: _walk(v, fn, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
          for k, v in tree.items()}


def _leaves(tree) -> List[torch.Tensor]:
  if isinstance(tree, dict):
    return [t for v in tree.values() for t in _leaves(v)]
  return [tree] if torch.is_tensor(tree) else []


def param_specs_like(params: Params, mesh: Optional[Mesh] = None) -> Params:
  """A spec tree mirroring the param tree. With the mesh, the specs it places by
  (axes it lacks dropped, the int4 guard applied)."""
  def spec(path, leaf):
    name = path[-1]
    s = spec_for_param(name, getattr(leaf, "ndim", None))
    if mesh is not None:
      return _restrict_spec(s, mesh, _int4_shape_guard(name, leaf))
    return s if s is not None else ()
  return _walk(params, spec)


def slice_for(shape: Sequence[int], spec: Spec, mesh: Mesh, p: int) -> Tuple[slice, ...]:
  """Position p's block of a tensor of `shape` split by `spec`: every named dimension
  cut into equal parts along its axis. A dimension its axis does not divide raises."""
  coords = mesh.coords(p)
  index = []
  for dim, size in enumerate(shape):
    ax = spec[dim] if dim < len(spec) else None
    if ax is None or ax not in mesh.shape:
      index.append(slice(None))
      continue
    n = mesh.shape[ax]
    if size % n:
      raise ValueError(f"dimension {dim} of size {size} does not split over {ax}={n}")
    part = size // n
    index.append(slice(coords[ax] * part, (coords[ax] + 1) * part))
  return tuple(index)


def place(x: torch.Tensor, spec: Spec, mesh: Mesh, positions: Optional[Sequence[int]] = None,
          memo: Optional[dict] = None) -> List[torch.Tensor]:
  """x split by `spec`, one contiguous piece per position (all of them by default), on
  that position's device. Positions whose device and block agree share one piece."""
  memo = {} if memo is None else memo
  out = []
  for p in positions if positions is not None else range(mesh.size):
    index = slice_for(x.shape, spec, mesh, p)
    key = (id(x), mesh.devices[p], tuple((s.start, s.stop) for s in index))
    if key not in memo:
      piece = x[index]
      memo[key] = piece.to(mesh.devices[p]).contiguous()
    out.append(memo[key])
  return out


class MeshParams:
  """A parameter tree placed on a mesh: `pieces[p]` is position p's tree, each leaf its
  slice under the partition rules. The transformer's forward takes it where it takes a
  plain tree and runs the mesh path."""

  def __init__(self, mesh: Mesh, pieces: List[Params]):
    self.mesh = mesh
    self.pieces = pieces

  def __contains__(self, name: str) -> bool:
    """Whether every position's tree has the top-level entry `name` (`lm_head`, ...)."""
    return name in self.pieces[0]


def shard_params(params: Params, mesh: Mesh) -> MeshParams:
  """Place a param tree onto the mesh per the partition rules: one piece per position,
  a replicated leaf shared by the positions of one device."""
  specs = param_specs_like(params, mesh)
  memo: dict = {}

  def piece_tree(p: int) -> Params:
    def one(path, leaf):
      spec = specs
      for k in path:
        spec = spec[k]
      return place(leaf, spec, mesh, [p], memo)[0]
    return _walk(params, one)

  return MeshParams(mesh, [piece_tree(p) for p in range(mesh.size)])


def device_bytes(tree) -> int:
  """Resident bytes at one position: for a MeshParams, the largest of its positions'
  pieces (equal under the even splits the engine builds), counted leaf by leaf as
  numel x element size, so a tp-sharded tree reports what one device holds; for a
  plain tree, all of it. Metadata only."""
  if isinstance(tree, MeshParams):
    return max(device_bytes(piece) for piece in tree.pieces)
  return int(sum(t.numel() * t.element_size() for t in _leaves(tree)))


def batch_spec(rank: int = 2) -> Spec:
  """Batch leaves shard along dp on their leading axis and (rank >= 2) the sequence
  axis over sp, where the mesh has those axes."""
  if rank >= 2:
    return ("dp", "sp") + (None,) * (rank - 2)
  return ("dp",)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, List[torch.Tensor]]:
  """Each batch leaf as one piece per position (dp over rows, sp over positions)."""
  return {k: place(x, _restrict_spec(batch_spec(x.ndim), mesh), mesh) for k, x in batch.items()}


def cache_spec(rank: int = 5) -> Spec:
  """[L, B, S, Hkv, D]: batch over dp, kv heads over tp. int8-KV scale leaves are rank
  4 ([L, B, S, Hkv]): the same placement minus the head dim. A page arena [L, P, page,
  Hkv, D] takes the same spec (its page axis is never split: the engine's meshes have
  no dp)."""
  if rank == 4:
    return (None, "dp", None, "tp")
  return (None, "dp", None, "tp", None)


def piece_name(name: str, j: int) -> str:
  """The flat cache key of leaf `name`'s piece for tp index j."""
  return name if j == 0 else f"{name}@{j}"


def base_names(cache: Dict[str, torch.Tensor]) -> List[str]:
  """The leaves of a cache, without their pieces' suffixes."""
  return [n for n in cache if "@" not in n]


def cache_piece(cache: Dict[str, torch.Tensor], j: int) -> Dict[str, torch.Tensor]:
  """Position j's own cache (tp index j) out of a flat sharded cache."""
  return {n: cache[piece_name(n, j)] for n in base_names(cache)}


def cache_device(mesh: Mesh, j: int) -> torch.device:
  """The device of cache piece j: the mesh's first position with tp index j."""
  return mesh.devices[mesh.positions(tp=j)[0]]


def shard_cache(cache: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
  """A {leaf: tensor} cache (or page arena) split over tp along the kv heads: one flat
  dict of pieces, piece j on `cache_device(mesh, j)`."""
  tp = mesh.axis_size("tp")
  out = {}
  for j in range(tp):
    p = mesh.positions(tp=j)[0]
    for name in base_names(cache):
      x = cache[name]
      spec = _restrict_spec(cache_spec(x.ndim), mesh)
      out[piece_name(name, j)] = place(x, spec, mesh, [p])[0]
  return out


def shard_map(f, mesh: Mesh, in_specs: Sequence[Spec], out_specs: Spec):
  """The port's counterpart of `shard_map`: a map over the mesh's positions. The
  returned function splits each global argument by its spec into one piece per
  position and calls `f` ONCE with, for each argument, the list of its pieces in mesh
  order (the single controller drives every position, so `f` may run collectives over
  those lists); `f` returns the list of output pieces, which are reassembled along
  `out_specs` on the first position's device (replicated dimensions taken from the
  first position of each block)."""
  def run(*args):
    memo: dict = {}
    pieces = [place(a, _restrict_spec(s, mesh), mesh, memo=memo) for a, s in zip(args, in_specs)]
    outs = f(*pieces)
    return assemble(outs, _restrict_spec(out_specs, mesh), mesh)
  return run


def assemble(pieces: Sequence[torch.Tensor], spec: Spec, mesh: Mesh) -> torch.Tensor:
  """The global tensor of per-position pieces split by `spec`, on the first position's
  device: each split dimension concatenated in axis order."""
  home = mesh.devices[0]
  named = [(dim, ax) for dim, ax in enumerate(spec) if ax is not None]

  def build(fixed: Dict[str, int], k: int) -> torch.Tensor:
    if k == len(named):
      return pieces[mesh.positions(**fixed)[0]].to(home)
    dim, ax = named[k]
    return torch.cat([build({**fixed, ax: i}, k + 1) for i in range(mesh.shape[ax])], dim=dim)

  return build({}, 0)
