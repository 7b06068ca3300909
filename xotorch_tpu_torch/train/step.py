"""The training step over a shard's parameter dictionary: loss, gradients, AdamW.

The port of xotorch_tpu/train/step.py. JAX jits a pure step that returns new trees; the
port runs eager autograd and updates the parameters IN PLACE through
`torch.optim.AdamW` (train/lora.adamw / masked_optimizer), so every holder of a
parameter tensor (a captured CUDA graph included) reads the trained values.

The training forward is `forward_shard` with no cache (`cache=None`): attention goes
through `flash_attention_train` (K1 forward, K1b backward on the card; the plain
version's autograd on the CPU) over the fresh K/V of the segment, as JAX's fresh
per-step cache holds nothing else, and quantized slots take the dequantized product
whatever B*T (TRAIN_ROUTE: the GEMV kernels have no backward).

Loss: next-token cross-entropy in fp32 with a length mask, divided by the count of
unmasked positions (at least 1). Gradients are taken over the float leaves only
(`split_float`): an int8 or int4 base is frozen by construction.

Over a local mesh (params a parallel/mesh.MeshParams) the same functions run the
transformer's mesh path, and the optimizer is parallel/zero.MeshAdamW (train/lora's
`optimizer_for`), which steps the pieces in place. With a dp axis each dp index runs
its rows (`forward_replicas`): each replica's masked sum is divided by the count over
the WHOLE batch and the replicas' terms are summed in rank order (JAX's
`masked_ce_loss` over the global batch), never averaged per replica. `ring_mesh` (JAX's
argument) trains sequence-parallel: attention rotates K/V chunks over the params'
mesh's sp axis (ops/ring_attention.py).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from xotorch_tpu_torch.models.config import ModelConfig
from xotorch_tpu_torch.models.transformer import QuantRoute, forward_replicas, forward_shard
from xotorch_tpu_torch.parallel.collectives import all_reduce
from xotorch_tpu_torch.parallel.mesh import MeshParams, dp_rows, global_shape, leaf_blocks
from xotorch_tpu_torch.parallel.zero import MeshAdamW

Params = Dict[str, Any]

# Quantized slots in a training or evaluation forward: the dequantized product always.
TRAIN_ROUTE = QuantRoute()


def split_float(tree: Params) -> Tuple[Params, Params]:
  """A nested dict split into (float leaves, the others), each keeping the nesting."""
  fl: Params = {}
  nf: Params = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      a, b = split_float(v)
      if a:
        fl[k] = a
      if b:
        nf[k] = b
    elif torch.is_tensor(v) and v.is_floating_point():
      fl[k] = v
    else:
      nf[k] = v
  return fl, nf


def merge_trees(a: Params, b: Params) -> Params:
  """The inverse of split_float: two disjoint nested dicts overlaid."""
  out = dict(a)
  for k, v in b.items():
    out[k] = merge_trees(out[k], v) if k in out and isinstance(v, dict) else v
  return out


def trainable_subtree(params: Params) -> Params:
  """The float subtree: what the optimizer and the gradients see."""
  return split_float(params)[0]


def leaf_paths(tree: Params, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
  """(key path, tensor) of every leaf in JAX's flatten order: keys sorted at each level,
  depth first (the order of a moments file, train/optstate.py)."""
  out = []
  for k in sorted(tree):
    v = tree[k]
    if isinstance(v, dict):
      out.extend(leaf_paths(v, prefix + (k,)))
    else:
      out.append((prefix + (k,), v))
  return out


def unflatten(paths: Sequence[Tuple[str, ...]], values: Sequence[Any]) -> Params:
  """A nested dict from key paths and their values."""
  out: Params = {}
  for path, value in zip(paths, values):
    node = out
    for k in path[:-1]:
      node = node.setdefault(k, {})
    node[path[-1]] = value
  return out


def masked_ce_sum(logits: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
  """logits [B, T, V] (fp32 on the way in), targets [B, T], lengths [B]: the fp32
  cross-entropy summed over positions t < length."""
  B, T, V = logits.shape
  mask = torch.arange(T, device=logits.device)[None, :] < lengths.to(logits.device)[:, None]
  ce = F.cross_entropy(logits.to(torch.float32).reshape(B * T, V),
                       targets.to(device=logits.device, dtype=torch.int64).reshape(B * T),
                       reduction="none").reshape(B, T)
  return (ce * mask).sum()


def unmasked_count(lengths: torch.Tensor, T: int) -> torch.Tensor:
  """The count of positions t < length over the batch, at least 1 (the denominator)."""
  return torch.clamp(torch.clamp(lengths.to(torch.int64), 0, T).sum(), min=1)


def masked_ce_loss(logits: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
  """The mean fp32 cross-entropy over positions t < length."""
  count = unmasked_count(lengths, logits.shape[1]).to(logits.device)
  return masked_ce_sum(logits, targets, lengths) / count


def _ring_of(params, ring_mesh) -> bool:
  """Whether to train sequence-parallel: `ring_mesh` must be the params' own mesh."""
  if ring_mesh is None:
    return False
  if not isinstance(params, MeshParams) or params.mesh is not ring_mesh:
    raise ValueError("ring_mesh: ring attention runs over the sp axis of the mesh the params "
                     "are placed on (parallel/mesh.shard_params)")
  return True


def training_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, is_first: bool,
                     is_last: bool, start_layer: int = 0, ring: bool = False) -> torch.Tensor:
  """One shard's forward from position 0 with no cache: hidden states, or fp32 logits on
  the last shard (over a dp mesh, every replica's rows gathered on its first device)."""
  out, _ = forward_shard(params, x, None, 0, cfg, is_first, is_last, use_flash=True,
                         start_layer=start_layer, route=TRAIN_ROUTE, ring=ring)
  return out


def full_model_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                    ring_mesh=None) -> torch.Tensor:
  """The loss when one shard holds the whole model (single-peer training). Over a mesh
  with a dp axis each replica's logits stay on it: its masked sum over the global
  count, the replicas' terms summed in rank order on the mesh's first device."""
  ring = _ring_of(params, ring_mesh)
  inputs, targets, lengths = batch["inputs"], batch["targets"], batch["lengths"]
  if not (isinstance(params, MeshParams) and params.mesh.axis_size("dp") > 1):
    return masked_ce_loss(training_forward(params, inputs, cfg, True, True, ring=ring),
                          targets, lengths)
  mesh = params.mesh
  count = unmasked_count(lengths, inputs.shape[1])
  outs = forward_replicas(params, inputs, cfg, True, True, route=TRAIN_ROUTE, ring=ring)
  terms = [masked_ce_sum(o, t, n) / count.to(o.device)
           for o, t, n in zip(outs, dp_rows(targets, mesh), dp_rows(lengths, mesh))]
  return all_reduce(terms, mesh.devices[:1])[0]


def value_and_grad(fn: Callable[[], torch.Tensor], wrt: Sequence[torch.Tensor],
                   grad_output: Optional[torch.Tensor] = None):
  """(fn(), its gradients with respect to the leaf tensors `wrt`): the leaves require
  grad for the call only. With `grad_output`, fn's output is pulled back along it (a
  vector-Jacobian product, in the output's dtype) and the value returned detached."""
  for t in wrt:
    t.requires_grad_(True)
  try:
    with torch.enable_grad():
      out = fn()
      if grad_output is not None:
        grad_output = grad_output.to(out.dtype)
      grads = torch.autograd.grad(out, list(wrt), grad_outputs=grad_output, allow_unused=True)
  finally:
    for t in wrt:
      t.requires_grad_(False)
  grads = [torch.zeros_like(t) if g is None else g for t, g in zip(wrt, grads)]
  return out.detach(), grads


def optimizer_leaves(optimizer) -> List[torch.Tensor]:
  """The tensors an optimizer's gradients are taken with respect to: a torch
  optimizer's parameters, or a MeshAdamW's distinct pieces."""
  if isinstance(optimizer, MeshAdamW):
    return list(optimizer.leaves)
  return [p for group in optimizer.param_groups for p in group["params"]]


def apply_grads(optimizer, leaves: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
  """One optimizer step with `grads` on `leaves` (updated in place); a MeshAdamW sums
  each block's copies first (parallel/zero.py)."""
  if isinstance(optimizer, MeshAdamW):
    optimizer.apply(grads)
    return
  for t, g in zip(leaves, grads):
    t.grad = g.to(t.dtype)
  optimizer.step()
  for t in leaves:
    t.grad = None


def _check_trainable(params: Params) -> None:
  from xotorch_tpu_torch.models.quantize import is_quantized
  from xotorch_tpu_torch.train.lora import has_lora
  tree = params.tree if isinstance(params, MeshParams) else params
  if is_quantized(tree) and not has_lora(tree):
    # Without a frozen-base mask the float scales and norms would train against
    # immutable int8 weights: neither a full fine-tune nor a clean freeze.
    raise ValueError("Training a quantized base requires LoRA adapters "
                     "(add_lora_params + masked_optimizer)")


def make_train_step(cfg: ModelConfig, optimizer, loss_fn: Optional[Callable] = None,
                    ring_mesh=None, opt_sharding_fn: Optional[Callable] = None) -> Callable:
  """(params, batch) -> loss: one eager step of `optimizer` (built over the params'
  trainable leaves: train/lora.optimizer_for or masked_optimizer; a MeshAdamW over a
  MeshParams), the parameters updated in place. `opt_sharding_fn` (ZeRO-1,
  parallel/zero.zero1_constraint) is applied to the optimizer after each step."""
  loss_fn = loss_fn or (lambda p, b: full_model_loss(p, b, cfg, ring_mesh=ring_mesh))
  leaves = optimizer_leaves(optimizer)

  def train_step(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    _check_trainable(params)
    loss, grads = value_and_grad(lambda: loss_fn(params, batch), leaves)
    with torch.no_grad():
      apply_grads(optimizer, leaves, grads)
      if opt_sharding_fn is not None:
        opt_sharding_fn(optimizer)
    return loss

  return train_step


def make_eval_step(cfg: ModelConfig, loss_fn: Optional[Callable] = None, ring_mesh=None) -> Callable:
  loss_fn = loss_fn or (lambda p, b: full_model_loss(p, b, cfg, ring_mesh=ring_mesh))

  def eval_step(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    with torch.no_grad():
      return loss_fn(params, batch)

  return eval_step


def leaf_loss_and_grads(params, cfg: ModelConfig, x: torch.Tensor, targets, lengths,
                        is_first: bool, leaves: Sequence[torch.Tensor], start_layer: int = 0):
  """A last shard's (loss, gradient of its input, gradients of `leaves`): the tensors an
  optimizer steps (`optimizer_leaves`; over a mesh, the distinct pieces), in their
  order. A first shard's input gradient is zeros [B, T, hidden] fp32."""
  B, T = x.shape[0], x.shape[1]
  xin = x if is_first else x.detach().clone()
  wrt = list(leaves) + ([] if is_first else [xin])

  def fwd():
    logits = training_forward(params, xin, cfg, is_first, True, start_layer)
    return masked_ce_loss(logits, targets, lengths)

  loss, grads = value_and_grad(fwd, wrt)
  x_grad = (torch.zeros((B, T, cfg.hidden_size), dtype=torch.float32, device=x.device)
            if is_first else grads.pop())
  return loss, x_grad, grads


def shard_loss_and_grads(params, cfg: ModelConfig, x: torch.Tensor, back_grad_or_targets,
                         lengths, is_first: bool, is_last: bool, start_layer: int = 0):
  """One shard of pipelined training over the ring. The last shard takes the targets and
  returns (loss, gradient of the input, parameter gradients); another shard takes the
  downstream gradient of its output and pulls it back through its slice, returning
  (0.0, gradient of the input, parameter gradients). A first shard's input (tokens) is
  not differentiable: its input gradient is zeros [B, T, hidden] fp32.

  Gradients come back in the structure of the float subtree, as JAX's do. Over a
  MeshParams they are taken per distinct piece, each block's copies summed
  (collectives.all_reduce, rank order), and returned as whole leaves on the mesh's
  first device."""
  mesh_params = params if isinstance(params, MeshParams) else None
  flat = leaf_paths(trainable_subtree(mesh_params.tree if mesh_params else params))
  paths = [p for p, _ in flat]
  if mesh_params is not None:
    blocks = [leaf_blocks(mesh_params, p) for p in paths]
    leaves = [t for bl in blocks for b in bl for t in b.tensors]
  else:
    leaves = [t for _, t in flat]
  B, T = x.shape[0], x.shape[1]
  xin = x if is_first else x.detach().clone()
  wrt = leaves if is_first else leaves + [xin]

  def fwd():
    out = training_forward(params, xin, cfg, is_first, is_last, start_layer)
    return masked_ce_loss(out, back_grad_or_targets, lengths) if is_last else out

  grad_output = None if is_last else back_grad_or_targets.to(device=x.device)
  value, grads = value_and_grad(fwd, wrt, grad_output)
  if is_first:
    x_grad = torch.zeros((B, T, cfg.hidden_size), dtype=torch.float32, device=x.device)
  else:
    x_grad = grads.pop()
  if mesh_params is not None:
    grads = _whole_grads(mesh_params, paths, blocks, leaves, grads)
  loss = value if is_last else torch.zeros((), dtype=torch.float32)
  return loss, x_grad, unflatten(paths, grads)


def _whole_grads(mp: MeshParams, paths, blocks, pieces, grads) -> List[torch.Tensor]:
  """Whole-leaf gradients on the mesh's first device from the gradients of the distinct
  `pieces`: each block's copies summed in rank order (collectives.all_reduce)."""
  by_id = {id(t): g for t, g in zip(pieces, grads)}
  home = mp.mesh.devices[0]
  out = []
  for path, bl in zip(paths, blocks):
    whole = torch.zeros(global_shape(mp, path), dtype=bl[0].tensors[0].dtype, device=home)
    for b in bl:
      whole[b.index] = all_reduce([by_id[id(t)] for t in b.tensors], [home])[0]
    out.append(whole)
  return out


def mesh_value_and_grad(fn: Callable[[], torch.Tensor], mp: MeshParams,
                        paths: Sequence[Tuple[str, ...]]):
  """(fn(), the whole-leaf gradients of the leaves `paths` of `mp`, in that order),
  taken per distinct piece and summed over each block's copies."""
  blocks = [leaf_blocks(mp, p) for p in paths]
  pieces = [t for bl in blocks for b in bl for t in b.tensors]
  value, grads = value_and_grad(fn, pieces)
  return value, _whole_grads(mp, paths, blocks, pieces, grads)
