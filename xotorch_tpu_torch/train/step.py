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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from xotorch_tpu_torch.models.config import ModelConfig
from xotorch_tpu_torch.models.transformer import QuantRoute, forward_shard

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


def masked_ce_loss(logits: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
  """logits [B, T, V] (fp32 on the way in), targets [B, T], lengths [B]: the mean fp32
  cross-entropy over positions t < length."""
  B, T, V = logits.shape
  mask = torch.arange(T, device=logits.device)[None, :] < lengths.to(logits.device)[:, None]
  ce = F.cross_entropy(logits.to(torch.float32).reshape(B * T, V),
                       targets.to(device=logits.device, dtype=torch.int64).reshape(B * T),
                       reduction="none").reshape(B, T)
  return (ce * mask).sum() / torch.clamp(mask.sum(), min=1)


def training_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, is_first: bool,
                     is_last: bool, start_layer: int = 0) -> torch.Tensor:
  """One shard's forward from position 0 with no cache: hidden states, or fp32 logits on
  the last shard."""
  out, _ = forward_shard(params, x, None, 0, cfg, is_first, is_last, use_flash=True,
                         start_layer=start_layer, route=TRAIN_ROUTE)
  return out


def full_model_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
  """The loss when one shard holds the whole model (single-peer training)."""
  logits = training_forward(params, batch["inputs"], cfg, True, True)
  return masked_ce_loss(logits, batch["targets"], batch["lengths"])


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


def apply_grads(optimizer: torch.optim.Optimizer, leaves: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor]) -> None:
  """One optimizer step with `grads` on `leaves` (updated in place)."""
  for t, g in zip(leaves, grads):
    t.grad = g.to(t.dtype)
  optimizer.step()
  for t in leaves:
    t.grad = None


def _check_trainable(params: Params) -> None:
  from xotorch_tpu_torch.models.quantize import is_quantized
  from xotorch_tpu_torch.train.lora import has_lora
  if is_quantized(params) and not has_lora(params):
    # Without a frozen-base mask the float scales and norms would train against
    # immutable int8 weights: neither a full fine-tune nor a clean freeze.
    raise ValueError("Training a quantized base requires LoRA adapters "
                     "(add_lora_params + masked_optimizer)")


def make_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer,
                    loss_fn: Optional[Callable] = None) -> Callable:
  """(params, batch) -> loss: one eager step of `optimizer` (built over the params'
  trainable leaves, train/lora.adamw or masked_optimizer), the parameters updated in
  place."""
  loss_fn = loss_fn or (lambda p, b: full_model_loss(p, b, cfg))
  leaves = [p for group in optimizer.param_groups for p in group["params"]]

  def train_step(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    _check_trainable(params)
    loss, grads = value_and_grad(lambda: loss_fn(params, batch), leaves)
    with torch.no_grad():
      apply_grads(optimizer, leaves, grads)
    return loss

  return train_step


def make_eval_step(cfg: ModelConfig, loss_fn: Optional[Callable] = None) -> Callable:
  loss_fn = loss_fn or (lambda p, b: full_model_loss(p, b, cfg))

  def eval_step(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    with torch.no_grad():
      return loss_fn(params, batch)

  return eval_step


def shard_loss_and_grads(params: Params, cfg: ModelConfig, x: torch.Tensor, back_grad_or_targets,
                         lengths, is_first: bool, is_last: bool, start_layer: int = 0,
                         trainable: Optional[Params] = None):
  """One shard of pipelined training over the ring. The last shard takes the targets and
  returns (loss, gradient of the input, parameter gradients); another shard takes the
  downstream gradient of its output and pulls it back through its slice, returning
  (0.0, gradient of the input, parameter gradients). A first shard's input (tokens) is
  not differentiable: its input gradient is zeros [B, T, hidden] fp32.

  Gradients come back in the structure of `trainable` (a subtree of `params`; by
  default the float subtree, as JAX's do)."""
  trainable = trainable_subtree(params) if trainable is None else trainable
  paths = [p for p, _ in leaf_paths(trainable)]
  leaves = [t for _, t in leaf_paths(trainable)]
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
  loss = value if is_last else torch.zeros((), dtype=torch.float32)
  return loss, x_grad, unflatten(paths, grads)
