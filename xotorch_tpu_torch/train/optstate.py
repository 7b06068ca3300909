"""The optimizer's moments beside a training checkpoint, for a resume.

The port of xotorch_tpu/train/optstate.py, in JAX's layout so that a moments file
crosses between the two packages: `opt.0` is the step count (an int32 scalar),
`opt.1..n` the first moments of the trainable leaves in JAX's flatten order (keys
sorted at each level: `embed.embedding`, `final_norm`, `layers.attn_norm`, ...; the
adapters alone under LoRA), then their second moments in the same order. That is the
leaf order of optax.adamw's state and of the masked optimizer's (the frozen branch
holds no leaves). The files go through the port's own safetensors reader and writer.
Loading checks the leaf count, every shape and every dtype against the optimizer's
own leaves, with JAX's messages, and refuses a file from another optimizer or model.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import torch

from xotorch_tpu_torch.models.weights import _SafetensorsFile, _write_safetensors


def _dtype_name(dtype: torch.dtype) -> str:
  return str(dtype).replace("torch.", "")


def _template(leaves: Sequence[torch.Tensor]) -> List[tuple]:
  """(shape, dtype) of every leaf of the state, in file order."""
  moments = [(tuple(t.shape), t.dtype) for t in leaves]
  return [((), torch.int32)] + moments + moments


def save_opt_state(optimizer: torch.optim.Optimizer, leaves: Sequence[torch.Tensor], path) -> None:
  """Write `optimizer`'s AdamW state over `leaves` (in file order) to `path`; a leaf
  not stepped yet has zero moments, as optax initialises them."""
  states = [optimizer.state.get(t, {}) for t in leaves]
  count = int(states[0]["step"]) if states and "step" in states[0] else 0
  tensors = {"opt.0": torch.tensor(count, dtype=torch.int32)}
  for key, base in (("exp_avg", 1), ("exp_avg_sq", 1 + len(leaves))):
    for i, (t, st) in enumerate(zip(leaves, states)):
      tensors[f"opt.{base + i}"] = st.get(key, torch.zeros_like(t))
  _write_safetensors(tensors, Path(path))


def load_opt_state(optimizer: torch.optim.Optimizer, leaves: Sequence[torch.Tensor], path) -> None:
  """Restore `optimizer`'s state over `leaves` from `path`, after checking it against a
  fresh state over the same leaves."""
  f = _SafetensorsFile(Path(path))
  template = _template(leaves)
  if len(f.header) != len(template):
    raise ValueError(
      f"optimizer checkpoint {path} has {len(f.header)} leaves; the current "
      f"optimizer state has {len(template)} — different optimizer or model")
  saved = []
  for i, (want, dtype) in enumerate(template):
    info = f.header.get(f"opt.{i}")
    got = None if info is None else tuple(info["shape"])
    if got != want:
      raise ValueError(f"optimizer checkpoint {path}: leaf {i} shape {got} != expected {want}")
    t = f.get(f"opt.{i}")
    if t.dtype != dtype:
      raise ValueError(f"optimizer checkpoint {path}: leaf {i} dtype {_dtype_name(t.dtype)} != "
                       f"expected {_dtype_name(dtype)}")
    saved.append(t)
  n = len(leaves)
  count = float(saved[0].item())
  for i, t in enumerate(leaves):
    optimizer.state[t] = {
      "step": torch.tensor(count, dtype=torch.float32),
      "exp_avg": saved[1 + i].to(device=t.device).clone(),
      "exp_avg_sq": saved[1 + n + i].to(device=t.device).clone(),
    }
