"""LoRA adapters for shard transformers: the tensors, their optimizer, and adapter-only
checkpoints.

The port of xotorch_tpu/train/lora.py. Adapter tensors live inside
the stacked `params["layers"]` dict as `lora_<slot>_a` [L, in, r] and
`lora_<slot>_b` [L, r, out], so the layer loop slices them with the rest
(models/transformer._maybe_lora applies them). Init follows the standard recipe:
A ~ N(0, 0.02), B = 0, so fresh adapters start at the base model exactly; the
contribution is scaled by alpha/r with alpha = 2r (LORA_SCALE, 2.0).

Adapter-only checkpoints name each tensor by its absolute layer index
(`lora.layers.{i}.{slot}_{a|b}`), so a peer holding any layer range restores its
slice, and a re-partitioned ring merges the saves of other ranges. They go through
the port's own safetensors reader and writer (models/weights.py): the JAX package's
files load here and the port's load there.

The optimizer is `torch.optim.AdamW` with optax.adamw's defaults (`adamw`): betas
(0.9, 0.999), eps 1e-8 and weight decay 1e-4, where torch's own default decay is 1e-2.
Torch applies the decay to the parameter before the Adam step and optax adds it to the
update; both give p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p). `masked_optimizer`
builds it over the adapter leaves alone: a frozen leaf gets no moments and no update,
as optax's multi_transform with set_to_zero gives it none.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

import torch

from xotorch_tpu_torch.models.quantize import _leaves
from xotorch_tpu_torch.models.transformer import LORA_SCALE, LORA_SLOTS  # noqa: F401 (re-exported)
from xotorch_tpu_torch.models.weights import _read_header, _SafetensorsFile, _write_safetensors

Params = Dict[str, Any]

# Slots eligible for adaptation (the forward's LORA_SLOTS): attention projections by
# default (the classic LoRA target set); MLP projections opt-in.
ATTN_SLOTS = LORA_SLOTS[:4]  # wq, wk, wv, wo
MLP_SLOTS = LORA_SLOTS[4:]  # w_gate, w_up, w_down


def lora_names(slot: str) -> Tuple[str, str]:
  return f"lora_{slot}_a", f"lora_{slot}_b"


def add_lora_params(params: Params, rank: int, generator: torch.Generator,
                    targets: Iterable[str] = ATTN_SLOTS, scale_init: float = 0.02) -> Params:
  """Return params with stacked LoRA tensors added to the layers dict for every target
  slot present in this shard, on the base slot's device. A is drawn from `generator`
  (one draw a slot, in target order, in fp32 on the generator's device), B is zero.
  Base tensors are untouched."""
  layers = dict(params["layers"])
  for slot in targets:
    base = layers.get(slot)
    if base is None:
      continue
    if base.dim() == 4:
      # int4 grouped layout, PACKED uint8 [L, G, gs/2, out] (dense targets only;
      # experts are never a LoRA target): logical in = G * gs = G * 2 * (gs/2).
      L, d_in, d_out = base.shape[0], base.shape[1] * base.shape[2] * 2, base.shape[3]
    else:
      L, d_in, d_out = base.shape[0], base.shape[1], base.shape[2]
    a_name, b_name = lora_names(slot)
    dtype = _adapter_dtype(layers, slot)
    a = torch.randn((L, d_in, rank), generator=generator, device=generator.device,
                    dtype=torch.float32) * scale_init
    layers[a_name] = a.to(device=base.device, dtype=dtype)
    layers[b_name] = torch.zeros((L, rank, d_out), dtype=dtype, device=base.device)
  return {**params, "layers": layers}


def _adapter_dtype(layers: Params, slot: str) -> torch.dtype:
  """Adapters follow the base dtype, except over a quantized base (QLoRA,
  models/quantize.py), where they take the scale's compute dtype: integer adapters
  could neither train nor add a fractional delta."""
  base = layers[slot]
  if base.is_floating_point():
    return base.dtype
  scale = layers.get(slot + "_scale")
  if scale is None:
    scale = layers.get(slot + "_gscale")
  return scale.dtype if scale is not None else torch.bfloat16


def has_lora(params: Params) -> bool:
  return any(k.startswith("lora_") for k in params.get("layers", {}))


def lora_mask(params: Params) -> Params:
  """Boolean tree: True exactly on adapter leaves."""
  def mark(tree, in_layers: bool):
    return {k: (mark(v, in_layers or k == "layers") if isinstance(v, dict)
                else in_layers and k.startswith("lora_")) for k, v in tree.items()}
  return mark(params, False)


ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default (torch's is 1e-2)


def adamw(leaves, lr: float) -> torch.optim.AdamW:
  """AdamW over `leaves` (tensors updated in place) with optax.adamw's defaults."""
  return torch.optim.AdamW(list(leaves), lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                           weight_decay=ADAMW_WEIGHT_DECAY)


def trainable_leaves(params: Params) -> list:
  """(key path, tensor) of what an optimizer over `params` trains, in JAX's flatten
  order: the adapter leaves when there are any, else every float leaf."""
  from xotorch_tpu_torch.train.step import leaf_paths, trainable_subtree
  flat = leaf_paths(trainable_subtree(params))
  if has_lora(params):
    flat = [(path, t) for path, t in flat if path[0] == "layers" and path[-1].startswith("lora_")]
  return flat


def masked_optimizer(params: Params, lr: float) -> torch.optim.AdamW:
  """AdamW over the adapter leaves alone (the base frozen: no moments, no update)."""
  return adamw([t for path, t in trainable_leaves(params) if path[-1].startswith("lora_")], lr)


def lora_param_counts(params: Params) -> Tuple[int, int]:
  """(trainable adapter param count, total param count)."""
  adapter = sum(int(v.numel()) for k, v in params.get("layers", {}).items()
                if k.startswith("lora_"))
  return adapter, sum(int(t.numel()) for t in _leaves(params))


def save_lora_checkpoint(params: Params, shard, out_path) -> None:
  """Adapter-ONLY checkpoint: the `lora_*` leaves of this shard, each layer's slice
  under its absolute index (`lora.layers.{i}.{slot}_{a|b}`), in their own dtype."""
  flat: Dict[str, torch.Tensor] = {}
  for k, v in params["layers"].items():
    if not k.startswith("lora_"):
      continue
    for idx, i in enumerate(range(shard.start_layer, shard.end_layer + 1)):
      flat[f"lora.layers.{i}.{k[len('lora_'):]}"] = v[idx]
  _write_safetensors(flat, Path(out_path))


# `{start}-{end}-{iter}` shard-save stem: THE naming rule for sharded adapter and
# checkpoint saves, shared with the engine's checkpoint code.
SHARD_SAVE_RE = re.compile(r"(\d+)-(\d+)-(\d+)")


def adapter_checkpoint_files(path) -> list:
  """Resolve a registered adapter path to its checkpoint FILE list: the one
  dir-to-files rule that the engine's load path and the API's listing share. A file
  resolves to itself; a directory to all `{start}-{end}-{iter}` shard saves, the
  latest iteration per layer range (the set a re-partitioned ring merges adapters
  from)."""
  p = Path(path)
  if not p.is_dir():
    return [p]
  best: Dict[str, tuple] = {}
  for f in p.glob("*.safetensors"):
    m = SHARD_SAVE_RE.fullmatch(f.stem)
    if not m:
      continue
    sid, it = f"{m.group(1)}-{m.group(2)}", int(m.group(3))
    if sid not in best or it > best[sid][0]:
      best[sid] = (it, f)
  return [f for _, f in sorted(best.values())]


def validate_adapter_file(path, n_layers: int) -> str | None:
  """Listing-time compatibility check of a registered adapter (XOT_ADAPTERS) against
  a base model's card. Reads only the safetensors HEADERS (names and shapes), never
  tensor data, so /v1/models can afford it. Returns an error string, or None when
  compatible.

  `path` may be one checkpoint file or a directory of shard saves, resolved by the
  rule the engine's load path uses; coverage is checked over the union of the files.
  Tensor names must parse as `lora.layers.{i}.{slot}_{a|b}` with a known slot, every
  slot must cover layers 0..n_layers-1 with both a and b, and all slots must agree on
  one rank."""
  known = {f"{s}_{ab}" for s in LORA_SLOTS for ab in ("a", "b")}
  files = adapter_checkpoint_files(path)
  if not files:
    return f"no adapter checkpoint files under {path}"
  shapes: Dict[str, tuple] = {}
  try:
    for fp in files:
      header, _ = _read_header(fp)
      for n, info in header.items():
        shapes[n] = tuple(info["shape"])
  except Exception as e:
    return f"unreadable adapter checkpoint: {e}"
  if not shapes:
    return "adapter checkpoint is empty"
  per_slot: Dict[str, set] = {}
  ranks = set()
  for name, shape in shapes.items():
    parts = name.split(".", 3)
    if len(parts) != 4 or parts[0] != "lora" or parts[1] != "layers" or not parts[2].isdigit():
      return f"not an adapter tensor name: {name!r}"
    slot = parts[3]
    if slot not in known:
      return f"unknown adapter slot {slot!r} (expected one of {sorted(known)})"
    if len(shape) != 2:
      return f"{name}: expected 2-D adapter tensor, got shape {shape}"
    ranks.add(shape[1] if slot.endswith("_a") else shape[0])
    per_slot.setdefault(slot, set()).add(int(parts[2]))
  if len(ranks) != 1:
    return f"inconsistent LoRA rank across tensors: {sorted(ranks)}"
  want = set(range(n_layers))
  for slot, got in per_slot.items():
    if got != want:
      missing = sorted(want - got)
      extra = sorted(got - want)
      detail = (f"missing layers {missing[:4]}{'...' if len(missing) > 4 else ''}" if missing
                else f"covers layers beyond the base's {n_layers} ({extra[:4]}...)")
      return f"slot {slot}: {detail} — adapter was trained for a different base depth"
  for slot in {s.rsplit("_", 1)[0] for s in per_slot}:
    if f"{slot}_a" not in per_slot or f"{slot}_b" not in per_slot:
      return f"slot {slot}: missing its a/b pair"
  return None


def is_lora_checkpoint(path) -> bool:
  """True when every tensor in the safetensors FILE is an adapter tensor. Directory to
  file resolution is the caller's (the engine's `_checkpoint_file_for`)."""
  try:
    names = list(_read_header(path)[0])
  except Exception:
    return False
  return bool(names) and all(n.startswith("lora.") for n in names)


def load_lora_checkpoint(params: Params, shard, path) -> Params:
  """Merge adapter-only checkpoint FILE(s) into `params`, restacking this shard's layer
  range, on the device of the shard's layers and in each slot's adapter dtype. `path`
  may be one file or a list: a node now serving layers 0-15 merges the 0-7 and 8-15
  files of a previous two-node split. The base tree is untouched; layers that the
  file set does not cover raise with the missing range."""
  paths = path if isinstance(path, (list, tuple)) else [path]
  raw: Dict[str, torch.Tensor] = {}
  for p in paths:
    f = _SafetensorsFile(Path(p))
    for name in f.header:
      raw[name] = f.get(name)

  slots = sorted({n.split(".", 3)[3] for n in raw if n.startswith("lora.layers.")})
  layers = dict(params["layers"])
  device = next(iter(layers.values())).device
  for slot in slots:  # e.g. "wq_a"
    missing = [i for i in range(shard.start_layer, shard.end_layer + 1)
               if f"lora.layers.{i}.{slot}" not in raw]
    if missing:
      raise KeyError(
        f"adapter checkpoint {path} lacks layers {missing} of slot {slot} "
        f"needed by shard {shard.start_layer}-{shard.end_layer}"
      )
    stacked = torch.stack([
      raw[f"lora.layers.{i}.{slot}"] for i in range(shard.start_layer, shard.end_layer + 1)
    ])
    base_slot = slot.rsplit("_", 1)[0]
    dtype = _adapter_dtype(layers, base_slot) if base_slot in layers else stacked.dtype
    layers[f"lora_{slot}"] = stacked.to(device=device, dtype=dtype)
  return {**params, "layers": layers}
