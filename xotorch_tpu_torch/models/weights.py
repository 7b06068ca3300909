"""HF safetensors checkpoints <-> the port's stacked shard parameters.

The port of xotorch_tpu/models/weights.py. `load_shard_params` reads a local
HF-layout checkpoint (one `model.safetensors`, or the shards an index names) and
returns the stacked layout `forward_shard` takes: per-layer tensors stacked along a
leading layer axis, linear weights transposed once to [in, out]. Only the tensors a
shard's layer range needs are read (`tensor_names_for_shard`); embeddings load on the
first shard (and the last for tied embeddings), the final norm and `lm_head` on the
last. Tensors go straight to the engine's device and dtype, one at a time, into
stacked buffers allocated there: no full copy of the model is built on the host.

The card has no `safetensors` package, so the format is read and written here with
the standard library and numpy: an 8-byte little-endian header length, a JSON header
({name: {dtype, shape, data_offsets}}, plus `__metadata__`), then the raw bytes. The
reader maps the file (`np.memmap`, copy-on-write, so tensors are views until they
are copied to the device); bf16 moves as 16-bit patterns and is viewed as
`torch.bfloat16`. `save_shard_params` writes a shard back in the same HF layout.

MoE checkpoints (qwen3_moe) stack each layer's experts on load: `mlp.gate.weight` is
the `router`, `mlp.experts.<e>.{gate,up,down}_proj.weight` fill `we_*` [L, E, in, out].
A llava checkpoint's text tensors (`language_model.` names) load like a dense model's;
its vision tower and projector go with the first shard (`load_vision_tower`).

`params_from_jax` carries the JAX package's stacked parameter tree (numpy leaves)
into torch tensors of the same layout, LoRA adapters (`lora_*` leaves) included: the
tests hold the two packages on the same weights with it. Adapter-only checkpoints
(`lora.layers.{i}.{slot}_{a|b}`) go through the same reader and writer
(train/lora.py).
"""
from __future__ import annotations

import json
import os
import re
import struct
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models.config import ModelConfig
from xotorch_tpu_torch.models.transformer import check_supported
from xotorch_tpu_torch.models.vision import is_vision_tensor, load_vision_params
from xotorch_tpu_torch.utils.helpers import DEBUG

# safetensors dtype names -> (numpy type the bytes are read as, torch type they are).
# bf16 has no numpy type: its 16-bit patterns travel as int16.
_ST_DTYPES = {
  "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
  "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
  "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
  "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8), "U8": (np.uint8, torch.uint8),
  "BOOL": (np.bool_, torch.bool),
}
_TORCH_TO_ST = {tt: name for name, (_, tt) in _ST_DTYPES.items()}


def _read_header(path: Path):
  """(header dict without __metadata__, byte offset of the data) of a safetensors file."""
  with open(path, "rb") as f:
    (n,) = struct.unpack("<Q", f.read(8))
    if n > os.fstat(f.fileno()).st_size - 8:
      raise ValueError(f"{path}: a {n}-byte header runs past the end of the file")
    header = json.loads(f.read(n))
  header.pop("__metadata__", None)
  return header, 8 + n


class _SafetensorsFile:
  """One safetensors file, mapped: `get(name)` is a CPU tensor over the mapping (a
  view; the bytes are read when it is copied)."""

  def __init__(self, path: Path):
    self.path = Path(path)
    self.header, self.data_start = _read_header(self.path)
    self._map = None

  def get(self, name: str) -> torch.Tensor:
    info = self.header[name]
    if info["dtype"] not in _ST_DTYPES:
      raise ValueError(f"{self.path}: tensor {name} has dtype {info['dtype']}, "
                       f"which the reader does not take ({sorted(_ST_DTYPES)})")
    np_type, torch_type = _ST_DTYPES[info["dtype"]]
    begin, end = info["data_offsets"]
    if self._map is None:
      # mode "c": copy-on-write pages, so the arrays are writable (torch wants that)
      # while the file is never written.
      self._map = np.memmap(self.path, dtype=np.uint8, mode="c")
    raw = self._map[self.data_start + begin:self.data_start + end]
    if (self.data_start + begin) % np.dtype(np_type).itemsize:
      raw = raw.copy()  # a misaligned tensor: torch takes aligned storage only
    arr = raw.view(np_type).reshape(info["shape"])
    t = torch.from_numpy(arr)
    return t.view(torch_type) if torch_type == torch.bfloat16 else t


def _write_safetensors(tensors: Dict[str, torch.Tensor], path: Path) -> None:
  """Write `tensors` (any device; written contiguous, in their own dtype) as one
  safetensors file, one tensor on the host at a time."""
  header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
  offset = 0
  for name, t in tensors.items():
    if t.dtype not in _TORCH_TO_ST:
      raise ValueError(f"tensor {name}: dtype {t.dtype} has no safetensors name here")
    n = t.numel() * t.element_size()
    header[name] = {"dtype": _TORCH_TO_ST[t.dtype], "shape": list(t.shape),
                    "data_offsets": [offset, offset + n]}
    offset += n
  blob = json.dumps(header, separators=(",", ":")).encode()
  blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned, as the library writes
  path = Path(path)
  path.parent.mkdir(parents=True, exist_ok=True)
  with open(path, "wb") as f:
    f.write(struct.pack("<Q", len(blob)))
    f.write(blob)
    for t in tensors.values():
      t = t.detach().contiguous().cpu()
      if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
      f.write(t.numpy().tobytes())


_LAYER_RE = re.compile(r"(?:^|\.)layers\.(\d+)\.")


def layer_of(tensor_name: str) -> Optional[int]:
  m = _LAYER_RE.search(tensor_name)
  return int(m.group(1)) if m else None


def tensor_names_for_shard(all_names: List[str], shard: Shard, tie_word_embeddings: bool) -> List[str]:
  """Which checkpoint tensors a shard needs (the JAX package's rule). A vision tower's
  and projector's tensors go with the first shard, which merges image features into
  the embeddings; their encoder.layers.N names are not text layers."""
  wanted = []
  for name in all_names:
    if is_vision_tensor(name):
      if shard.is_first_layer:
        wanted.append(name)
      continue
    layer = layer_of(name)
    if layer is not None:
      if shard.start_layer <= layer <= shard.end_layer:
        wanted.append(name)
      continue
    is_embed = "embed_tokens" in name
    is_head = name.startswith("lm_head") or ".lm_head" in name
    is_final_norm = re.search(r"(?:^|\.)norm\.weight$", name) is not None
    if is_embed and (shard.is_first_layer or (tie_word_embeddings and shard.is_last_layer)):
      wanted.append(name)
    elif (is_head or is_final_norm) and shard.is_last_layer:
      wanted.append(name)
    elif not (is_embed or is_head or is_final_norm):
      if shard.is_first_layer:
        wanted.append(name)
  return wanted


def _index_for(model_dir: Path) -> Dict[str, str]:
  """tensor name -> file name."""
  index_file = model_dir / "model.safetensors.index.json"
  if index_file.exists():
    with open(index_file) as f:
      return json.load(f)["weight_map"]
  single = model_dir / "model.safetensors"
  if single.exists():
    return {name: "model.safetensors" for name in _read_header(single)[0]}
  raise FileNotFoundError(f"No safetensors checkpoint in {model_dir}")


def _read_tensors(model_dir: Path, names: List[str], index: Dict[str, str]) -> Dict[str, torch.Tensor]:
  """CPU tensors over the mapped files (views: nothing is read yet)."""
  files: Dict[str, _SafetensorsFile] = {}
  out: Dict[str, torch.Tensor] = {}
  for name in names:
    file_name = index[name]
    if file_name not in files:
      files[file_name] = _SafetensorsFile(model_dir / file_name)
    out[name] = files[file_name].get(name)
  return out


def _split_fused_projections(t: Dict[str, torch.Tensor], cfg: ModelConfig) -> None:
  """Phi-3-family checkpoints fuse qkv_proj and gate_up_proj; split them into the
  canonical per-projection names (HF [out, in] layout: split along out)."""
  q_rows = cfg.num_heads * cfg.head_dim
  kv_rows = cfg.num_kv_heads * cfg.head_dim
  for name in [n for n in list(t.keys()) if n.endswith("self_attn.qkv_proj.weight")]:
    base = name[: -len("qkv_proj.weight")]
    fused = t.pop(name)
    t[base + "q_proj.weight"] = fused[:q_rows]
    t[base + "k_proj.weight"] = fused[q_rows:q_rows + kv_rows]
    t[base + "v_proj.weight"] = fused[q_rows + kv_rows:]
  for name in [n for n in list(t.keys()) if n.endswith("mlp.gate_up_proj.weight")]:
    base = name[: -len("gate_up_proj.weight")]
    fused = t.pop(name)
    half = fused.shape[0] // 2
    t[base + "gate_proj.weight"] = fused[:half]
    t[base + "up_proj.weight"] = fused[half:]


_HF_PREFIXES = ("model.", "language_model.model.", "language_model.")


def _strip_prefix(name: str) -> str:
  for prefix in _HF_PREFIXES:
    if name.startswith(prefix):
      return name[len(prefix):]
  return name


def load_shard_params(
  model_dir: Path, cfg: ModelConfig, shard: Shard, dtype=torch.bfloat16, device="cpu",
  checkpoint_file: Optional[Path] = None,
) -> Dict[str, Any]:
  """Load a shard's params in the stacked layout `forward_shard` takes, on `device`
  in `dtype`.

  checkpoint_file: load every tensor from this one safetensors file instead of the HF
  index (a single-file shard save)."""
  check_supported(cfg)
  model_dir = Path(model_dir)
  if checkpoint_file is not None:
    checkpoint_file = Path(checkpoint_file)
    model_dir = checkpoint_file.parent
    index = {name: checkpoint_file.name for name in _read_header(checkpoint_file)[0]}
  else:
    index = _index_for(model_dir)
  names = tensor_names_for_shard(list(index.keys()), shard, cfg.tie_word_embeddings)
  raw = _read_tensors(model_dir, [n for n in names if not is_vision_tensor(n)], index)
  t = {_strip_prefix(k): v for k, v in raw.items()}
  _split_fused_projections(t, cfg)

  def put(src: torch.Tensor, dst: torch.Tensor, linear: bool = False) -> torch.Tensor:
    # One tensor crosses to the device as the file holds it, then is cast (and a
    # linear weight transposed, [out, in] -> [in, out]) there.
    src = src.to(device=dst.device)
    return dst.copy_(src.T if linear else src)

  def single(name: str, linear: bool = False) -> torch.Tensor:
    src = t[name]
    shape = tuple(src.shape[::-1]) if linear else tuple(src.shape)
    return put(src, torch.empty(shape, dtype=dtype, device=device), linear)

  layer_ids = list(range(shard.start_layer, shard.end_layer + 1))

  def stack(fn: Callable[[int], str], linear: bool = False) -> torch.Tensor:
    first = t[fn(layer_ids[0])]
    shape = tuple(first.shape[::-1]) if linear else tuple(first.shape)
    out = torch.empty((len(layer_ids),) + shape, dtype=dtype, device=device)
    for idx, i in enumerate(layer_ids):
      put(t[fn(i)], out[idx], linear)
    return out

  def stack_experts(n: str) -> torch.Tensor:
    # [L, E, in, out], filled one expert's [out, in] tensor at a time.
    name = lambda i, e: f"layers.{i}.mlp.experts.{e}.{n}_proj.weight"  # noqa: E731
    first = t[name(layer_ids[0], 0)]
    out = torch.empty((len(layer_ids), cfg.num_experts) + tuple(first.shape[::-1]), dtype=dtype,
                      device=device)
    for idx, i in enumerate(layer_ids):
      for e in range(cfg.num_experts):
        put(t[name(i, e)], out[idx, e], linear=True)
    return out

  # In llama-lineage checkpoints post_attention_layernorm IS the pre-MLP norm;
  # gemma2's sandwich layout names the pre-MLP norm pre_feedforward_layernorm and
  # adds two post-norms.
  pre_mlp = "pre_feedforward_layernorm" if cfg.sandwich_norms else "post_attention_layernorm"
  proj = lambda n: (lambda i: f"layers.{i}.self_attn.{n}_proj.weight")
  layers: Dict[str, torch.Tensor] = {
    "attn_norm": stack(lambda i: f"layers.{i}.input_layernorm.weight"),
    "mlp_norm": stack(lambda i: f"layers.{i}.{pre_mlp}.weight"),
    "wq": stack(proj("q"), linear=True),
    "wk": stack(proj("k"), linear=True),
    "wv": stack(proj("v"), linear=True),
    "wo": stack(proj("o"), linear=True),
  }
  if cfg.sandwich_norms:
    layers["post_attn_norm"] = stack(lambda i: f"layers.{i}.post_attention_layernorm.weight")
    layers["post_mlp_norm"] = stack(lambda i: f"layers.{i}.post_feedforward_layernorm.weight")
  if cfg.attention_bias and f"layers.{shard.start_layer}.self_attn.q_proj.bias" in t:
    for n in ("q", "k", "v"):
      layers[f"b{n}"] = stack(lambda i, n=n: f"layers.{i}.self_attn.{n}_proj.bias")
  if cfg.qk_norm:
    layers["q_norm"] = stack(lambda i: f"layers.{i}.self_attn.q_norm.weight")
    layers["k_norm"] = stack(lambda i: f"layers.{i}.self_attn.k_norm.weight")
  if cfg.is_moe:
    layers["router"] = stack(lambda i: f"layers.{i}.mlp.gate.weight", linear=True)
    for n in ("gate", "up", "down"):
      layers[f"we_{n}"] = stack_experts(n)
  else:
    for slot, n in (("w_gate", "gate"), ("w_up", "up"), ("w_down", "down")):
      layers[slot] = stack(lambda i, n=n: f"layers.{i}.mlp.{n}_proj.weight", linear=True)

  params: Dict[str, Any] = {"layers": layers}
  if "embed_tokens.weight" in t:
    params["embed"] = {"embedding": single("embed_tokens.weight")}
  if shard.is_last_layer:
    params["final_norm"] = single("norm.weight")
    if "lm_head.weight" in t and not cfg.tie_word_embeddings:
      params["lm_head"] = single("lm_head.weight", linear=True)
  if DEBUG >= 2:
    n_params = sum(w.numel() for w in layers.values()) + sum(
      v.numel() for k, v in params.items() if k != "layers" and torch.is_tensor(v))
    print(f"Loaded shard {shard}: {n_params / 1e6:.1f}M params from {model_dir}")
  return params


def load_vision_tower(model_dir: Path, cfg: ModelConfig, dtype=torch.float32, device="cpu"):
  """The vision tower and projector of a llava-style checkpoint, (tower params,
  projector params) on `device` in `dtype`. First shard only."""
  model_dir = Path(model_dir)
  index = _index_for(model_dir)
  names = [n for n in index if is_vision_tensor(n)]
  return load_vision_params(_read_tensors(model_dir, names, index), cfg.vision, dtype=dtype,
                            device=device)


def save_shard_params(params: Dict[str, Any], cfg: ModelConfig, shard: Shard, out_path: Path) -> None:
  """Write a shard's params back to HF-layout safetensors, each tensor in its own
  dtype (linear weights transposed back to [out, in])."""
  flat: Dict[str, torch.Tensor] = {}
  layers = params["layers"]
  for idx, i in enumerate(range(shard.start_layer, shard.end_layer + 1)):
    prefix = f"model.layers.{i}."
    flat[prefix + "input_layernorm.weight"] = layers["attn_norm"][idx]
    if "post_attn_norm" in layers:  # gemma2 sandwich layout (see the load side)
      flat[prefix + "pre_feedforward_layernorm.weight"] = layers["mlp_norm"][idx]
      flat[prefix + "post_attention_layernorm.weight"] = layers["post_attn_norm"][idx]
      flat[prefix + "post_feedforward_layernorm.weight"] = layers["post_mlp_norm"][idx]
    else:
      flat[prefix + "post_attention_layernorm.weight"] = layers["mlp_norm"][idx]
    for n in ("q", "k", "v", "o"):
      flat[prefix + f"self_attn.{n}_proj.weight"] = layers[f"w{n}"][idx].T
    if "bq" in layers:
      for n in ("q", "k", "v"):
        flat[prefix + f"self_attn.{n}_proj.bias"] = layers[f"b{n}"][idx]
    if "q_norm" in layers:
      flat[prefix + "self_attn.q_norm.weight"] = layers["q_norm"][idx]
      flat[prefix + "self_attn.k_norm.weight"] = layers["k_norm"][idx]
    if "router" in layers:
      flat[prefix + "mlp.gate.weight"] = layers["router"][idx].T
      for e in range(layers["we_gate"].shape[1]):
        for n in ("gate", "up", "down"):
          flat[prefix + f"mlp.experts.{e}.{n}_proj.weight"] = layers[f"we_{n}"][idx, e].T
    else:
      for slot, n in (("w_gate", "gate"), ("w_up", "up"), ("w_down", "down")):
        flat[prefix + f"mlp.{n}_proj.weight"] = layers[slot][idx].T
  if "embed" in params:
    flat["model.embed_tokens.weight"] = params["embed"]["embedding"]
  if "final_norm" in params:
    flat["model.norm.weight"] = params["final_norm"]
  if "lm_head" in params:
    flat["lm_head.weight"] = params["lm_head"].T
  _write_safetensors(flat, Path(out_path))


def _tensor(a) -> torch.Tensor:
  a = np.array(a)  # a writable, contiguous copy: JAX hands out read-only views
  if a.dtype.name == "bfloat16":
    # ml_dtypes' bfloat16 has no torch counterpart in from_numpy: move the raw
    # 16-bit patterns and reinterpret them.
    return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
  return torch.from_numpy(a)


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
  """Nested dict of arrays -> the same nested dict of tensors on `device`, floating
  leaves cast to `dtype` when given (else kept in each array's own type). Integer
  leaves (int8 / packed-uint8 quantized weights) keep their type: a cast would turn
  the stored codes into values."""
  check_supported(cfg)

  def convert(node):
    if isinstance(node, dict):
      return {k: convert(v) for k, v in node.items()}
    t = _tensor(node)
    if dtype is not None and t.is_floating_point():
      return t.to(device=device, dtype=dtype)
    return t.to(device=device)

  return convert(np_params)
