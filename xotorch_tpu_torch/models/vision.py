"""CLIP ViT vision tower and the LLaVA multi-modal projector.

The port of xotorch_tpu/models/vision.py:

- `encode_images`: the patch embedding as a reshaped matmul (the conv's stride equals
  its kernel, so the conv is exactly a patch-flatten times a weight), the CLS and
  position embeddings, the pre-LN, then the encoder layers, bidirectional attention as
  a plain matmul and softmax (fp32 softmax, as JAX): neither the causal prefill kernel
  K1 nor a library attention call runs here;
- LLaVA semantics: the features are hidden_states[vision_feature_layer] (default -2,
  the penultimate layer's output), CLS dropped under the "default" select strategy,
  then the two-layer projector (`projector_hidden_act`) maps them into the language
  model's embedding space;
- `merge_image_features` splices each image's projected features in at its `<image>`
  placeholder; the engine runs the merged sequence through the text stack as a hidden
  input from position 0 (K1 on the card).

Parameters keep the JAX package's layout (`vparams["layers"][name]` stacked along a
leading layer axis, linear weights [in, out]), so the two packages' tensors map one to
one. Preprocessing (`preprocess_images`, `_resize_bilinear`) is numpy, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]

# CLIP preprocessing constants (openai/clip-vit-large-patch14-336 processor).
CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


@dataclass(frozen=True)
class VisionConfig:
  hidden_size: int
  intermediate_size: int
  num_layers: int
  num_heads: int
  image_size: int
  patch_size: int
  layer_norm_eps: float = 1e-5
  hidden_act: str = "quick_gelu"

  @property
  def num_patches(self) -> int:
    return (self.image_size // self.patch_size) ** 2


def vision_config_from_hf(vcfg: dict) -> VisionConfig:
  return VisionConfig(
    hidden_size=int(vcfg.get("hidden_size", 1024)),
    intermediate_size=int(vcfg.get("intermediate_size", 4096)),
    num_layers=int(vcfg.get("num_hidden_layers", 24)),
    num_heads=int(vcfg.get("num_attention_heads", 16)),
    image_size=int(vcfg.get("image_size", 336)),
    patch_size=int(vcfg.get("patch_size", 14)),
    layer_norm_eps=float(vcfg.get("layer_norm_eps", 1e-5)),
    hidden_act=str(vcfg.get("hidden_act", "quick_gelu")),
  )


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
  x32 = x.to(torch.float32)
  mu = x32.mean(-1, keepdim=True)
  var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
  out = (x32 - mu) * torch.rsqrt(var + eps) * w.to(torch.float32) + b.to(torch.float32)
  return out.to(x.dtype)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
  """HF ACT2FN subset: exact-erf "gelu" by default, sigmoid "quick_gelu",
  tanh-approximated "gelu_new"/"gelu_pytorch_tanh"/"gelu_fast", "relu", "silu"."""
  if kind == "quick_gelu":
    return x * torch.sigmoid(1.702 * x)
  if kind in ("gelu_new", "gelu_pytorch_tanh", "gelu_fast"):
    return F.gelu(x, approximate="tanh")
  if kind == "relu":
    return F.relu(x)
  if kind == "silu":
    return F.silu(x)
  return F.gelu(x)


def encode_images(vparams: Params, pixels: torch.Tensor, vcfg: VisionConfig,
                  feature_layer: int = -2, select: str = "default") -> torch.Tensor:
  """pixels [B, 3, S, S] (CLIP-normalised fp32) -> features [B, N, visH] in the tower's
  dtype: CLIPVisionTransformer's embeddings, pre-LN and encoder; hidden_states
  [feature_layer], CLS dropped when select == "default". Only the layers up to the
  selected one run (the later ones cannot change it)."""
  B = pixels.shape[0]
  P, H = vcfg.patch_size, vcfg.hidden_size
  Sp = vcfg.image_size // vcfg.patch_size
  pe = vparams["patch_embed"]
  # [B, 3, S, S] -> [B, Sp*Sp, 3*P*P]: feature order (c, ph, pw), the row-major reshape
  # of the HF conv weight [H, 3, P, P].
  x = pixels.reshape(B, 3, Sp, P, Sp, P).permute(0, 2, 4, 1, 3, 5).reshape(B, Sp * Sp, 3 * P * P)
  patches = x.to(device=pe.device, dtype=pe.dtype) @ pe  # [B, N, H]
  cls = vparams["class_embed"].to(patches.dtype).expand(B, 1, H)
  h = torch.cat([cls, patches], dim=1) + vparams["pos_embed"][None]
  h = _layer_norm(h, vparams["pre_ln_w"], vparams["pre_ln_b"], vcfg.layer_norm_eps)

  # hidden_states = [embeddings, out_1 .. out_L]; index like HF.
  n_states = vcfg.num_layers + 1
  idx = feature_layer if feature_layer >= 0 else n_states + feature_layer
  D = H // vcfg.num_heads
  scale = D ** -0.5
  stacked = vparams["layers"]
  for i in range(idx):
    layer = {name: w[i] for name, w in stacked.items()}
    residual = h
    x = _layer_norm(h, layer["ln1_w"], layer["ln1_b"], vcfg.layer_norm_eps)
    T = x.shape[1]
    q = (x @ layer["wq"] + layer["bq"]).reshape(B, T, vcfg.num_heads, D)
    k = (x @ layer["wk"] + layer["bk"]).reshape(B, T, vcfg.num_heads, D)
    v = (x @ layer["wv"] + layer["bv"]).reshape(B, T, vcfg.num_heads, D)
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    attn = torch.softmax(attn.to(torch.float32), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, H)
    h = residual + (out @ layer["wo"] + layer["bo"])
    residual = h
    x = _layer_norm(h, layer["ln2_w"], layer["ln2_b"], vcfg.layer_norm_eps)
    h = residual + (_act(x @ layer["w_fc1"] + layer["b_fc1"], vcfg.hidden_act) @ layer["w_fc2"]
                    + layer["b_fc2"])
  if select == "default":
    h = h[:, 1:]  # drop CLS
  return h


def project_features(pparams: Params, feats: torch.Tensor, act: str = "gelu") -> torch.Tensor:
  """The LLaVA multi-modal projector: linear, `projector_hidden_act`, linear into the
  text model's embedding space."""
  h = _act(feats @ pparams["w1"] + pparams["b1"], act)
  return h @ pparams["w2"] + pparams["b2"]


# ------------------------------------------------------------- weight load

_VISION_PREFIX = "vision_tower.vision_model."
_PROJ_PREFIX = "multi_modal_projector."


def is_vision_tensor(name: str) -> bool:
  return name.startswith((_VISION_PREFIX, _PROJ_PREFIX)) or ".vision_tower." in name


def vision_tensor_names(vcfg: VisionConfig) -> Dict[str, str]:
  """Each HF tensor name of the tower and the projector (without a wrapper prefix) ->
  the slot it fills: `patch_embed`, `class_embed`, ..., `layers.<i>.<slot>`,
  `proj.<slot>`."""
  names = {
    "embeddings.class_embedding": "class_embed",
    "embeddings.patch_embedding.weight": "patch_embed",
    "embeddings.position_embedding.weight": "pos_embed",
    "pre_layrnorm.weight": "pre_ln_w",
    "pre_layrnorm.bias": "pre_ln_b",
  }
  per_layer = {
    "layer_norm1.weight": "ln1_w", "layer_norm1.bias": "ln1_b",
    "layer_norm2.weight": "ln2_w", "layer_norm2.bias": "ln2_b",
    "self_attn.q_proj.weight": "wq", "self_attn.q_proj.bias": "bq",
    "self_attn.k_proj.weight": "wk", "self_attn.k_proj.bias": "bk",
    "self_attn.v_proj.weight": "wv", "self_attn.v_proj.bias": "bv",
    "self_attn.out_proj.weight": "wo", "self_attn.out_proj.bias": "bo",
    "mlp.fc1.weight": "w_fc1", "mlp.fc1.bias": "b_fc1",
    "mlp.fc2.weight": "w_fc2", "mlp.fc2.bias": "b_fc2",
  }
  for i in range(vcfg.num_layers):
    names.update((f"encoder.layers.{i}.{k}", f"layers.{i}.{v}") for k, v in per_layer.items())
  for n in (1, 2):
    names[f"{_PROJ_PREFIX}linear_{n}.weight"] = f"proj.w{n}"
    names[f"{_PROJ_PREFIX}linear_{n}.bias"] = f"proj.b{n}"
  return names


def _canon(name: str) -> str:
  """A tower or projector tensor's name without any wrapper prefix before
  vision_tower.vision_model. / multi_modal_projector."""
  for marker in (_VISION_PREFIX, _PROJ_PREFIX):
    idx = name.find(marker)
    if idx >= 0:
      stripped = name[idx + len(marker):]
      return stripped if marker == _VISION_PREFIX else _PROJ_PREFIX + stripped
  return name


def load_vision_params(raw: Dict[str, torch.Tensor], vcfg: VisionConfig, dtype=torch.float32,
                       device="cpu") -> Tuple[Params, Params]:
  """(tower params, projector params) from raw HF tensors of a llava checkpoint, on
  `device` in `dtype`: linear weights transposed to [in, out], the conv weight
  [H, 3, P, P] flattened to [3*P*P, H] in encode_images' patch order, per-layer tensors
  stacked along a leading layer axis."""
  t = {_canon(k): v for k, v in raw.items()}
  slots = vision_tensor_names(vcfg)
  H, P = vcfg.hidden_size, vcfg.patch_size

  def put(name: str, slot: str) -> torch.Tensor:
    w = t[name].to(device=device)
    if slot == "patch_embed":
      w = w.reshape(H, 3 * P * P).T
    elif slot.rsplit(".", 1)[-1].startswith("w") and w.ndim == 2:
      w = w.T
    return w.to(dtype).contiguous()

  vparams: Params = {}
  pparams: Params = {}
  layers: Dict[str, List[torch.Tensor]] = {}
  for name, slot in slots.items():
    w = put(name, slot)
    if slot.startswith("layers."):
      layers.setdefault(slot.split(".", 2)[2], []).append(w)
    elif slot.startswith("proj."):
      pparams[slot[len("proj."):]] = w
    else:
      vparams[slot] = w
  vparams["layers"] = {k: torch.stack(v) for k, v in layers.items()}
  return vparams, pparams


# ------------------------------------------------------------ preprocessing

def preprocess_images(images: List[np.ndarray], image_size: int) -> np.ndarray:
  """uint8 HWC images (any size) -> CLIP-normalised [B, 3, S, S] fp32: the shortest
  edge resized to image_size (aspect kept, bilinear), then a centre crop."""
  out = np.empty((len(images), 3, image_size, image_size), dtype=np.float32)
  for i, img in enumerate(images):
    arr = np.asarray(img)
    if arr.ndim == 2:
      arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
      arr = arr[..., :3]
    h, w = arr.shape[:2]
    if h != image_size or w != image_size:
      if h <= w:
        new_h, new_w = image_size, max(image_size, round(w * image_size / h))
      else:
        new_h, new_w = max(image_size, round(h * image_size / w)), image_size
      arr = _resize_bilinear(arr.astype(np.float32), new_h, new_w)
      top = (new_h - image_size) // 2
      left = (new_w - image_size) // 2
      arr = arr[top:top + image_size, left:left + image_size]
    x = arr.astype(np.float32) / 255.0
    x = (x - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD
    out[i] = x.transpose(2, 0, 1)
  return out


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
  h, w = img.shape[:2]
  ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
  xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
  y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
  x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
  y1 = np.clip(y0 + 1, 0, h - 1)
  x1 = np.clip(x0 + 1, 0, w - 1)
  wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
  wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
  top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
  bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
  return top * (1 - wy) + bot * wy


def decode_image_data_uri(uri: str) -> np.ndarray:
  """data:image/...;base64,... -> uint8 HWC array via PIL, imported here. Every
  malformed input raises ValueError, so the API answers 400 and not 500."""
  import base64
  import binascii
  if not uri.startswith("data:"):
    raise ValueError("only data: image URIs are supported (zero-egress serving)")
  if "," not in uri:
    raise ValueError("malformed data URI: missing ',' payload separator")
  payload = uri.split(",", 1)[1]
  try:
    blob = base64.b64decode(payload, validate=True)
  except (binascii.Error, ValueError) as e:
    raise ValueError(f"invalid base64 image payload: {e}") from e
  try:
    from io import BytesIO
    from PIL import Image
    return np.asarray(Image.open(BytesIO(blob)).convert("RGB"))
  except ImportError as e:
    raise ValueError("PIL is required to decode image payloads") from e
  except Exception as e:  # UnidentifiedImageError, truncated files, ...
    raise ValueError(f"undecodable image payload: {e}") from e


def merge_image_features(token_embeds: torch.Tensor, token_ids: np.ndarray,
                         image_feats: torch.Tensor, image_token_id: int) -> torch.Tensor:
  """LLaVA-1.5's merge: token_embeds [T, H] (the rows of token_ids [T]) with each
  `<image>` placeholder replaced by that image's N feature rows (image_feats
  [n_images, N, H]), so the sequence grows by n_images * (N - 1)."""
  ids = np.asarray(token_ids).reshape(-1)
  positions = np.where(ids == image_token_id)[0]
  if len(positions) != image_feats.shape[0]:
    raise ValueError(
      f"prompt has {len(positions)} image placeholders but {image_feats.shape[0]} images were provided")
  pieces = []
  start = 0
  for img_idx, pos in enumerate(positions):
    pieces.append(token_embeds[start:pos])
    pieces.append(image_feats[img_idx].to(token_embeds.dtype))
    start = pos + 1
  pieces.append(token_embeds[start:])
  return torch.cat(pieces, dim=0)
