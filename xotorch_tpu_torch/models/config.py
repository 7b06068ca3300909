"""Model configuration: HF config.json -> a static, hashable ModelConfig.

The port's copy of xotorch_tpu/models/config.py (ModelConfig, RopeScaling,
config_from_hf_dict, load_model_config), so both packages read a checkpoint's config
the same way.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional, Tuple


@dataclass(frozen=True)
class RopeScaling:
  """Llama-3 style frequency scaling (rope_type 'llama3' in HF configs)."""
  factor: float = 32.0
  low_freq_factor: float = 1.0
  high_freq_factor: float = 4.0
  original_max_position_embeddings: int = 8192
  rope_type: str = "llama3"


@dataclass(frozen=True)
class ModelConfig:
  model_family: str  # llama | qwen2 | qwen3 | mistral | phi3 | gemma2 | generic
  vocab_size: int
  hidden_size: int
  num_layers: int
  num_heads: int
  num_kv_heads: int
  head_dim: int
  intermediate_size: int
  rms_norm_eps: float = 1e-5
  rope_theta: float = 10000.0
  rope_scaling: Optional[RopeScaling] = None
  max_seq_len: int = 8192
  tie_word_embeddings: bool = False
  attention_bias: bool = False  # qwen2-style q/k/v bias
  qk_norm: bool = False  # qwen3-style per-head RMSNorm on q/k
  # Gemma-family architecture knobs (all inert at their defaults, so every
  # other family's compiled graph is unchanged):
  hidden_act: str = "silu"  # MLP gate activation ("gelu_pytorch_tanh" = gemma)
  norm_offset: bool = False  # RMSNorm multiplies by (1 + w) (zero-centred w)
  scale_embedding: bool = False  # embeddings scaled by sqrt(hidden_size)
  sandwich_norms: bool = False  # gemma2 post-attn / pre+post-ffn norms
  attn_logit_softcap: float = 0.0  # tanh soft-cap on attention scores
  final_logit_softcap: float = 0.0  # tanh soft-cap on lm-head logits
  query_pre_attn_scalar: float = 0.0  # attention scale = this**-0.5 (0 -> head_dim)
  # Sliding-window attention. 0 = global everywhere. Which layers slide comes
  # from HF `layer_types` when the checkpoint states it, else the family rule
  # (mistral: every layer; gemma2: even layers).
  sliding_window: int = 0
  layer_types: Optional[Tuple[str, ...]] = None
  # MoE (0 experts = dense). The reference shipped only dead MoE stubs
  # (llm_utils.py:502-590); here MoE is a first-class config.
  num_experts: int = 0
  num_experts_per_tok: int = 0
  moe_intermediate_size: int = 0
  norm_topk_prob: bool = False
  eos_token_ids: Tuple[int, ...] = ()
  # Multimodal (llava-style): hashable VisionConfig keeps jit cache keys
  # working; None = text-only.
  vision: Optional["object"] = None  # models.vision.VisionConfig
  image_token_index: int = -1
  vision_feature_layer: int = -2
  vision_feature_select: str = "default"
  projector_hidden_act: str = "gelu"

  @property
  def is_moe(self) -> bool:
    return self.num_experts > 0

  def layer_window(self, layer_idx: int) -> int:
    """Sliding-window size for an ABSOLUTE layer index (0 = global
    attention). HF `layer_types` wins when present; otherwise gemma2
    alternates (even layers slide, transformers Gemma2Config) and every
    other windowed family slides everywhere (mistral semantics)."""
    if self.sliding_window <= 0:
      return 0
    if self.layer_types is not None:
      kind = self.layer_types[layer_idx % len(self.layer_types)]
      return self.sliding_window if kind == "sliding_attention" else 0
    if self.model_family == "gemma2":
      return self.sliding_window if layer_idx % 2 == 0 else 0
    return self.sliding_window

  @property
  def uses_sliding_window(self) -> bool:
    return self.sliding_window > 0 and any(
      self.layer_window(i) > 0 for i in range(self.num_layers))

  @property
  def is_multimodal(self) -> bool:
    return self.vision is not None


def config_from_hf_dict(cfg: dict) -> ModelConfig:
  model_type = cfg.get("model_type", "llama")
  # Multimodal configs nest the decoder under text_config (llava et al);
  # capture the vision side before descending.
  vision = None
  image_token_index = -1
  vision_feature_layer = -2
  vision_feature_select = "default"
  projector_hidden_act = "gelu"
  if "text_config" in cfg:
    if "vision_config" in cfg:
      raise NotImplementedError("vision (llava-style) configs are not ported yet")
      image_token_index = int(cfg.get("image_token_index", 32000))
      vision_feature_layer = int(cfg.get("vision_feature_layer", -2))
      vision_feature_select = str(cfg.get("vision_feature_select_strategy", "default"))
      projector_hidden_act = str(cfg.get("projector_hidden_act", "gelu"))
    inner = dict(cfg["text_config"])
    inner.setdefault("model_type", inner.get("model_type", model_type))
    cfg = inner
    model_type = cfg.get("model_type", "llama")
  family = {
    "llama": "llama",
    "mistral": "mistral",
    "qwen2": "qwen2",
    "qwen3": "qwen3",
    "qwen3_moe": "qwen3",
    "phi3": "phi3",
    "gemma2": "gemma2",
  }.get(model_type, "generic")
  is_gemma = family == "gemma2"

  num_heads = int(cfg.get("num_attention_heads", 32))
  hidden = int(cfg.get("hidden_size", 4096))
  head_dim = int(cfg.get("head_dim") or hidden // num_heads)
  rope_scaling = None
  rs = cfg.get("rope_scaling")
  if rs and rs.get("rope_type", rs.get("type")) == "llama3":
    rope_scaling = RopeScaling(
      factor=float(rs.get("factor", 32.0)),
      low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
      high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
      original_max_position_embeddings=int(rs.get("original_max_position_embeddings", 8192)),
    )

  eos = cfg.get("eos_token_id", ())
  if isinstance(eos, int):
    eos = (eos,)
  elif eos is None:
    eos = ()
  else:
    eos = tuple(int(e) for e in eos)

  # Sliding windows: gemma2 always windows (HF Gemma2Config defaults to
  # 4096); mistral only when the checkpoint says so (v0.3+/nemo set null).
  # Qwen2.5-style checkpoints state a sliding_window but gate it behind
  # use_sliding_window (false on every released card) — honouring the gate
  # keeps those families global-attention AND on the Pallas fast path.
  sliding = cfg.get("sliding_window")
  if cfg.get("use_sliding_window") is False:
    sliding = 0
  if sliding is None and is_gemma:
    sliding = 4096
  layer_types = cfg.get("layer_types")
  if layer_types is not None:
    layer_types = tuple(str(k) for k in layer_types)

  return ModelConfig(
    model_family=family,
    vocab_size=int(cfg.get("vocab_size", 32000)),
    hidden_size=hidden,
    num_layers=int(cfg.get("num_hidden_layers", 32)),
    num_heads=num_heads,
    num_kv_heads=int(cfg.get("num_key_value_heads", num_heads)),
    head_dim=head_dim,
    intermediate_size=int(cfg.get("intermediate_size", 11008)),
    rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
    rope_theta=float(cfg.get("rope_theta", 10000.0)),
    rope_scaling=rope_scaling,
    max_seq_len=int(cfg.get("max_position_embeddings", 8192)),
    tie_word_embeddings=bool(cfg.get("tie_word_embeddings", is_gemma)),
    attention_bias=bool(cfg.get("attention_bias", model_type == "qwen2")),
    qk_norm=model_type in ("qwen3", "qwen3_moe"),
    hidden_act=str(cfg.get("hidden_activation") or cfg.get("hidden_act")
                   or ("gelu_pytorch_tanh" if is_gemma else "silu")),
    norm_offset=is_gemma,
    scale_embedding=is_gemma,
    sandwich_norms=is_gemma,
    attn_logit_softcap=float(cfg.get("attn_logit_softcapping") or 0.0),
    final_logit_softcap=float(cfg.get("final_logit_softcapping") or 0.0),
    query_pre_attn_scalar=float(cfg.get("query_pre_attn_scalar") or 0.0),
    sliding_window=int(sliding or 0),
    layer_types=layer_types,
    num_experts=int(cfg.get("num_experts", cfg.get("num_local_experts", 0)) or 0),
    num_experts_per_tok=int(cfg.get("num_experts_per_tok", 0) or 0),
    moe_intermediate_size=int(cfg.get("moe_intermediate_size", 0) or 0),
    norm_topk_prob=bool(cfg.get("norm_topk_prob", False)),
    eos_token_ids=eos,
    vision=vision,
    image_token_index=image_token_index,
    vision_feature_layer=vision_feature_layer,
    vision_feature_select=vision_feature_select,
    projector_hidden_act=projector_hidden_act,
  )


def load_model_config(model_dir: Path, max_seq_len_override: Optional[int] = None) -> ModelConfig:
  """Read config.json from a local model dir; `max_seq_len_override`, else
  XOT_MAX_SEQ_LEN, caps the model's maximum sequence length."""
  with open(Path(model_dir) / "config.json") as f:
    cfg = config_from_hf_dict(json.load(f))
  from xotorch_tpu_torch.utils import knobs
  override = max_seq_len_override or knobs.get_int("XOT_MAX_SEQ_LEN", None)
  if override:
    cfg = replace(cfg, max_seq_len=min(cfg.max_seq_len, override))
  return cfg
