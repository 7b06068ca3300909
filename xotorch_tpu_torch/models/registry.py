"""Model registry: short name -> layer count + repo per engine classname.

The port's subset of xotorch_tpu/models/registry.py, keyed by the port's engine
classname: the dense cards (llama, mistral, the deepseek-r1 distills, qwen 2.5,
qwen-3-32b, gemma2, nemotron, phi-4-mini) and the synthetic cards. A dense card's
checkpoint is read from XOT_HOME/models/<org>--<name> (download/hf_shard_download.py);
synthetic cards carry their config and get random weights from a seed. The MoE and
vision cards (qwen-3-30b-a3b, llava-1.5-7b-hf) wait until MoE and vision are ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from xotorch_tpu_torch.inference.shard import Shard

TORCH = "TorchShardInferenceEngine"

model_cards: Dict[str, Dict] = {
  ### llama 3 family
  "llama-3.3-70b": {"layers": 80, "repo": {TORCH: "unsloth/Llama-3.3-70B-Instruct"}},
  "llama-3.2-1b": {"layers": 16, "repo": {TORCH: "unsloth/Llama-3.2-1B-Instruct"}},
  "llama-3.2-3b": {"layers": 28, "repo": {TORCH: "unsloth/Llama-3.2-3B-Instruct"}},
  "llama-3.1-8b": {"layers": 32, "repo": {TORCH: "mlx-community/Meta-Llama-3.1-8B-Instruct-bf16"}},
  "llama-3.1-70b": {"layers": 80, "repo": {TORCH: "mlx-community/Meta-Llama-3.1-70B-Instruct-bf16"}},
  "llama-3.1-405b": {"layers": 126, "repo": {TORCH: "mlx-community/Meta-Llama-3.1-405B-bf16"}},
  "llama-3-8b": {"layers": 32, "repo": {TORCH: "mlx-community/Meta-Llama-3-8B-Instruct-bf16"}},
  "llama-3-70b": {"layers": 80, "repo": {TORCH: "mlx-community/Meta-Llama-3-70B-Instruct-bf16"}},
  ### mistral
  "mistral-nemo": {"layers": 40, "repo": {TORCH: "unsloth/Mistral-Nemo-Instruct-2407"}},
  "mistral-large": {"layers": 88, "repo": {TORCH: "mistralai/Mistral-Large-Instruct-2407"}},
  ### deepseek r1 distills
  "deepseek-r1-distill-qwen-1.5b": {"layers": 28, "repo": {TORCH: "deepseek-ai/DeepSeek-R1-Distill-Qwen-1.5B"}},
  "deepseek-r1-distill-qwen-7b": {"layers": 28, "repo": {TORCH: "deepseek-ai/DeepSeek-R1-Distill-Qwen-7B"}},
  "deepseek-r1-distill-qwen-14b": {"layers": 48, "repo": {TORCH: "deepseek-ai/DeepSeek-R1-Distill-Qwen-14B"}},
  "deepseek-r1-distill-qwen-32b": {"layers": 64, "repo": {TORCH: "deepseek-ai/DeepSeek-R1-Distill-Qwen-32B"}},
  "deepseek-r1-distill-llama-8b": {"layers": 32, "repo": {TORCH: "deepseek-ai/DeepSeek-R1-Distill-Llama-8B"}},
  "deepseek-r1-distill-llama-70b": {"layers": 80, "repo": {TORCH: "deepseek-ai/DeepSeek-R1-Distill-Llama-70B"}},
  ### qwen 2.5
  "qwen-2.5-0.5b": {"layers": 24, "repo": {TORCH: "Qwen/Qwen2.5-0.5B-Instruct"}},
  "qwen-2.5-1.5b": {"layers": 28, "repo": {TORCH: "Qwen/Qwen2.5-1.5B-Instruct"}},
  "qwen-2.5-coder-1.5b": {"layers": 28, "repo": {TORCH: "Qwen/Qwen2.5-Coder-1.5B-Instruct"}},
  "qwen-2.5-3b": {"layers": 36, "repo": {TORCH: "Qwen/Qwen2.5-3B-Instruct"}},
  "qwen-2.5-coder-3b": {"layers": 36, "repo": {TORCH: "Qwen/Qwen2.5-Coder-3B-Instruct"}},
  "qwen-2.5-7b": {"layers": 28, "repo": {TORCH: "Qwen/Qwen2.5-7B-Instruct"}},
  "qwen-2.5-coder-7b": {"layers": 28, "repo": {TORCH: "Qwen/Qwen2.5-Coder-7B-Instruct"}},
  "qwen-2.5-math-7b": {"layers": 28, "repo": {TORCH: "Qwen/Qwen2.5-Math-7B-Instruct"}},
  "qwen-2.5-14b": {"layers": 48, "repo": {TORCH: "Qwen/Qwen2.5-14B-Instruct"}},
  "qwen-2.5-coder-14b": {"layers": 48, "repo": {TORCH: "Qwen/Qwen2.5-Coder-14B-Instruct"}},
  "qwen-2.5-32b": {"layers": 64, "repo": {TORCH: "Qwen/Qwen2.5-32B-Instruct"}},
  "qwen-2.5-coder-32b": {"layers": 64, "repo": {TORCH: "Qwen/Qwen2.5-Coder-32B-Instruct"}},
  "qwen-2.5-72b": {"layers": 80, "repo": {TORCH: "Qwen/Qwen2.5-72B-Instruct"}},
  "qwen-2.5-math-72b": {"layers": 80, "repo": {TORCH: "Qwen/Qwen2.5-Math-72B-Instruct"}},
  ### qwen 3 (dense; the MoE card waits for MoE)
  "qwen-3-32b": {"layers": 64, "repo": {TORCH: "Qwen/Qwen3-32B"}},
  ### gemma 2 (sandwich norms, alternating sliding window, soft-capped logits)
  "gemma2-2b": {"layers": 26, "repo": {TORCH: "google/gemma-2-2b-it"}},
  "gemma2-9b": {"layers": 42, "repo": {TORCH: "google/gemma-2-9b-it"}},
  "gemma2-27b": {"layers": 46, "repo": {TORCH: "google/gemma-2-27b-it"}},
  ### nemotron
  "nemotron-70b": {"layers": 80, "repo": {TORCH: "nvidia/Llama-3.1-Nemotron-70B-Instruct-HF"}},
  ### phi
  "phi-4-mini": {"layers": 32, "repo": {TORCH: "microsoft/Phi-4-mini-instruct"}},
  ### synthetic (random weights from a seed, no download;
  ### shapes match the corresponding real models)
  "synthetic-llama-1b": {
    "layers": 16, "repo": {TORCH: "synthetic"},
    "synthetic_config": {
      "model_type": "llama", "hidden_size": 2048, "intermediate_size": 8192,
      "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
      "num_hidden_layers": 16, "vocab_size": 128256, "max_position_embeddings": 131072,
      "rope_theta": 500000.0, "tie_word_embeddings": True, "eos_token_id": 128001,
    },
  },
  "synthetic-llama-8b": {
    "layers": 32, "repo": {TORCH: "synthetic"},
    "synthetic_config": {
      "model_type": "llama", "hidden_size": 4096, "intermediate_size": 14336,
      "num_attention_heads": 32, "num_key_value_heads": 8,
      "num_hidden_layers": 32, "vocab_size": 128256, "max_position_embeddings": 131072,
      "rope_theta": 500000.0, "tie_word_embeddings": False, "eos_token_id": 128001,
    },
  },
  "synthetic-tiny": {
    "layers": 4, "repo": {TORCH: "synthetic"},
    "synthetic_config": {
      "model_type": "llama", "hidden_size": 64, "intermediate_size": 128,
      "num_attention_heads": 4, "num_key_value_heads": 2,
      "num_hidden_layers": 4, "vocab_size": 256, "max_position_embeddings": 2048,
      "rope_theta": 10000.0, "tie_word_embeddings": False, "eos_token_id": 2,
    },
  },
  "synthetic-tiny-moe": {
    "layers": 4, "repo": {TORCH: "synthetic"}, "moe": True,
    "synthetic_config": {
      "model_type": "qwen3_moe", "hidden_size": 64, "intermediate_size": 128,
      "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
      "num_hidden_layers": 4, "vocab_size": 256, "max_position_embeddings": 2048,
      "rope_theta": 10000.0, "tie_word_embeddings": False, "eos_token_id": 2,
      "num_experts": 4, "num_experts_per_tok": 2, "moe_intermediate_size": 64,
      "norm_topk_prob": True,
    },
  },
  # Gemma2 architecture knobs (sandwich norms, soft-caps, alternating sliding window).
  "synthetic-tiny-gemma2": {
    "layers": 4, "repo": {TORCH: "synthetic"},
    "synthetic_config": {
      "model_type": "gemma2", "hidden_size": 64, "intermediate_size": 128,
      "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
      "num_hidden_layers": 4, "vocab_size": 256, "max_position_embeddings": 2048,
      "rope_theta": 10000.0, "eos_token_id": 2,
      "sliding_window": 8, "attn_logit_softcapping": 50.0,
      "final_logit_softcapping": 30.0, "query_pre_attn_scalar": 16.0,
    },
  },
}


def get_model_card(model_id: str) -> Optional[Dict]:
  return model_cards.get(model_id)


def get_repo(model_id: str, inference_engine_classname: str) -> Optional[str]:
  return model_cards.get(model_id, {}).get("repo", {}).get(inference_engine_classname)


def build_base_shard(model_id: str, inference_engine_classname: str) -> Optional[Shard]:
  """start=end=0 sentinel shard used to address a model before its layer range is
  known."""
  n_layers = (get_model_card(model_id) or {}).get("layers", 0)
  if n_layers < 1 or get_repo(model_id, inference_engine_classname) is None:
    return None
  return Shard(model_id, 0, 0, n_layers)


def build_full_shard(model_id: str, inference_engine_classname: str) -> Optional[Shard]:
  base = build_base_shard(model_id, inference_engine_classname)
  return Shard(model_id, 0, base.n_layers - 1, base.n_layers) if base else None


def get_supported_models(engine_classname: str = TORCH) -> List[str]:
  return [m for m, card in model_cards.items() if engine_classname in card.get("repo", {})]

