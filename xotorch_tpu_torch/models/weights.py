"""Carry parameters into the port's layout.

`params_from_jax` takes the JAX package's stacked parameter tree (from its
init_random_params or load_shard_params), as nested dictionaries of numpy arrays,
and returns the same tree of torch tensors. The layouts are the same, quantized
trees included (models/quantize.py), so this is a dtype and device move. Loading safetensors checkpoints directly is a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from xotorch_tpu_torch.models.config import ModelConfig
from xotorch_tpu_torch.models.transformer import check_supported


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
