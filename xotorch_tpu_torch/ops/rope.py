"""Rotary position embeddings, HF rotate-half convention.

The port of xotorch_tpu/ops/rope.py: plain rotary and Llama-3 scaled rotary.
Frequencies and angles stay in fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from xotorch_tpu_torch.models.config import RopeScaling


def rope_frequencies(head_dim: int, theta: float, scaling: Optional[RopeScaling] = None,
                     device=None) -> torch.Tensor:
  """Per-pair inverse frequencies [head_dim // 2] in fp32, with optional llama3 band
  scaling (transformers' _compute_llama3_parameters)."""
  exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
  inv_freq = 1.0 / (theta ** exponents)
  if scaling is None or scaling.rope_type != "llama3":
    return inv_freq
  low_freq_wavelen = scaling.original_max_position_embeddings / scaling.low_freq_factor
  high_freq_wavelen = scaling.original_max_position_embeddings / scaling.high_freq_factor
  wavelen = 2 * math.pi / inv_freq
  # Low-frequency bands are divided by `factor`; a smooth ramp interpolates between
  # the two regimes for medium frequencies.
  scaled = inv_freq / scaling.factor
  smooth = (scaling.original_max_position_embeddings / wavelen - scaling.low_freq_factor) / (
    scaling.high_freq_factor - scaling.low_freq_factor
  )
  smoothed = (1 - smooth) * scaled + smooth * inv_freq
  is_low = wavelen > low_freq_wavelen
  is_medium = (~is_low) & (wavelen > high_freq_wavelen)
  out = torch.where(is_low, scaled, inv_freq)
  return torch.where(is_medium, smoothed, out)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
  """Rotate q or k. x: [B, T, H, D]; positions: [B, T] int; inv_freq [D // 2].
  The head dim splits into two halves (not interleaved pairs)."""
  angles = positions[..., None].to(torch.float32) * inv_freq  # [B, T, D//2]
  cos = torch.cos(angles)[:, :, None, :]
  sin = torch.sin(angles)[:, :, None, :]
  x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
  rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
  return rotated.to(x.dtype)
