"""Plain masked grouped-query attention: the reference every attention kernel of the
port is held against.

The port of xotorch_tpu/ops/attention.py::gqa_attention. Scores and the softmax are
fp32; probabilities are cast to v's dtype for the second product, as the JAX version
does.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def gqa_attention(
  q: torch.Tensor,  # [B, T, Hq, D]
  k: torch.Tensor,  # [B, S, Hkv, D]  (full cache buffer)
  v: torch.Tensor,  # [B, S, Hkv, D]
  q_positions: torch.Tensor,  # [B, T] absolute positions of the queries
  kv_valid_len: Optional[torch.Tensor] = None,  # [B]: entries >= this are invalid
  scale: Optional[float] = None,  # score scale; None -> D**-0.5
  softcap: float = 0.0,  # tanh soft-cap on scores (0 = off)
  window: Optional[int] = None,  # sliding window (0 or None = global)
) -> torch.Tensor:
  """Grouped-query causal attention. Returns [B, T, Hq, D] in q's dtype.

  Key position s is visible to query position p iff s <= p, s < kv_valid_len (when
  given) and, with a window w > 0, s > p - w."""
  B, T, Hq, D = q.shape
  S, Hkv = k.shape[1], k.shape[2]
  groups = Hq // Hkv

  q_ = q.reshape(B, T, Hkv, groups, D).to(torch.float32)
  scores = torch.einsum("btkgd,bskd->bkgts", q_, k.to(torch.float32))
  scores = scores * (scale if scale is not None else D ** -0.5)
  if softcap:
    scores = torch.tanh(scores / softcap) * softcap

  kv_pos = torch.arange(S, device=q.device)
  visible = kv_pos[None, None, :] <= q_positions[:, :, None]  # [B, T, S]
  if kv_valid_len is not None:
    visible = visible & (kv_pos[None, None, :] < kv_valid_len[:, None, None])
  if window:
    visible = visible & (kv_pos[None, None, :] > q_positions[:, :, None] - int(window))
  scores = torch.where(visible[:, None, None, :, :], scores, torch.tensor(NEG_INF, device=q.device))

  probs = torch.softmax(scores, dim=-1)
  out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
  return out.reshape(B, T, Hq, D).to(q.dtype)
