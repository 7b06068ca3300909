"""Plain masked grouped-query attention: the reference every attention kernel of the
port is held against.

The port of xotorch_tpu/ops/attention.py::gqa_attention. Scores and the softmax are
fp32; probabilities are cast to v's dtype for the second product, as the JAX version
does. `gqa_attention_lse` is each query row's log-sum-exp of the same scores: the plain
version of what K1 writes for its gradient kernel K1b.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _scores(q, k, q_positions, kv_valid_len, scale, softcap, window):
  """gqa_attention's fp32 scores [B, Hkv, groups, T, S] (scaled, soft-capped) and the
  visibility [B, T, S] of each key to each query."""
  B, T, Hq, D = q.shape
  S, Hkv = k.shape[1], k.shape[2]
  q_ = q.reshape(B, T, Hkv, Hq // Hkv, D).to(torch.float32)
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
  return scores, visible


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
  scores, visible = _scores(q, k, q_positions, kv_valid_len, scale, softcap, window)
  scores = torch.where(visible[:, None, None, :, :], scores, torch.tensor(NEG_INF, device=q.device))

  probs = torch.softmax(scores, dim=-1)
  out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
  return out.reshape(B, T, Hq, D).to(q.dtype)


def gqa_attention_lse(
  q: torch.Tensor,  # [B, T, Hq, D]
  k: torch.Tensor,  # [B, S, Hkv, D]
  q_positions: torch.Tensor,  # [B, T]
  kv_valid_len: Optional[torch.Tensor] = None,  # [B]
  scale: Optional[float] = None,
  softcap: float = 0.0,
  window: Optional[int] = None,
) -> torch.Tensor:
  """Each query row's log-sum-exp of `gqa_attention`'s scores over the keys it sees, in
  base 2 (log2 of the sum of exp2(score x log2(e)), the units K1 writes): [B, T, Hq]
  fp32; +inf for a row that sees no key, so that every probability rebuilt from it is 0."""
  B, T, Hq, _ = q.shape
  scores, visible = _scores(q, k, q_positions, kv_valid_len, scale, softcap, window)
  scores = scores.masked_fill(~visible[:, None, None, :, :], float("-inf"))
  lse = torch.logsumexp(scores, dim=-1) * (1.0 / math.log(2.0))  # [B, Hkv, groups, T]
  lse = lse.masked_fill(~visible.any(-1)[:, None, None, :], float("inf"))
  return lse.permute(0, 3, 1, 2).reshape(B, T, Hq).contiguous()
