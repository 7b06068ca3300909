"""Token sampling on the device: greedy, per-row temperature, top-k / top-p / min-p,
logit bias and presence/frequency penalties, Gumbel-max.

The port of xotorch_tpu/ops/sampling.py (`sample_logits`, `sample_logits_logprobs`).
Noise comes from an explicit `torch.Generator`, or from a `gumbel` tensor the caller
passes (the tests inject JAX's noise this way, since the two frameworks' generators
give different numbers from one seed).

Nothing here copies a host value to the device: a temperature, penalty or min-p floor
is either a Python float, used as a kernel's scalar argument, or a device tensor ([B] or
[B, 1] per row), so a decode step can be captured as a CUDA graph (models/graphs.py),
where a host-to-device copy is refused. The captured decode steps pass temperatures,
penalties and min-p as device tensors read from static buffers: a Python number would
be baked into the graph.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_TEMP = 0.6
DEFAULT_TOP_K = 35

Scalar = Union[float, torch.Tensor]


def _per_row(x: Scalar, rows: int, device) -> torch.Tensor:
  """A [rows, 1] fp32 column: a per-row [B] tensor reshaped, or a Python number filled
  in on the device (a fill, not a host-to-device copy)."""
  if torch.is_tensor(x):
    return x.to(device=device, dtype=torch.float32).reshape(-1, 1).expand(rows, 1)
  return torch.full((rows, 1), float(x), dtype=torch.float32, device=device)


def _penalized(logits, bias, counts, presence, frequency):
  """OpenAI logit adjustments (additive bias, presence/frequency penalties): the
  distribution both sampling and logprob reporting see."""
  if bias is not None:
    logits = logits.to(torch.float32) + bias.to(torch.float32)
  if counts is not None:
    c = counts.to(torch.float32)
    pres = _per_row(presence, logits.shape[0], logits.device)
    freq = _per_row(frequency, logits.shape[0], logits.device)
    logits = logits.to(torch.float32) - pres * (c > 0) - freq * c
  return logits


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
  """Standard Gumbel noise -log(-log(U)), U uniform in (tiny, 1)."""
  u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
  u = u.clamp_min(torch.finfo(torch.float32).tiny)
  return -torch.log(-torch.log(u))


def sample_logits(
  logits: torch.Tensor,  # [B, V]
  temp: Scalar = DEFAULT_TEMP,  # python float or per-row [B]
  top_k: int = DEFAULT_TOP_K,
  top_p: float = 0.0,
  bias: Optional[torch.Tensor] = None,  # [B, V] additive logit bias
  counts: Optional[torch.Tensor] = None,  # [B, V] token counts of the text so far
  presence: Scalar = 0.0,
  frequency: Scalar = 0.0,
  min_p: Optional[Scalar] = None,  # None = off; a float, or per-row [B]
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [B, V] noise to use instead of drawing it
) -> torch.Tensor:
  """Returns [B] int64 token ids. Rows with temp == 0 take the greedy pick."""
  logits = _penalized(logits, bias, counts, presence, frequency)
  greedy = torch.argmax(logits, dim=-1)
  if not torch.is_tensor(temp) and temp <= 0.0:
    return greedy
  B, V = logits.shape
  temp_b = _per_row(temp, B, logits.device)
  logits = logits.to(torch.float32) / torch.clamp(temp_b, min=1e-6)
  neg_inf = float("-inf")
  if top_k and 0 < top_k < V:
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    logits = logits.masked_fill(logits < kth, neg_inf)
  if top_p and 0.0 < top_p < 1.0:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cumulative = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # Keep the smallest prefix with cumulative mass >= top_p (always >= 1 token).
    cutoff_idx = torch.sum(cumulative < top_p, dim=-1, keepdim=True).clamp_max(V - 1)
    cutoff_logit = torch.gather(sorted_logits, -1, cutoff_idx)
    logits = logits.masked_fill(logits < cutoff_logit, neg_inf)
  if min_p is not None:
    # min-p: keep tokens whose probability is at least min_p times the largest.
    probs = torch.softmax(logits, dim=-1)
    floor = _per_row(min_p, B, logits.device) if torch.is_tensor(min_p) else float(min_p)
    cutoff = floor * probs.max(dim=-1, keepdim=True).values
    logits = logits.masked_fill(probs < cutoff, neg_inf)
  noise = gumbel if gumbel is not None else gumbel_noise(logits.shape, generator, logits.device)
  sampled = torch.argmax(logits + noise.to(logits.device, torch.float32), dim=-1)
  return torch.where(temp_b[:, 0] > 0, sampled, greedy)


def sample_logits_logprobs(
  logits: torch.Tensor,
  temp: Scalar = DEFAULT_TEMP,
  top_k: int = DEFAULT_TOP_K,
  top_p: float = 0.0,
  bias: Optional[torch.Tensor] = None,
  counts: Optional[torch.Tensor] = None,
  presence: Scalar = 0.0,
  frequency: Scalar = 0.0,
  top_lp: int = 0,
  min_p: Optional[Scalar] = None,
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,
):
  """sample_logits plus OpenAI logprob reporting: returns (tok [B], lp [B],
  top_ids [B, top_lp], top_lps [B, top_lp]). Logprobs are the log-softmax of the
  penalised logits before temperature."""
  adj = _penalized(logits, bias, counts, presence, frequency)
  tok = sample_logits(adj, temp=temp, top_k=top_k, top_p=top_p, min_p=min_p,
                      generator=generator, gumbel=gumbel)
  logp = torch.log_softmax(adj.to(torch.float32), dim=-1)
  lp = torch.gather(logp, -1, tok[:, None])[:, 0]
  if top_lp > 0:
    top_lps, top_ids = torch.topk(logp, top_lp, dim=-1)
  else:
    B = logits.shape[0]
    top_ids = torch.zeros((B, 0), dtype=torch.int64, device=logits.device)
    top_lps = torch.zeros((B, 0), dtype=torch.float32, device=logits.device)
  return tok, lp, top_ids, top_lps
