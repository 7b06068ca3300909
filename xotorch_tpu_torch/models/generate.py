"""Forward + on-device sampling, and multi-token decode.

The port of xotorch_tpu/models/generate.py (`forward_sample`, `decode_chunk`).
Where JAX ran the K decode steps under one `lax.scan`, the port runs a Python loop of
K steps; sampled tokens stay on the device and feed the next step, so the host sees
the chunk's tokens once, at its end. (Capturing the loop as a CUDA graph is later
work.) The cache is updated in place where JAX donated it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from xotorch_tpu_torch.models.config import ModelConfig
from xotorch_tpu_torch.models.transformer import forward_shard, unembed
from xotorch_tpu_torch.ops.sampling import sample_logits, sample_logits_logprobs


def forward_sample(
  params,
  x: torch.Tensor,  # [B, T] tokens (is_first) or [B, T, H] hidden
  cache: Dict[str, torch.Tensor],
  start_pos: int,
  last_index: int,  # index of the last REAL position in x (before bucket padding)
  cfg: ModelConfig,
  is_first: bool,
  temp: float,
  top_k: int,
  top_p: float = 0.0,
  use_flash: bool = False,
  use_flash_decode: bool = False,
  start_layer: int = 0,
  bias: Optional[torch.Tensor] = None,  # [B, V] OpenAI logit_bias
  counts: Optional[torch.Tensor] = None,  # [B, V] token counts for penalties
  presence: float = 0.0,
  frequency: float = 0.0,
  top_lp: int = -1,  # -1 = no logprob reporting; >= 0 = report
  min_p: Optional[float] = None,
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [B, V] noise for the sample
):
  """Last-shard forward + sampling: returns ([B] sampled token on the device, the
  cache), or ((tok, lp, top_ids, top_lps), cache) with `top_lp >= 0`. The
  unembedding runs on the one position `last_index`, not the segment."""
  h, cache = forward_shard(params, x, cache, start_pos, cfg=cfg, is_first=is_first,
                           is_last=False, use_flash=use_flash,
                           use_flash_decode=use_flash_decode, start_layer=start_layer)
  logits = unembed(params, h[:, last_index:last_index + 1], cfg)[:, -1, :]
  kw = dict(temp=temp, top_k=top_k, top_p=top_p, bias=bias, counts=counts, presence=presence,
            frequency=frequency, min_p=min_p, generator=generator, gumbel=gumbel)
  if top_lp >= 0:
    return sample_logits_logprobs(logits, top_lp=top_lp, **kw), cache
  return sample_logits(logits, **kw), cache


def decode_chunk(
  params,
  tok: torch.Tensor,  # [B, 1] last sampled token, on the device
  cache: Dict[str, torch.Tensor],
  start_pos: int,  # absolute position of `tok`
  cfg: ModelConfig,
  num_tokens: int,
  temp: float,
  top_k: int,
  top_p: float = 0.0,
  use_flash_decode: bool = False,
  bias: Optional[torch.Tensor] = None,  # [B, V] OpenAI logit_bias
  counts: Optional[torch.Tensor] = None,  # [B, V] token counts; updated step by step
  presence: float = 0.0,
  frequency: float = 0.0,
  top_lp: int = -1,  # -1 = no logprob reporting; >= 0 = report
  min_p: Optional[float] = None,
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [num_tokens, B, V] noise, one slice per step
):
  """Generate `num_tokens` tokens. The shard must span the whole model. Returns
  ([B, num_tokens] tokens on the device, the cache), plus the updated counts when
  `counts` is passed, plus (lp [B, K], top_ids [B, K, top_lp], top_lps [B, K, top_lp])
  last when `top_lp >= 0` — the same tuple as the JAX function. The incoming `tok`
  is consumed (its forward is the first step); the returned tokens start at
  start_pos + 1. Token i + 1 sees token i's penalty."""
  if counts is not None:
    counts = counts.clone()
  toks, reports = [], []
  tok = tok.to(torch.int64)
  rows = torch.arange(tok.shape[0], device=tok.device)
  for i in range(num_tokens):
    logits, cache = forward_shard(params, tok, cache, start_pos + i, cfg=cfg, is_first=True,
                                  is_last=True, use_flash_decode=use_flash_decode)
    kw = dict(temp=temp, top_k=top_k, top_p=top_p, bias=bias, counts=counts, presence=presence,
              frequency=frequency, min_p=min_p, generator=generator,
              gumbel=None if gumbel is None else gumbel[i])
    if top_lp >= 0:
      nxt, *report = sample_logits_logprobs(logits[:, -1, :], top_lp=top_lp, **kw)
      reports.append(report)
    else:
      nxt = sample_logits(logits[:, -1, :], **kw)
    if counts is not None:
      counts[rows, nxt] += 1
    toks.append(nxt)
    tok = nxt[:, None]
  out = [torch.stack(toks, dim=1), cache]
  if counts is not None:
    out.append(counts)
  if top_lp >= 0:
    lp, top_ids, top_lps = (torch.stack(r, dim=1) for r in zip(*reports))
    out.append((lp, top_ids, top_lps))
  return tuple(out)
