"""Forward + on-device sampling, multi-token decode alone or batched, the
segment-scan prefill, draft verification's forward + argmax, and the fused ring of
co-located partitions.

The port of xotorch_tpu/models/generate.py (`forward_sample`, `decode_chunk`,
`decode_chunk_batched`, `decode_chunk_paged`, `scan_groups`, `prefill_scan`,
`forward_argmax_paged`, `decode_chunk_ring`, `forward_argmax_ring`,
`decode_chunk_ring_batched`). Where JAX
runs a decode chunk as ONE XLA program (`lax.scan` over K steps under `jax.jit`), the
port splits out the step: `decode_step` is one forward + sampling over buffers it
updates in place (token in and out, positions, the cache or the page arena), with no
host read and no host-to-device copy. The CPU runs it K times eagerly (`decode_chunk`);
on the card models/graphs.py captures it once as a CUDA graph and replays it K times,
the counterpart of the jitted scan. `prefill_scan` runs a long prompt's equal
segments, each through the cached-attention kernels (K2, or K4 on the page arena),
and returns every position's last-layer hidden state; on the card a power-of-two
group of segments is one captured graph. The cache, or the page arena, is updated in
place where JAX donated it. A ring of partitions that share one process decodes the
same way: `decode_step_ring` chains every partition's layer stack (each over its own
params and cache) and samples, one step of the composite program JAX scans.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from xotorch_tpu_torch.models.config import ModelConfig
from xotorch_tpu_torch.models.transformer import QuantRoute, forward_shard, unembed
from xotorch_tpu_torch.ops.sampling import Scalar, sample_logits, sample_logits_logprobs


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
  presence: Scalar = 0.0,  # a float, or per-row [B]
  frequency: Scalar = 0.0,
  top_lp: int = -1,  # -1 = no logprob reporting; >= 0 = report
  min_p: Optional[Scalar] = None,  # None = off; a float, or per-row [B]
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [B, V] noise for the sample
  page_table: Optional[torch.Tensor] = None,  # [B, max_pages]: `cache` is the page arena
  route: Optional[QuantRoute] = None,  # quantized decode projections (transformer.quant_route)
):
  """Last-shard forward + sampling: returns ([B] sampled token on the device, the
  cache), or ((tok, lp, top_ids, top_lps), cache) with `top_lp >= 0`. The
  unembedding runs on the one position `last_index`, not the segment. With
  `page_table` the segment's K/V go straight into the request's pool pages."""
  h, cache = forward_shard(params, x, cache, start_pos, cfg=cfg, is_first=is_first,
                           is_last=False, use_flash=use_flash,
                           use_flash_decode=use_flash_decode, start_layer=start_layer,
                           page_table=page_table, route=route)
  logits = unembed(params, h[:, last_index:last_index + 1], cfg)[:, -1, :]
  kw = dict(temp=temp, top_k=top_k, top_p=top_p, bias=bias, counts=counts, presence=presence,
            frequency=frequency, min_p=min_p, generator=generator, gumbel=gumbel)
  if top_lp >= 0:
    return sample_logits_logprobs(logits, top_lp=top_lp, **kw), cache
  return sample_logits(logits, **kw), cache


def forward_argmax(
  params,
  x: torch.Tensor,  # [1, T_pad] tokens: [prev_token] + draft, zero-padded to a bucket
  cache: Dict[str, torch.Tensor],
  start_pos: Union[int, torch.Tensor],  # the request's committed position: int, or [1]
  cfg: ModelConfig,
  page_table: Optional[torch.Tensor] = None,  # [1, max_pages]: `cache` is the page arena
  start_layer: int = 0,
  route: Optional[QuantRoute] = None,
):
  """Draft verification's forward: x through the whole model at `start_pos` (K2 at
  T > 1 on a contiguous cache, K4 through the page table on the arena) and the greedy
  argmax of every position. Returns ([1, T_pad] int64 argmax, the cache, updated in
  place). Positions past the true draft are padding: their K/V land past the position
  the caller rolls back to, where no query reads them and the next write overwrites
  them."""
  logits, cache = forward_shard(params, x, cache, start_pos, cfg=cfg, is_first=True, is_last=True,
                                use_flash_decode=True, start_layer=start_layer,
                                page_table=page_table, route=route)
  return torch.argmax(logits, dim=-1), cache


def forward_argmax_paged(params, x: torch.Tensor, arena: Dict[str, torch.Tensor],
                         page_table: torch.Tensor, start_pos: Union[int, torch.Tensor],
                         cfg: ModelConfig, start_layer: int = 0,
                         route: Optional[QuantRoute] = None):
  """JAX's `forward_argmax_paged`: `forward_argmax` over the page arena, [prev_token] +
  draft as a T > 1 ragged query through the request's page table (K4, K4q on an int8
  arena), which the caller has already extended over the padded bucket. Returns
  ([1, T_pad] argmax, the arena)."""
  return forward_argmax(params, x, arena, start_pos, cfg, page_table=page_table,
                        start_layer=start_layer, route=route)


def decode_step(
  params,
  tok: torch.Tensor,  # [B, 1] int64: the token to forward; the sampled one on return
  cache: Dict[str, torch.Tensor],
  pos: torch.Tensor,  # [B] int32: each row's position of `tok`; advanced by one
  cfg: ModelConfig,
  temp: Union[float, torch.Tensor],  # one temperature, or [B] per row
  top_k: int,
  top_p: float = 0.0,
  use_flash_decode: bool = False,
  bias: Optional[torch.Tensor] = None,
  counts: Optional[torch.Tensor] = None,  # [B, V]; bumped by the sampled token
  presence: Scalar = 0.0,  # a float, or per-row [B]
  frequency: Scalar = 0.0,
  top_lp: int = -1,
  min_p: Optional[Scalar] = None,  # None = off; a float, or per-row [B]
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [R, B, V] noise; row `step[0]` is this step's
  page_table: Optional[torch.Tensor] = None,  # [B, max_pages]: `cache` is the page arena
  route: Optional[QuantRoute] = None,
  out: Optional[torch.Tensor] = None,  # [R, B] int64: row `step[0]` gets the sampled token
  step: Optional[torch.Tensor] = None,  # [1] int64: the row of `out` and `gumbel`; advanced
  lp_out: Optional[Sequence[torch.Tensor]] = None,  # ([R, B], [R, B, K], [R, B, K]) report rows
):
  """One decode step over buffers updated in place, the body of JAX's decode scan:
  forward `tok` at `pos` (a per-row device tensor, so the step reads no host value),
  sample, write the sampled token into `tok`, `out[step]` and `counts` (and with
  `lp_out` the logprob report into its row `step`), advance `pos` and `step` by one.
  Returns (the sampled [B] token, the logprob report or None). Every input that
  changes from step to step lives in a tensor, so the same call serves K eager steps
  (decode_chunk) and a captured CUDA graph replayed K times (models/graphs.py); the
  Python values (top_k, top_p, top_lp, and which optional inputs are given) are the
  graph's statics, as they are jit statics in JAX. Penalties and min-p are read from
  per-row tensors there, as JAX traces them."""
  logits, _ = forward_shard(params, tok, cache, pos, cfg=cfg, is_first=True, is_last=True,
                            use_flash_decode=use_flash_decode, page_table=page_table, route=route)
  noise = None if gumbel is None else gumbel.index_select(0, step)[0]
  kw = dict(temp=temp, top_k=top_k, top_p=top_p, bias=bias, counts=counts, presence=presence,
            frequency=frequency, min_p=min_p, generator=generator, gumbel=noise)
  report = None
  if top_lp >= 0:
    nxt, *report = sample_logits_logprobs(logits[:, -1, :], top_lp=top_lp, **kw)
  else:
    nxt = sample_logits(logits[:, -1, :], **kw)
  if counts is not None:
    counts[torch.arange(nxt.shape[0], device=nxt.device), nxt] += 1
  tok.copy_(nxt[:, None])
  pos.add_(1)
  if out is not None:
    out.index_copy_(0, step, nxt[None])
  if lp_out is not None and report is not None:
    for buf, r in zip(lp_out, report):
      buf.index_copy_(0, step, r[None])
  if step is not None:
    step.add_(1)
  return nxt, report


def decode_chunk(
  params,
  tok: torch.Tensor,  # [B, 1] last sampled token, on the device
  cache: Dict[str, torch.Tensor],
  start_pos: Union[int, torch.Tensor],  # absolute position of `tok`: int, or [B] per row
  cfg: ModelConfig,
  num_tokens: int,
  temp: Union[float, torch.Tensor],  # one temperature, or [B] per row
  top_k: int,
  top_p: float = 0.0,
  use_flash_decode: bool = False,
  bias: Optional[torch.Tensor] = None,  # [B, V] OpenAI logit_bias
  counts: Optional[torch.Tensor] = None,  # [B, V] token counts; updated step by step
  presence: Scalar = 0.0,  # a float, or per-row [B]
  frequency: Scalar = 0.0,
  top_lp: int = -1,  # -1 = no logprob reporting; >= 0 = report
  min_p: Optional[Scalar] = None,
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [num_tokens, B, V] noise, one slice per step
  page_table: Optional[torch.Tensor] = None,  # [B, max_pages]: `cache` is the page arena
  route: Optional[QuantRoute] = None,
):
  """Generate `num_tokens` tokens: `decode_step` run eagerly that many times. The
  shard must span the whole model. Returns ([B, num_tokens] tokens on the device, the
  cache), plus the updated counts when `counts` is passed, plus (lp [B, K], top_ids
  [B, K, top_lp], top_lps [B, K, top_lp]) last when `top_lp >= 0` — the same tuple as
  the JAX function. The incoming `tok` is consumed (its forward is the first step);
  the returned tokens start at start_pos + 1. Token i + 1 sees token i's penalty."""
  B, device = tok.shape[0], tok.device
  if counts is not None:
    counts = counts.clone()
  tok = tok.to(torch.int64).clone()
  if torch.is_tensor(start_pos):
    pos = start_pos.to(device=device, dtype=torch.int32).clone()
  else:
    S = page_table.shape[1] * cache["k"].shape[2] if page_table is not None else cache["k"].shape[2]
    if start_pos < 0 or start_pos + num_tokens > S:
      raise ValueError(f"decode [{start_pos}, {start_pos + num_tokens}) outside the {S}-slot cache")
    pos = torch.full((B,), start_pos, dtype=torch.int32, device=device)
  out = torch.empty((num_tokens, B), dtype=torch.int64, device=device)
  step = torch.zeros((1,), dtype=torch.int64, device=device)
  reports = []
  for _ in range(num_tokens):
    _, report = decode_step(params, tok, cache, pos, cfg, temp, top_k, top_p,
                            use_flash_decode=use_flash_decode, bias=bias, counts=counts,
                            presence=presence, frequency=frequency, top_lp=top_lp, min_p=min_p,
                            generator=generator, gumbel=gumbel, page_table=page_table,
                            route=route, out=out, step=step)
    reports.append(report)
  result = [out.t().contiguous(), cache]
  if counts is not None:
    result.append(counts)
  if top_lp >= 0:
    lp, top_ids, top_lps = (torch.stack(r, dim=1) for r in zip(*reports))
    result.append((lp, top_ids, top_lps))
  return tuple(result)


def scan_groups(n_segs: int):
  """Power-of-two decomposition of a segment count: yields (offset, size) groups,
  largest first (7 -> (0, 4), (4, 2), (6, 1)), as JAX's. The engine's scan prefill
  runs one program for each group, so the programs (captured graphs on the card) stay
  logarithmic in the longest prompt's segment count."""
  off = 0
  while n_segs > 0:
    g = 1 << (n_segs.bit_length() - 1)
    yield off, g
    off += g
    n_segs -= g


def prefill_scan(
  params,
  x: torch.Tensor,  # [B, T] tokens (is_first) or [B, T, H] hidden; T = n_segs * seg
  cache: Dict[str, torch.Tensor],
  start_pos: Union[int, torch.Tensor],  # absolute position of x[:, 0]: int, or [B]
  cfg: ModelConfig,
  n_segs: int,
  is_first: bool = True,
  start_layer: int = 0,
  page_table: Optional[torch.Tensor] = None,  # [1, max_pages]: `cache` is the page arena
  route: Optional[QuantRoute] = None,
):
  """A long prompt's `n_segs` equal segments in order, each a forward_shard through
  the cached-attention kernel (`use_flash_decode`: K2, K2q over an int8 cache; K4/K4q
  on the page arena): in-segment causality goes by absolute position, so the same
  kernel serves the from-zero segment and every later one, as in JAX's scan. No
  unembedding runs. Returns ([B, T, H] last-layer hidden states of every position,
  the cache, updated in place). With `page_table` the segments' K/V go straight into
  the pool pages (the table must already cover start_pos + T). On the card a call is
  one captured graph (models/graphs.py), so `start_pos` is then a [B] device tensor."""
  B, T = x.shape[0], x.shape[1]
  seg = T // n_segs
  hs = []
  for i in range(n_segs):
    h, cache = forward_shard(params, x[:, i * seg:(i + 1) * seg], cache, start_pos + i * seg,
                             cfg=cfg, is_first=is_first, is_last=False, use_flash_decode=True,
                             start_layer=start_layer, page_table=page_table, route=route)
    hs.append(h)
  return (hs[0] if n_segs == 1 else torch.cat(hs, dim=1)), cache


def _pad_rows(x: torch.Tensor, n: int, fill: Optional[torch.Tensor] = None) -> torch.Tensor:
  """x with n more rows along dim 0: copies of `fill` (a one-row tensor), or zeros."""
  if n == 0:
    return x
  pad = (fill.expand(n, *x.shape[1:]) if fill is not None
         else torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device))
  return torch.cat([x, pad], dim=0)


def _padded_extras(pad_rows: int, bias, counts, presence, frequency, min_p) -> dict:
  """The sampling extras with pad rows of zeros (bias, counts and per-row penalties and
  min-p; a Python number needs none), as decode_chunk takes them."""
  pad = lambda x: _pad_rows(x, pad_rows) if torch.is_tensor(x) else x
  return dict(bias=pad(bias), counts=pad(counts), presence=pad(presence),
              frequency=pad(frequency), min_p=pad(min_p))


def _real_rows(extra: Sequence, B: int) -> list:
  """decode_chunk's counts and logprob triple (its results past the tokens and the
  cache) cut to the B real rows."""
  return [tuple(t[:B] for t in r) if isinstance(r, tuple) else r[:B] for r in extra]


def decode_chunk_batched(
  params,
  caches: Sequence[Dict[str, torch.Tensor]],  # B per-request caches, UNIFORM shapes
  toks: torch.Tensor,  # [B, 1] each request's last sampled token
  pos_vec: torch.Tensor,  # [B] per-request positions
  cfg: ModelConfig,
  num_tokens: int,
  temps: torch.Tensor,  # [B] per-request temperatures
  top_k: int,
  top_p: float = 0.0,
  use_flash_decode: bool = False,
  pad_rows: int = 0,  # dummy rows padding B to a power of two
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [num_tokens, B + pad_rows, V]
  route: Optional[QuantRoute] = None,
  bias: Optional[torch.Tensor] = None,  # [B, V] OpenAI logit_bias
  counts: Optional[torch.Tensor] = None,  # [B, V] token counts; updated step by step
  presence: Scalar = 0.0,  # a float, or per-row [B]
  frequency: Scalar = 0.0,
  top_lp: int = -1,  # -1 = no logprob reporting; >= 0 = report
  min_p: Optional[Scalar] = None,  # None = off; a float, or per-row [B]
):
  """Batched decode for continuous batching: stack the requests' contiguous caches
  (every leaf: an int8 cache's codes and scales alike) along the batch axis, decode with per-row positions and temperatures, split the
  updated caches back per request. Pad rows are zero caches replicating row 0's
  token, position and temperature (zero bias, counts and penalties); their outputs
  are dropped. The stack and the split each copy every member's cache (the JAX
  design, where one compiled program fused them). Returns ([B, num_tokens] tokens,
  list of B updated caches), plus the updated counts when `counts` is passed, plus
  the logprob triple when `top_lp >= 0` (decode_chunk's order)."""
  B = len(caches)
  stacked = {name: torch.cat([c[name] for c in caches]
                             + [torch.zeros_like(caches[0][name])] * pad_rows, dim=1)
             for name in caches[0]}
  res = decode_chunk(
    params, _pad_rows(toks, pad_rows, toks[:1]), stacked,
    _pad_rows(pos_vec, pad_rows, pos_vec[:1]), cfg, num_tokens,
    _pad_rows(temps, pad_rows, temps[:1]), top_k, top_p, use_flash_decode=use_flash_decode,
    generator=generator, gumbel=gumbel, route=route, top_lp=top_lp,
    **_padded_extras(pad_rows, bias, counts, presence, frequency, min_p))
  out, stacked = res[0], res[1]
  split: List[Dict[str, torch.Tensor]] = [
    {name: stacked[name][:, i:i + 1].clone() for name in stacked} for i in range(B)]
  return tuple([out[:B], split] + _real_rows(res[2:], B))


def decode_chunk_paged(
  params,
  arena: Dict[str, torch.Tensor],  # shared page arena: [L, P, page, Hkv, D] leaves
  page_table: torch.Tensor,  # [B, max_pages] int32 physical page ids (0-padded)
  toks: torch.Tensor,  # [B, 1] each request's last sampled token
  pos_vec: torch.Tensor,  # [B] per-request positions
  cfg: ModelConfig,
  num_tokens: int,
  temps: torch.Tensor,  # [B] per-request temperatures
  top_k: int,
  top_p: float = 0.0,
  pad_rows: int = 0,  # dummy rows padding B to a power of two
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [num_tokens, B + pad_rows, V]
  route: Optional[QuantRoute] = None,
  bias: Optional[torch.Tensor] = None,  # [B, V] OpenAI logit_bias
  counts: Optional[torch.Tensor] = None,  # [B, V] token counts; updated step by step
  presence: Scalar = 0.0,  # a float, or per-row [B]
  frequency: Scalar = 0.0,
  top_lp: int = -1,  # -1 = no logprob reporting; >= 0 = report
  min_p: Optional[Scalar] = None,  # None = off; a float, or per-row [B]
):
  """Batched decode over the PAGED KV pool: rows index the one shared arena through
  their page tables, writes land in each row's current page, and reads stop at each
  row's own occupied pages (K3). Batch membership is metadata: no stack, no split,
  no common-length growth. Pad rows carry an all-zero table and position 0: their
  writes land in the pool's scratch page 0 and their outputs are dropped. The sampling
  extras (bias, penalties with the counts updated inside the chunk, min-p, logprob
  reporting) follow decode_chunk's contract, as in JAX's decode_chunk_paged. Returns
  ([B, num_tokens] tokens, the arena, updated in place), plus the updated counts when
  `counts` is passed, plus the logprob triple when `top_lp >= 0`."""
  B = toks.shape[0]
  table = _pad_rows(page_table, pad_rows)
  res = decode_chunk(
    params, _pad_rows(toks, pad_rows, toks[:1]), arena, _pad_rows(pos_vec, pad_rows), cfg,
    num_tokens, _pad_rows(temps, pad_rows, temps[:1]), top_k, top_p, generator=generator,
    gumbel=gumbel, page_table=table.contiguous(), route=route, top_lp=top_lp,
    **_padded_extras(pad_rows, bias, counts, presence, frequency, min_p))
  return tuple([res[0][:B], res[1]] + _real_rows(res[2:], B))


# ------------------------------------------------------------------ the fused ring

def _ring_forward(params_segs: Sequence, x: torch.Tensor, caches: Sequence[Dict[str, torch.Tensor]],
                  pos: Union[int, torch.Tensor], cfg: ModelConfig, start_layers: Sequence[int],
                  route: Optional[QuantRoute]) -> torch.Tensor:
  """x through every partition in ring order, each over its own params and cache (K2 at
  every segment's attention), then the last partition's unembedding: fp32 logits."""
  h = x
  for i, (params, cache) in enumerate(zip(params_segs, caches)):
    h, _ = forward_shard(params, h, cache, pos, cfg=cfg, is_first=i == 0, is_last=False,
                         use_flash_decode=True, start_layer=start_layers[i], route=route)
  return unembed(params_segs[-1], h, cfg)


def decode_step_ring(
  params_segs: Sequence,  # each partition's params, ring order (first .. last)
  tok: torch.Tensor,  # [B, 1] int64: the token to forward; the sampled one on return
  caches: Sequence[Dict[str, torch.Tensor]],  # each partition's [L_i, B, S, ...] cache
  pos: torch.Tensor,  # [B] int32: each row's position of `tok`; advanced by one
  cfg: ModelConfig,
  temp: Union[float, torch.Tensor],
  top_k: int,
  top_p: float = 0.0,
  start_layers: Sequence[int] = (0,),  # each partition's absolute first layer
  route: Optional[QuantRoute] = None,
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [R, B, V] noise; row `step[0]` is this step's
  out: Optional[torch.Tensor] = None,  # [R, B] int64: row `step[0]` gets the sampled token
  step: Optional[torch.Tensor] = None,  # [1] int64; advanced
) -> torch.Tensor:
  """One step of the composite ring program, over buffers updated in place: `tok`
  through every partition's layer stack (segment 0 embeds, the last unembeds), sampled
  on the device, the sampled token written into `tok` and `out[step]`, `pos` and `step`
  advanced. The body JAX scans in `decode_chunk_ring`; models/graphs.py captures it
  once and replays it a token. The ring carries no sampling extras (a request with
  extras takes the per-token ring). Returns the sampled [B] token."""
  logits = _ring_forward(params_segs, tok, caches, pos, cfg, start_layers, route)
  noise = None if gumbel is None else gumbel.index_select(0, step)[0]
  nxt = sample_logits(logits[:, -1, :], temp=temp, top_k=top_k, top_p=top_p,
                      generator=generator, gumbel=noise)
  tok.copy_(nxt[:, None])
  pos.add_(1)
  if out is not None:
    out.index_copy_(0, step, nxt[None])
  if step is not None:
    step.add_(1)
  return nxt


def decode_chunk_ring(
  params_segs: Sequence,
  tok: torch.Tensor,  # [B, 1] last sampled token
  caches: Sequence[Dict[str, torch.Tensor]],  # each partition's cache, ring order
  start_pos: Union[int, torch.Tensor],  # absolute position of `tok`: int, or [B] per row
  cfg: ModelConfig,
  num_tokens: int,
  temp: Union[float, torch.Tensor],
  top_k: int,
  top_p: float = 0.0,
  start_layers: Sequence[int] = (0,),
  route: Optional[QuantRoute] = None,
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [num_tokens, B, V] noise, one slice a step
):
  """JAX's `decode_chunk_ring`: a co-located ring's whole chain decoded `num_tokens`
  steps, every partition keeping its own params and cache (the per-token ring's layout,
  so entering or leaving the fused path moves nothing), positions in lockstep.
  `decode_step_ring` run eagerly that many times. Returns ([B, num_tokens] tokens, the
  caches, updated in place)."""
  B, device = tok.shape[0], tok.device
  tok = tok.to(torch.int64).clone()
  if torch.is_tensor(start_pos):
    pos = start_pos.to(device=device, dtype=torch.int32).clone()
  else:
    pos = torch.full((B,), start_pos, dtype=torch.int32, device=device)
  out = torch.empty((num_tokens, B), dtype=torch.int64, device=device)
  step = torch.zeros((1,), dtype=torch.int64, device=device)
  for _ in range(num_tokens):
    decode_step_ring(params_segs, tok, caches, pos, cfg, temp, top_k, top_p, start_layers, route,
                     generator, gumbel, out, step)
  return out.t().contiguous(), list(caches)


def forward_argmax_ring(
  params_segs: Sequence,
  x: torch.Tensor,  # [1, T_pad] tokens: [prev_token] + draft, zero-padded
  caches: Sequence[Dict[str, torch.Tensor]],
  start_pos: Union[int, torch.Tensor],
  cfg: ModelConfig,
  start_layers: Sequence[int] = (0,),
  route: Optional[QuantRoute] = None,
):
  """JAX's `forward_argmax_ring`: draft verification through every co-located
  partition in one forward (K2 at T > 1 in each), and every position's greedy argmax.
  Returns ([1, T_pad] argmax, the caches, updated in place); positions past the true
  draft are padding, past the position the caller rolls back to."""
  logits = _ring_forward(params_segs, x, caches, start_pos, cfg, start_layers, route)
  return torch.argmax(logits, dim=-1), list(caches)


def decode_chunk_ring_batched(
  params_segs: Sequence,
  seg_caches: Sequence[Sequence[Dict[str, torch.Tensor]]],  # over segments, over B requests
  toks: torch.Tensor,  # [B, 1] each request's last sampled token
  pos_vec: torch.Tensor,  # [B] per-request positions
  cfg: ModelConfig,
  num_tokens: int,
  temps: torch.Tensor,  # [B] per-request temperatures
  top_k: int,
  top_p: float = 0.0,
  start_layers: Sequence[int] = (0,),
  pad_rows: int = 0,  # dummy rows padding B to a power of two
  route: Optional[QuantRoute] = None,
  generator: Optional[torch.Generator] = None,
  gumbel: Optional[torch.Tensor] = None,  # [num_tokens, B + pad_rows, V]
):
  """JAX's `decode_chunk_ring_batched`: B requests on one co-located chain in one
  chunk. Each segment's member caches stacked along the batch axis (pad rows: zero
  caches with row 0's token, position and temperature), the composite step with per-row
  positions, every segment's caches split back. Returns ([B, num_tokens] tokens, over
  segments the B updated caches)."""
  B = len(seg_caches[0])
  stacked = [{name: torch.cat([c[name] for c in caches]
                              + [torch.zeros_like(caches[0][name])] * pad_rows, dim=1)
              for name in caches[0]} for caches in seg_caches]
  out, stacked = decode_chunk_ring(
    params_segs, _pad_rows(toks, pad_rows, toks[:1]), stacked,
    _pad_rows(pos_vec, pad_rows, pos_vec[:1]), cfg, num_tokens,
    _pad_rows(temps, pad_rows, temps[:1]), top_k, top_p, start_layers, route, generator, gumbel)
  split = [[{name: seg[name][:, i:i + 1].clone() for name in seg} for i in range(B)]
           for seg in stacked]
  return out[:B], split
