"""Ring attention: causal sequence parallelism over a mesh axis.

The port of xotorch_tpu/ops/ring_attention.py (`_fold_chunk`, `ring_attention`,
`ring_attention_sharded`). The sequence is split over the `sp` axis: position i holds
one contiguous Q/K/V chunk, global positions [i*Tl, (i+1)*Tl), and the KV chunks
rotate around the ring (parallel/collectives.send_next, JAX's `ppermute`) while every
position folds each visiting chunk into an online-softmax accumulator in fp32 (the
Liu et al. ring-attention / Milakov-Gimelshein recurrence). Chunks after the query's
own are skipped: no work on the steps the causal mask excludes.

JAX computes it with `jnp.einsum` outside any Pallas kernel, so plain PyTorch products
are the faithful port: the scores and the weighted sum in fp32.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from xotorch_tpu_torch.parallel.collectives import send_next

NEG_INF = -1e30


def _fold_chunk(q, k, v, acc, m, l, q_pos, k_pos, scale):
  """One online-softmax update of (acc, m, l) with a visiting KV chunk.

  q [B, Tq, Hkv, g, D]; k, v [B, Tk, Hkv, D]; q_pos [Tq], k_pos [Tk] absolute;
  acc [B, Tq, Hkv, g, D] fp32; m, l [B, Tq, Hkv, g] fp32.
  """
  s = torch.einsum("btkgd,bskd->btkgs", q.float(), k.float()) * scale
  visible = (k_pos[None, :] <= q_pos[:, None])[None, :, None, None, :]  # [1, Tq, 1, 1, Tk]
  s = torch.where(visible, s, NEG_INF)
  m_cur = s.amax(dim=-1)
  m_new = torch.maximum(m, m_cur)
  # Rows with no visible key yet keep m = NEG_INF: clamp the shift, as JAX does.
  shift = torch.where(m_new == NEG_INF, torch.zeros_like(m_new), m_new)
  p = torch.exp(s - shift[..., None])
  p = torch.where(visible, p, torch.zeros_like(p))
  alpha = torch.where(m == NEG_INF, torch.zeros_like(m), torch.exp(m - shift))
  l_new = alpha * l + p.sum(dim=-1)
  acc_new = acc * alpha[..., None] + torch.einsum("btkgs,bskd->btkgd", p, v.float())
  return acc_new, m_new, l_new


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
  """Causal GQA ring attention over one ring of positions: `qs[i]` [B, Tl, Hq, D],
  `ks[i]`/`vs[i]` [B, Tl, Hkv, D] are position i's chunks on `devices[i]`. Returns
  each position's output chunk [B, Tl, Hq, D] in q's dtype.

  Position i folds the chunks j <= i as they come round; the last rotation is skipped
  (JAX's loop makes it and drops it)."""
  P = len(qs)
  B, Tl, Hq, D = qs[0].shape
  Hkv = ks[0].shape[2]
  g = Hq // Hkv
  scale = 1.0 / (D ** 0.5)
  state = []
  for i, (q, d) in enumerate(zip(qs, devices)):
    q_pos = i * Tl + torch.arange(Tl, device=d)
    state.append([q.reshape(B, Tl, Hkv, g, D), q_pos,
                  torch.zeros((B, Tl, Hkv, g, D), dtype=torch.float32, device=d),
                  torch.full((B, Tl, Hkv, g), NEG_INF, dtype=torch.float32, device=d),
                  torch.zeros((B, Tl, Hkv, g), dtype=torch.float32, device=d)])
  k_cur, v_cur = list(ks), list(vs)
  for s in range(P):
    for i, st in enumerate(state):
      src = (i - s) % P  # the chunk now resident on position i came from position src
      if src > i:
        continue
      qg, q_pos, acc, m, l = st
      k_pos = src * Tl + torch.arange(Tl, device=devices[i])
      st[2], st[3], st[4] = _fold_chunk(qg, k_cur[i], v_cur[i], acc, m, l, q_pos, k_pos, scale)
    if s < P - 1:
      k_cur, v_cur = send_next(k_cur, devices), send_next(v_cur, devices)
  out = []
  for q, (_, _, acc, _, l) in zip(qs, state):
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # causality always folds the diagonal
    out.append((acc / l[..., None]).reshape(B, Tl, Hq, D).to(q.dtype))
  return out


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           axis_name: str = "sp") -> torch.Tensor:
  """Global q [B, T, Hq, D], k/v [B, T, Hkv, D] split over `axis_name` along T (batch
  over dp and heads over tp where the mesh has them), ring attention over each ring of
  positions that differ only along `axis_name`, the output reassembled on the mesh's
  first device. The ring communicates over `axis_name` only, so tp and dp hold
  without resharding."""
  from xotorch_tpu_torch.parallel.mesh import shard_map

  spec = ("dp", axis_name, "tp", None)

  def per_positions(qp, kp, vp):
    out = [None] * mesh.size
    others = [a for a in mesh.axis_names if a != axis_name]
    for p in range(mesh.size):
      c = mesh.coords(p)
      if c.get(axis_name, 0) != 0:
        continue
      ring = mesh.positions(**{a: c[a] for a in others})
      got = ring_attention([qp[r] for r in ring], [kp[r] for r in ring], [vp[r] for r in ring],
                           [mesh.devices[r] for r in ring])
      for r, o in zip(ring, got):
        out[r] = o
    return out

  return shard_map(per_positions, mesh, (spec, spec, spec), spec)(q, k, v)
