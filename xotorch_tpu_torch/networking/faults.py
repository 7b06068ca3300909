"""Hop retry policy for the transport layer.

The port of the retry half of xotorch_tpu/networking/faults.py: bounded retries with
exponential backoff and jitter on transient hop failures (`XOT_HOP_RETRIES`, default
2; `XOT_HOP_BACKOFF_S`, the base). A retried delivery is made safe by receiver-side
dedup: the sender attaches a sequence id per logical send (`hop_seq`) and
`Node.note_hop_delivery` drops a redelivery, so a retry after a lost ack never
decodes a position twice. (The fault injector of the JAX module is not ported yet.)
"""
from __future__ import annotations

import asyncio
import random
import uuid
from typing import Optional

from xotorch_tpu_torch.utils import knobs


class TransientHopError(Exception):
  """A hop failure a retry may heal: a dropped connection, a lost ack, a peer in
  mid-restart."""


def hop_retries() -> int:
  return max(0, knobs.get_int("XOT_HOP_RETRIES"))


def hop_backoff_s() -> float:
  return max(0.0, knobs.get_float("XOT_HOP_BACKOFF_S"))


def is_transient(exc: BaseException) -> bool:
  """Connection failures, timeouts and TransientHopError; codec errors, engine
  exceptions and cancellation propagate on the first attempt."""
  return isinstance(exc, (TransientHopError, ConnectionError, asyncio.TimeoutError,
                          asyncio.IncompleteReadError))


async def with_hop_retries(attempt_fn, retriable: bool = True):
  """Run one hop attempt, retrying transient failures up to XOT_HOP_RETRIES times.
  retriable=False runs exactly one attempt."""
  retries = hop_retries() if retriable else 0
  base = hop_backoff_s()
  attempt = 0
  while True:
    try:
      return await attempt_fn()
    except Exception as e:
      if attempt >= retries or not is_transient(e):
        raise
      await asyncio.sleep(base * (2 ** attempt) * (0.5 + random.random()))
      attempt += 1


def hop_seq() -> Optional[str]:
  """A fresh id per logical send, or None when a redelivery is impossible (retries
  off). Every attempt of one send carries the same id."""
  return uuid.uuid4().hex if hop_retries() > 0 else None
