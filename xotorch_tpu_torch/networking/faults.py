"""Hop retry policy and the test-only fault injector of the transport layer.

The port of xotorch_tpu/networking/faults.py. Two jobs, one module because they share
the vocabulary of transient failures:

1. Retry policy (`with_hop_retries`): bounded retries with exponential backoff and
   jitter on transient hop failures (`XOT_HOP_RETRIES`, default 2;
   `XOT_HOP_BACKOFF_S`, the base). A retried delivery is made safe by receiver-side
   dedup: the sender attaches a sequence id per logical send (`hop_seq`) and
   `Node.note_hop_delivery` drops a redelivery, so a retry after a lost ack never
   decodes a position twice.

2. Fault injector (`FaultInjector`): a deterministic tap at the peer-handle boundary
   that can drop, delay or fail the Nth call of an RPC, lose the ack after a
   delivery, silently sink a delivery (the peer that died after acking, which the
   stall watchdog exists for) or kill a peer outright. Installed in code (`install`),
   through `XOT_FAULT_SPEC` (a JSON list of rules) or at runtime through the API's
   /v1/debug/faults. With no injector installed and no spec set, a hop pays one
   environment read.

Process-wide survivability counters live here too (`COUNTERS`, exported at /metrics).
"""
from __future__ import annotations

import asyncio
import json
import random
import uuid
from typing import Optional

from xotorch_tpu_torch.utils import knobs


# Process-wide: peer handles have no Node back-reference, so no per-node registry can
# own these. hop_retries counts retried transient hop failures, health_check_failures
# the failed checks of the health monitor.
COUNTERS = {"hop_retries": 0, "health_check_failures": 0}


def bump(name: str, n: int = 1) -> None:
  COUNTERS[name] = COUNTERS.get(name, 0) + n


class TransientHopError(Exception):
  """A hop failure a retry may heal: an injected fault, a dropped connection, a lost
  ack, a peer in mid-restart."""


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
      bump("hop_retries")
      await asyncio.sleep(base * (2 ** attempt) * (0.5 + random.random()))
      attempt += 1


class _Rule:
  """One injection rule: fire `action` on the matching calls nth..nth+times-1.

  Spec keys: rpc (None = any), peer (None = any), nth (1-based, default 1), action,
  times (default 1), delay_s (the delay action's, default 0.05). Actions: "drop" and
  "error" (fail before delivery), "delay" (sleep, then deliver), "lost_ack" (deliver,
  then fail: the retry exercises dedup), "sink" (ack success and deliver nothing: the
  silent death the stall watchdog catches), "kill" (the peer is dead from this call
  on)."""

  def __init__(self, spec: dict):
    self.rpc: Optional[str] = spec.get("rpc")
    self.peer: Optional[str] = spec.get("peer")
    self.nth = int(spec.get("nth", 1))
    self.action = str(spec["action"])
    self.times = int(spec.get("times", 1))
    self.delay_s = float(spec.get("delay_s", 0.05))
    self.calls = 0

  def matches(self, rpc: str, peer_id: Optional[str]) -> bool:
    if self.rpc is not None and self.rpc != rpc:
      return False
    if self.peer is not None and peer_id is not None and self.peer != peer_id:
      return False
    return True

  @property
  def firing(self) -> bool:
    return self.nth <= self.calls < self.nth + self.times


class FaultInjector:
  def __init__(self, rules):
    self.rules = [_Rule(dict(r)) for r in rules]
    self.dead_peers: set = set()

  def kill_peer(self, peer_id: str) -> None:
    self.dead_peers.add(peer_id)

  def is_dead(self, peer_id: Optional[str]) -> bool:
    return peer_id in self.dead_peers

  async def apply(self, rpc: str, peer_id: Optional[str]) -> dict:
    """Run the matching rules for one call attempt. Raises TransientHopError for a
    failure before delivery (drop, error, kill, a dead peer); sleeps for a delay;
    returns the {"lost_ack", "sink"} flags the caller applies around its delivery. A
    retried attempt consults the rules again, so a one-shot rule lets the retry
    through."""
    if peer_id in self.dead_peers:
      raise TransientHopError(f"peer {peer_id} is dead (injected kill)")
    flags = {"lost_ack": False, "sink": False}
    for rule in self.rules:
      if not rule.matches(rpc, peer_id):
        continue
      rule.calls += 1
      if not rule.firing:
        continue
      if rule.action == "kill":
        self.dead_peers.add(rule.peer or peer_id)
        raise TransientHopError(f"peer {peer_id} killed (injected, {rpc} call {rule.calls})")
      if rule.action in ("drop", "error"):
        raise TransientHopError(f"injected {rule.action} on {rpc} call {rule.calls} to {peer_id}")
      if rule.action == "delay":
        await asyncio.sleep(rule.delay_s)
      elif rule.action == "lost_ack":
        flags["lost_ack"] = True
      elif rule.action == "sink":
        flags["sink"] = True
    return flags


_installed: Optional[FaultInjector] = None
_env_spec: Optional[str] = None
_env_injector: Optional[FaultInjector] = None


def install(injector: Optional[FaultInjector]) -> None:
  """Install (or with None, remove) the process-wide injector. It takes precedence
  over XOT_FAULT_SPEC."""
  global _installed
  _installed = injector


def active() -> Optional[FaultInjector]:
  """The installed injector, else the one XOT_FAULT_SPEC describes (parsed once per
  spec value), else None."""
  global _env_spec, _env_injector
  if _installed is not None:
    return _installed
  spec = knobs.get_str("XOT_FAULT_SPEC", None)
  if not spec:
    # Unset drops the cache: setting the same spec again gives a fresh injector, not
    # one with spent rule counters and dead peers.
    _env_spec = _env_injector = None
    return None
  if spec != _env_spec:
    rules = json.loads(spec)
    _env_injector = FaultInjector(rules if isinstance(rules, list) else [rules])
    _env_spec = spec
  return _env_injector


async def apply(rpc: str, peer_id: Optional[str]) -> dict:
  inj = active()
  if inj is None:
    return {"lost_ack": False, "sink": False}
  return await inj.apply(rpc, peer_id)


def peer_killed(peer_id: str) -> bool:
  inj = active()
  return inj is not None and inj.is_dead(peer_id)


def hop_seqs_enabled() -> bool:
  """Sequence ids ride the hops only when a redelivery is possible: retries on, or an
  injector that could force one."""
  return hop_retries() > 0 or active() is not None


def hop_seq() -> Optional[str]:
  """A fresh id per logical send, or None when a redelivery is impossible. Every
  attempt of one send carries the same id."""
  return uuid.uuid4().hex if hop_seqs_enabled() else None
