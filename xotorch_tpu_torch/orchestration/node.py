"""Node: the masterless peer of the token ring.

The port of the serving paths of xotorch_tpu/orchestration/node.py, with the same
public surface (start/stop, process_prompt/process_tensor, collect_topology, on_token,
on_opaque_status) and the same deterministic ring:

- every peer derives the same partition table from the gossiped topology
  (RingMemoryWeightedPartitioningStrategy); the node that accepts a request pins that
  table as the request's ring map, which rides every hop, so every peer routes the
  request the same way even while its own view lags;
- a prompt goes to the owner of layer 0; each partition runs its layers and hands the
  hidden state (in the model's dtype, bf16 on the card) to the next; the last-layer
  peer samples, broadcasts the new token to every peer as a delta, and sends it back
  to partition 0 for the next step;
- the request's max_tokens, temperature, top_p and OpenAI sampling extras (seed,
  logit_bias, penalties, min_p, logprobs) ride the hops to the sampler peer, whose
  engine keeps the extras' state (the penalty counts) across its calls; logprobs are
  reported where the API's node hosts the sampling shard;
- a hop error aborts the request on every peer (a finish carrying the error), and
  every peer frees the request's state when it learns of the finish;
- a multi-LoRA id (`base@name`, XOT_ADAPTERS) rides the shards whole: its layers and
  partition table are the base card's (models/registry resolves the card through the
  base), and each peer's engine serves it from the adapter's own context, with its
  own batcher, over the base's tensors.

Observability (the JAX Node's): the Node keeps NodeMetrics, a Tracer, a
FlightRecorder, the latency anatomy (a ClockSkew collector fed by hop clock stamps and
a reservoir of stage breakdowns), the admission gate, and the alert engine and metrics
history with their background loops (XOT_ALERT, XOT_HISTORY); it hands the engine its
hooks (`metrics`, `flight`, `tracer`, `trace_ctx`). A request's trace context rides
`send_prompt`'s traceparent and the tensor hops' inference_state (TRACEPARENT_KEY), so
it has one trace id on every peer; each peer flushes its spans of a finished request
over the opaque-status bus, where its metric summary also goes on the topology cadence
(`node_metrics`, stamped on receipt so a silent peer's row goes stale).

When one partition spans the whole model, process_sampled_token takes the fused
decode loop instead: chunks of XOT_DECODE_CHUNK tokens, doubling up to
XOT_DECODE_CHUNK_MAX, through the engine's generate_chunk, each call naming the size
of the next (`next_size`) so the engine can run it ahead. With XOT_SPECULATE > 0 (8
when XOT_DRAFT_MODEL names a draft model) a greedy request without reshaping extras
speculates between chunks: a draft from the draft model (only while it is the one
outstanding request), else the continuation of the last n-gram's earlier occurrence in
prompt and output (`_lookup_draft`), verified by the engine's verify_draft in one
forward; two bonus-only rounds in a row turn speculation off for the request. Peers reconcile membership
every `topology_interval` seconds and re-gossip the topology with a visited-set
crawl. A peer's capabilities in a view are what that peer last reported of itself,
and its discovery entry (a manual config's, written by hand) only until it has
reported: the JAX package's crawl takes the discovery entry for a peer that is
skipped because it started the crawl, so there the last crawl to land can leave two
peers with different views of the ring.

Survivability (the JAX Node's, with its defaults): a stall watchdog aborts a request
with no progress for XOT_STALL_TIMEOUT_S (30 s; a hop received, a token sampled or a
broadcast delta applied is progress; the origin of a forwarded prompt sweeps it too;
an abort waits while the local engine is mid-dispatch, at most 4x the timeout) or past
its XOT_REQUEST_DEADLINE_S (0 = off), whose remaining budget rides the hops
(DEADLINE_KEY, send_prompt's deadline) so every peer enforces it; a health monitor
checks every peer each XOT_HEALTH_INTERVAL_S (5 s) and evicts one that fails
XOT_HEALTH_FAILS (2) checks in a row: its metric row goes, a flight snapshot is frozen,
the ring repartitions at once and discovery cannot re-admit it for
XOT_EVICT_COOLDOWN_S (30 s). `heal_ring` (the API's restart path) evicts after one
failed check. A ring peer that discovery stops listing and that fails one check then
is evicted too (JAX drops it uncounted: a dead peer that discovery's own check saw
first left no eviction, event or cooldown behind). Every abort goes through
_abort_request, so every surviving peer frees the request's state and KV. An origin request passes the fault injector's
"ProcessPrompt" rules (networking/faults.py), the gray-failure tap of a single node.

Training (the JAX Node's): `enqueue_example` pins the example's ring map and routes it
to the partition-0 owner; `process_example` runs this peer's slice through the engine's
`train_example` / `evaluate_example`, whose `forward_fn` (`_forward_example_fn`) sends
the activations on (SendExample) and returns the loss and the gradient; the map is
dropped when the example returns. `coordinate_save` saves this peer's shard as
`{dir}/{model}/{start}-{end}-{iteration}.safetensors` and asks every peer over the
status bus to save its own (`save_checkpoint`); `coordinate_resume` loads this peer's
range and asks the others to load theirs (`resume_checkpoint`).

Co-located partitions (the JAX Node's): where every partition of a request's ring is
served in this process (this node or InProcessPeerHandle peers, `_inprocess_chain`),
a hop to the next partition carries the device tensor (`_keep_on_device_kwargs`; a hop
to any other peer is copied to the host first, in forward_tensor), and the last
partition decodes the whole chain in fused chunks (`_ring_fused_gen`: the engine's
generate_chunk_ring, with verify_draft_ring for speculation) instead of one hop a
partition a token. A request with sampling extras keeps the per-token ring (counted in
`ring_declines`). With speculation on, the first partition sends the prompt's ids to
the sampler on the first hop (PROMPT_TOKENS_KEY), which alone consumes them.
"""
from __future__ import annotations

import asyncio
import json
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from xotorch_tpu_torch.inference.engine import CacheExhausted, InferenceEngine
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.networking import faults
from xotorch_tpu_torch.networking.discovery import Discovery
from xotorch_tpu_torch.networking.peer_handle import PeerHandle
from xotorch_tpu_torch.networking.server import Server
from xotorch_tpu_torch.orchestration.admission import AdmissionGate
from xotorch_tpu_torch.orchestration.alerts import AlertEngine
from xotorch_tpu_torch.orchestration.anatomy import AnatomyStore, ClockSkew, extract_breakdown, ring_offsets
from xotorch_tpu_torch.orchestration.flight import FlightRecorder
from xotorch_tpu_torch.orchestration.history import MetricsHistory
from xotorch_tpu_torch.orchestration.metrics import NodeMetrics, aggregate_histograms
from xotorch_tpu_torch.orchestration.tracing import TRACEPARENT_KEY, TraceContext, Tracer
from xotorch_tpu_torch.topology.device_capabilities import (UNKNOWN_DEVICE_CAPABILITIES, DeviceCapabilities,
                                                          device_capabilities)
from xotorch_tpu_torch.topology.partitioning import PartitioningStrategy, map_partitions_to_shards
from xotorch_tpu_torch.topology.topology import Topology
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG, AsyncCallbackSystem, spawn_detached

# inference_state keys that carry a request's settings to the sampler peer.
MAX_TOKENS_KEY = "xot_max_tokens"
TEMP_KEY = "xot_temperature"
TOP_P_KEY = "xot_top_p"
# The request's OpenAI sampling extras, one JSON-safe dict validated at the API.
SAMPLING_KEY = "xot_sampling"
# The request's pinned partition map: [[node_id, start_layer, end_layer], ...] in ring
# order, set once by the node that accepts the request.
RING_MAP_KEY = "xot_ring_map"
# The request's remaining end-to-end budget in seconds at send time: every peer derives
# its own absolute deadline from it (monotonic clocks do not compare across hosts).
DEADLINE_KEY = "xot_deadline_s"
# The prompt's token ids, for the sampler's prompt lookup on a co-located ring: mid-ring
# hops carry hidden states, so the first partition sends the ids once, on the first
# hop, and only the last partition consumes them. Set only with XOT_SPECULATE > 0.
PROMPT_TOKENS_KEY = "xot_prompt_tokens"



def _lookup_draft(context: List[int], k: int, window: int = 2048) -> List[int]:
  """Prompt-lookup drafting (JAX's): the continuation of the most recent earlier
  occurrence of the context's last 3-gram (else 2-gram) in its last `window` tokens
  (XOT_SPECULATE_WINDOW). The newest occurrence with k tokens after it wins; otherwise
  the longest continuation of at least two tokens. [] when nothing repeats, k < 2 or
  the context is shorter than four tokens."""
  if k < 2 or len(context) < 4:
    return []
  context = context[-window:]
  for n in (3, 2):
    if len(context) <= n:
      continue
    tail = context[-n:]
    best: List[int] = []
    for i in range(len(context) - n - 1, -1, -1):
      if context[i:i + n] == tail:
        cont = context[i + n:i + n + k]
        if len(cont) == k:
          return cont
        if len(cont) > len(best):
          best = cont
    if len(best) >= 2:
      return best
  return []


# A busy local engine defers a stall abort for at most this many stall timeouts: one
# first request's graph captures fit, while an engine kept busy by other requests
# cannot shield a dead peer's hang for ever.
_STALL_DEFER_CAP = 4


class Node:
  def __init__(
    self,
    _id: str,
    server: Optional[Server],
    inference_engine: InferenceEngine,
    discovery: Optional[Discovery],
    partitioning_strategy: PartitioningStrategy,
    max_generate_tokens: int = 1024,
    default_sample_temp: float = 0.6,
    default_sample_top_k: int = 35,
    decode_chunk_size: Optional[int] = None,
  ):
    self.id = _id
    self.server = server
    self.inference_engine = inference_engine
    self.discovery = discovery
    self.partitioning_strategy = partitioning_strategy
    self.max_generate_tokens = max_generate_tokens
    self.default_sample_temp = default_sample_temp
    self.default_sample_top_k = default_sample_top_k
    # Tokens per fused decode call when one partition owns the whole model; each call
    # doubles the next up to the ceiling, so the first chunk stays small for streaming.
    self.decode_chunk_size = (decode_chunk_size if decode_chunk_size is not None
                              else knobs.get_int("XOT_DECODE_CHUNK"))
    self.max_decode_chunk_size = max(self.decode_chunk_size, knobs.get_int("XOT_DECODE_CHUNK_MAX"))

    self.peers: List[PeerHandle] = []
    self.device_capabilities = UNKNOWN_DEVICE_CAPABILITIES
    self.topology = Topology()
    # What each peer reported of its own capabilities in a crawl (collect_topology).
    self._peer_reports: Dict[str, DeviceCapabilities] = {}
    # A node driven without start() serves alone: its one partition is the whole model.
    self.topology.update_node(self.id, self.device_capabilities)
    self.buffered_token_output: Dict[str, Tuple[List[int], bool]] = {}
    self.on_token: AsyncCallbackSystem = AsyncCallbackSystem()
    self.on_opaque_status: AsyncCallbackSystem = AsyncCallbackSystem()
    self.on_opaque_status.register("node_status").on_next(self.on_node_status)
    self.outstanding_requests: Dict[str, str] = {}
    # Observability: spans, metrics and the always-on flight recorder.
    self.tracer = Tracer(node_id=self.id)
    self.metrics = NodeMetrics(node_id=self.id)
    self.flight = FlightRecorder(node_id=self.id)
    self._request_trace_ctx: Dict[str, TraceContext] = {}
    self._last_token_time: Dict[str, float] = {}
    # Each peer's latest metric summary off the status bus (/v1/cluster/metrics), and
    # when it arrived: past 3x the topology cadence a row is stale.
    self.peer_metrics: "OrderedDict[str, dict]" = OrderedDict()
    self._peer_metrics_at: Dict[str, float] = {}
    self.topology_interval = 2.0  # start() sets the real cadence
    # The engine's observability hooks (duck-typed; None on the base class).
    for hook, value in (("metrics", self.metrics), ("flight", self.flight),
                        ("tracer", self.tracer), ("trace_ctx", self._request_trace_ctx.get)):
      setattr(inference_engine, hook, value)
    # Metrics history before the alert engine: its drift sentinel reads the history.
    self.history = MetricsHistory(self)
    self.alerts = AlertEngine(self)
    # Bounded admission (XOT_MAX_INFLIGHT, 0 = off): the API takes a slot before
    # process_prompt and sheds overload as 429s.
    self.admission = AdmissionGate(self)
    # Prefetches of queued prompts (bounded LRU of (shard, prompt hash) -> monotonic
    # time): /v1/prefetch and the admission gate's on_queued hook fire for the same
    # queued request, and one restore a prompt per window is all the host tier can use.
    self._prefetch_recent: "OrderedDict[tuple, float]" = OrderedDict()
    # Latency anatomy: clock skew from hop stamps, spans stamped through the same clock,
    # and the origin's reservoir of stage breakdowns (/v1/anatomy).
    self.clock = ClockSkew(self.id)
    self.tracer.now_ns = self.clock.wall_ns
    self.anatomy = AnatomyStore()
    self._anatomy_delay_s = max(0.0, knobs.get_float("XOT_ANATOMY_DELAY_S"))
    # Requests this node originated (bounded): only the origin assembles a breakdown.
    self._anatomy_origin: "OrderedDict[str, None]" = OrderedDict()
    # Why a request aborted (bounded LRU; the API pops entries when reporting).
    self.request_errors: "OrderedDict[str, str]" = OrderedDict()
    # Requests whose finish broadcast was applied here (bounded): a delayed delta must
    # not bring a finished request back.
    self._finished_results: "OrderedDict[str, None]" = OrderedDict()
    self._request_max_tokens: Dict[str, int] = {}
    self._request_temp: Dict[str, float] = {}
    self._request_top_p: Dict[str, float] = {}
    self._request_sampling: Dict[str, dict] = {}
    self._request_eos: Dict[str, Tuple[int, ...]] = {}
    self._request_started: Dict[str, float] = {}
    # Speculative decoding: each request's prompt ids on this sampler (the lookup's
    # source), the draft model (XOT_DRAFT_MODEL; it implies a depth of 8) and the draft
    # depth (XOT_SPECULATE, 0 = off) and lookup window.
    self._request_prompt_tokens: Dict[str, List[int]] = {}
    self.draft_model = knobs.get_str("XOT_DRAFT_MODEL", "") or ""
    self.speculate_tokens = knobs.get_int("XOT_SPECULATE", 8 if self.draft_model else 0)
    self.speculate_window = knobs.get_int("XOT_SPECULATE_WINDOW")
    self._request_ring_map: "OrderedDict[str, list]" = OrderedDict()
    # Requests whose co-located ring declined the fused path here, by reason.
    self.ring_declines: Dict[str, int] = {}
    # Training checkpoints this node saved: model -> {"start-end": iteration}.
    self.checkpoints: Dict[str, Dict[str, int]] = {}
    # Receiver-side hop dedup: per-request bounded sets of hop sequence ids.
    self._hop_seen: "OrderedDict[str, OrderedDict]" = OrderedDict()
    # Cancelled or finished-elsewhere requests (bounded LRU, outliving their state so a
    # late hop or a running loop still sees the flag).
    self._cancelled: "OrderedDict[str, None]" = OrderedDict()
    self._update_peers_lock = asyncio.Lock()
    self._tasks: set = set()
    # Survivability (the JAX Node's knobs and defaults; 0 turns each off).
    self.request_deadline_s = knobs.get_float("XOT_REQUEST_DEADLINE_S")
    self.stall_timeout_s = knobs.get_float("XOT_STALL_TIMEOUT_S")
    self.health_interval_s = knobs.get_float("XOT_HEALTH_INTERVAL_S")
    self.health_fail_threshold = max(1, knobs.get_int("XOT_HEALTH_FAILS"))
    self.evict_cooldown_s = knobs.get_float("XOT_EVICT_COOLDOWN_S")
    self._request_deadline: Dict[str, float] = {}  # request -> monotonic deadline
    self._last_progress: Dict[str, float] = {}  # request -> monotonic time of progress
    # Requests whose stall abort waits on a busy engine: one `watchdog.deferred` event an
    # episode, not one a sweep.
    self._stall_deferred: set = set()
    self._health_fails: Dict[str, int] = {}
    self._evicted_until: Dict[str, float] = {}  # peer -> monotonic end of its cooldown
    self._watchdog_task: Optional[asyncio.Task] = None
    self._health_task: Optional[asyncio.Task] = None

  def _spawn(self, coro) -> "asyncio.Task":
    return spawn_detached(coro, self._tasks)

  # ------------------------------------------------------------- lifecycle

  async def start(self, wait_for_peers: int = 0, topology_interval: float = 2.0) -> None:
    self.topology_interval = topology_interval
    self.device_capabilities = await device_capabilities()
    self.topology.update_node(self.id, self.device_capabilities)
    await self.server.start()
    await self.discovery.start()
    await self.update_peers(wait_for_peers)
    await self.collect_topology(set())
    self._spawn(self.periodic_topology_collection(topology_interval))
    self.start_watchdog()
    self.start_health_monitor()
    self.start_alerts()
    self.start_history()
    if DEBUG >= 1:
      print(f"Node {self.id} started; topology: {self.topology}")

  def start_alerts(self) -> None:
    if self.alerts.enabled:
      self._spawn(self._background(self.alerts.eval_interval_s, self.alerts.evaluate, "alert evaluation"))

  def start_history(self) -> None:
    if self.history.enabled:
      self._spawn(self._background(self.history.sample_s, self.history.observe, "history sampling"))

  @staticmethod
  async def _background(interval: float, step, what: str) -> None:
    """A host-side cadence (alert rules, history samples): reads metric cells, engine
    counters and EWMAs only, so it never adds a device sync."""
    while True:
      await asyncio.sleep(interval)
      try:
        step()
      except Exception as e:  # the loop must outlive one failed tick
        if DEBUG >= 1:
          print(f"{what} error: {e!r}")

  async def stop(self) -> None:
    for task in list(self._tasks):
      task.cancel()
    await asyncio.gather(*self._tasks, return_exceptions=True)
    self._watchdog_task = self._health_task = None
    if self.discovery is not None:
      await self.discovery.stop()
    if self.server is not None:
      await self.server.stop()
    for peer in self.peers:
      await peer.disconnect()

  # -------------------------------------------------------- survivability

  def start_watchdog(self, request_id: Optional[str] = None) -> None:
    """Arm the deadline and stall watchdog (a no-op when nothing needs it). Also armed
    lazily by progress and by a deadline adopted from a hop, so a node driven without
    start() is covered, and a peer whose own knobs are off still enforces a deadline
    the origin set. `request_id` is the request whose progress armed it (the
    snapshot's arming event)."""
    if self._watchdog_task is None and (
        self.stall_timeout_s > 0 or self.request_deadline_s > 0 or self._request_deadline):
      self._watchdog_task = self._spawn(self._watchdog_loop())
      self.flight.record("watchdog.armed", request_id,
                         stall_s=self.stall_timeout_s, deadline_s=self.request_deadline_s)

  def start_health_monitor(self) -> None:
    if self._health_task is None and self.health_interval_s > 0:
      self._health_task = self._spawn(self._health_monitor_loop())

  def _note_progress(self, request_id: str) -> None:
    self._last_progress[request_id] = time.monotonic()
    self._stall_deferred.discard(request_id)
    self.start_watchdog(request_id)

  async def _watchdog_loop(self) -> None:
    """Abort requests past their deadline or without progress for the stall timeout:
    a peer that dies after acking a hop raises no error anywhere. The abort is
    _abort_request's, so the finish broadcast frees the request on every surviving
    peer."""
    bounds = [t for t in (self.stall_timeout_s, self.request_deadline_s) if t > 0]
    tick = min(1.0, max(0.02, min(bounds) / 4)) if bounds else 1.0
    while True:
      await asyncio.sleep(tick)
      now = time.monotonic()
      try:
        for rid, dl in list(self._request_deadline.items()):
          if now <= dl:
            continue
          if rid in self.outstanding_requests or rid in self.buffered_token_output:
            self.metrics.watchdog_aborts_total.inc()
            self.flight.record("deadline.expired", rid, overdue_s=round(now - dl, 3))
            self.flight.record("watchdog.fired", rid, kind="deadline")
            await self._abort_request(rid, f"deadline_exceeded: request blew its deadline on {self.id}")
          else:
            self._request_deadline.pop(rid, None)  # finished elsewhere
        if self.stall_timeout_s > 0:
          # Every request with a progress row, not only the outstanding ones: the origin
          # of a forwarded prompt is never outstanding here, yet a lost prompt chain
          # must end at its stall bound. Rows die at the finish, so a finished request
          # cannot be aborted.
          busy_fn = getattr(self.inference_engine, "dispatch_inflight", None)
          for rid in set(self.outstanding_requests) | set(self._last_progress):
            last = self._last_progress.get(rid)
            if last is None:
              self._last_progress[rid] = now
            elif now - last > self.stall_timeout_s:
              if (busy_fn is not None and busy_fn()
                  and now - last <= self.stall_timeout_s * _STALL_DEFER_CAP):
                # The local engine is mid-dispatch (a first request's graph captures can
                # outlast the bound): active work, not a silent stall. The stall clock
                # keeps running, so the abort fires at the first sweep that finds the
                # engine idle, or past the cap regardless; a hung device call is the
                # deadline's job.
                if rid not in self._stall_deferred:
                  self._stall_deferred.add(rid)
                  self.flight.record("watchdog.deferred", rid, idle_s=round(now - last, 3))
                continue
              self._stall_deferred.discard(rid)
              self.metrics.watchdog_aborts_total.inc()
              self.flight.record("watchdog.fired", rid, kind="stall", idle_s=round(now - last, 3))
              await self._abort_request(
                rid, f"stalled: no progress for {now - last:.2f}s on {self.id} "
                     f"(stall timeout {self.stall_timeout_s:g}s)")
      except Exception as e:  # the loop must outlive one failed sweep
        if DEBUG >= 1:
          print(f"watchdog error: {e!r}")

  async def _health_monitor_loop(self) -> None:
    """Check every peer each interval; a peer that fails the threshold in a row is
    evicted, so the next request pins a ring of live peers."""
    while True:
      await asyncio.sleep(self.health_interval_s)
      try:
        await self._health_sweep(self.health_fail_threshold, by="health monitor")
      except Exception as e:  # the loop must outlive one failed sweep
        if DEBUG >= 1:
          print(f"health monitor error: {e!r}")

  async def _health_sweep(self, evict_after: int, by: str) -> None:
    for peer in list(self.peers):
      try:
        ok = await peer.health_check()
      except Exception:
        ok = False
      if ok:
        self._health_fails.pop(peer.id(), None)
        continue
      faults.bump("health_check_failures")
      fails = self._health_fails.get(peer.id(), 0) + 1
      self._health_fails[peer.id()] = fails
      self.flight.record("health.check_failed", None, peer=peer.id(), fails=fails)
      if fails >= evict_after:
        await self._evict_peer(peer, by)

  async def _evict_peer(self, peer, by: str) -> None:
    """Drop the peer, bar it from discovery for the cooldown, drop its metric summary
    (a dead peer's last row must not freeze the ring's percentiles), freeze a
    node-scope flight snapshot, disconnect, and repartition now: the dead peer leaves
    the partition table before any new or restarted request pins its ring map."""
    if all(p.id() != peer.id() for p in self.peers):
      return  # the health monitor, heal_ring or a reconcile got there first
    if DEBUG >= 1:
      print(f"Evicting unhealthy peer {peer.id()}@{peer.addr()}")
    self.peers = [p for p in self.peers if p.id() != peer.id()]
    self._evicted_until[peer.id()] = time.monotonic() + self.evict_cooldown_s
    self._health_fails.pop(peer.id(), None)
    self._peer_reports.pop(peer.id(), None)
    self.peer_metrics.pop(peer.id(), None)
    self._peer_metrics_at.pop(peer.id(), None)
    self.metrics.peer_evictions_total.inc()
    self.metrics.peers.set(len(self.peers))
    self.flight.record("peer.evicted", None, peer=peer.id(), cooldown_s=self.evict_cooldown_s, by=by)
    self.flight.freeze(None, reason=f"peer_evicted:{peer.id()}")
    try:
      await peer.disconnect()
    except Exception as e:
      if DEBUG >= 1:
        print(f"evicted peer {peer.id()} disconnect failed (already dead?): {e!r}")
    try:
      await self.collect_topology(set())
    except Exception as e:
      if DEBUG >= 1:
        print(f"post-eviction repartition failed (the next periodic sweep retries): {e!r}")

  @staticmethod
  async def _answers(peer) -> bool:
    try:
      return bool(await peer.health_check())
    except Exception:
      return False

  def _is_evicted(self, peer_id: str) -> bool:
    until = self._evicted_until.get(peer_id)
    if until is None:
      return False
    if time.monotonic() >= until:
      self._evicted_until.pop(peer_id, None)
      return False
    return True

  async def heal_ring(self) -> None:
    """The API's restart path: a request just died, so one failed check evicts; then
    repartition, so the restarted request pins a live ring. Peers that pass stay: an
    engine fault must not cost a healthy peer its seat."""
    await self._health_sweep(evict_after=1, by="heal_ring")
    try:
      await self.collect_topology(set())
    except Exception as e:
      if DEBUG >= 1:
        print(f"heal_ring repartition failed (the restart pins the stale map): {e!r}")

  @property
  def current_topology(self) -> Topology:
    return self.topology

  # ------------------------------------------------------------ inference

  async def process_prompt(self, base_shard: Shard, prompt: str, request_id: Optional[str] = None,
                           traceparent: Optional[str] = None, max_tokens: Optional[int] = None,
                           images: Optional[List[np.ndarray]] = None,
                           temperature: Optional[float] = None,
                           top_p: Optional[float] = None,
                           sampling: Optional[dict] = None,
                           ring_map: Optional[list] = None,
                           deadline: Optional[float] = None) -> None:
    """Prefill `prompt` here, or forward it to the owner of layer 0; tokens arrive
    through `on_token` on every peer. `ring_map` is the origin's pinned partition map
    on a forwarded prompt. `sampling` holds the request's OpenAI extras (validated
    at the API). `traceparent` is the origin's trace context on a forwarded prompt (None
    at the origin, which counts the request and assembles its anatomy); `deadline` is
    the origin's remaining budget in seconds on a forwarded prompt (an origin request
    starts one from XOT_REQUEST_DEADLINE_S); `images` (uint8 HWC arrays) ride to the
    owner of layer 0 with the prompt, for a vision card (JAX's route: the multimodal
    prefill, a host sample of the first token, then the decode loop)."""
    if request_id is None:
      request_id = str(uuid.uuid4())
    if request_id not in self._request_deadline:
      if deadline is not None:
        self._request_deadline[request_id] = time.monotonic() + max(0.0, float(deadline))
      elif self.request_deadline_s > 0:
        self._request_deadline[request_id] = time.monotonic() + self.request_deadline_s
    self._request_started.setdefault(request_id, time.monotonic())
    self.flight.record("request.admitted", request_id, model=base_shard.model_id,
                       origin=traceparent is None)
    self._note_progress(request_id)
    if traceparent is None:
      # The origin's gray-failure tap (test and soak only): injector rules that name
      # "ProcessPrompt" apply here, after the first-touch stamp, so a delay lands in this
      # node's own TTFT and latency histograms while /healthcheck stays green. Rules
      # without an rpc keep to the peer handles and their calls are not counted here.
      # With no injector installed this costs one environment read an origin request.
      inj = faults.active()
      if inj is not None and any(r.rpc == "ProcessPrompt" for r in inj.rules):
        try:
          await inj.apply("ProcessPrompt", None)
        except faults.TransientHopError as e:
          await self._abort_request(request_id, f"injected fault on {self.id}: {e}")
          return
    if traceparent is None:
      # Origin requests only: a forwarded prompt would double the cluster-wide sum.
      self.metrics.requests_total.inc()
      if self.anatomy.enabled:
        self._anatomy_origin[request_id] = None
        self._anatomy_origin.move_to_end(request_id)
        while len(self._anatomy_origin) > 512:
          self._anatomy_origin.popitem(last=False)
    if max_tokens is not None:
      self._request_max_tokens[request_id] = self._clamp_max_tokens(max_tokens)
    if temperature is not None:
      self._request_temp[request_id] = max(0.0, float(temperature))
    if top_p is not None:
      self._request_top_p[request_id] = min(1.0, max(0.0, float(top_p)))
    if sampling:
      self._request_sampling[request_id] = dict(sampling)
    parent_ctx = TraceContext.from_traceparent(traceparent)
    with self.tracer.start_span(
      "process_prompt" if parent_ctx is None else "process_prompt.forwarded", parent=parent_ctx,
      attributes={"request.id": request_id, "model.id": base_shard.model_id},
    ) as span:
      # The request's root context rides the hops, so every peer's spans join its trace.
      self._request_trace_ctx[request_id] = span.context()
      try:
        if ring_map:
          if request_id not in self._request_ring_map:
            self._set_ring_map(request_id, ring_map)
        else:
          self._pin_ring_map(base_shard, request_id)
        await self._process_prompt(base_shard, prompt, request_id, images)
      except CacheExhausted as e:
        # The prompt itself does not fit the KV budget: a client error, answered 400.
        await self._abort_request(request_id, f"context_length_exceeded: {e}")
      except Exception as e:  # the request's boundary: every peer learns it failed
        print(f"Error processing prompt [{request_id}]: {e!r}")
        if DEBUG >= 2:
          import traceback
          traceback.print_exc()
        await self._abort_request(request_id, f"prompt processing failed on {self.id}: {e!r}")

  async def _process_prompt(self, base_shard: Shard, prompt: str, request_id: str,
                            images: Optional[List[np.ndarray]] = None) -> None:
    shard = self.get_current_shard(base_shard, request_id=request_id)
    if not shard.is_first_layer:
      await self.forward_prompt(base_shard, prompt, request_id, 0, images)
      return
    self.outstanding_requests[request_id] = "processing prompt"
    self.metrics.active_requests.set(len(self.outstanding_requests))
    if shard.is_last_layer and not images:
      # One partition, a text prompt: prefill and sample on the device in one engine
      # call. An image prompt takes infer_prompt below and records no prompt tokens for
      # the lookup (its positions hold image features), as in JAX.
      tokens = await self.inference_engine.encode(shard, prompt)
      if self.speculate_tokens > 0:
        self._request_prompt_tokens[request_id] = [int(t) for t in np.asarray(tokens).reshape(-1)]
      token, _ = await self.inference_engine.infer_sample_tensor(
        request_id, shard, np.asarray(tokens).reshape(1, -1), temp=self._temp_for(request_id),
        top_k=self.default_sample_top_k, top_p=self._top_p_for(request_id),
        **self._sampling_kwargs(request_id))
      await self.process_sampled_token(base_shard, int(token), request_id)
      return
    result, inference_state = await self.inference_engine.infer_prompt(
      request_id, shard, prompt, images=images, **self._keep_on_device_kwargs(shard, request_id))
    if (self.speculate_tokens > 0 and not shard.is_last_layer and not images
        and self._inprocess_chain(base_shard, request_id) is not None):
      # The sampler drafts from the prompt's ids, which the hidden-state hops do not
      # carry: they ride the first hop once. Only a co-located chain, whose fused ring
      # is what speculates over a ring, pays for it.
      try:
        toks = await self.inference_engine.encode(shard, prompt)
        inference_state = {**(inference_state or {}),
                           PROMPT_TOKENS_KEY: [int(t) for t in np.asarray(toks).reshape(-1)]}
      except Exception as e:  # the request goes on; speculation drafts from output only
        if DEBUG >= 1:
          print(f"[{request_id}] prompt tokenize for speculation failed: {e!r}")
    await self.process_inference_result(base_shard, result, request_id, inference_state)

  async def process_tensor(self, base_shard: Shard, tensor, request_id: Optional[str] = None,
                           inference_state: Optional[dict] = None) -> None:
    """One hop's work: run this partition's layers on `tensor` (token ids for
    partition 0, a hidden state otherwise), then forward the result or, on the last
    partition, sample."""
    if request_id is None:
      request_id = str(uuid.uuid4())
    if request_id in self._cancelled:
      return  # the request ended elsewhere; a late hop must not recreate its state
    if inference_state:
      if request_id not in self._request_ring_map and inference_state.get(RING_MAP_KEY):
        self._set_ring_map(request_id, inference_state[RING_MAP_KEY])
      cap = inference_state.get(MAX_TOKENS_KEY)
      if cap is not None and request_id not in self._request_max_tokens:
        self._request_max_tokens[request_id] = self._clamp_max_tokens(cap)
      t = inference_state.get(TEMP_KEY)
      if t is not None and request_id not in self._request_temp:
        self._request_temp[request_id] = max(0.0, float(t))
      p = inference_state.get(TOP_P_KEY)
      if p is not None and request_id not in self._request_top_p:
        self._request_top_p[request_id] = min(1.0, max(0.0, float(p)))
      sampling = inference_state.get(SAMPLING_KEY)
      if sampling and request_id not in self._request_sampling:
        self._request_sampling[request_id] = dict(sampling)
    self._request_started.setdefault(request_id, time.monotonic())
    # Join the request's trace: its traceparent rides the inference_state.
    ctx = self._request_trace_ctx.get(request_id)
    if ctx is None and inference_state:
      ctx = TraceContext.from_traceparent(inference_state.get(TRACEPARENT_KEY))
      if ctx is not None:
        self._request_trace_ctx[request_id] = ctx
    start_ns = time.perf_counter_ns()
    self.metrics.tensor_hops_total.inc()
    shard = None
    try:
      shard = self.get_current_shard(base_shard, request_id=request_id)
      self.outstanding_requests[request_id] = "processing tensor"
      self.metrics.active_requests.set(len(self.outstanding_requests))
      self.flight.record("hop.recv", request_id, layers=f"{shard.start_layer}-{shard.end_layer}")
      self._note_progress(request_id)
      if inference_state and shard.is_last_layer and request_id not in self._request_prompt_tokens:
        # The sampler consumes the prompt's ids; a mid-ring peer passes them on.
        pt = inference_state.pop(PROMPT_TOKENS_KEY, None)
        if pt:
          self._request_prompt_tokens[request_id] = [int(t) for t in pt]
      d = inference_state.get(DEADLINE_KEY) if inference_state else None
      if d is not None and request_id not in self._request_deadline:
        # A hop-carried deadline is enforced here too, whatever this node's knobs say.
        self._request_deadline[request_id] = time.monotonic() + max(0.0, float(d))
        self.start_watchdog(request_id)
      with self.tracer.start_span(
        "process_tensor", parent=ctx,
        attributes={"request.id": request_id, "shard.start": shard.start_layer,
                    "shard.end": shard.end_layer},
      ):
        if shard.is_last_layer:
          # Forward and sample on the device: only the token crosses to the host.
          token, inference_state = await self.inference_engine.infer_sample_tensor(
            request_id, shard, tensor, temp=self._temp_for(request_id),
            top_k=self.default_sample_top_k, inference_state=inference_state,
            top_p=self._top_p_for(request_id), **self._sampling_kwargs(request_id))
        else:
          result, inference_state = await self.inference_engine.infer_tensor(
            request_id, shard, tensor, inference_state,
            **self._keep_on_device_kwargs(shard, request_id))
      self.metrics.hop_latency.observe((time.perf_counter_ns() - start_ns) / 1e9)
      if shard.is_last_layer:
        await self.process_sampled_token(base_shard, int(token), request_id, inference_state)
      else:
        await self.process_inference_result(base_shard, result, request_id, inference_state)
    except CacheExhausted as e:
      if DEBUG >= 1:
        print(f"[{request_id}] cache exhausted, finishing as length: {e}")
      await self._finish_as_length(request_id)
    except Exception as e:  # the hop's boundary: every peer learns the request failed
      print(f"Error processing tensor for shard {shard}: {e!r}")
      if DEBUG >= 2:
        import traceback
        traceback.print_exc()
      await self._abort_request(request_id, f"tensor hop failed on {self.id} ({shard}): {e!r}")

  async def process_inference_result(self, base_shard: Shard, result, request_id: str,
                                     inference_state: Optional[dict] = None) -> None:
    """Forward a non-last partition's output to the next partition. The last partition
    lands here only with a multimodal prefill's logits (a text prompt samples on the
    device, in infer_sample_tensor): it samples the first token on the host with the
    request's extras, then goes on as the sampled token's path does."""
    shard = self.get_current_shard(base_shard, request_id=request_id)
    if not shard.is_last_layer:
      self.outstanding_requests[request_id] = "waiting"
      await self.forward_tensor(base_shard, result, request_id,
                                self.get_partition_index(offset=1, request_id=request_id),
                                inference_state)
      return
    # Only an engine with a vision path gets here (infer_prompt raises for images on any
    # other), and its host sampler takes the request's extras.
    token = await self.inference_engine.sample(
      result, temp=self._temp_for(request_id), top_k=self.default_sample_top_k,
      top_p=self._top_p_for(request_id), request_id=request_id,
      sampling=self._request_sampling.get(request_id))
    await self.process_sampled_token(base_shard, int(np.asarray(token).reshape(-1)[0]), request_id,
                                     inference_state)

  async def process_sampled_token(self, base_shard: Shard, token_int: int, request_id: str,
                                  inference_state: Optional[dict] = None) -> None:
    """Buffer and broadcast a sampled token, then stop (EOS or the cap) or keep the
    ring turning: the fused decode loop when this partition spans the whole model, or
    when every partition of the ring is co-located (the fused ring; detached, so
    process_prompt returns after the first token), else the token goes back to
    partition 0."""
    shard = self.get_current_shard(base_shard, request_id=request_id)
    buffered, _ = self.buffered_token_output.setdefault(request_id, ([], False))
    if self._ingest_sampled_tokens(request_id, [token_int], buffered, base_shard):
      await self._finish_generation(request_id)
      return
    if self.decode_chunk_size > 1:
      if shard.is_first_layer:
        self._spawn(self._fused_decode_loop(base_shard, shard, request_id, buffered))
        return
      ring = self._ring_fused_gen(base_shard, request_id)
      if ring is not None:
        gen, verify = ring
        self._spawn(self._fused_decode_loop(base_shard, shard, request_id, buffered, gen=gen,
                                            ring_verify=verify))
        return
    await self._forward_next_token(base_shard, request_id, buffered, inference_state)

  def _ring_fused_gen(self, base_shard: Shard, request_id: str):
    """(a generate_chunk-shaped call that decodes the whole co-located ring in fused
    chunks, the ring's draft verifier or None), or None when the ring does not qualify:
    a partition not served in this process by an engine that fuses, or a request with
    sampling extras (counted in `ring_declines`: the per-token ring's sampler applies
    them). The chain binds the request's pinned partition table; a segment evicted
    mid-generation fails the request loudly (RequestStateLost)."""
    ring = getattr(self.inference_engine, "generate_chunk_ring", None)
    chain = self._inprocess_chain(base_shard, request_id) if ring is not None else None
    if chain is None:
      return None
    if self._request_sampling.get(request_id):
      self.ring_declines["extras"] = self.ring_declines.get("extras", 0) + 1
      return None

    async def gen(rid, _shard, prev_token, num_tokens, temp, top_k, top_p=0.0, next_size=None):
      return await ring(rid, chain, prev_token, num_tokens, temp=temp, top_k=top_k, top_p=top_p,
                        next_size=next_size)

    verify_ring = getattr(self.inference_engine, "verify_draft_ring", None)
    verify = None
    if verify_ring is not None:
      async def verify(rid, _shard, prev_token, draft):
        return await verify_ring(rid, chain, prev_token, draft)
    return gen, verify

  def _inprocess_chain(self, base_shard: Shard, request_id: Optional[str] = None):
    """The ring-ordered [(engine, shard)] of the request's partitions when every one is
    served in this process (this node, or an InProcessPeerHandle peer's node) by an
    engine that fuses rings, else None. A request with a pinned map binds its map, not
    the live view."""
    entries = self._ring_entries(request_id)
    if entries is not None:
      node_ids = [n for n, _, _ in entries]
    else:
      try:
        node_ids = [p.node_id for p in self.partitioning_strategy.partition(self.topology)]
      except Exception:
        return None
    if len(node_ids) < 2:
      return None
    chain = []
    for i, node_id in enumerate(node_ids):
      if node_id == self.id:
        eng = self.inference_engine
      else:
        peer = next((p for p in self.peers if p.id() == node_id), None)
        node = getattr(peer, "node", None)  # an InProcessPeerHandle's
        eng = getattr(node, "inference_engine", None)
      if eng is None or not getattr(eng, "supports_ring_fusion", False):
        return None
      chain.append((eng, self.get_current_shard(base_shard, i, request_id=request_id)))
    return chain

  def _keep_on_device_kwargs(self, shard: Shard, request_id: Optional[str] = None) -> dict:
    """The engine keywords of a mid-ring forward: keep the output on the device when the
    engine can and the next partition is this node or an in-process peer (whose engine
    takes the device tensor as it is)."""
    if shard.is_last_layer or not getattr(self.inference_engine, "supports_device_io", False):
      return {}
    try:
      target_id = self._ring_target_id(self.get_partition_index(offset=1, request_id=request_id),
                                       request_id)
    except Exception:
      return {}
    if target_id == self.id:
      return {"keep_on_device": True}
    peer = next((p for p in self.peers if p.id() == target_id), None)
    if peer is not None and getattr(peer, "accepts_device_arrays", False):
      return {"keep_on_device": True}
    return {}

  async def _fused_decode_loop(self, base_shard: Shard, shard: Shard, request_id: str,
                               buffered: List[int], gen=None, ring_verify=None) -> None:
    """Chunked decode through `gen` (the engine's generate_chunk, or the fused ring's
    call) until EOS or the cap; tokens past EOS inside a chunk are discarded. With
    speculation on (see the module docstring) each round first tries a draft: a
    verified draft yields up to its length plus one tokens, each what greedy decode
    would produce, through the engine's verify_draft, or on the fused ring through
    `ring_verify` alone (the one-shard verify must not touch a segment's state).
    Speculation is for greedy requests whose extras leave the greedy pick as it is:
    penalties and logit_bias change it, and a verify records no logprobs; a seed or
    min_p does not change it."""
    ring = gen is not None
    gen = gen or self.inference_engine.generate_chunk
    s = self._request_sampling.get(request_id)
    attach = getattr(self.inference_engine, "attach_sampling", None)
    if s and attach is not None and not ring:
      # A prefill that sampled on the host (multimodal) bound no extras to the request's
      # decode state: bind them now, the first token counted, so the chunks apply the
      # bias and seed and record logprobs like a text request's.
      try:
        await attach(shard, request_id, s, sampled_tokens=tuple(buffered))
      except Exception as e:
        if DEBUG >= 1:
          print(f"[{request_id}] attach_sampling failed: {e!r}")
    reshaping = set(s or ()) & {"presence_penalty", "frequency_penalty", "logit_bias", "logprobs"}
    verify = None
    if self.speculate_tokens > 0 and self._temp_for(request_id) == 0 and not reshaping:
      verify = ring_verify if ring else getattr(self.inference_engine, "verify_draft", None)
    # The draft's source, prompt and output, appended as tokens arrive.
    spec_context = (list(self._request_prompt_tokens.get(request_id, ())) + list(buffered)
                    if verify is not None else [])
    spec_strikes = 0
    try:
      self.outstanding_requests[request_id] = "generating"
      size = self.decode_chunk_size
      while True:
        if request_id in self._cancelled:
          await self._finish_generation(request_id)
          return
        limit = self._request_max_tokens.get(request_id, self.max_generate_tokens)
        remaining = max(1, limit - len(buffered))
        if verify is not None:
          k = min(self.speculate_tokens, remaining)
          drafter = (getattr(self.inference_engine, "draft_tokens", None)
                     if self.draft_model else None)
          if drafter is not None and len(self.outstanding_requests) > 1:
            # Under concurrency the batched chunk already shares the weight read; a
            # draft's forwards would add executor work of their own. The lookup stays.
            drafter = None
          draft = list(await drafter(request_id, spec_context, k)) if drafter else []
          if not draft:
            draft = _lookup_draft(spec_context, k, self.speculate_window)
          if len(draft) >= 2:
            accepted = await verify(request_id, shard, buffered[-1], draft)
            if accepted:
              # Two bonus-only rounds in a row: the text repeats n-grams that continue
              # differently, and each round would pay a forward for one token.
              if len(accepted) == 1:
                spec_strikes += 1
                if spec_strikes >= 2:
                  verify = None
              else:
                spec_strikes = 0
              spec_context.extend(accepted)
              if self._ingest_sampled_tokens(request_id, accepted, buffered, base_shard):
                await self._finish_generation(request_id)
                return
              continue
        # Never compute far past the cap: the last chunk shrinks to the next power
        # of two covering what the cap still allows.
        this_size = min(size, 1 << (remaining - 1).bit_length())
        rem_after = remaining - this_size
        next_hint = (min(min(size * 2, self.max_decode_chunk_size),
                         1 << (rem_after - 1).bit_length()) if rem_after >= 1 else None)
        chunk = await gen(
          request_id, shard, buffered[-1], this_size, temp=self._temp_for(request_id),
          top_k=self.default_sample_top_k, top_p=self._top_p_for(request_id), next_size=next_hint)
        if chunk is None:
          # An engine that cannot decode this shard in chunks, or a fused ring that
          # declined (lockstep broken, no room for the chunk): the per-token ring.
          await self._forward_next_token(base_shard, request_id, buffered, None)
          return
        new_tokens = np.asarray(chunk).reshape(-1).tolist()
        if verify is not None:
          spec_context.extend(int(t) for t in new_tokens)
        if self._ingest_sampled_tokens(request_id, new_tokens, buffered, base_shard):
          await self._finish_generation(request_id)
          return
        size = min(size * 2, self.max_decode_chunk_size)
    except CacheExhausted as e:
      if DEBUG >= 1:
        print(f"[{request_id}] cache exhausted, finishing as length: {e}")
      await self._finish_as_length(request_id)
    except Exception as e:  # the decode loop's boundary: every peer learns it failed
      print(f"Error in fused decode for [{request_id}]: {e!r}")
      if DEBUG >= 2:
        import traceback
        traceback.print_exc()
      await self._abort_request(request_id, f"fused decode failed on {self.id}: {e!r}")

  async def _forward_next_token(self, base_shard: Shard, request_id: str, buffered: List[int],
                                inference_state: Optional[dict]) -> None:
    """Feed the sampled token back to partition 0 for the next decode step."""
    self.outstanding_requests[request_id] = "waiting"
    await self.forward_tensor(base_shard, np.asarray([[buffered[-1]]], dtype=np.int64), request_id,
                              self.get_partition_index_of_first_layer(), inference_state)

  def _ingest_sampled_tokens(self, request_id: str, new_tokens: List[int], buffered: List[int],
                             base_shard: Optional[Shard] = None) -> bool:
    """Append tokens to the request's buffer, stopping at EOS or the cap, fire the
    callbacks and broadcast the new tokens to the peers. Returns finished."""
    if request_id in self._cancelled:
      return True
    eos = self._request_eos.get(request_id)
    if eos is None:
      eos = self._eos_token_ids(base_shard, request_id)
      if eos:
        self._request_eos[request_id] = eos
    limit = self._request_max_tokens.get(request_id, self.max_generate_tokens)
    trace_ctx = self._request_trace_ctx.get(request_id)
    now = time.monotonic()
    self._note_progress(request_id)
    last = self._last_token_time.get(request_id)
    appended = 0
    finished = False
    for t in new_tokens:
      buffered.append(int(t))
      appended += 1
      if DEBUG >= 2:  # every sampled token, a fused chunk's too
        print(f"[{request_id}] token {int(t)} ({len(buffered)} so far)")
      self.metrics.tokens_total.inc()
      self.tracer.record_token(request_id, trace_ctx)
      if int(t) in eos or len(buffered) >= limit:
        finished = True
        break
    if last is None and appended:
      # The first sampled token on this node: TTFT from this node's first touch.
      started = self._request_started.get(request_id)
      if started is not None:
        self.metrics.ttft.observe(now - started)
    if last is not None and appended:
      self.metrics.token_latency.observe((now - last) / appended)
    self._last_token_time[request_id] = now
    self.buffered_token_output[request_id] = (buffered, finished)
    self.trigger_on_token_callbacks(request_id, buffered, finished)
    if self.peers:
      # A delta: only the new tokens cross the wire; total_len lets a peer that missed
      # one ask for the full list. full_ref is the live buffer, which outlives the
      # buffered_token_output entry that _finish_generation pops.
      self._spawn(self.broadcast_result(request_id, buffered[len(buffered) - appended:], finished,
                                        total_len=len(buffered), full_ref=buffered))
    return finished

  async def _finish_generation(self, request_id: str) -> None:
    self.finish_request_state(request_id)
    self.buffered_token_output.pop(request_id, None)
    await self.inference_engine.clear_request(request_id)

  async def _finish_as_length(self, request_id: str) -> None:
    """End a request whose cache filled as a normal 'length' completion, on every
    peer."""
    tokens, _ = self.buffered_token_output.get(request_id, ([], False))
    self.buffered_token_output[request_id] = (tokens, True)
    self.trigger_on_token_callbacks(request_id, tokens, True)
    await self.broadcast_result(request_id, tokens, True)
    await self._finish_generation(request_id)

  async def _abort_request(self, request_id: str, error: str) -> None:
    """End a request after an error, here and on every peer: the finish broadcast
    carries the error, so the API node reports it and mid-ring peers free the
    request's state."""
    self.record_request_error(request_id, error)
    self.metrics.requests_failed_total.inc()
    # The request's flight timeline, frozen before the cleanup churns it.
    self.flight.record("request.aborted", request_id, error=error[:200])
    self.flight.freeze(request_id, reason=error[:200])
    self._mark_cancelled(request_id)
    tokens, _ = self.buffered_token_output.get(request_id, ([], False))
    self.trigger_on_token_callbacks(request_id, tokens, True)
    await self.broadcast_result(request_id, tokens, True, error=error)
    await self._finish_generation(request_id)

  async def cancel_request(self, request_id: str) -> None:
    """Stop a request with the tokens produced so far (client gone, stop sequence):
    here at the next chunk or token, on the other peers through the finish
    broadcast."""
    if request_id not in self.outstanding_requests and request_id not in self.buffered_token_output:
      return
    self._mark_cancelled(request_id)
    tokens, _ = self.buffered_token_output.get(request_id, ([], False))
    self.buffered_token_output[request_id] = (tokens, True)
    self.trigger_on_token_callbacks(request_id, tokens, True)
    self._spawn(self.broadcast_result(request_id, [], True, total_len=len(tokens), full_ref=tokens))

  def _mark_cancelled(self, request_id: str) -> None:
    self._cancelled[request_id] = None
    self._cancelled.move_to_end(request_id)
    while len(self._cancelled) > 512:
      self._cancelled.popitem(last=False)

  def record_request_error(self, request_id: str, error: str) -> None:
    self.request_errors[request_id] = error
    while len(self.request_errors) > 512:
      self.request_errors.popitem(last=False)

  def note_hop_delivery(self, request_id: Optional[str], hop_seq: Optional[str]) -> bool:
    """Receiver-side dedup of retried hops: False when this (request, seq) was already
    delivered (the sender lost the ack and sent again). The seen-sets outlive the
    request in a bounded LRU, so a retry landing after the finish is dropped too."""
    if hop_seq is None:
      return True
    key = request_id or ""
    seen = self._hop_seen.get(key)
    if seen is None:
      seen = self._hop_seen[key] = OrderedDict()
      while len(self._hop_seen) > 256:
        self._hop_seen.popitem(last=False)
    self._hop_seen.move_to_end(key)
    if hop_seq in seen:
      self.metrics.dedup_drops_total.inc()
      self.flight.record("hop.dedup_drop", request_id, seq=hop_seq)
      if DEBUG >= 2:
        print(f"[{request_id}] duplicate hop delivery {hop_seq} dropped")
      return False
    seen[hop_seq] = None
    while len(seen) > 128:
      seen.popitem(last=False)
    return True

  def finish_request_state(self, request_id: str) -> None:
    """Release the request's bookkeeping (idempotent): on the sampler when it
    finishes, on every other peer when the finish broadcast arrives."""
    self.outstanding_requests.pop(request_id, None)
    self.metrics.active_requests.set(len(self.outstanding_requests))
    self.tracer.finish_request(request_id)
    started = self._request_started.pop(request_id, None)
    if started is not None:
      elapsed = time.monotonic() - started
      self.metrics.request_latency.observe(elapsed)
      self.flight.record("request.finished", request_id, secs=round(elapsed, 4))
    ctx = self._request_trace_ctx.pop(request_id, None)
    if ctx is not None and ctx.sampled and self.tracer.enabled and self.peers:
      # This node's spans of the request go to every peer, so /v1/traces on any node
      # holds the ring's whole trace; the ctx pop makes it once a request.
      self._spawn(self._flush_trace_spans(request_id, ctx.trace_id))
    was_origin = request_id in self._anatomy_origin
    self._anatomy_origin.pop(request_id, None)
    if ctx is not None and was_origin and self.anatomy.enabled and self.tracer.enabled:
      self._spawn(self._assemble_anatomy(request_id, ctx.trace_id))
    self._last_token_time.pop(request_id, None)
    self._request_max_tokens.pop(request_id, None)
    self._request_temp.pop(request_id, None)
    self._request_top_p.pop(request_id, None)
    self._request_sampling.pop(request_id, None)
    self._request_eos.pop(request_id, None)
    self._request_prompt_tokens.pop(request_id, None)
    self._request_ring_map.pop(request_id, None)
    self._request_deadline.pop(request_id, None)
    self._last_progress.pop(request_id, None)
    self._stall_deferred.discard(request_id)

  def trigger_on_token_callbacks(self, request_id: str, tokens: List[int], is_finished: bool) -> None:
    self.on_token.trigger_all(request_id, tokens, is_finished)

  def _temp_for(self, request_id: str) -> float:
    return self._request_temp.get(request_id, self.default_sample_temp)

  def _top_p_for(self, request_id: str) -> float:
    return self._request_top_p.get(request_id, 0.0)

  def _sampling_kwargs(self, request_id: str) -> dict:
    """The engine's `sampling` keyword for a request with extras; none for a plain one."""
    sampling = self._request_sampling.get(request_id)
    return {"sampling": sampling} if sampling else {}

  def pop_request_logprobs(self, request_id: str, n: Optional[int] = None) -> Optional[list]:
    """Drain the engine's logprob entries for a request (OpenAI `logprobs`). None when
    this peer's engine recorded none: a plain request, or a ring where another peer
    samples (the token broadcast carries ids only)."""
    return self.inference_engine.pop_logprobs(request_id, n)

  def _clamp_max_tokens(self, cap: Any) -> int:
    return max(1, min(int(cap), self.max_generate_tokens))

  def _eos_token_ids(self, base_shard: Optional[Shard] = None,
                     request_id: Optional[str] = None) -> Tuple[int, ...]:
    """EOS ids of the request's model: from the engine's context for this peer's
    shard, else from its tokenizer and config."""
    per_shard = getattr(self.inference_engine, "eos_token_ids_for", None)
    if base_shard is not None and per_shard is not None:
      ids = per_shard(self.get_current_shard(base_shard, request_id=request_id))
      if ids:
        return tuple(ids)
    tokenizer = getattr(self.inference_engine, "tokenizer", None)
    eos = getattr(tokenizer, "eos_token_id", None) if tokenizer else None
    cfg = getattr(self.inference_engine, "cfg", None)
    from_cfg = tuple(getattr(cfg, "eos_token_ids", ()) or ()) if cfg else ()
    return tuple(((eos,) if eos is not None else ()) + from_cfg)

  # -------------------------------------------------------------- routing

  def _set_ring_map(self, request_id: str, ring_map) -> None:
    self._request_ring_map[request_id] = [(str(n), int(s), int(e)) for n, s, e in ring_map]
    self._request_ring_map.move_to_end(request_id)
    while len(self._request_ring_map) > 512:
      self._request_ring_map.popitem(last=False)

  def _ring_entries(self, request_id: Optional[str]):
    """The request's pinned [node_id, start, end] rows, or None."""
    if not request_id:
      return None
    rows = self._request_ring_map.get(request_id)
    if rows is not None:
      self._request_ring_map.move_to_end(request_id)
    return rows

  def _pin_ring_map(self, base_shard: Shard, request_id: str) -> None:
    """Pin the request's partition map from this node's current view (the node that
    first accepts a request)."""
    if request_id in self._request_ring_map:
      return
    partitions = self.partitioning_strategy.partition(self.topology)
    shards = map_partitions_to_shards(partitions, base_shard.n_layers, base_shard.model_id)
    self._set_ring_map(request_id, [(p.node_id, s.start_layer, s.end_layer)
                                    for p, s in zip(partitions, shards)])

  def get_partition_index(self, offset: int = 0, request_id: Optional[str] = None) -> int:
    entries = self._ring_entries(request_id)
    if entries is not None:
      current = next((i for i, (n, _, _) in enumerate(entries) if n == self.id), None)
      if current is None:
        raise ValueError(f"Node {self.id} is not in request {request_id}'s ring map")
      return (current + offset) % len(entries)
    partitions = self.partitioning_strategy.partition(self.topology)
    current = next((i for i, p in enumerate(partitions) if p.node_id == self.id), None)
    if current is None:
      raise ValueError(f"No partition found for node {self.id}")
    return (current + offset) % len(partitions)

  def get_partition_index_of_first_layer(self) -> int:
    # map_partitions_to_shards gives layer 0 to partitions[0], in the live view and
    # in every pinned ring map.
    return 0

  def get_current_shard(self, base_shard: Shard, index: Optional[int] = None,
                        request_id: Optional[str] = None) -> Shard:
    entries = self._ring_entries(request_id)
    if entries is not None:
      if index is None:
        index = self.get_partition_index(request_id=request_id)
      _, start, end = entries[index]
      return Shard(base_shard.model_id, start, end, base_shard.n_layers)
    if index is None:
      index = self.get_partition_index()
    partitions = self.partitioning_strategy.partition(self.topology)
    return map_partitions_to_shards(partitions, base_shard.n_layers, base_shard.model_id)[index]

  async def _peer_by_id(self, target_id: str) -> Optional[PeerHandle]:
    """The hop's peer handle; one on-demand reconcile covers a peer that discovery
    knows and the periodic reconcile has not adopted yet."""
    peer = next((p for p in self.peers if p.id() == target_id), None)
    if peer is not None:
      return peer
    await self.update_peers()
    return next((p for p in self.peers if p.id() == target_id), None)

  def _ring_target_id(self, target_index: int, request_id: Optional[str]) -> str:
    entries = self._ring_entries(request_id)
    if entries is not None:
      return entries[target_index][0]
    return self.partitioning_strategy.partition(self.topology)[target_index].node_id

  async def forward_prompt(self, base_shard: Shard, prompt: str, request_id: str, target_index: int,
                           images: Optional[List[np.ndarray]] = None) -> None:
    if DEBUG >= 1:
      print(f"Forwarding prompt [{request_id}] to partition {target_index}")
    target_id = self._ring_target_id(target_index, request_id)
    if target_id == self.id:
      await self._process_prompt(base_shard, prompt, request_id, images)
      return
    peer = await self._peer_by_id(target_id)
    if peer is None:
      raise ValueError(f"Peer for {target_index} ({target_id}) not found")
    ctx = self._request_trace_ctx.get(request_id)
    dl = self._request_deadline.get(request_id)
    await peer.send_prompt(self.get_current_shard(base_shard, target_index, request_id=request_id),
                           prompt, request_id, traceparent=ctx.traceparent() if ctx else None,
                           max_tokens=self._request_max_tokens.get(request_id), images=images,
                           temperature=self._request_temp.get(request_id),
                           top_p=self._request_top_p.get(request_id),
                           ring_map=self._ring_entries(request_id),
                           deadline=max(0.0, dl - time.monotonic()) if dl is not None else None)

  async def forward_tensor(self, base_shard: Shard, tensor, request_id: str, target_index: int,
                           inference_state: Optional[dict] = None) -> None:
    """Hand `tensor` to partition `target_index`, with the request's ring map and
    settings in `inference_state`. A hop to this node is spawned, not awaited: a
    direct call would grow one coroutine chain per token."""
    target_id = self._ring_target_id(target_index, request_id)
    state = dict(inference_state or {})
    ctx = self._request_trace_ctx.get(request_id)
    if ctx is not None:
      state[TRACEPARENT_KEY] = ctx.traceparent()
    ring_rows = self._ring_entries(request_id)
    if ring_rows is not None:
      state[RING_MAP_KEY] = ring_rows
    for key, table in ((MAX_TOKENS_KEY, self._request_max_tokens), (TEMP_KEY, self._request_temp),
                       (TOP_P_KEY, self._request_top_p), (SAMPLING_KEY, self._request_sampling)):
      if request_id in table:
        state[key] = table[request_id]
    dl = self._request_deadline.get(request_id)
    if dl is not None:
      state[DEADLINE_KEY] = max(0.0, dl - time.monotonic())
    if target_id == self.id:
      self._spawn(self.process_tensor(base_shard, tensor, request_id, state))
      return
    peer = await self._peer_by_id(target_id)
    if peer is None:
      raise ValueError(f"Peer for {target_index} ({target_id}) not found")
    if not getattr(peer, "accepts_device_arrays", False) and not isinstance(tensor, np.ndarray):
      # A peer across a wire: a tensor kept on the device comes to the host here and
      # only here (a bf16 hidden state stays a CPU tensor, the codec's bf16 frame).
      tensor = tensor.detach().cpu()
      if str(tensor.dtype) != "torch.bfloat16":
        tensor = tensor.numpy()
    await peer.send_tensor(self.get_current_shard(base_shard, target_index, request_id=request_id),
                           tensor, request_id, state)

  # -------------------------------------------------------------- training

  async def enqueue_example(self, base_shard: Shard, example, target, length, train: bool = False,
                            request_id: Optional[str] = None):
    """Route an example to the partition-0 owner: (loss, the input gradient or None).
    The example's ring map is pinned from this node's view, as a serving request's is,
    so that every peer runs the layer range this view gives it, and dropped when the
    example returns."""
    if request_id is None:
      request_id = str(uuid.uuid4())
    self._pin_ring_map(base_shard, request_id)
    try:
      shard = self.get_current_shard(base_shard, request_id=request_id)
      if shard.is_first_layer:
        return await self.process_example(base_shard, example, target, length, train, request_id)
      index = self.get_partition_index_of_first_layer()
      target_id = self._ring_target_id(index, request_id)
      peer = await self._peer_by_id(target_id)
      if peer is None:
        raise ValueError(f"No peer for first-layer partition {index}")
      result = await peer.send_example(
        self.get_current_shard(base_shard, index, request_id=request_id), example, target,
        length, train, request_id, ring_map=self._ring_entries(request_id))
      if result is None:
        raise RuntimeError(f"Peer {target_id} returned no loss for example {request_id}")
      return result
    finally:
      self._request_ring_map.pop(request_id, None)

  async def process_example(self, base_shard: Shard, example, target, length, train: bool = False,
                            request_id: Optional[str] = None, ring_map: Optional[list] = None):
    """This peer's slice of a training or evaluation example, chained down the ring:
    (loss, the gradient of the example's input) when training, (loss, None) else."""
    if request_id is None:
      request_id = str(uuid.uuid4())
    if ring_map and request_id not in self._request_ring_map:
      self._set_ring_map(request_id, ring_map)
    shard = self.get_current_shard(base_shard, request_id=request_id)
    start_ns = time.perf_counter_ns()
    kind = "train_example" if train else "eval_example"
    self._spawn(self.broadcast_opaque_status(request_id, json.dumps({
      "type": "node_status", "node_id": self.id, "status": f"start_{kind}",
      "request_id": request_id})))
    try:
      forward_fn = self._forward_example_fn(base_shard, request_id)
      if train:
        return await self.inference_engine.train_example(request_id, shard, example, target,
                                                         length, forward_fn=forward_fn)
      loss = await self.inference_engine.evaluate_example(request_id, shard, example, target,
                                                          length, forward_fn=forward_fn)
      return loss, None
    finally:
      self._request_ring_map.pop(request_id, None)
      self._spawn(self.broadcast_opaque_status(request_id, json.dumps({
        "type": "node_status", "node_id": self.id, "status": f"end_{kind}",
        "request_id": request_id, "elapsed_time_ns": time.perf_counter_ns() - start_ns})))

  def _forward_example_fn(self, base_shard: Shard, request_id: str):
    """The downstream hop of a pipelined example: the activations to the next
    partition, (loss, the gradient of the activations) back."""
    async def forward(activations, target, length, train: bool):
      next_index = self.get_partition_index(offset=1, request_id=request_id)
      target_id = self._ring_target_id(next_index, request_id)
      if target_id == self.id:
        return await self.process_example(base_shard, activations, target, length, train, request_id)
      peer = await self._peer_by_id(target_id)
      if peer is None:
        raise ValueError(f"No peer for partition {next_index}")
      result = await peer.send_example(
        self.get_current_shard(base_shard, next_index, request_id=request_id), activations,
        target, length, train, request_id, ring_map=self._ring_entries(request_id))
      if result is None:
        raise RuntimeError(f"Peer {target_id} returned no loss for example {request_id}")
      return result
    return forward

  async def _resume_local(self, base_shard: Shard, path: str) -> None:
    try:
      shard = self.get_current_shard(base_shard)
      await self.inference_engine.load_checkpoint(shard, path)
      if DEBUG >= 1:
        print(f"Resumed {shard} from {path}")
    except Exception as e:
      print(f"Resume of {base_shard.model_id} from {path} failed on {self.id}: {e!r}")

  async def coordinate_resume(self, base_shard: Shard, path: str) -> None:
    """Restore a checkpoint across the whole ring: this peer's layer range now, every
    other peer's through a `resume_checkpoint` status (the shard saves share one
    directory), so that no partition restarts fresh beside resumed ones."""
    await self._resume_local(base_shard, path)
    await self.broadcast_opaque_status("", json.dumps({
      "type": "resume_checkpoint", "node_id": self.id, "base_shard": base_shard.to_dict(),
      "path": path}))

  async def _save_local(self, base_shard: Shard, iteration: int, destination: str) -> None:
    shard = self.get_current_shard(base_shard)
    model = base_shard.model_id
    sid = f"{shard.start_layer}-{shard.end_layer}"
    saved = self.checkpoints.setdefault(model, {})
    if saved.get(sid) == iteration:
      return
    saved[sid] = iteration
    path = f"{destination}/{model}/{sid}-{iteration}.safetensors"
    await self.inference_engine.save_checkpoint(shard, path)
    if DEBUG >= 1:
      print(f"Saved checkpoint {path}")

  async def coordinate_save(self, base_shard: Shard, iteration: int, destination: str) -> None:
    """Save the ring's shards at `iteration`: this peer's now, every other peer's through
    a `save_checkpoint` status. A peer's save goes to its engine's executor when the
    status arrives, ahead of the next example the origin sends after this returns."""
    await self._save_local(base_shard, iteration, destination)
    await self.broadcast_opaque_status("", json.dumps({
      "type": "save_checkpoint", "node_id": self.id, "base_shard": base_shard.to_dict(),
      "iteration": iteration, "destination": destination}))

  # ------------------------------------------------------- peers, topology

  async def update_peers(self, wait_for_peers: int = 0) -> bool:
    """Reconcile the peer set with discovery; serialised, since hop-time reconciles
    race the periodic one. Returns whether the set changed."""
    async with self._update_peers_lock:
      return await self._update_peers_locked(wait_for_peers)

  async def _update_peers_locked(self, wait_for_peers: int = 0) -> bool:
    if self.discovery is None:
      return False
    next_peers = await self.discovery.discover_peers(wait_for_peers)
    # An evicted peer stays out for its cooldown while discovery still lists it (its
    # view of liveness can lag a death by many seconds).
    next_peers = [p for p in next_peers if not self._is_evicted(p.id())]
    current_ids = {p.id() for p in self.peers}
    next_ids = {p.id() for p in next_peers}
    peers_added = [p for p in next_peers if p.id() not in current_ids]
    peers_removed = [p for p in self.peers if p.id() not in next_ids]
    # Keep known peers, but adopt discovery's replacement handle when the peer's
    # address changed (re-admitted through a better interface).
    by_id = {p.id(): p for p in next_peers}
    peers_kept = []
    for p in self.peers:
      if p.id() not in next_ids:
        continue
      replacement = by_id[p.id()]
      peers_kept.append(replacement if replacement is not p and replacement.addr() != p.addr() else p)

    async def _connect(peer) -> bool:
      try:
        await asyncio.wait_for(peer.connect(), timeout=5.0)
        return True
      except (OSError, asyncio.TimeoutError) as e:
        if DEBUG >= 1:
          print(f"Failed to connect {peer.id()}: {e!r}")
        return False

    connected = await asyncio.gather(*(_connect(p) for p in peers_added))
    # A peer discovery no longer lists either left (it still answers) or died; a dead
    # one is evicted, counted and barred as the health monitor would have done.
    alive = await asyncio.gather(*(self._answers(p) for p in peers_removed))
    for peer, ok in zip(peers_removed, alive):
      if not ok:
        await self._evict_peer(peer, "reconcile")
        continue
      self._peer_reports.pop(peer.id(), None)
      await peer.disconnect(grace=600.0)
    # Filtered again: an eviction can land during the awaits above (the health monitor
    # does not hold this lock) and must not be undone by this stale snapshot.
    self.peers = [p for p in peers_kept + [p for p, ok in zip(peers_added, connected) if ok]
                  if not self._is_evicted(p.id())]
    for p in self.peers:
      # Hop sends record in this node's flight recorder and carry its clock stamp.
      p.flight = self.flight
      p.clock = self.clock
    self.metrics.peers.set(len(self.peers))
    return bool(peers_added or peers_removed)

  async def periodic_topology_collection(self, interval: float) -> None:
    while True:
      await asyncio.sleep(interval)
      try:
        if await self.update_peers():
          await self.collect_topology(set())
        if self.peers:
          # The cluster metrics rollup rides the topology cadence.
          await self.broadcast_opaque_status("", json.dumps({
            "type": "node_metrics", "node_id": self.id, "metrics": self.metrics_summary()}))
      except Exception as e:  # the loop must outlive one failed round
        if DEBUG >= 1:
          print(f"Topology collection error: {e!r}")

  async def collect_topology(self, visited: set, max_depth: int = 4) -> Topology:
    """Visited-set crawl: this node, its peers, and what each peer reports of itself
    (for a peer up the crawl, which is not asked again, what it reported last)."""
    prev_visited = set(visited)
    next_topology = Topology()
    next_topology.update_node(self.id, self.device_capabilities)
    visited.add(self.id)
    visited.update(p.id() for p in self.peers)
    for peer in self.peers:
      next_topology.update_node(peer.id(), self._peer_reports.get(peer.id(),
                                                                  peer.device_capabilities()))
      next_topology.add_edge(self.id, peer.id(), peer.description())
      if peer.id() in prev_visited or max_depth <= 0:
        continue  # someone up the crawl already asked this peer
      try:
        other = await asyncio.wait_for(peer.collect_topology(set(visited), max_depth - 1), timeout=5.0)
      except Exception as e:  # an unreachable peer keeps what discovery reported of it
        if DEBUG >= 2:
          print(f"collect_topology from {peer.id()} failed: {e!r}")
        continue
      visited.update(other.nodes.keys())
      if peer.id() in other.nodes:
        self._peer_reports[peer.id()] = other.nodes[peer.id()]
      # Only the peer's own edges and capabilities; nodes it learned of are added when
      # unknown here.
      next_topology.merge(peer.id(), other)
      for node_id, caps in other.nodes.items():
        if node_id not in next_topology.nodes:
          next_topology.update_node(node_id, caps)
    self.topology = next_topology
    return next_topology

  # ------------------------------------------------------------ broadcast

  async def broadcast_result(self, request_id: str, result: List[int], is_finished: bool,
                             error: Optional[str] = None, total_len: Optional[int] = None,
                             full_ref: Optional[List[int]] = None) -> None:
    """Send the (delta) tokens to every peer. A peer whose ack reports a gap gets the
    full list once (retried once: for a finished request it is the peer's only chance
    to learn the end)."""
    async def send(peer):
      try:
        ack = await asyncio.wait_for(
          peer.send_result(request_id, result, is_finished, error=error, total_len=total_len),
          timeout=15.0)
        if total_len is not None and isinstance(ack, dict) and ack.get("applied") is False:
          full = list(full_ref) if full_ref is not None else list(result)
          for attempt in (1, 2):
            try:
              await asyncio.wait_for(peer.send_result(request_id, full, is_finished, error=error,
                                                      total_len=len(full)), timeout=15.0)
              break
            except (OSError, asyncio.TimeoutError, RuntimeError):
              if attempt == 2:
                raise
      except Exception as e:  # one peer's failure must not stop the others' delivery
        if DEBUG >= 2:
          print(f"broadcast_result to {peer.id()} failed: {e!r}")
    await asyncio.gather(*(send(p) for p in self.peers))

  async def ingest_remote_result(self, request_id: str, tokens: List[int],
                                 total_len: Optional[int], is_finished: bool,
                                 error: Optional[str] = None) -> Tuple[bool, int]:
    """Receiver side of the token broadcast. Returns (applied, have) for the ack: a gap
    answers applied=False so the sender sends the full list. total_len=None means
    `tokens` is the full list. A send not ahead of what is held is a stale reorder and
    is ignored; anything after the finish is dropped."""
    if request_id in self._finished_results:
      return True, 0
    buffered, _ = self.buffered_token_output.get(request_id, ([], False))
    have = len(buffered)
    if is_finished and not tokens:
      merged = buffered  # an abort from a peer that holds no tokens
    elif total_len is not None and total_len <= have and not is_finished and not error:
      return True, have
    elif total_len is None or total_len == len(tokens):
      merged = list(tokens)
    else:
      start = total_len - len(tokens)
      if have < start:
        if error:
          self.record_request_error(request_id, error)
        return False, have
      merged = buffered[:start] + list(tokens)
    if error:
      self.record_request_error(request_id, error)
    # An applied delta is progress for this peer's watchdog: a peer that neither samples
    # nor receives the next hop hears of a healthy request only through these.
    self._note_progress(request_id)
    self.buffered_token_output[request_id] = (merged, is_finished)
    self.trigger_on_token_callbacks(request_id, merged, is_finished)
    if is_finished:
      # How a non-sampler peer learns the request ended: the sampler's cleanup, the
      # engine's KV state included; the cancel flag stops a loop still running here.
      self._mark_cancelled(request_id)
      self._finished_results[request_id] = None
      while len(self._finished_results) > 512:
        self._finished_results.popitem(last=False)
      await self._finish_generation(request_id)
    return True, len(merged)

  # ------------------------------------------------------- status bus, rollups

  def on_node_status(self, request_id, opaque_status) -> None:
    """The opaque-status bus: a peer's spans of a finished request (the cluster trace
    rollup) and its metric summary (the cluster metrics rollup). A node's own broadcasts
    echo locally and are skipped."""
    try:
      status = json.loads(opaque_status)
    except (TypeError, ValueError) as e:
      if DEBUG >= 2:
        print(f"on_node_status: not JSON: {e!r}")
      return
    if not isinstance(status, dict) or status.get("node_id") == self.id:
      return
    kind = status.get("type", "")
    if kind == "trace_spans":
      self.tracer.ingest(status.get("spans") or [])
    elif kind == "node_metrics" and status.get("node_id"):
      self.ingest_peer_metrics(status["node_id"], status.get("metrics") or {})
    elif kind == "resume_checkpoint":
      # A ring-wide resume: each peer loads its own layer range from the directory.
      self._spawn(self._resume_local(Shard.from_dict(status.get("base_shard", {})),
                                     status.get("path", "")))
    elif kind == "save_checkpoint":
      self._spawn(self._save_local(Shard.from_dict(status.get("base_shard", {})),
                                   int(status.get("iteration", 0)), status.get("destination", "")))

  async def broadcast_opaque_status(self, request_id: str, status: str) -> None:
    async def send(peer):
      try:
        await asyncio.wait_for(peer.send_opaque_status(request_id, status), timeout=15.0)
      except Exception as e:  # one peer's failure must not stop the others' delivery
        if DEBUG >= 2:
          print(f"broadcast_status to {peer.id()} failed: {e!r}")
    await asyncio.gather(*(send(p) for p in self.peers))
    self.on_opaque_status.trigger_all(request_id, status)

  async def _flush_trace_spans(self, request_id: str, trace_id: str) -> None:
    """This node's finished spans of one trace to every peer over the status bus. The
    export filters by node, so spans ingested from peers are never sent again; the
    short sleep lets the spans around the finish close first."""
    await asyncio.sleep(0.05)
    spans = self.tracer.export(trace_id=trace_id, node_id=self.id)
    if spans:
      await self.broadcast_opaque_status(request_id, json.dumps({
        "type": "trace_spans", "node_id": self.id, "request_id": request_id,
        "trace_id": trace_id, "spans": spans}))

  def _peer_hop_rtts(self) -> Dict[str, float]:
    """This node's hop send RTT average in seconds for each peer."""
    out: Dict[str, float] = {}
    for p in self.peers:
      ewma = getattr(p, "hop_rtt", None)
      v = ewma.value() if ewma is not None else None
      if v is not None:
        out[p.id()] = round(v, 6)
    return out

  def ring_offsets_view(self) -> Dict[str, dict]:
    """Every reachable node's clock offset relative to this node, from this node's skew
    estimator and each fresh peer summary's `clock` (anatomy.ring_offsets)."""
    clocks: Dict[str, dict] = {self.id: self.clock.deltas()}
    rtts: Dict[str, Dict[str, float]] = {self.id: self._peer_hop_rtts()}
    for nid, summary in self.peer_metrics.items():
      if self.peer_metrics_stale(nid):
        continue
      clk = summary.get("clock") if isinstance(summary, dict) else None
      if isinstance(clk, dict):
        clocks[nid] = clk.get("deltas") or {}
        if isinstance(clk.get("hop_rtt_s"), dict):
          rtts[nid] = clk["hop_rtt_s"]
    return ring_offsets(self.id, clocks, rtts)

  async def _assemble_anatomy(self, request_id: str, trace_id: str) -> None:
    """The origin's stage breakdown of one finished request: after a delay for the
    peers' span shards to arrive, the trace re-based onto this clock, swept off the
    event loop (it is quadratic-ish in the spans), into the reservoir."""
    await asyncio.sleep(self._anatomy_delay_s)
    try:
      spans = self.tracer.export(trace_id=trace_id)
      if not spans:
        return
      offsets = self.ring_offsets_view()
      breakdown = await asyncio.get_running_loop().run_in_executor(
        None, extract_breakdown, spans, offsets, request_id, trace_id)
      if breakdown is None:
        return
      self.anatomy.add(breakdown)
      self.flight.record("anatomy.breakdown", request_id, e2e_s=breakdown["e2e_s"],
                         stages=len(breakdown["stages"]),
                         unattributed_s=breakdown["stages"]["unattributed"]["secs"])
    except Exception as e:  # best effort: a failed assembly must not fail anything else
      if DEBUG >= 1:
        print(f"[{request_id}] anatomy assembly failed: {e!r}")

  def spool_flight(self, reason: str = "") -> Optional[str]:
    """Post-mortem spool: the flight ring and frozen snapshots as JSON into
    XOT_FLIGHT_DUMP_DIR (no-op when unset); main calls it on SIGTERM/SIGINT."""
    dump_dir = knobs.get_str("XOT_FLIGHT_DUMP_DIR")
    if not dump_dir:
      return None
    return self.flight.dump_to(dump_dir, reason=reason)

  def metrics_summary(self) -> dict:
    """This node's compact metric summary for the cluster rollup: what rides the status
    bus and what /v1/cluster/metrics serves per node, with the clock, perf, alert,
    admission and history compacts of what is enabled."""
    summary = self.metrics.summary()
    summary["node_id"] = self.id
    summary["ts"] = time.time()
    if self.clock.enabled:
      summary["clock"] = {"deltas": self.clock.deltas(), "hop_rtt_s": self._peer_hop_rtts()}
    perf_fn = getattr(self.inference_engine, "perf_compact", None)
    perf = perf_fn() if callable(perf_fn) else None
    if perf is not None:
      summary["perf"] = perf
    if self.alerts.enabled:
      summary["alerts"] = self.alerts.compact()
    if self.admission.enabled:
      summary["admission"] = self.admission.compact()
    if self.history.enabled:
      summary["history"] = self.history.compact()
    return summary

  async def prefetch_prompt(self, base_shard: Shard, prompt: str) -> bool:
    """Start the engine's host-to-device prefix restore for a prompt that is still
    queued (at the admission gate, or announced by /v1/prefetch), so that by admission
    its warm prefix is resident and it prefills only the rest. Best effort and free of
    side effects on a miss: an engine without the hook or without a host tier reports
    False. A prompt prefetched within the last 30 s is not prefetched again."""
    hook = getattr(self.inference_engine, "prefetch_host_prefix", None)
    if hook is None:
      return False
    try:
      shard = self.get_current_shard(base_shard)
      key = (shard, hash(prompt))
      now = time.monotonic()
      last = self._prefetch_recent.get(key)
      if last is not None and now - last < 30.0:
        return False
      self._prefetch_recent[key] = now
      self._prefetch_recent.move_to_end(key)
      while len(self._prefetch_recent) > 128:
        self._prefetch_recent.popitem(last=False)
      return bool(await hook(shard, prompt))
    except Exception as e:
      if DEBUG >= 1:
        print(f"anticipatory prefix prefetch failed (cold prefill instead): {e!r}")
      return False

  def ingest_peer_metrics(self, node_id: str, summary: dict) -> None:
    self.peer_metrics[node_id] = summary
    self.peer_metrics.move_to_end(node_id)
    self._peer_metrics_at[node_id] = time.monotonic()
    while len(self.peer_metrics) > 64:
      evicted_id, _ = self.peer_metrics.popitem(last=False)
      self._peer_metrics_at.pop(evicted_id, None)

  def peer_metrics_stale(self, node_id: str) -> bool:
    """True when a peer's last summary is older than 3x the topology cadence (three
    missed ticks: its row is history, not signal)."""
    at = self._peer_metrics_at.get(node_id)
    if at is None:
      return True
    return time.monotonic() - at > 3.0 * max(0.1, self.topology_interval)

  def cluster_metrics_view(self) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """(nodes, aggregate) for /v1/cluster/metrics: this node's summary and each peer's
    latest, stale rows marked and left out of the ring-wide percentiles."""
    nodes: Dict[str, dict] = {self.id: self.metrics_summary()}
    for node_id, summary in self.peer_metrics.items():
      if node_id in nodes:
        continue
      if self.peer_metrics_stale(node_id):
        summary = {**summary, "stale": True}
      nodes[node_id] = summary
    aggregate = aggregate_histograms([s for s in nodes.values() if not s.get("stale")])
    return nodes, aggregate
