"""Registry of the `XOT_*` environment knobs the port reads.

The port's own copy of xotorch_tpu/utils/knobs.py: the same accessors (`raw`,
`get_str`, `get_int`, `get_float`, `get_bool`) with the same names and defaults, over
only the knobs this package reads. A name missing here raises `UnknownKnobError` at
the read site instead of silently returning a default.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


class UnknownKnobError(KeyError):
  """An env read referenced an `XOT_*` name that is not registered."""


@dataclass(frozen=True)
class Knob:
  name: str
  kind: str  # "int" | "float" | "bool" | "str" | "path" | "json"
  default: Optional[str]  # env-string form; None = unset
  doc: str


_DEFS: Tuple[Knob, ...] = (
  Knob("XOT_DTYPE", "str", "bfloat16", "Model compute/weight dtype."),
  Knob("XOT_CACHE_LEN", "int", "2048", "Initial per-request KV-cache length (tokens); grows geometrically when exceeded."),
  Knob("XOT_MAX_CACHE_LEN", "int", "32768", "Hard ceiling for per-request KV-cache growth (tokens)."),
  Knob("XOT_PREFILL_CHUNK", "int", "4096", "Prefill chunk length (tokens): prompts longer than this prefill in chunks."),
  Knob("XOT_SCAN_PREFILL", "bool", "1", "Use the lax.scan prefill over equal chunks (one compile for any chunk count)."),
  Knob("XOT_DECODE_CHUNK", "int", "8", "Tokens per fused decode dispatch on a single-partition ring; 1 = per-token ring."),
  Knob("XOT_DECODE_CHUNK_MAX", "int", "64", "Adaptive fused-decode chunk ceiling (doubles per dispatch up to this)."),
  Knob("XOT_FLASH_BLOCK_Q", "int", "128", "K1's query rows a block (positions x query heads of one kv head): 64 or 128. At head_dim 256 K1 takes 64 whatever this says."),
  Knob("XOT_FLASH_BLOCK_K", "int", "128", "K1's keys a shared-memory tile: 64 or 128. At head_dim 256 K1 takes 64 whatever this says."),
  Knob("XOT_FD_BLOCK_Q", "int", "128", "K2/K2q's query rows a block on segments at T > 1 (positions x query heads of one kv head): 64 or 128. At head_dim 256 K2/K2q take 64 whatever this says."),
  Knob("XOT_FD_BLOCK_K", "int", "256", "The most keys one K2/K2q decode split reads (a CUDA block of split-K flash-decoding): a positive multiple of 64."),
  Knob("XOT_SEED", "int", None, "Sampling PRNG seed; unset derives one from wall-clock time."),
  Knob("XOT_MAX_RESIDENT_REQUESTS", "int", "8", "Max request states resident per shard context before LRU eviction."),
  Knob("XOT_MAX_RESIDENT_MODELS", "int", "2", "Max model shard contexts resident before LRU eviction of whole models."),
  Knob("XOT_OVERLAP_CHUNKS", "bool", "1", "Overlap fused-decode chunk N+1 dispatch with chunk N host readback."),
  Knob("XOT_OVERLAP_BATCH", "bool", "0", "Overlap batched-decode dispatch with readback (two in-flight batches)."),
  Knob("XOT_DECODE_BATCH", "int", "8", "Max concurrent requests fused into one batched decode dispatch."),
  Knob("XOT_BATCH_WINDOW_MS", "float", "0", "Batching window (ms) the decode batcher waits to coalesce submitters; 0 = one event-loop tick."),
  Knob("XOT_PAGED_KV", "bool", "0", "Serve decode from the shared paged KV pool instead of contiguous per-request caches."),
  Knob("XOT_KV_PAGE", "int", "128", "Page size (tokens) of the paged KV pool: any page of one or more tokens (K3/K4 read a multiple of 64 a page a tile, any other page an id a row)."),
  Knob("XOT_KV_POOL_TOKENS", "int", "0", "Total paged-pool capacity in tokens; 0 sizes it automatically."),
  Knob("XOT_PAGED_PREFILL", "bool", "1", "Prefill straight into pool pages under XOT_PAGED_KV (no contiguous commit copy)."),
  Knob("XOT_PAGED_KERNEL", "bool", None, "Paged attention through K3/K4 (K3q/K4q); unset and `1` take the kernels. `0` (the JAX package's gathered view) is not ported and the engine raises when it is built."),
  Knob("XOT_RAGGED_PREFILL", "bool", "1", "Paged T>1 segments read pages natively through K4 (K4q). Reserved: `0` (the JAX package's gathered view) is not ported and the engine raises."),
  Knob("XOT_PAGED_SPEC", "bool", "1", "Draft verification runs native to the page arena (ragged query over the request's page table); 0 restores unpage-then-verify."),
  Knob("XOT_KV_DEFRAG", "bool", "1", "Page-pool defragmentation in batcher-idle slots: migrate high pages into low free holes and rewrite only the virtual maps."),
  Knob("XOT_KV_DEFRAG_MAX_MOVES", "int", "8", "Max page migrations per idle defrag pass."),
  Knob("XOT_PREFILL_COSCHED", "bool", "1", "Co-schedule chunked prefill slices through the decode batcher's drain cycle."),
  Knob("XOT_PREFILL_CHUNK_BUDGET", "int", "1", "Prefill segments admitted per decode drain cycle under co-scheduling."),
  Knob("XOT_KV_HOST_BYTES", "int", "268435456", "Host-RAM budget (bytes) for the spilled warm-prefix KV tier; 0 disables."),
  Knob("XOT_PREFIX_CACHE", "int", "2", "Prefix-cache entries kept per context (LRU); 0 disables prefix caching."),
  Knob("XOT_PREFIX_CACHE_MIN", "int", "32", "Minimum matched prefix length (tokens) worth reusing from the cache."),
  Knob("XOT_SPECULATE", "int", "0", "Speculative draft depth (tokens per round); 0 disables (8 implied by XOT_DRAFT_MODEL)."),
  Knob("XOT_SPECULATE_WINDOW", "int", "2048", "Backward scan window (tokens) for prompt-lookup draft matching."),
  Knob("XOT_DRAFT_MODEL", "str", None, "Resident draft model id for model-based speculative decoding."),
  Knob("XOT_DRAFT_RETRY_S", "float", "300", "Cooldown (s) before retrying a draft model that failed to load."),
  Knob("XOT_SPEC_EWMA_S", "float", "60", "Time constant (s) of the xot_spec_accept_rate EWMA gauge."),
  Knob("XOT_QUANTIZE", "str", None, "Weight quantization mode (`int8` or `int4`); unset serves full precision."),
  Knob("XOT_KV_QUANT", "str", None, "KV-cache quantization mode (`int8`); unset keeps KV in compute dtype."),
  Knob("XOT_INT4_KERNEL", "str", "1", "int4 decode GEMV kernel (K5/K5v4): always taken on the card, a serving mesh's positions included (each on its own slice); `force` takes its function on the CPU too (plain version); `0`, which the JAX package sets only because GSPMD cannot split its kernel, is reserved and acts as `1`."),
  Knob("XOT_INT4_V", "int", "1", "int4 kernel variant: 1-3 the exact W4A16 kernel (K5), 4 the W4A8 kernel (K5v4)."),
  Knob("XOT_INT8_KERNEL", "str", "0", "W8A8 decode GEMV kernel (K6): `1` on the card, `0` off, `force` its function on the CPU too (plain version)."),
  Knob("XOT_TP", "int", None, "Tensor-parallel width of each ring partition's serving mesh (primary knob; overrides XOT_SERVE_TP). 0 forces single-device; unset defers to XOT_SERVE_TP."),
  Knob("XOT_SERVE_TP", "int", None, "Tensor-parallel degree for serving; unset auto-selects from local devices."),
  Knob("XOT_SERVE_SP", "int", "0", "Sequence-parallel degree for long-prompt serving prefill."),
  Knob("XOT_SERVE_EP", "int", "0", "Expert-parallel degree for MoE serving."),
  Knob("XOT_VIRTUAL_DEVICES", "int", "0", "The port's local devices as the engine's one device repeated N times (a mesh whose positions share one card, or the CPU); 0 = the real devices (every CUDA card, or the CPU once)."),
  Knob("XOT_COORDINATOR", "str", None, "Multi-host coordinator address (`host:port`) of process 0; setting it implies multi-host."),
  Knob("XOT_MULTIHOST", "bool", "0", "Force multi-host initialization (torch.distributed's `env://`, which a launcher sets)."),
  Knob("XOT_NUM_PROCESSES", "int", None, "Process count for multi-host init (required with XOT_COORDINATOR)."),
  Knob("XOT_PROCESS_ID", "int", None, "This process's index for multi-host init (required with XOT_COORDINATOR)."),
  Knob("XOT_LORA_RANK", "int", "0", "LoRA adapter rank for training; 0 trains/serves without LoRA."),
  Knob("XOT_LORA_TARGETS", "str", None, "LoRA target set; `all` extends adapters to MLP slots (default attention-only)."),
  Knob("XOT_ADAPTERS", "str", None, "Comma-separated `name=path` list of LoRA adapters to serve (multi-LoRA)."),
  Knob("XOT_LR", "float", "1e-5", "Training learning rate."),
  Knob("XOT_SAVE_OPT_STATE", "bool", "1", "Persist/restore optimizer state across training checkpoints."),
  Knob("XOT_HOP_RETRIES", "int", "2", "Retries per ring hop on transient transport failures; 0 = fail-fast."),
  Knob("XOT_HOP_BACKOFF_S", "float", "0.05", "Base backoff (s) for hop retries (exponential + jitter)."),
  Knob("XOT_REQUEST_DEADLINE_S", "float", "0", "End-to-end request deadline (s); remaining budget rides the hops. 0 disables."),
  Knob("XOT_STALL_TIMEOUT_S", "float", "30", "Per-node stall watchdog: abort a request with no progress for this long. A mid-dispatch local engine (compiles included) defers the abort, bounded at 4x. 0 disables."),
  Knob("XOT_HEALTH_INTERVAL_S", "float", "5", "Peer health-check cadence (s); 0 disables the health monitor."),
  Knob("XOT_HEALTH_FAILS", "int", "2", "Consecutive failed health checks before a peer is evicted."),
  Knob("XOT_EVICT_COOLDOWN_S", "float", "30", "Seconds an evicted peer stays barred from re-admission by discovery."),
  Knob("XOT_REQUEST_RESTARTS", "int", "0", "One-shot transparent API restarts after a ring failure (streaming qualifies until its first content chunk)."),
  Knob("XOT_FAULT_SPEC", "json", None, "Test-only: JSON fault-injection rules applied at the peer-handle boundary."),
  Knob("XOT_MAX_SEQ_LEN", "int", None, "Override the model's maximum sequence length (RoPE/table sizing)."),
  Knob("XOT_HOME", "path", None, "Root directory for downloads and state; unset uses `~/.xot_tpu`."),
  Knob("XOT_MODEL_DIR", "path", None, "Local directory of model checkpoints (offline serving)."),
  Knob("XOT_PROBE_TIMEOUT", "float", "120", "Timeout (s) for the device-capability probe; past it a node reports its host's capabilities."),
  Knob("XOT_MAX_INFLIGHT", "int", "0", "Bounded admission: max requests admitted into the ring concurrently by the origin node's API; 0 disables the gate (today's behavior)."),
  Knob("XOT_ADMIT_QUEUE_DEPTH", "int", "32", "Bounded admission queue: over-limit requests wait here (FIFO); beyond it they are rejected with HTTP 429 + Retry-After."),
  Knob("XOT_ROUTER_POLL_S", "float", "2", "Router: cadence (s) for polling each replica's /v1/alerts, /v1/queue, and /healthcheck."),
  Knob("XOT_ROUTER_PROBE_TOKENS", "int", "2", "Router: max_tokens of the synthetic canary completion sent to a probing replica."),
  Knob("XOT_ROUTER_PROBES", "int", "2", "Router: consecutive successful canaries required before a drained replica is readmitted."),
  Knob("XOT_ROUTER_MIN_OUT_S", "float", "10", "Router: minimum seconds a drained replica stays out before readmission; doubles (bounded 8x) when the replica flaps."),
  Knob("XOT_ROUTER_FLAP_S", "float", "60", "Router: a re-drain within this many seconds of a readmission counts as flapping (escalates the out-time hysteresis)."),
  Knob("XOT_ROUTER_SPILL_DEPTH", "int", "2", "Router: spill a request to the least-loaded healthy replica when its affinity replica's admission queue is at least this deep."),
  Knob("XOT_ROUTER_TIMEOUT_S", "float", "300", "Router: total proxy timeout (s) for one forwarded request."),
  Knob("XOT_ROUTER_DRIFT", "bool", "1", "Router: compare each replica's /v1/history trailing gauges against the fleet median and treat a chronic drifter as a drain-eligible perf_drift suspect."),
  Knob("XOT_ROUTER_DRIFT_POLLS", "int", "3", "Router: consecutive poll ticks a replica must deviate from the fleet median before it is named perf_drift."),
  Knob("XOT_ROUTER_HEDGE_PCT", "float", "0", "Router: request-hedging budget as a percentage of proxied requests (a still-unstarted request is duplicated to the least-loaded other replica, first byte wins); 0 disables hedging."),
  Knob("XOT_ROUTER_HEDGE_FACTOR", "float", "2", "Router: hedge delay as a multiple of the fleet's trailing request p99 (median of routable replicas' /v1/history compacts)."),
  Knob("XOT_ROUTER_HEDGE_MIN_S", "float", "0.5", "Router: hedge-delay floor (s); also the delay used while the fleet has no trailing p99 history yet."),
  Knob("XOT_FLEET_MIN", "int", "1", "Fleet controller: minimum replica slots kept spawned (the template's initially-active set)."),
  Knob("XOT_FLEET_MAX", "int", "0", "Fleet controller: maximum concurrently active replica slots; 0 means every slot in the template."),
  Knob("XOT_FLEET_UP_QUEUE", "int", "1", "Fleet controller: scale up when the fleet-wide admission-queue high-water mark is at least this deep for XOT_FLEET_UP_POLLS consecutive ticks."),
  Knob("XOT_FLEET_UP_POLLS", "int", "3", "Fleet controller: consecutive controller ticks the queue-depth signal must hold before a scale-up actuates."),
  Knob("XOT_FLEET_IDLE_POLLS", "int", "60", "Fleet controller: consecutive idle ticks (no queue, no inflight fleet-wide) before a controller-scaled spare replica is retired via the drain path."),
  Knob("XOT_FLEET_DEAD_POLLS", "int", "3", "Fleet controller: consecutive unreachable-or-scrape-failed polls before an ever-reachable replica is declared dead and respawned."),
  Knob("XOT_FLEET_COOLDOWN_S", "float", "20", "Fleet controller: minimum seconds between scaling actuations (respawns of dead replicas are exempt)."),
  Knob("XOT_FLEET_BOOT_TIMEOUT_S", "float", "180", "Fleet controller: seconds a freshly spawned replica gets to answer its healthcheck before the spawn counts as a respawn failure."),
  Knob("XOT_FLEET_LEASE_TTL_S", "float", "15", "Fleet controller: TTL (s) of the actuation lease; a dead lease holder's lease expires and actuation hands over to a surviving router."),
  Knob("XOT_FLEET_LEASE_PATH", "path", None, "Fleet controller: path of the shared TTL'd lease file gating actuation to one router; unset runs the controller solo (always holds)."),
  Knob("XOT_FLEET_WARM_PREFIXES", "int", "4", "Fleet controller: recent request prefixes pre-announced (/v1/prefetch) at a fresh spawn before it enters rotation (PRESERVE-style warm cold-start)."),
  Knob("XOT_FABRIC_PEERS", "str", "", "Fleet-wide KV fabric: comma-separated sibling replica base URLs to probe on a host-tier prefix miss; empty disables static peer probing (router offers still work)."),
  Knob("XOT_FABRIC_ROLE", "str", "mixed", "Disaggregated serving role: `prefill` (compute KV, offer it, return a handle instead of streaming), `decode` (import offered KV, serve decode), or `mixed` (default: serve everything)."),
  Knob("XOT_FABRIC_TIMEOUT_S", "float", "2", "KV fabric: per-request transport timeout (s) for peer match probes and entry fetches; a timed-out fetch degrades to a cold prefill."),
  Knob("XOT_FABRIC_OFFER_TTL_S", "float", "120", "KV fabric: seconds an announced peer offer stays usable in the local directory before it expires."),
  Knob("XOT_TRACING", "bool", "1", "Record request/hop spans in the in-process tracer (served at /v1/traces)."),
  Knob("XOT_FLIGHT", "bool", "1", "Record runtime events in the per-node flight recorder (served at /v1/debug/flight)."),
  Knob("XOT_FLIGHT_EVENTS", "int", "4096", "Flight-recorder ring capacity (events)."),
  Knob("XOT_FLIGHT_SNAPSHOTS", "int", "16", "Frozen flight-recorder snapshots kept per node (LRU)."),
  Knob("XOT_FLIGHT_DUMP_DIR", "path", None, "Post-mortem spool: on SIGTERM/SIGINT the node dumps its flight ring + frozen snapshots here as JSON; unset disables."),
  Knob("XOT_ANATOMY", "bool", "1", "Critical-path latency anatomy: hop clock stamps, skew-corrected per-request stage breakdowns (served at /v1/anatomy). 0 removes the clock field from the wire entirely."),
  Knob("XOT_ANATOMY_RESERVOIR", "int", "256", "Recent stage breakdowns kept per node for /v1/anatomy percentiles and diffs."),
  Knob("XOT_ANATOMY_CLOCK_WINDOW", "int", "64", "Per-peer window of one-way clock-delta samples the skew estimator min-filters."),
  Knob("XOT_ANATOMY_DELAY_S", "float", "0.35", "Seconds after a request finishes before the origin assembles its breakdown (lets remote span shards arrive over the status bus)."),
  Knob("XOT_ANATOMY_SKEW_NS", "int", "0", "Test-only: artificial offset (ns) added to this node's anatomy wall clock — the skew-injection point for offset-recovery proofs."),
  Knob("XOT_PERF_ATTR", "bool", "1", "Live roofline attribution: per-dispatch time/bytes/FLOPs accounting served at /v1/perf."),
  Knob("XOT_PERF_EWMA_S", "float", "30", "Time constant (s) of the EWMA throughput/utilization gauges (xot_decode_tok_s and friends)."),
  Knob("XOT_DEVICE_TRACE_MAX_S", "float", "120", "Auto-stop a /v1/trace/device/start torch.profiler session after this many seconds; 0 disables the cap."),
  Knob("XOT_ALERT", "bool", "1", "Evaluate SLO burn-rate alert rules on a background cadence (served at /v1/alerts)."),
  Knob("XOT_ALERT_EVAL_S", "float", "5", "Alert-rule evaluation cadence (seconds)."),
  Knob("XOT_ALERT_FAST_S", "float", "120", "Fast burn-rate window (seconds) of the multi-window SLO rules."),
  Knob("XOT_ALERT_SLOW_S", "float", "600", "Slow burn-rate window (seconds) of the multi-window SLO rules."),
  Knob("XOT_ALERT_BURN_FAST", "float", "14.4", "Fast-window burn-rate threshold (error-budget multiples) a rule must exceed to fire."),
  Knob("XOT_ALERT_BURN_SLOW", "float", "6", "Slow-window burn-rate threshold (error-budget multiples) a rule must exceed to fire."),
  Knob("XOT_ALERT_PENDING_S", "float", "10", "Seconds the burn condition must hold before a pending alert transitions to firing."),
  Knob("XOT_ALERT_RESOLVE_S", "float", "60", "Hysteresis: seconds the burn condition must stay clear before a firing alert resolves."),
  Knob("XOT_ALERT_SNAPSHOTS", "int", "256", "Bounded ring of timestamped metric snapshots the burn windows are computed over."),
  Knob("XOT_ALERT_HISTORY", "int", "64", "Recent resolved alerts kept for /v1/alerts (bounded)."),
  Knob("XOT_ALERT_DEVICE_TRACE", "bool", "0", "Capture-on-anomaly: a firing alert starts the bounded device trace (auto-stops after XOT_DEVICE_TRACE_MAX_S)."),
  Knob("XOT_ALERT_RTT_TAU_S", "float", "30", "Time constant (s) of the per-peer hop send RTT EWMAs (xot_peer_hop_seconds)."),
  Knob("XOT_ALERT_HOP_DEGRADED_S", "float", "0.2", "Absolute hop-RTT floor (s) below which a peer is never scored degraded."),
  Knob("XOT_ALERT_DEGRADED_FACTOR", "float", "3", "A peer whose hop RTT or per-dispatch compute exceeds this multiple of the ring median is scored degraded."),
  Knob("XOT_SLO_TTFT_S", "float", "10", "TTFT SLO target (s) the XOT_SLO_TARGET fraction of requests must beat."),
  Knob("XOT_SLO_E2E_S", "float", "60", "End-to-end request latency SLO target (s)."),
  Knob("XOT_SLO_TARGET", "float", "0.99", "Fraction of requests that must meet each latency SLO target (error budget = 1 - target; must leave budget * XOT_ALERT_BURN_FAST below 1 or the rule can never fire)."),
  Knob("XOT_SLO_ERROR_RATE", "float", "0.01", "Failed-request budget: the fraction of requests that may abort before the error-rate rule burns."),
  Knob("XOT_HISTORY", "bool", "1", "Metrics history: sample windowed deltas of the node's own gauges on a background cadence (served at /v1/history); 0 disables the sampler entirely — no task, no wire keys, byte-identical serving."),
  Knob("XOT_HISTORY_SAMPLE_S", "float", "10", "History sampling cadence (seconds): one windowed-delta gauge sample per tick."),
  Knob("XOT_HISTORY_SAMPLES", "int", "360", "Fine-tier samples kept before the oldest are merged into the next-coarser tier (at the default 10 s cadence: one hour at full resolution)."),
  Knob("XOT_HISTORY_MERGE", "int", "8", "Samples merged into one duration-weighted bucket when a history tier overflows into the next-coarser tier."),
  Knob("XOT_HISTORY_COARSE", "int", "336", "Buckets kept in each of the two coarser history tiers (mid keeps merge-fold buckets, old keeps merge^2-fold)."),
  Knob("XOT_HISTORY_DIR", "path", None, "JSONL spool directory for history samples: restarts and soak teardowns keep the record (restored rows are marked as a restart boundary); unset keeps history in memory only."),
  Knob("XOT_DRIFT", "bool", "1", "Evaluate chronic perf-drift rules over the metrics history inside the alert loop (requires XOT_HISTORY and XOT_ALERT); fires the perf_drift alert class."),
  Knob("XOT_DRIFT_WINDOW_S", "float", "120", "Recent window (s) a drift rule averages over — also the trailing-mean window of the history compact the router and ring peers compare."),
  Knob("XOT_DRIFT_BASELINE_S", "float", "600", "Trailing baseline window (s) a drift rule compares its recent window against; the baseline ends where the recent window begins."),
  Knob("XOT_DRIFT_RATIO", "float", "0.25", "Relative worsening vs the gauge's own trailing baseline before a drift rule's condition holds (direction-aware: tok/s down, rtt up)."),
  Knob("XOT_DRIFT_PEER_RATIO", "float", "0.5", "Relative worsening vs the median of peer nodes' trailing gauges before a drift rule's condition holds."),
  Knob("XOT_DRIFT_MIN_SAMPLES", "int", "3", "Minimum samples carrying the gauge in each compared window before a drift rule may evaluate (thin evidence never pages)."),
  Knob("XOT_DRIFT_PENDING_S", "float", "30", "Seconds a drift condition must hold before the pending perf_drift alert transitions to firing."),
  Knob("XOT_DRIFT_RESOLVE_S", "float", "60", "Hysteresis: seconds a drift condition must stay clear before a firing perf_drift alert resolves."),
  Knob("XOT_SIDECAR_BIN", "path", None, "Path to a prebuilt native sidecar binary (skips the make step)."),
  Knob("XOT_SIDECAR_QUANT", "str", None, "Native sidecar weight quantization (`int8`); read by the C++ engine."),
)

REGISTRY: Dict[str, Knob] = {k.name: k for k in _DEFS}

# The JAX package's knobs the port does not register, each with its reason.
EXCLUDED: Dict[str, str] = {
  "XOT_UUID": "the port's node id is --node-id or a fresh uuid4 a process; it keeps no "
              "per-machine id file to override",
  "XOT_PLATFORM": "pins JAX's platform; the port picks its device with --device (cuda or cpu)",
  "XOT_SKIP_JAX_PROBE": "skips JAX's accelerator probe; the port's probe asks torch.cuda, "
                        "which costs nothing",
  "XOT_COMPILE_CACHE_DIR": "JAX's persistent XLA compilation cache; the port compiles its "
                           "kernels with nvcc once a process and captures CUDA graphs in "
                           "memory",
  "XOT_FLASH_ATTENTION": "turns JAX's Pallas prefill kernel on or off; on the card the port "
                         "always takes K1, and on the CPU its plain version",
  "XOT_FLASH_DECODE": "turns JAX's Pallas decode kernel on or off; on the card the port always "
                      "takes K2, and on the CPU its plain version",
  "XOT_FLASH_DECODE_MIN": "the cache length below which JAX decodes through XLA instead of "
                          "its kernel; the port takes K2 at every length",
  **{f"XOT_SOAK_{name}": "read by tools/soak, which drives the JAX package's main, not the port"
     for name in ("SECONDS", "RPS", "PROCS", "STREAM_FRACTION", "SESSION_REUSE", "RECON_TOL_S",
                  "SEED")},
}

_UNSET = object()
_FALSE_STRINGS = frozenset(("", "0", "false", "no", "off"))


def _lookup(name: str) -> Knob:
  try:
    return REGISTRY[name]
  except KeyError:
    raise UnknownKnobError(
      f"{name} is not a registered knob — add it to xotorch_tpu_torch/utils/knobs.py"
    ) from None


def raw(name: str, default=_UNSET) -> Optional[str]:
  """The env value as a string, or the registered default. A set-but-empty value is
  returned verbatim; the numeric accessors map it to the default."""
  knob = _lookup(name)
  value = os.environ.get(name)
  if value is None:
    return knob.default if default is _UNSET else default
  return value


def get_str(name: str, default=_UNSET) -> Optional[str]:
  return raw(name, default)


def _numeric(name: str, default, cast):
  value = raw(name, default)
  if isinstance(value, str) and value.strip() == "":
    knob = _lookup(name)
    value = knob.default if default is _UNSET else default
  if value is None:
    if default is not _UNSET:
      return None
    raise RuntimeError(f"knob {name} has no default and is not set in the environment")
  return cast(value)


def get_int(name: str, default=_UNSET) -> Optional[int]:
  return _numeric(name, default, int)


def get_float(name: str, default=_UNSET) -> Optional[float]:
  return _numeric(name, default, float)


def get_bool(name: str, default=_UNSET) -> Optional[bool]:
  """"0"/"false"/"no"/"off" (any case) and set-but-empty are False; any other set
  value is True."""
  value = raw(name, default)
  if value is None:
    if default is not _UNSET:
      return None
    raise RuntimeError(f"knob {name} has no default and is not set in the environment")
  if isinstance(value, bool):
    return value
  return str(value).strip().lower() not in _FALSE_STRINGS
