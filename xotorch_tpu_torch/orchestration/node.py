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
  every peer frees the request's state when it learns of the finish.

When one partition spans the whole model, process_sampled_token takes the fused
decode loop instead: chunks of XOT_DECODE_CHUNK tokens, doubling up to
XOT_DECODE_CHUNK_MAX, through the engine's generate_chunk. Peers reconcile membership
every `topology_interval` seconds and re-gossip the topology with a visited-set
crawl. A peer's capabilities in a view are what that peer last reported of itself,
and its discovery entry (a manual config's, written by hand) only until it has
reported: the JAX package's crawl takes the discovery entry for a peer that is
skipped because it started the crawl, so there the last crawl to land can leave two
peers with different views of the ring.

Not ported yet (ROADMAP): the fused in-process ring, device-resident hops, the
watchdog and deadlines, the health monitor, eviction and heal_ring, tracing, the
flight recorder, alerts, history and metrics, training and checkpoints.
"""
from __future__ import annotations

import asyncio
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from xotorch_tpu_torch.inference.engine import CacheExhausted, InferenceEngine
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.networking.discovery import Discovery
from xotorch_tpu_torch.networking.peer_handle import PeerHandle
from xotorch_tpu_torch.networking.server import Server
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
    self.outstanding_requests: Dict[str, str] = {}
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
    self._request_ring_map: "OrderedDict[str, list]" = OrderedDict()
    # Receiver-side hop dedup: per-request bounded sets of hop sequence ids.
    self._hop_seen: "OrderedDict[str, OrderedDict]" = OrderedDict()
    # Cancelled or finished-elsewhere requests (bounded LRU, outliving their state so a
    # late hop or a running loop still sees the flag).
    self._cancelled: "OrderedDict[str, None]" = OrderedDict()
    self._update_peers_lock = asyncio.Lock()
    self._tasks: set = set()

  def _spawn(self, coro) -> "asyncio.Task":
    return spawn_detached(coro, self._tasks)

  # ------------------------------------------------------------- lifecycle

  async def start(self, wait_for_peers: int = 0, topology_interval: float = 2.0) -> None:
    self.device_capabilities = await device_capabilities()
    self.topology.update_node(self.id, self.device_capabilities)
    await self.server.start()
    await self.discovery.start()
    await self.update_peers(wait_for_peers)
    await self.collect_topology(set())
    self._spawn(self.periodic_topology_collection(topology_interval))
    if DEBUG >= 1:
      print(f"Node {self.id} started; topology: {self.topology}")

  async def stop(self) -> None:
    for task in list(self._tasks):
      task.cancel()
    await asyncio.gather(*self._tasks, return_exceptions=True)
    if self.discovery is not None:
      await self.discovery.stop()
    if self.server is not None:
      await self.server.stop()
    for peer in self.peers:
      await peer.disconnect()

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
    at the API). `traceparent` and `deadline` are accepted for the JAX package's wire
    and ignored; images are not ported yet and abort the request."""
    if request_id is None:
      request_id = str(uuid.uuid4())
    self._request_started.setdefault(request_id, time.monotonic())
    if max_tokens is not None:
      self._request_max_tokens[request_id] = self._clamp_max_tokens(max_tokens)
    if temperature is not None:
      self._request_temp[request_id] = max(0.0, float(temperature))
    if top_p is not None:
      self._request_top_p[request_id] = min(1.0, max(0.0, float(top_p)))
    if sampling:
      self._request_sampling[request_id] = dict(sampling)
    if images:
      await self._abort_request(request_id, "images are not supported by xotorch_tpu_torch yet")
      return
    try:
      if ring_map:
        if request_id not in self._request_ring_map:
          self._set_ring_map(request_id, ring_map)
      else:
        self._pin_ring_map(base_shard, request_id)
      await self._process_prompt(base_shard, prompt, request_id)
    except CacheExhausted as e:
      # The prompt itself does not fit the KV budget: a client error, answered 400.
      await self._abort_request(request_id, f"context_length_exceeded: {e}")
    except Exception as e:  # the request's boundary: every peer learns it failed
      print(f"Error processing prompt [{request_id}]: {e!r}")
      if DEBUG >= 2:
        import traceback
        traceback.print_exc()
      await self._abort_request(request_id, f"prompt processing failed on {self.id}: {e!r}")

  async def _process_prompt(self, base_shard: Shard, prompt: str, request_id: str) -> None:
    shard = self.get_current_shard(base_shard, request_id=request_id)
    if not shard.is_first_layer:
      await self.forward_prompt(base_shard, prompt, request_id, 0)
      return
    self.outstanding_requests[request_id] = "processing prompt"
    if shard.is_last_layer:
      # One partition: prefill and sample on the device in one engine call.
      tokens = await self.inference_engine.encode(shard, prompt)
      token, _ = await self.inference_engine.infer_sample_tensor(
        request_id, shard, np.asarray(tokens).reshape(1, -1), temp=self._temp_for(request_id),
        top_k=self.default_sample_top_k, top_p=self._top_p_for(request_id),
        **self._sampling_kwargs(request_id))
      await self.process_sampled_token(base_shard, int(token), request_id)
      return
    result, inference_state = await self.inference_engine.infer_prompt(request_id, shard, prompt)
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
    shard = None
    try:
      shard = self.get_current_shard(base_shard, request_id=request_id)
      self.outstanding_requests[request_id] = "processing tensor"
      if shard.is_last_layer:
        # Forward and sample on the device: only the token crosses to the host.
        token, inference_state = await self.inference_engine.infer_sample_tensor(
          request_id, shard, tensor, temp=self._temp_for(request_id),
          top_k=self.default_sample_top_k, inference_state=inference_state,
          top_p=self._top_p_for(request_id), **self._sampling_kwargs(request_id))
        await self.process_sampled_token(base_shard, int(token), request_id, inference_state)
      else:
        result, inference_state = await self.inference_engine.infer_tensor(
          request_id, shard, tensor, inference_state)
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
    """Forward a non-last partition's output to the next partition. (The last
    partition samples on the device, in infer_sample_tensor, and never lands here.)"""
    self.outstanding_requests[request_id] = "waiting"
    await self.forward_tensor(base_shard, result, request_id,
                              self.get_partition_index(offset=1, request_id=request_id),
                              inference_state)

  async def process_sampled_token(self, base_shard: Shard, token_int: int, request_id: str,
                                  inference_state: Optional[dict] = None) -> None:
    """Buffer and broadcast a sampled token, then stop (EOS or the cap) or keep the
    ring turning: the fused decode loop when this partition spans the whole model
    (detached, so process_prompt returns after the first token), else the token goes
    back to partition 0."""
    shard = self.get_current_shard(base_shard, request_id=request_id)
    buffered, _ = self.buffered_token_output.setdefault(request_id, ([], False))
    if DEBUG >= 2:
      print(f"[{request_id}] token {token_int} ({len(buffered) + 1} so far)")
    if self._ingest_sampled_tokens(request_id, [token_int], buffered, base_shard):
      await self._finish_generation(request_id)
      return
    if self.decode_chunk_size > 1 and shard.is_first_layer:
      self._spawn(self._fused_decode_loop(base_shard, shard, request_id, buffered))
      return
    await self._forward_next_token(base_shard, request_id, buffered, inference_state)

  async def _fused_decode_loop(self, base_shard: Shard, shard: Shard, request_id: str,
                               buffered: List[int]) -> None:
    """Chunked decode through the engine's generate_chunk until EOS or the cap;
    tokens past EOS inside a chunk are discarded."""
    try:
      self.outstanding_requests[request_id] = "generating"
      size = self.decode_chunk_size
      while True:
        if request_id in self._cancelled:
          await self._finish_generation(request_id)
          return
        limit = self._request_max_tokens.get(request_id, self.max_generate_tokens)
        remaining = max(1, limit - len(buffered))
        # Never compute far past the cap: the last chunk shrinks to the next power
        # of two covering what the cap still allows.
        this_size = min(size, 1 << (remaining - 1).bit_length())
        rem_after = remaining - this_size
        next_hint = (min(min(size * 2, self.max_decode_chunk_size),
                         1 << (rem_after - 1).bit_length()) if rem_after >= 1 else None)
        chunk = await self.inference_engine.generate_chunk(
          request_id, shard, buffered[-1], this_size, temp=self._temp_for(request_id),
          top_k=self.default_sample_top_k, top_p=self._top_p_for(request_id), next_size=next_hint)
        if chunk is None:
          raise RuntimeError(f"engine cannot decode {shard} in fused chunks")
        if self._ingest_sampled_tokens(request_id, np.asarray(chunk).reshape(-1).tolist(), buffered,
                                       base_shard):
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
    appended = 0
    finished = False
    for t in new_tokens:
      buffered.append(int(t))
      appended += 1
      if int(t) in eos or len(buffered) >= limit:
        finished = True
        break
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
    self._request_started.pop(request_id, None)
    self._request_max_tokens.pop(request_id, None)
    self._request_temp.pop(request_id, None)
    self._request_top_p.pop(request_id, None)
    self._request_sampling.pop(request_id, None)
    self._request_eos.pop(request_id, None)
    self._request_ring_map.pop(request_id, None)

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

  async def forward_prompt(self, base_shard: Shard, prompt: str, request_id: str, target_index: int) -> None:
    if DEBUG >= 1:
      print(f"Forwarding prompt [{request_id}] to partition {target_index}")
    target_id = self._ring_target_id(target_index, request_id)
    if target_id == self.id:
      await self._process_prompt(base_shard, prompt, request_id)
      return
    peer = await self._peer_by_id(target_id)
    if peer is None:
      raise ValueError(f"Peer for {target_index} ({target_id}) not found")
    await peer.send_prompt(self.get_current_shard(base_shard, target_index, request_id=request_id),
                           prompt, request_id, max_tokens=self._request_max_tokens.get(request_id),
                           temperature=self._request_temp.get(request_id),
                           top_p=self._request_top_p.get(request_id),
                           ring_map=self._ring_entries(request_id))

  async def forward_tensor(self, base_shard: Shard, tensor, request_id: str, target_index: int,
                           inference_state: Optional[dict] = None) -> None:
    """Hand `tensor` to partition `target_index`, with the request's ring map and
    settings in `inference_state`. A hop to this node is spawned, not awaited: a
    direct call would grow one coroutine chain per token."""
    target_id = self._ring_target_id(target_index, request_id)
    state = dict(inference_state or {})
    ring_rows = self._ring_entries(request_id)
    if ring_rows is not None:
      state[RING_MAP_KEY] = ring_rows
    for key, table in ((MAX_TOKENS_KEY, self._request_max_tokens), (TEMP_KEY, self._request_temp),
                       (TOP_P_KEY, self._request_top_p), (SAMPLING_KEY, self._request_sampling)):
      if request_id in table:
        state[key] = table[request_id]
    if target_id == self.id:
      self._spawn(self.process_tensor(base_shard, tensor, request_id, state))
      return
    peer = await self._peer_by_id(target_id)
    if peer is None:
      raise ValueError(f"Peer for {target_index} ({target_id}) not found")
    await peer.send_tensor(self.get_current_shard(base_shard, target_index, request_id=request_id),
                           tensor, request_id, state)

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
    for peer in peers_removed:
      self._peer_reports.pop(peer.id(), None)
      await peer.disconnect(grace=600.0)
    self.peers = peers_kept + [p for p, ok in zip(peers_added, connected) if ok]
    return bool(peers_added or peers_removed)

  async def periodic_topology_collection(self, interval: float) -> None:
    while True:
      await asyncio.sleep(interval)
      try:
        if await self.update_peers():
          await self.collect_topology(set())
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
