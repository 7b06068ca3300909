"""OpenAI-compatible chat completions over the standard library only.

The port of the serving core of xotorch_tpu/api/chatgpt_api.py on
`asyncio.start_server` with a minimal HTTP/1.1 handler (one request per connection):

- POST /v1/chat/completions: `stream: false` (one JSON body with `usage` and
  `finish_reason`) and `stream: true` (server-sent events ending in `data: [DONE]`).
  Every field the JAX package serves is served with its validation and messages:
  `max_tokens`/`max_completion_tokens`, `temperature`, `top_p` (snapped to the 0.05
  grid), `stop` (1-4 strings; the answer is cut before the first occurrence and the
  request cancelled; a stream holds back max(len(stop)) - 1 characters so it never
  sends part of one), `seed`, `min_p`, `presence_penalty`, `frequency_penalty`,
  `logit_bias` (the sampling extras, applied on the device by the sampler peer),
  `logprobs`/`top_logprobs` (per token, in both response shapes), `n` (1-8
  completions, sub-requests "rid#i") and `tools` (handed to the chat template). On a
  card with `"vision"` (llava) each `image_url` part (a data: URI, decoded with PIL)
  becomes an `<image>` placeholder in the prompt and a uint8 array that rides
  process_prompt to the engine; any other card answers such a part 400 naming the
  model, as the JAX package does (an undecodable data URI too);
- POST /v1/chat/token/encode (and /chat/token/encode) builds a request's prompt as a
  completion would (system prompt and tools included) and returns its tokens;
- GET /v1/models lists the cards this engine serves; GET /healthcheck;
- observability, with the JAX handler's payload keys: GET /metrics (Prometheus text:
  the node's registry, then the engine's counters and gauges, the perf, alert and
  anatomy gauges), /v1/traces (?trace_id=, ?clear=1, ?format=chrome), /v1/perf,
  /v1/queue, /v1/debug/flight (?request_id=, ?live=N), /v1/cluster/metrics,
  /v1/anatomy (?request_id=, ?diff=s), /v1/alerts, /v1/history (?window=, ?metric=,
  ?diff=, ?compact=1), and POST /v1/trace/device/start (body {"logdir": ...}; a
  torch.profiler session whose Chrome trace /v1/trace/device/stop writes there);
- bounded admission (XOT_MAX_INFLIGHT > 0): a completion takes a slot of the node's
  gate first, waits in its queue (its warm prefix prefetched from the host KV tier
  the moment it queues), or is answered 429 with Retry-After when the queue is full;
  responses carry the x-ratelimit-* headers while the gate is on;
- POST /v1/prefetch ({model, prompt} or {model, messages[, tools]}) starts the host
  KV tier's restore of a queued prompt's warm prefix and answers 202;
- the one-shot transparent restart (XOT_REQUEST_RESTARTS, 0 = off): a completion that
  a ring failure killed (a hop error, a stall abort, an evicted peer; never
  context_length_exceeded or deadline_exceeded, and not once XOT_REQUEST_DEADLINE_S of
  wall time is spent) is resubmitted under a fresh request id after `Node.heal_ring`;
  a stream qualifies only until its first event reaches the client. All n siblings
  are resubmitted together; those of the failed attempt are cancelled when the HTTP
  request ends. Counted on xot_request_restarts_total;
- GET /v1/topology (and /topology): the node's topology (the JAX handler's body) and
  `partitions`, the ring's layer ranges for ?model= (default: the API's model);
- GET, POST and DELETE /v1/debug/faults: the process-wide fault injector's state,
  installing one ({"rules": [...]}, the XOT_FAULT_SPEC rule shape) and removing it.
  A test and soak surface: a deployment firewalls /v1/debug/* as it does /quit.

Synthetic models use DummyTokenizer, with the model's own EOS id, as the dummy card does.
"""
from __future__ import annotations

import asyncio
import json
import math
import time
import uuid
from typing import Dict, List, NamedTuple, Optional, Tuple
from urllib.parse import parse_qsl

from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer, resolve_tokenizer, tokenizer_for_dir
from xotorch_tpu_torch.models.registry import build_base_shard, get_model_card, get_repo, get_supported_models
from xotorch_tpu_torch.networking import faults
from xotorch_tpu_torch.orchestration.admission import AdmissionRejected
from xotorch_tpu_torch.orchestration.anatomy import chrome_trace
from xotorch_tpu_torch.orchestration.tracing import DEFAULT_TRACE_DIR, start_device_trace, stop_device_trace
from xotorch_tpu_torch.topology.partitioning import map_partitions_to_shards
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG, spawn_detached

REASONS = {200: "OK", 202: "Accepted", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
           429: "Too Many Requests", 500: "Internal Server Error"}

# Engine counters /metrics appends (the JAX handler's table): the port engine's
# attribute, family, help. The families of subsystems the port lacks (the KV fabric)
# read 0, as the JAX package's do with that feature off.
ENGINE_COUNTERS = (
  ("_prefix_hits", "xot_prefix_cache_hits_total", "Prefill prefix-cache hits"),
  ("_prefix_tokens_saved", "xot_prefix_tokens_saved_total", "Prompt tokens whose prefill was skipped"),
  ("_spec_proposed", "xot_spec_tokens_proposed_total", "Speculative draft tokens proposed"),
  ("_spec_accepted", "xot_spec_tokens_accepted_total", "Speculative draft tokens accepted"),
  ("_grow_copies", "xot_kv_grow_copies_total",
   "Contiguous KV grow-copies (zero under XOT_PAGED_KV decode)"),
  ("_commit_copy_bytes", "xot_kv_commit_copy_bytes_total",
   "Device bytes copied committing contiguous prefill KV into pool pages "
   "(zero under paged-native prefill, XOT_PAGED_PREFILL)"),
  ("_unpage_calls", "xot_kv_unpage_total",
   "Paged-to-contiguous cache gathers (zero under virtual KV addressing "
   "unless XOT_PAGED_SPEC=0 restores the legacy fallback)"),
  ("defrag_moves", "xot_kv_defrag_moves_total",
   "Pages migrated by idle-slot pool compaction (XOT_KV_DEFRAG)"),
  ("_oom_count", "xot_oom_recoveries_total",
   "HBM-exhaustion recoveries (engine._free_device_memory invocations)"),
  ("_prefix_evictions", "xot_prefix_evictions_total",
   "Prefix-cache entries evicted (LRU bound, pool pressure, OOM recovery)"),
  ("_host_kv_hits", "xot_kv_host_hits_total",
   "Prefix lookups served from the host KV tier (XOT_KV_HOST_BYTES)"),
  ("_host_spill_bytes", "xot_kv_spill_bytes_total",
   "Bytes spilled D2H into the host KV tier by prefix evictions"),
  ("_host_fetch_bytes", "xot_kv_fetch_bytes_total",
   "Bytes restored H2D from the host KV tier on warm-prefix admission"),
  ("_fabric_hits", "xot_kv_fabric_hits_total",
   "Prefix entries imported from sibling replicas over the KV fabric"),
  ("_fabric_misses", "xot_kv_fabric_misses_total",
   "Fabric consults that found no usable sibling entry (cold prefill)"),
  ("_fabric_errors", "xot_kv_fabric_errors_total",
   "Fabric transfers dropped (peer error, torn blob, digest mismatch)"),
  ("_fabric_bytes", "xot_kv_fabric_bytes_total",
   "Host-tier bytes imported over the KV fabric from sibling replicas"),
  ("_jit_first_dispatches", "xot_jit_first_dispatch_total",
   "Device dispatches whose executable identity was first seen (jit cache miss: "
   "pays XLA compilation)"),
  ("_jit_cached_dispatches", "xot_jit_cached_dispatch_total",
   "Device dispatches that hit an already-compiled executable"),
)


class HTTPError(Exception):
  def __init__(self, status: int, body: dict, headers: Optional[dict] = None):
    super().__init__(body)
    self.status = status
    self.body = body
    self.headers = headers or {}


def _invalid(message: str) -> HTTPError:
  return HTTPError(400, {"error": {"type": "invalid_request_error", "message": message}})


class _StreamRestart(Exception):
  """A stream died to a restartable ring failure before any event reached the client:
  the completion handler resubmits it under a fresh request id."""

  def __init__(self, error: str):
    super().__init__(error)
    self.error = error


class Params(NamedTuple):
  """A chat completion's validated request fields (the JAX package's handler)."""
  max_tokens: Optional[int]
  temperature: Optional[float]
  top_p: Optional[float]  # snapped to the 0.05 grid; None = off
  stop: Optional[List[str]]
  sampling: Optional[dict]  # the extras the sampler applies; None for a plain request
  logprobs: bool
  tools: Optional[list]
  n: int


def extract_images(messages: List[dict]) -> list:
  """Every image_url content part (a data: URI) decoded to a uint8 HWC array, in prompt
  order (the JAX package's). A malformed or undecodable URI raises ValueError."""
  from xotorch_tpu_torch.models.vision import decode_image_data_uri
  images = []
  for m in messages:
    content = m.get("content", "")
    if not isinstance(content, list):
      continue
    for part in content:
      if isinstance(part, dict) and part.get("type") == "image_url":
        images.append(decode_image_data_uri((part.get("image_url") or {}).get("url", "")))
  return images


def check_images(model: str, messages: List[dict]) -> Optional[list]:
  """A request's images, or None when it has none. A card without `"vision"` answers
  any image_url part 400 naming the model (JAX's message; an undecodable one with the
  decoder's reason after it); on a vision card an undecodable part is answered 400 with
  the decoder's reason, as JAX answers it."""
  vision = bool((get_model_card(model) or {}).get("vision"))
  try:
    images = extract_images(messages)
  except ValueError as e:
    raise _invalid(str(e) if vision else f"model {model} does not support image input ({e})") from None
  if images and not vision:
    raise _invalid(f"model {model} does not support image input")
  return images or None


def build_prompt(tokenizer, messages: List[dict], tools: Optional[list] = None) -> str:
  """Chat-template prompt with `tools` handed to the template, and a plain fallback
  (the JAX package's: an image_url part becomes an <image> placeholder where it
  stands)."""
  chat = []
  for m in messages:
    content = m.get("content", "")
    if isinstance(content, list):
      pieces = []
      for part in content:
        if not isinstance(part, dict):
          continue
        if part.get("type") == "text":
          pieces.append(part.get("text", ""))
        elif part.get("type") == "image_url":
          pieces.append("<image>")
      content = "\n".join(pieces)
    chat.append({"role": m.get("role", "user"), "content": content})
  try:
    kwargs = {"tokenize": False, "add_generation_prompt": True}
    if tools:
      kwargs["tools"] = tools
    return tokenizer.apply_chat_template(chat, **kwargs)
  except Exception:
    return "\n".join(f"{m['role']}: {m['content']}" for m in chat) + "\nassistant:"


class ChatGPTAPI:
  def __init__(self, node, inference_engine_classname: str, response_timeout: int = 90,
               default_model: Optional[str] = None, system_prompt: Optional[str] = None):
    self.node = node
    self.inference_engine_classname = inference_engine_classname
    self.response_timeout = response_timeout
    self.default_model = default_model or "synthetic-llama-1b"
    self.system_prompt = system_prompt
    self.token_queues: Dict[str, asyncio.Queue] = {}
    self._tasks: set = set()
    self._tokenizers: Dict[str, object] = {}
    node.on_token.register("chatgpt-api-token-handler").on_next(self._enqueue_tokens)

  def _enqueue_tokens(self, request_id: str, tokens: List[int], is_finished: bool) -> None:
    q = self.token_queues.get(request_id)
    if q is not None:
      q.put_nowait((list(tokens), is_finished))

  # ------------------------------------------------------------------ HTTP

  async def start(self, host: str = "0.0.0.0", port: int = 52415) -> asyncio.AbstractServer:
    server = await asyncio.start_server(self._handle_connection, host, port)
    if DEBUG >= 0:
      print(f"ChatGPT-compatible API on http://{host}:{port}", flush=True)
    return server

  async def _handle_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
    try:
      method, path, query, body = await self._read_request(reader)
      await self._route(method, path, query, body, writer)
    except HTTPError as e:
      await self._write_json(writer, e.status, e.body, e.headers)
    except (asyncio.IncompleteReadError, ConnectionError):
      pass  # the client went away
    except Exception as e:
      print(f"API error: {e!r}")
      try:
        await self._write_json(writer, 500, {"error": {"type": "server_error", "message": repr(e)}})
      except ConnectionError:
        pass
    finally:
      writer.close()
      try:
        await writer.wait_closed()
      except ConnectionError:
        pass

  async def _read_request(self, reader: asyncio.StreamReader) -> Tuple[str, str, dict, bytes]:
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) < 2:
      raise _invalid(f"malformed request line {lines[0]!r}")
    headers = {}
    for line in lines[1:]:
      if ":" in line:
        key, value = line.split(":", 1)
        headers[key.strip().lower()] = value.strip()
    length = int(headers.get("content-length", "0") or 0)
    body = await reader.readexactly(length) if length else b""
    path, _, query = parts[1].partition("?")
    return parts[0].upper(), path, dict(parse_qsl(query, keep_blank_values=True)), body

  async def _write(self, writer: asyncio.StreamWriter, status: int, payload: bytes,
                   content_type: str, headers: Optional[dict] = None) -> None:
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    writer.write((f"HTTP/1.1 {status} {REASONS.get(status, 'Error')}\r\n"
                  f"Content-Type: {content_type}\r\n"
                  f"Content-Length: {len(payload)}\r\n{extra}"
                  "Connection: close\r\n\r\n").encode() + payload)
    await writer.drain()

  async def _write_json(self, writer: asyncio.StreamWriter, status: int, body: dict,
                        headers: Optional[dict] = None) -> None:
    await self._write(writer, status, json.dumps(body).encode(), "application/json", headers)

  async def _route(self, method: str, path: str, query: dict, body: bytes,
                   writer: asyncio.StreamWriter) -> None:
    get = self._get_routes().get(path)
    if path == "/healthcheck" and method == "GET":
      await self._write_json(writer, 200, {"status": "ok"})
    elif path in ("/v1/models", "/models") and method == "GET":
      await self._write_json(writer, 200, self.models_body())
    elif path == "/metrics" and method == "GET":
      payload, content_type = self.metrics_exposition()
      await self._write(writer, 200, payload, content_type)
    elif get is not None and method == "GET":
      await self._write_json(writer, 200, get(query))
    elif path == "/v1/prefetch":
      if method != "POST":
        raise HTTPError(405, {"detail": f"{method} not allowed on {path}"})
      await self._write_json(writer, 202, await self.handle_post_prefetch(body))
    elif path == "/v1/debug/faults":
      await self._write_json(writer, 200, self.handle_debug_faults(method, body))
    elif path in ("/v1/trace/device/start", "/v1/trace/device/stop"):
      if method != "POST":
        raise HTTPError(405, {"detail": f"{method} not allowed on {path}"})
      await self._write_json(writer, 200, await self.handle_device_trace(path, body))
    elif path in ("/v1/chat/completions", "/chat/completions",
                  "/v1/chat/token/encode", "/chat/token/encode"):
      if method != "POST":
        raise HTTPError(405, {"detail": f"{method} not allowed on {path}"})
      try:
        data = json.loads(body or b"{}")
      except json.JSONDecodeError as e:
        raise _invalid(f"request body is not JSON: {e}") from None
      if path.endswith("/token/encode"):
        await self._write_json(writer, 200, await self.handle_post_chat_token_encode(data))
      else:
        await self.handle_post_chat_completions(data, writer)
    else:
      raise HTTPError(404, {"detail": f"no route {method} {path}"})

  # --------------------------------------------------------- observability

  def _get_routes(self) -> dict:
    return {"/v1/traces": self.handle_get_traces, "/v1/anatomy": self.handle_get_anatomy,
            "/v1/debug/flight": self.handle_get_flight,
            "/v1/cluster/metrics": self.handle_get_cluster_metrics,
            "/v1/alerts": self.handle_get_alerts, "/v1/history": self.handle_get_history,
            "/v1/perf": self.handle_get_perf, "/v1/queue": self.handle_get_queue,
            "/v1/topology": self.handle_get_topology, "/topology": self.handle_get_topology}

  @staticmethod
  def _float_param(query: dict, key: str, what: str) -> Optional[float]:
    if key not in query:
      return None
    try:
      return float(query[key])
    except ValueError:
      raise HTTPError(400, {"detail": f"{key} must be {what}, got {query[key]!r}"}) from None

  def handle_get_traces(self, query: dict) -> dict:
    """Finished spans, OTLP-style JSON. ?trace_id= filters one trace; ?clear=1 drains
    what was read; ?format=chrome gives Chrome trace-event JSON re-based onto this
    node's clock (the estimated ring offsets)."""
    spans = self.node.tracer.export(trace_id=query.get("trace_id"), clear=query.get("clear") == "1")
    if query.get("format") == "chrome":
      offsets = self.node.ring_offsets_view()
      return {"traceEvents": chrome_trace(spans, offsets), "displayTimeUnit": "ms",
              "otherData": {"node_id": self.node.id,
                            "skew_corrected": any(nid != self.node.id for nid in offsets)}}
    return {"spans": spans, "count": len(spans)}

  def handle_get_anatomy(self, query: dict) -> dict:
    """Latency anatomy: per-stage percentiles over the origin's reservoir and the ring's
    clock offsets; ?request_id= one request's breakdown (404 when none was assembled);
    ?diff=<seconds> which stage grew between the last window and the one before."""
    store = self.node.anatomy
    rid = query.get("request_id")
    if rid:
      b = store.get(rid)
      if b is None:
        raise HTTPError(404, {"detail": f"no anatomy breakdown assembled for request {rid}"})
      return b
    window_s = self._float_param(query, "diff", "a window in seconds")
    if window_s is not None:
      return {"node_id": self.node.id, **store.diff(window_s)}
    return {"node_id": self.node.id, "enabled": store.enabled, "breakdowns": len(store.recent()),
            "total": store.total, "stages": store.percentiles(),
            "offsets": self.node.ring_offsets_view(),
            "recent_requests": [b.get("request_id") for b in store.recent(16)]}

  def handle_get_flight(self, query: dict) -> dict:
    """Flight-recorder postmortems: every frozen snapshot and the recorder's stats;
    ?request_id= one snapshot (404 when none was frozen); ?live=N also the live ring's
    last N events (0 or `all` for every one)."""
    fl = self.node.flight
    rid = query.get("request_id")
    if rid:
      snap = fl.snapshot(rid)
      if snap is None:
        raise HTTPError(404, {"detail": f"no flight snapshot frozen for request {rid}"})
      return snap
    body = {"node_id": self.node.id, **fl.stats(), "snapshots": fl.snapshots()}
    live = query.get("live")
    if live is not None:
      try:
        n = 0 if live in ("", "all") else max(0, int(live))
      except ValueError:
        raise HTTPError(400, {"detail": f"live must be an integer or 'all', got {live!r}"}) from None
      body["events"] = fl.tail(n)
    return body

  def handle_get_cluster_metrics(self, query: dict) -> dict:
    """This node's metric summary and each peer's latest off the status bus; a stale
    peer's row is marked and left out of the ring-wide percentiles."""
    nodes, aggregate = self.node.cluster_metrics_view()
    return {"nodes": nodes, "count": len(nodes), "aggregate": aggregate}

  def _peer_compacts(self, key: str, stale_mark: bool = True) -> Dict[str, dict]:
    """Each peer's `key` compact off the status bus (stale ones marked)."""
    out = {}
    for nid, summary in self.node.peer_metrics.items():
      part = summary.get(key) if isinstance(summary, dict) else None
      if not part:
        continue
      if stale_mark and self.node.peer_metrics_stale(nid):
        part = {**part, "stale": True}
      out[nid] = part
    return out

  def handle_get_alerts(self, query: dict) -> dict:
    """SLO alerts: this node's rule status (burn rates, active and recent alerts, the
    ring decomposition) and each peer's alert compact, merged in `cluster`."""
    al = self.node.alerts
    loc = al.localization()
    body = {"node_id": self.node.id, **al.status(localization=loc)}
    nodes = {self.node.id: al.compact(localization=loc), **self._peer_compacts("alerts")}
    cluster_active, cluster_recent = [], []
    for nid, alerts in nodes.items():
      cluster_active.extend({"node_id": nid, **row} for row in alerts.get("active") or [])
      cluster_recent.extend({"node_id": nid, **row} for row in alerts.get("recent") or [])
    body["nodes"] = nodes
    body["cluster"] = {
      "active": cluster_active, "recent": cluster_recent,
      "firing": sum(int(a.get("firing") or 0) for a in nodes.values()),
      "degraded_peers": sorted({p for a in nodes.values() for p in (a.get("degraded_peers") or [])}),
    }
    return body

  def handle_get_history(self, query: dict) -> dict:
    """The node's downsampled gauge time-series: ?window=<s> bounds it, ?metric= keeps
    one gauge, ?diff=<s> which metric moved, ?compact=1 just the trailing rollup;
    `cluster` holds each peer's history compact."""
    hist = self.node.history
    if query.get("compact") == "1":
      return {"node_id": self.node.id, "enabled": hist.enabled,
              "compact": hist.compact() if hist.enabled else None}
    window_s = self._float_param(query, "diff", "a window in seconds")
    if window_s is not None:
      return {"node_id": self.node.id, **hist.diff(window_s)}
    body = {"node_id": self.node.id,
            **hist.status(window_s=self._float_param(query, "window", "seconds"),
                          metric=query.get("metric"))}
    body["cluster"] = {**({self.node.id: hist.compact()} if hist.enabled else {}),
                       **self._peer_compacts("history")}
    return body

  def handle_get_perf(self, query: dict) -> dict:
    """The engine's roofline attribution report and, in `cluster`, each peer's compact
    perf summary and this node's. 404 when attribution is off (XOT_PERF_ATTR=0)."""
    eng = self.node.inference_engine
    report = eng.perf_report()
    if report is None:
      raise HTTPError(404, {"detail": "engine exposes no perf attribution (XOT_PERF_ATTR=0)"})
    cluster = self._peer_compacts("perf", stale_mark=False)
    local = eng.perf_compact()
    if local is not None:
      cluster[self.node.id] = local
    return {"node_id": self.node.id, **report, "cluster": cluster}

  def handle_get_queue(self, query: dict) -> dict:
    """The admission gate's state (inflight, queued, totals, estimated wait) and each
    peer's admission compact: `enabled` false and an empty cluster while the gate is
    off everywhere."""
    gate = self.node.admission
    local = gate.compact()
    cluster = {self.node.id: local} if gate.enabled else {}
    cluster.update(self._peer_compacts("admission"))
    return {"node_id": self.node.id, "enabled": gate.enabled,
            "active_requests": len(self.node.outstanding_requests),
            "fabric_role": "mixed",  # no KV fabric in the port: every node serves everything
            "admission": local, "cluster": cluster}

  def handle_get_topology(self, query: dict) -> dict:
    """The node's topology (nodes, peer graph, active node) and `partitions`: the ring's
    [node_id, start_layer, end_layer] rows for ?model= (default: the API's model), so an
    operator sees the ring as a healed node would pin it."""
    topology = self.node.current_topology
    body = topology.to_json()
    shard = build_base_shard(self._resolve_model(query.get("model")), self.inference_engine_classname)
    if shard is not None:
      partitions = self.node.partitioning_strategy.partition(topology)
      shards = map_partitions_to_shards(partitions, shard.n_layers, shard.model_id)
      body["partitions"] = [{"node_id": p.node_id, "start_layer": s.start_layer, "end_layer": s.end_layer}
                            for p, s in zip(partitions, shards)]
    return body

  def handle_debug_faults(self, method: str, body: bytes) -> dict:
    """The process-wide fault injector (test and soak surface): GET its state, POST
    {"rules": [{rpc, peer, nth, action, times, delay_s}, ...]} to install one in place of
    any other, DELETE to remove it."""
    if method == "GET":
      inj = faults.active()
      if inj is None:
        return {"installed": False, "rules": 0, "dead_peers": []}
      return {"installed": True, "rules": len(inj.rules), "dead_peers": sorted(inj.dead_peers)}
    if method == "DELETE":
      faults.install(None)
      return {"installed": False}
    if method != "POST":
      raise HTTPError(405, {"detail": f"{method} not allowed on /v1/debug/faults"})
    try:
      data = json.loads(body or b"{}")
    except (json.JSONDecodeError, UnicodeDecodeError):
      raise _invalid("body must be JSON") from None
    rules = data.get("rules") if isinstance(data, dict) else None
    if (not isinstance(rules, list) or not rules
        or not all(isinstance(r, dict) and r.get("action") for r in rules)):
      raise _invalid("rules must be a non-empty list of objects with an `action`")
    try:
      faults.install(faults.FaultInjector(rules))
    except (KeyError, TypeError, ValueError) as e:
      raise _invalid(f"bad rule: {e!r}") from None
    return {"installed": True, "rules": len(rules)}

  async def handle_device_trace(self, path: str, body: bytes) -> dict:
    """Start or stop the process's torch.profiler session (orchestration/tracing.py). The
    profiler waits for any CUDA graph capture to end, so it runs off the event loop."""
    loop = asyncio.get_running_loop()
    if path.endswith("/stop"):
      return {"stopped": await loop.run_in_executor(None, stop_device_trace)}
    try:
      data = json.loads(body or b"{}")
    except json.JSONDecodeError:
      raise _invalid("body must be JSON") from None
    logdir = data.get("logdir", DEFAULT_TRACE_DIR)
    started = await loop.run_in_executor(None, start_device_trace, logdir)
    return {"started": started, "logdir": logdir, "max_s": knobs.get_float("XOT_DEVICE_TRACE_MAX_S")}

  def metrics_exposition(self) -> Tuple[bytes, str]:
    """/metrics: the node's registry, then the engine's counters, the page pool's
    gauges (once a pool exists), the roofline gauges, and the alert and anatomy gauges
    (the JAX handler's families and help texts)."""
    body, content_type = self.node.metrics.exposition_with_content_type()
    eng = self.node.inference_engine
    extra = []

    def gauge(name: str, help_text: str, value) -> None:
      extra.append(f"# HELP {name} {help_text}\n# TYPE {name} gauge\n{name} {value}\n")

    def labelled(name: str, help_text: str, label: str, rows: dict) -> None:
      if rows:
        extra.append(f"# HELP {name} {help_text}\n# TYPE {name} gauge\n")
        extra.extend(f'{name}{{{label}="{k}"}} {v}\n' for k, v in sorted(rows.items()))

    for attr, name, help_text in ENGINE_COUNTERS:
      extra.append(f"# HELP {name} {help_text}\n# TYPE {name} counter\n{name} {getattr(eng, attr, 0)}\n")
    stats = eng.page_pool_stats()
    if stats is not None:
      for key, name, help_text in (
        ("pages_in_use", "xot_kv_pool_pages_in_use", "KV pool pages currently referenced"),
        ("free_pages", "xot_kv_pool_free_pages", "KV pool pages on the free list"),
        ("peak_pages_in_use", "xot_kv_pool_peak_pages",
         "High-water mark of concurrently referenced KV pool pages"),
        ("fragmentation", "xot_kv_fragmentation_pages",
         "Free pages stranded below the pool's highest used page id "
         "(the holes an idle defrag pass can close)"),
      ):
        gauge(name, help_text, stats[key])
    # The host KV tier's occupancy (absent until an eviction first touches the tier).
    host_fn = getattr(eng, "host_kv_stats", None)
    host = host_fn() if host_fn is not None else None
    if host is not None:
      for key, name, help_text in (
        ("bytes", "xot_kv_host_bytes", "Host-RAM bytes held by spilled prefix KV"),
        ("entries", "xot_kv_host_entries", "Prefix entries resident in the host KV tier"),
      ):
        gauge(name, help_text, host[key])
    perf = eng.perf_stats()
    if perf is not None:
      for key, name, help_text in (
        ("decode_tok_s", "xot_decode_tok_s",
         "EWMA decode throughput observed at the engine batcher (tokens/s)"),
        ("prefill_tok_s", "xot_prefill_tok_s", "EWMA prefill throughput observed at the engine (tokens/s)"),
        ("hbm_util_pct", "xot_hbm_util_pct",
         "EWMA predicted HBM bandwidth utilization vs the chip peak (0 off-TPU)"),
        ("mfu_pct", "xot_mfu_pct", "EWMA model FLOP utilization vs the chip peak (0 off-TPU)"),
      ):
        gauge(name, help_text, perf[key])
    # Speculation's efficiency (absent until a draft has been verified): the EWMA of
    # accepted over proposed draft tokens.
    spec_fn = getattr(eng, "spec_stats", None)
    spec = spec_fn() if spec_fn is not None else None
    if spec is not None:
      gauge("xot_spec_accept_rate", "EWMA fraction of drafted tokens accepted by verification",
            spec["accept_rate"])
    alerts = self.node.alerts
    if alerts.enabled:
      astats = alerts.gauge_stats()
      gauge("xot_alerts_firing", "SLO alert rules currently firing on this node", astats["firing"])
      gauge("xot_perf_drift_firing", "Chronic perf_drift rules currently firing on this node",
            astats["drift_firing"])
      labelled("xot_slo_burn_rate",
               "Fast-window SLO burn rate (error-budget multiples) per rule family", "family",
               alerts.burn_gauges())
      labelled("xot_peer_hop_seconds",
               "EWMA hop send RTT to each ring peer (gray-failure localization signal)", "peer",
               alerts.peer_hop_gauges())
    anat = self.node.anatomy
    if anat.enabled:
      astats = anat.gauge_stats()
      gauge("xot_anatomy_breakdowns",
            "Skew-corrected stage breakdowns currently held in the anatomy reservoir",
            astats["breakdowns"])
      gauge("xot_anatomy_unattributed_share",
            "Mean unattributed fraction of recent latency breakdowns (0 = fully attributed)",
            astats["unattributed_share"])
      offsets = {nid: round(float(o.get("offset_ns") or 0.0) / 1e9, 6)
                 for nid, o in self.node.ring_offsets_view().items() if nid != self.node.id}
      labelled("xot_clock_offset_seconds",
               "Estimated clock offset of each ring peer relative to this node (latency anatomy)",
               "peer", offsets)
    return body + "".join(extra).encode(), content_type

  def _ratelimit_headers(self, remaining: Optional[int] = None,
                         reset_s: Optional[float] = None) -> dict:
    """OpenAI-style x-ratelimit-* headers from the admission gate's live view: the
    budget is the concurrency cap plus the queue, `remaining` what is left of it now,
    and reset the estimated wait. `remaining`/`reset_s` give a 429's own numbers. Empty
    while the gate is off."""
    gate = self.node.admission
    if not gate.enabled:
      return {}
    limit = gate.max_inflight + gate.queue_limit
    if remaining is None:
      c = gate.compact()
      used = int(c["inflight"]) + int(c["queued"])
      remaining = max(0, limit - used)
      reset_s = float(c["est_wait_s"]) if used else 0.0
    return {"x-ratelimit-limit-requests": str(limit),
            "x-ratelimit-remaining-requests": str(remaining),
            "x-ratelimit-reset-requests": f"{reset_s:g}s"}

  def models_body(self) -> dict:
    return {"object": "list", "data": [
      {"id": m, "object": "model", "owned_by": "xotorch", "ready": True}
      for m in get_supported_models(self.inference_engine_classname)]}

  # ------------------------------------------------------- chat completions

  def _resolve_model(self, model: Optional[str]) -> str:
    if not model or model.startswith("gpt-"):
      return self.default_model
    return model

  async def _tokenizer_for(self, model: str):
    tok = self._tokenizers.get(model)
    if tok is None:
      card = get_model_card(model) or {}
      if "synthetic_config" in card or model == "dummy":
        tok = DummyTokenizer()
        eos = card.get("synthetic_config", {}).get("eos_token_id")
        if eos is not None:
          tok.eos_token_id = eos if isinstance(eos, int) else eos[0]
      else:
        tok = await self._checkpoint_tokenizer(model)
      self._tokenizers[model] = tok
    return tok

  async def _checkpoint_tokenizer(self, model: str):
    """A checkpoint's tokenizer: the engine's when it serves `model`, else the one its
    downloader's directory gives (the DummyTokenizer where none can be built there,
    as the engine does), else the repo id's."""
    engine = self.node.inference_engine
    shard = getattr(engine, "shard", None)
    if shard is not None and shard.model_id == model and engine.tokenizer is not None:
      return engine.tokenizer
    downloader = getattr(engine, "shard_downloader", None)
    if downloader is not None:
      try:
        local = await downloader.ensure_shard(build_base_shard(model, self.inference_engine_classname),
                                              self.inference_engine_classname)
      except Exception as e:
        if DEBUG >= 1:
          print(f"local tokenizer resolve for {model} failed ({e!r}); trying its repo id")
      else:
        return await tokenizer_for_dir(local)
    return await resolve_tokenizer(get_repo(model, self.inference_engine_classname))

  def _eos_ids(self, tokenizer) -> set:
    ids = set(self.node._eos_token_ids())
    eos = getattr(tokenizer, "eos_token_id", None)
    if eos is not None:
      ids.add(eos)
    return ids

  async def _request_prompt(self, model: str, messages: List[dict], tools: Optional[list]):
    """(prompt, tokenizer) of a request, the system prompt injected as a completion
    gets it."""
    if self.system_prompt and not any(m.get("role") == "system" for m in messages):
      messages = [{"role": "system", "content": self.system_prompt}] + messages
    tokenizer = await self._tokenizer_for(model)
    return build_prompt(tokenizer, messages, tools), tokenizer

  async def handle_post_prefetch(self, body: bytes) -> dict:
    """Announce a queued request's prompt so that the engine's host-to-device restore
    of its warm prefix starts before the request arrives (the JAX handler's route).
    Body: {model, prompt} or {model, messages[, tools]}; messages build the prompt a
    completion would run, so the prefix keys match. Fire and forget: 202 means the
    prefetch was scheduled, never that a warm prefix exists."""
    try:
      data = json.loads(body or b"{}")
    except (json.JSONDecodeError, UnicodeDecodeError):
      raise _invalid("body must be JSON") from None
    if not isinstance(data, dict):
      raise _invalid("body must be a JSON object")
    model = self._resolve_model(data.get("model"))
    shard = build_base_shard(model, self.inference_engine_classname)
    if shard is None:
      raise HTTPError(400, {"detail": f"Invalid model: {model}"})
    prompt = data.get("prompt")
    messages = data.get("messages")
    if not prompt and messages:
      if not isinstance(messages, list) or not all(isinstance(m, dict) for m in messages):
        raise _invalid("messages must be a list of objects")
      prompt, _ = await self._request_prompt(model, messages, data.get("tools"))
    if not prompt or not isinstance(prompt, str):
      raise _invalid("a non-empty `prompt` or `messages` list is required")
    spawn_detached(self.node.prefetch_prompt(shard, prompt), self._tasks)
    return {"accepted": True, "model": model}

  async def handle_post_chat_token_encode(self, data: dict) -> dict:
    """Tokenize a chat request without running it: the prompt a completion would run
    (system prompt and tools included), as the JAX package answers."""
    model = self._resolve_model(data.get("model"))
    if build_base_shard(model, self.inference_engine_classname) is None:
      raise HTTPError(400, {"detail": f"Invalid model: {model}"})
    prompt, tokenizer = await self._request_prompt(model, data.get("messages", []),
                                                   data.get("tools"))
    tokens = tokenizer.encode(prompt)
    tokens = tokens.tolist() if hasattr(tokens, "tolist") else list(tokens)
    return {"length": len(prompt), "num_tokens": len(tokens), "encoded_tokens": tokens,
            "encoded_prompt": prompt}

  @staticmethod
  def _parse_sampling(data: dict) -> Params:
    """The request's fields, validated with the JAX package's checks and messages (each
    a 400). Neutral values (a zero penalty or min_p, an empty logit_bias, logprobs
    false, n 1, no tools) parse as absent."""
    max_tokens = data.get("max_completion_tokens")
    if max_tokens is None:
      max_tokens = data.get("max_tokens")
    if max_tokens is not None and (isinstance(max_tokens, bool) or not isinstance(max_tokens, int)
                                   or max_tokens < 1):
      raise _invalid(f"max_tokens must be a positive integer, got {max_tokens!r}")
    temperature = data.get("temperature")
    if temperature is not None:
      if (isinstance(temperature, bool) or not isinstance(temperature, (int, float))
          or not 0 <= temperature <= 2):
        raise _invalid(f"temperature must be a number in [0, 2], got {temperature!r}")
      temperature = float(temperature)
    top_p = data.get("top_p")
    if top_p is not None:
      if isinstance(top_p, bool) or not isinstance(top_p, (int, float)) or not 0 < top_p <= 1:
        raise _invalid(f"top_p must be a number in (0, 1], got {top_p!r}")
      # The JAX package's 0.05 grid: top_p is a static of every captured decode graph
      # (a compile-time constant of JAX's executable), so a client's every distinct
      # value would otherwise capture graphs of its own. The floor of 0.05 keeps a tiny
      # top_p restrictive; a value that snaps to 1 (the OpenAI default) is off.
      top_p = max(0.05, round(float(top_p) * 20) / 20)
      top_p = top_p if top_p < 1 else None
    stop = data.get("stop")
    if stop is not None:
      if isinstance(stop, str):
        stop = [stop]
      if (not isinstance(stop, list) or not stop or len(stop) > 4
          or not all(isinstance(s, str) and s for s in stop)):
        raise _invalid(f"stop must be a non-empty string or list of 1-4 strings, got {stop!r}")
    sampling: dict = {}
    seed = data.get("seed")
    if seed is not None:
      if isinstance(seed, bool) or not isinstance(seed, int) or not -(2**63) <= seed < 2**63:
        raise _invalid(f"seed must be a 64-bit integer, got {seed!r}")
      sampling["seed"] = seed
    min_p = data.get("min_p")
    if min_p is not None:
      if isinstance(min_p, bool) or not isinstance(min_p, (int, float)) or not 0 <= min_p <= 1:
        raise _invalid(f"min_p must be a number in [0, 1], got {min_p!r}")
      if min_p:
        sampling["min_p"] = float(min_p)
    for key in ("presence_penalty", "frequency_penalty"):
      pen = data.get(key)
      if pen is not None:
        if isinstance(pen, bool) or not isinstance(pen, (int, float)) or not -2 <= pen <= 2:
          raise _invalid(f"{key} must be a number in [-2, 2], got {pen!r}")
        if pen:
          sampling[key] = float(pen)
    logit_bias = data.get("logit_bias")
    if logit_bias is not None:
      # isascii(): isdigit() alone admits non-ASCII digits that int() refuses.
      ok = (isinstance(logit_bias, dict) and len(logit_bias) <= 300
            and all(isinstance(k, (str, int)) and str(k).isascii() and str(k).isdigit()
                    and isinstance(v, (int, float)) and not isinstance(v, bool)
                    and -100 <= v <= 100
                    for k, v in logit_bias.items()))
      if not ok:
        raise _invalid("logit_bias must map up to 300 non-negative token ids "
                       "to numbers in [-100, 100]")
      if logit_bias:
        sampling["logit_bias"] = {str(k): float(v) for k, v in logit_bias.items()}
    want_logprobs = data.get("logprobs")
    top_logprobs = data.get("top_logprobs")
    if want_logprobs is not None and not isinstance(want_logprobs, bool):
      raise _invalid(f"logprobs must be a boolean, got {want_logprobs!r}")
    if top_logprobs is not None:
      if (isinstance(top_logprobs, bool) or not isinstance(top_logprobs, int)
          or not 0 <= top_logprobs <= 20):
        raise _invalid(f"top_logprobs must be an integer in [0, 20], got {top_logprobs!r}")
      if not want_logprobs:
        raise _invalid("top_logprobs requires logprobs to be true")
    if want_logprobs:
      sampling["logprobs"] = int(top_logprobs or 0)
    n = data.get("n")
    if n is None:
      n = 1  # an explicit null means the default, as in the OpenAI API
    if isinstance(n, bool) or not isinstance(n, int) or not 1 <= n <= 8:
      raise _invalid(f"n must be an integer in [1, 8], got {n!r}")
    return Params(max_tokens, temperature, top_p, stop, sampling or None, bool(want_logprobs),
                  data.get("tools") or None, n)

  async def handle_post_chat_completions(self, data: dict, writer: asyncio.StreamWriter) -> None:
    model = self._resolve_model(data.get("model"))
    shard = build_base_shard(model, self.inference_engine_classname)
    if shard is None:
      raise HTTPError(400, {"detail": f"Invalid model: {model}. Supported: "
                                      f"{get_supported_models(self.inference_engine_classname)}"})
    p = self._parse_sampling(data)
    messages = data.get("messages", [])
    images = check_images(model, messages)
    prompt, tokenizer = await self._request_prompt(model, messages, p.tools)

    # n completions of one prompt: sub-requests "rid#0".."rid#n-1" (seeded siblings
    # draw distinct streams; plain ones coalesce in the engine's batcher).
    base = str(uuid.uuid4())
    # Bounded admission (XOT_MAX_INFLIGHT, 0 = off): one slot for the whole HTTP request
    # (all n sub-completions), taken before the request touches the ring. Over the cap
    # it waits in the gate's queue (its warm prefix prefetched from the host tier the
    # moment it queues); past the queue it is shed as 429 with Retry-After.
    gate = self.node.admission
    try:
      held_slot = await gate.acquire(
        base, on_queued=lambda: spawn_detached(self.node.prefetch_prompt(shard, prompt), self._tasks))
    except AdmissionRejected as e:
      retry_after = max(1, int(math.ceil(e.retry_after_s)))
      raise HTTPError(429, {"error": {
        "type": "rate_limit_error", "code": "overloaded",
        "message": f"admission queue is full ({e.queued}/{e.limit} waiting); retry in ~{retry_after}s",
        "queue_depth": e.queued, "queue_limit": e.limit, "queue_position": e.queued + 1,
        "est_wait_s": e.retry_after_s}},
        headers={"Retry-After": str(retry_after),
                 **self._ratelimit_headers(remaining=0, reset_s=e.retry_after_s)}) from None
    rl_headers = self._ratelimit_headers()  # the budget as it stood at admission
    # The one-shot transparent restart (XOT_REQUEST_RESTARTS, 0 = off): a completion a
    # ring failure killed is resubmitted, all n siblings under a fresh base id (a cold
    # prefill on the healed ring), while nothing has reached the client and the
    # request deadline's wall time is not spent.
    restart_budget = max(0, knobs.get_int("XOT_REQUEST_RESTARTS"))
    deadline_s = knobs.get_float("XOT_REQUEST_DEADLINE_S")
    t0 = time.monotonic()
    all_rids: List[str] = []
    attempt = 0
    try:
      while True:
        request_ids = [base] if p.n == 1 else [f"{base}#{i}" for i in range(p.n)]
        all_rids.extend(request_ids)
        for rid in request_ids:
          self.token_queues[rid] = asyncio.Queue()
        for rid in request_ids:
          spawn_detached(self.node.process_prompt(shard, prompt, rid, max_tokens=p.max_tokens,
                                                  images=images,
                                                  temperature=p.temperature, top_p=p.top_p,
                                                  sampling=p.sampling), self._tasks)
        if data.get("stream"):
          include_usage = bool((data.get("stream_options") or {}).get("include_usage"))
          can_restart = (attempt < restart_budget
                         and (deadline_s <= 0 or time.monotonic() - t0 < deadline_s))
          try:
            await self._stream_response(writer, request_ids, model, tokenizer,
                                        prompt if include_usage else None, p.stop, p.logprobs,
                                        rl_headers, restartable=can_restart)
          except _StreamRestart as e:
            attempt += 1
            base = await self._restart_request(base, e.error)
            continue
          return
        eos_ids = self._eos_ids(tokenizer)
        results = await asyncio.gather(*(self._await_completion(rid, tokenizer, eos_ids, p.stop)
                                         for rid in request_ids))
        error = next((err for _, err in results if err), None)
        if (error is not None and attempt < restart_budget and self._restartable(error)
            and (deadline_s <= 0 or time.monotonic() - t0 < deadline_s)):
          attempt += 1
          base = await self._restart_request(base, error)
          continue
        status, body = self._full_response(request_ids, results, error, model, tokenizer, prompt,
                                           eos_ids, p.stop, p.logprobs)
        await self._write_json(writer, status, body, rl_headers)
        return
    except asyncio.TimeoutError:
      raise HTTPError(500, {"error": {"type": "server_error",
                                      "message": f"no token for {self.response_timeout} s"}}) from None
    finally:
      if held_slot:
        gate.release()  # wakes the oldest queued waiter
      for rid in all_rids:
        self.token_queues.pop(rid, None)
        # A sub-request that ended early here (an error, a timeout, a stop sequence, a
        # client gone, a failed attempt's sibling) must not decode on to its cap; a
        # finished one is a no-op.
        await self.node.cancel_request(rid)

  @staticmethod
  def _restartable(error: str) -> bool:
    """Client errors and spent deadlines are final; ring failures (hop errors, stalls,
    evicted peers) qualify for the restart."""
    return not error.startswith(("context_length_exceeded", "deadline_exceeded"))

  async def _restart_request(self, base_request_id: str, error: str) -> str:
    """Count the restart, heal the ring (one failed health check evicts, after a request
    just died there) and return the fresh request id the resubmission runs under."""
    self.node.metrics.request_restarts_total.inc()
    if DEBUG >= 1:
      print(f"restarting request {base_request_id} after: {error}")
    try:
      await self.node.heal_ring()
    except Exception as e:  # the restart runs on whatever ring there is
      if DEBUG >= 1:
        print(f"ring heal before restart failed: {e!r}")
    return str(uuid.uuid4())

  async def _await_completion(self, request_id: str, tokenizer, eos_ids: set,
                              stop: Optional[List[str]]):
    """One sub-request's full token list and error. With `stop`, the node is cancelled
    once a stop sequence shows in the new tokens (decoded with a stop-sized overlap of
    tokens before them)."""
    tokens: List[int] = []
    finished = False
    cancel_sent = False
    scanned = 0
    while not finished:
      payload, finished = await asyncio.wait_for(self.token_queues[request_id].get(),
                                                 timeout=self.response_timeout)
      if len(payload) >= len(tokens):
        tokens = payload  # an empty finish signal must not wipe the completion
      if stop and not cancel_sent and not finished and len(tokens) > scanned:
        overlap = max(len(s) for s in stop)
        window = [t for t in tokens[max(0, scanned - overlap):] if t not in eos_ids]
        scanned = len(tokens)
        if any(s in tokenizer.decode(window) for s in stop):
          cancel_sent = True
          await self.node.cancel_request(request_id)
    return tokens, self.node.request_errors.pop(request_id, None)

  @staticmethod
  def _error_body(error: str) -> Tuple[int, dict]:
    if error.startswith("context_length_exceeded"):
      return 400, {"error": {"type": "invalid_request_error",
                             "code": "context_length_exceeded", "message": error}}
    return 500, {"error": {"type": "server_error", "message": error}}

  def _logprob_content(self, tokenizer, token_ids: List[int], entries: list) -> list:
    """OpenAI logprobs content items: each token's text, logprob, UTF-8 bytes and the
    top alternatives the sampler reported (entries 1:1 with token_ids)."""
    items = []
    for tid, ent in zip(token_ids, entries):
      text = tokenizer.decode([tid])
      tops = []
      for alt_id, alt_lp in ent.get("top", ()):
        alt_text = tokenizer.decode([alt_id])
        tops.append({"token": alt_text, "logprob": alt_lp, "bytes": list(alt_text.encode("utf-8"))})
      items.append({"token": text, "logprob": ent["logprob"], "bytes": list(text.encode("utf-8")),
                    "top_logprobs": tops})
    return items

  def _full_response(self, request_ids: List[str], results, error: Optional[str], model: str,
                     tokenizer, prompt: str, eos_ids: set, stop: Optional[List[str]] = None,
                     logprobs: bool = False) -> Tuple[int, dict]:
    """The JSON completion from the sub-requests' (tokens, error) results (the JAX
    package's `_build_full_response`): each choice cut before its first stop sequence
    (finish "stop"), its logprobs drained from the node, EOS dropped."""
    if error is not None:
      return self._error_body(error)
    choices = []
    total = 0
    for idx, (tokens, _) in enumerate(results):
      finish_reason = "stop" if (tokens and tokens[-1] in eos_ids) else "length"
      content_tokens = [t for t in tokens if t not in eos_ids]
      content = tokenizer.decode(content_tokens) if content_tokens else ""
      stop_cut = False
      if stop:
        cut = min((i for i in (content.find(s) for s in stop) if i >= 0), default=-1)
        if cut >= 0:
          # OpenAI: the completion ends BEFORE the stop sequence.
          content, finish_reason, stop_cut = content[:cut], "stop", True
          content_tokens = list(tokenizer.encode(content)) if content else []
      total += len(content_tokens)
      lp_obj = None
      if logprobs:
        # None where another peer sampled: the token broadcast carries ids only.
        entries = self.node.pop_request_logprobs(request_ids[idx])
        if entries is not None:
          pairs = [(t, e) for t, e in zip(tokens, entries) if t not in eos_ids]
          if stop_cut:
            # Cut at the sampled tokens' boundary: keep tokens until their decode covers
            # the kept text (a re-encode may tokenize the cut text otherwise).
            kept: list = []
            for pair in pairs:
              if len(tokenizer.decode([q[0] for q in kept])) >= len(content):
                break
              kept.append(pair)
            pairs = kept
          lp_obj = {"content": self._logprob_content(tokenizer, [q[0] for q in pairs],
                                                     [q[1] for q in pairs])}
      choices.append({"index": idx, "message": {"role": "assistant", "content": content},
                      "logprobs": lp_obj, "finish_reason": finish_reason})
    prompt_tokens = len(tokenizer.encode(prompt))
    return 200, {
      "id": f"chatcmpl-{request_ids[0].split('#')[0]}",
      "object": "chat.completion",
      "created": int(time.time()),
      "model": model,
      "choices": choices,
      "usage": {"prompt_tokens": prompt_tokens, "completion_tokens": total,
                "total_tokens": prompt_tokens + total},
    }

  def _chunk(self, request_id: str, model: str, content: str, finish_reason: Optional[str],
             index: int = 0, logprobs: Optional[dict] = None) -> dict:
    return {
      "id": f"chatcmpl-{request_id.split('#')[0]}",
      "object": "chat.completion.chunk",
      "created": int(time.time()),
      "model": model,
      "choices": [{"index": index,
                   "delta": {"role": "assistant", "content": content} if content else {},
                   "logprobs": logprobs, "finish_reason": finish_reason}],
    }

  async def _stream_response(self, writer: asyncio.StreamWriter, request_ids: List[str], model: str,
                             tokenizer, usage_prompt: Optional[str] = None,
                             stop: Optional[List[str]] = None, logprobs: bool = False,
                             headers: Optional[dict] = None, restartable: bool = False) -> None:
    """Server-sent events over one or more completions (OpenAI n): the sub-requests'
    queues merged, one chunk per batch of new tokens carrying its choice index, the
    finish reason on each choice's last, then `data: [DONE]`. With `stop`, each choice's
    whole text is decoded again per batch and the last max(len(stop)) - 1 characters
    are held back until it finishes, so no part of a stop sequence reaches the client;
    a stop cuts the choice there (finish "stop") and cancels its request. With
    `logprobs` (and no stop) each chunk carries its tokens' logprobs. With
    `usage_prompt` (OpenAI stream_options include_usage) a final chunk with empty
    choices carries the usage. The headers go out with the first event, so an error
    before any token still gets a plain JSON error response, or, when `restartable`
    and the error is a ring failure, raises _StreamRestart for the handler's restart."""
    eos_ids = self._eos_ids(tokenizer)
    started = False

    async def send(obj) -> None:
      nonlocal started
      if not started:
        started = True
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(("HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                      f"Cache-Control: no-cache\r\n{extra}Connection: close\r\n\r\n").encode())
      data = obj if isinstance(obj, str) else json.dumps(obj)
      writer.write(f"data: {data}\n\n".encode())
      await writer.drain()

    n = len(request_ids)
    acc, sent_chars = [""] * n, [0] * n
    sent_tokens, completion, done = [0] * n, [0] * n, [False] * n
    holdback = max(len(s) for s in stop) - 1 if stop else 0
    merged: asyncio.Queue = asyncio.Queue()

    async def pump(idx: int, rid: str) -> None:
      while True:
        tokens, fin = await self.token_queues[rid].get()
        await merged.put((idx, rid, tokens, fin))
        if fin:
          return

    pumps = [spawn_detached(pump(i, rid)) for i, rid in enumerate(request_ids)]
    try:
      while not all(done):
        idx, rid, tokens, finished = await asyncio.wait_for(merged.get(),
                                                            timeout=self.response_timeout)
        if done[idx]:
          continue  # a straggler after a stop-sequence cut
        error = self.node.request_errors.pop(rid, None) if finished else None
        if error is not None:
          if not started and restartable and self._restartable(error):
            raise _StreamRestart(error)
          if not started:
            raise HTTPError(*self._error_body(error))
          etype = ("invalid_request_error" if error.startswith("context_length_exceeded")
                   else "server_error")
          await send({"error": {"type": etype, "message": error}})
          return
        delta = tokens[sent_tokens[idx]:]
        sent_tokens[idx] = max(sent_tokens[idx], len(tokens))
        finish_reason = None
        if finished:
          finish_reason = "stop" if (delta and delta[-1] in eos_ids) else "length"
        if stop:
          non_eos = [t for t in tokens if t not in eos_ids]
          text = tokenizer.decode(non_eos) if non_eos else ""
          scan_from = max(0, len(acc[idx]) - holdback)
          if len(text) >= len(acc[idx]):
            acc[idx] = text  # an empty finish signal must not wipe the text
          cut = min((i for i in (acc[idx].find(s, scan_from) for s in stop) if i >= 0), default=-1)
          if cut >= 0:
            content, finished, finish_reason = acc[idx][sent_chars[idx]:cut], True, "stop"
            completion[idx] = len(tokenizer.encode(acc[idx][:cut])) if cut else 0
            await self.node.cancel_request(rid)
          else:
            emit_to = len(acc[idx]) if finished else max(sent_chars[idx], len(acc[idx]) - holdback)
            content = acc[idx][sent_chars[idx]:emit_to]
            completion[idx] = len(non_eos)
          sent_chars[idx] += len(content)
        else:
          new_tokens = [t for t in delta if t not in eos_ids]
          completion[idx] += len(new_tokens)
          content = tokenizer.decode(new_tokens) if new_tokens else ""
        lp_obj = None
        if logprobs and not stop and delta:
          # Token-aligned: exactly this delta's entries. (A stop stream sends character
          # slices that cross token boundaries, so its chunks carry none.)
          entries = self.node.pop_request_logprobs(rid, len(delta))
          if entries is not None:
            pairs = [(t, e) for t, e in zip(delta, entries) if t not in eos_ids]
            lp_obj = {"content": self._logprob_content(tokenizer, [q[0] for q in pairs],
                                                       [q[1] for q in pairs])}
        done[idx] = done[idx] or finished
        await send(self._chunk(rid, model, content, finish_reason, index=idx, logprobs=lp_obj))
    finally:
      for task in pumps:
        task.cancel()
    if usage_prompt is not None:
      prompt_tokens = len(tokenizer.encode(usage_prompt))
      chunk = self._chunk(request_ids[0], model, "", None)
      chunk["choices"] = []
      total = sum(completion)
      chunk["usage"] = {"prompt_tokens": prompt_tokens, "completion_tokens": total,
                        "total_tokens": prompt_tokens + total}
      await send(chunk)
    await send("[DONE]")
