"""The router process: one OpenAI endpoint over N independent replicas.

The port's copy of xotorch_tpu/router/app.py, on the standard library: its server and
its client are the port's asyncio HTTP (api/http.py), where the JAX router uses aiohttp.
It

1. places each chat completion on a replica by session or prefix affinity, spilling to
   the least loaded one when the affinity target's queue is deep (`router.route`), and
   retries a 429 or a refused connection once on another replica;
2. pre-announces a queued or spilled prompt at the target's `/v1/prefetch`, so the host
   tier's restore (and, through it, a fabric fetch from a sibling) overlaps the wait;
3. chains a request through a prefill-role replica (XOT_FABRIC_ROLE=prefill) first and
   offers the resulting KV handle at the decode target's `/v1/kv/offer`;
4. hedges a request whose primary has produced no byte after the fleet's trailing p99
   (XOT_ROUTER_HEDGE_PCT > 0): the first attempt to answer wins, the other's connection
   is closed, which cancels it on its replica;
5. polls every replica's `/healthcheck`, `/v1/queue`, `/v1/alerts` and
   `/v1/history?compact=1` each XOT_ROUTER_POLL_S, feeds `ReplicaLifecycle` and the
   drift detector, sends canary completions to probing replicas, records every
   transition in its own flight recorder (`/v1/debug/flight`) and reports at
   `/v1/router`;
6. with a fleet template, runs the elastic controller (fleet/controller.py) once a poll.

The router holds no model state and shares nothing with the replicas but HTTP.
"""
from __future__ import annotations

import asyncio
import json
import time
from collections import deque
from typing import Dict, List, Optional
from urllib.parse import urlencode

from xotorch_tpu_torch.api import http
from xotorch_tpu_torch.orchestration.flight import FlightRecorder
from xotorch_tpu_torch.router import (ReplicaLifecycle, fleet_trailing_medians, hedge_delay_s,
                                      least_loaded, name_drift, prefix_key, replica_names, route)
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG, spawn_detached

_POLL_TIMEOUT = 5.0
_PROBE_TIMEOUT = 60.0
# Read-only conveniences any routable replica answers, so that OpenAI clients pointed at
# the router keep working.
PROXY_GETS = ("/v1/models", "/models", "/v1/topology", "/modelpool")
# What a request forwards to a prefetch, a chained prefill or a warm announce.
_PROMPT_KEYS = ("model", "messages", "tools")
# The upstream failures a forward treats as "never reached the replica".
_UPSTREAM_ERRORS = (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError)


def _passthrough_headers(upstream_headers: dict) -> dict:
  """The response headers relayed verbatim: Retry-After and the x-ratelimit-* family the
  replica's admission gate stamps."""
  return {k: v for k, v in upstream_headers.items()
          if k.lower() == "retry-after" or k.lower().startswith("x-ratelimit-")}


def _prompt_of(body: dict) -> dict:
  return {k: body[k] for k in _PROMPT_KEYS if k in body}


class _Replica:
  """One replica's live view: its lifecycle and the latest poll observations."""

  def __init__(self, name: str, url: str):
    self.name = name
    self.url = url
    self.lifecycle = ReplicaLifecycle(name)
    self.reachable = False
    # The latest /v1/queue admission compact; None until the first successful poll (an
    # unknown load ranks as heavy, never as idle).
    self.queue: Optional[dict] = None
    self.active_requests = 0
    # The replica's fabric role (XOT_FABRIC_ROLE, from /v1/queue): a prefill replica is
    # never routable, only the first leg of a chained request.
    self.role = "mixed"
    self.firing = 0
    self.suspect: Optional[str] = None
    # The latest /v1/history compact and its receive time on the router's clock; the
    # live drift comparison (`drift_hit`) and the name it has held on for
    # XOT_ROUTER_DRIFT_POLLS polls (`drift`); the last name ever held, kept after it
    # clears.
    self.history: Optional[dict] = None
    self.history_at: Optional[float] = None
    self.drift_hit: Optional[dict] = None
    self.drift_polls = 0
    self.drift: Optional[str] = None
    self.drift_last: Optional[dict] = None
    self.drift_named_total = 0
    self.routed_total = 0
    self.spilled_to_total = 0
    self.relayed_429_total = 0
    self.probe_inflight = False
    # Poll ticks in a row where the replica was unreachable or a scrape of it failed:
    # one signal for a dead process and an unobservable one (the fleet's dead detector).
    self.down_streak = 0
    self.scrape_failures_total = 0
    # Fleet gates: `warming` holds a fresh spawn out of rotation until its warm
    # announce lands, `retiring` a scale-down target while its work drains.
    self.warming = False
    self.retiring = False

  def view(self) -> dict:
    """The placement view `router.route` takes. A replica whose queue has never
    answered ranks as maximally loaded: affinity may still pick it, spill never does."""
    if self.queue is None:
      return {"name": self.name, "queued": 1 << 30, "est_wait_s": 1e9}
    return {"name": self.name, "queued": int(self.queue.get("queued") or 0),
            "est_wait_s": float(self.queue.get("est_wait_s") or 0.0)}

  def snapshot(self) -> dict:
    return {
      **self.lifecycle.snapshot(),
      "url": self.url, "reachable": self.reachable, "role": self.role,
      "firing": self.firing, "suspect": self.suspect,
      "drift": self.drift, "drift_hit": self.drift_hit, "drift_last": self.drift_last,
      "drift_named_total": self.drift_named_total,
      "active_requests": self.active_requests, "queue": self.queue,
      "routed_total": self.routed_total, "spilled_to_total": self.spilled_to_total,
      "relayed_429_total": self.relayed_429_total, "down_streak": self.down_streak,
      "scrape_failures_total": self.scrape_failures_total,
      "warming": self.warming, "retiring": self.retiring,
    }


class RouterApp:
  def __init__(self, replica_urls: List[str], fleet_template: Optional[str] = None,
               router_id: str = "router"):
    self.router_id = router_id
    if fleet_template:
      # The template is the replica universe: every slot, active or latent, has a row
      # now, so a scale-up never changes the table's shape.
      from xotorch_tpu_torch.fleet import load_template
      slot_urls = {s["name"]: str(s["url"]).rstrip("/") for s in load_template(fleet_template)}
    else:
      slot_urls = replica_names(replica_urls)
    self.replicas: Dict[str, _Replica] = {name: _Replica(name, url)
                                          for name, url in slot_urls.items()}
    self.poll_s = max(0.2, knobs.get_float("XOT_ROUTER_POLL_S"))
    self.spill_depth = max(0, knobs.get_int("XOT_ROUTER_SPILL_DEPTH"))
    self.probe_tokens = max(1, knobs.get_int("XOT_ROUTER_PROBE_TOKENS"))
    self.drift_enabled = knobs.get_bool("XOT_ROUTER_DRIFT")
    self.drift_polls_required = max(1, knobs.get_int("XOT_ROUTER_DRIFT_POLLS"))
    self.drift_peer_ratio = max(0.01, knobs.get_float("XOT_DRIFT_PEER_RATIO"))
    self.drift_min_samples = max(1, knobs.get_int("XOT_DRIFT_MIN_SAMPLES"))
    self.proxy_timeout = max(5.0, knobs.get_float("XOT_ROUTER_TIMEOUT_S"))
    # Hedging: 0% (the default) is the plain forward; the budget caps hedges at pct% of
    # proxied requests.
    self.hedge_pct = max(0.0, knobs.get_float("XOT_ROUTER_HEDGE_PCT"))
    self.hedge_factor = max(0.0, knobs.get_float("XOT_ROUTER_HEDGE_FACTOR"))
    self.hedge_min_s = max(0.0, knobs.get_float("XOT_ROUTER_HEDGE_MIN_S"))
    self.flight = FlightRecorder(node_id=router_id)
    self.proxied_total = 0
    self.no_replica_503_total = 0
    self.prefetch_announced_total = 0
    self.fabric_chained_total = 0
    self.fabric_chain_failures_total = 0
    self.hedges_fired_total = 0
    self.hedges_won_total = 0
    self.hedge_cancelled_total = 0
    # Zero by construction (one attempt a request is relayed): nonzero means two
    # attempts reached one client.
    self.hedge_both_streamed_total = 0
    # Recent prompts: what the fleet controller announces at a fresh spawn.
    self.recent_bodies: deque = deque(maxlen=32)
    self._poll_task = None
    self._server: Optional[asyncio.AbstractServer] = None
    self._tasks: set = set()
    self.fleet = None
    if fleet_template:
      from xotorch_tpu_torch.fleet.controller import FleetController
      self.fleet = FleetController(self, fleet_template, router_id)

  # -------------------------------------------------------------- lifecycle

  async def start(self) -> None:
    self._poll_task = spawn_detached(self._poll_loop(), self._tasks)

  async def run(self, host: str = "0.0.0.0", port: int = 52400) -> asyncio.AbstractServer:
    """Start polling and serving; returns the listening server."""
    await self.start()
    self._server = await asyncio.start_server(self._handle_connection, host, port)
    if DEBUG >= 0:
      print(f"xot router on http://{host}:{port} over {len(self.replicas)} replica(s): "
            + ", ".join(f"{n}={r.url}" for n, r in self.replicas.items()), flush=True)
    return self._server

  async def stop(self) -> None:
    if self._poll_task is not None:
      self._poll_task.cancel()
      try:
        await self._poll_task
      except asyncio.CancelledError:
        pass
      self._poll_task = None
    if self._server is not None:
      self._server.close()
      self._server = None
    if self.fleet is not None:
      # Hand actuation to a surviving router now, not after a TTL.
      self.fleet.lease.release()

  def routable(self) -> List[_Replica]:
    # Prefill replicas answer KV handles, not token streams; warming and retiring ones
    # are out of rotation by the controller's decree.
    return [r for r in self.replicas.values()
            if r.lifecycle.routable and r.reachable and r.role != "prefill"
            and not r.warming and not r.retiring]

  def prefill_replicas(self) -> List[_Replica]:
    return [r for r in self.replicas.values()
            if r.lifecycle.routable and r.reachable and r.role == "prefill"]

  # ------------------------------------------------------------ poll + probe

  async def _poll_one(self, rep: _Replica) -> None:
    """One replica's poll tick. Only a tick where the healthcheck answered and every
    scrape succeeded is clean; unclean ticks in a row make `down_streak`."""
    clean = await self._poll_endpoints(rep)
    rep.down_streak = 0 if clean else rep.down_streak + 1

  async def _scrape(self, rep: _Replica, path: str) -> dict:
    status, data = await http.fetch_json("GET", rep.url + path, timeout=_POLL_TIMEOUT)
    if status != 200 or not isinstance(data, dict):
      raise ValueError(f"{path}: HTTP {status}")
    return data

  async def _poll_endpoints(self, rep: _Replica) -> bool:
    clean = True
    try:
      status, _ = await http.fetch_json("GET", rep.url + "/healthcheck", timeout=_POLL_TIMEOUT)
      rep.reachable = status == 200
    except Exception:
      rep.reachable = False
    if not rep.reachable:
      return False
    # Each scrape that fails keeps the last observed view (fail closed): zeroing it
    # would make the replica whose endpoint just timed out look the least loaded, or
    # promote a still-burning one out of draining.
    try:
      q = await self._scrape(rep, "/v1/queue")
      rep.queue = q.get("admission") or {}
      rep.active_requests = int(q.get("active_requests") or 0)
      rep.role = str(q.get("fabric_role") or "mixed")
    except Exception as e:
      clean = False
      rep.scrape_failures_total += 1
      if DEBUG >= 2:
        print(f"router: /v1/queue poll of {rep.name} failed: {e!r}")
    try:
      cluster = (await self._scrape(rep, "/v1/alerts")).get("cluster") or {}
      rep.firing = int(cluster.get("firing") or 0)
      rep.suspect = next((str(row["suspect"]) for row in cluster.get("active") or []
                          if row.get("suspect")), None)
    except Exception as e:
      clean = False
      rep.scrape_failures_total += 1
      if DEBUG >= 2:
        print(f"router: /v1/alerts poll of {rep.name} failed: {e!r}")
    if not self.drift_enabled:
      return clean
    try:
      h = await self._scrape(rep, "/v1/history?compact=1")
      rep.history = h.get("compact") if h.get("enabled") else None
      rep.history_at = time.monotonic()  # the router's clock, never the replica's
    except Exception as e:
      clean = False
      rep.scrape_failures_total += 1
      if DEBUG >= 2:
        print(f"router: /v1/history poll of {rep.name} failed: {e!r}")
    return clean

  async def _probe_one(self, rep: _Replica) -> None:
    """One canary completion against a probing replica (no model: it serves its
    default). The outcome is stamped when the probe completes, so a readmission is
    never backdated."""
    rep.probe_inflight = True
    try:
      body = {"messages": [{"role": "user", "content": "router canary probe"}],
              "max_tokens": self.probe_tokens, "temperature": 0}
      try:
        status, data = await http.fetch_json("POST", rep.url + "/v1/chat/completions", body,
                                             timeout=_PROBE_TIMEOUT)
        content = (data.get("choices") or [{}])[0].get("message", {}).get("content")
        ok = status == 200 and bool(content)
      except Exception:
        ok = False
      now = time.monotonic()
      if rep.lifecycle.note_probe(ok, now) is not None:  # the one probe transition
        self.flight.record("replica.readmitted", None, replica=rep.name,
                           probes=rep.lifecycle.probes_required,
                           out_s=round(now - (rep.lifecycle.drained_at or now), 2))
        if DEBUG >= 0:
          print(f"router: replica {rep.name} readmitted after "
                f"{rep.lifecycle.probes_required} canaries", flush=True)
    finally:
      rep.probe_inflight = False

  def _note_drift(self, rep: _Replica) -> None:
    """One tick of the differential drift detector: this replica's trailing gauges
    against the median of its healthy reachable peers', debounced over polls. Run for
    every reachable replica, so a drained one can clear its name."""
    now = time.monotonic()

    def fresh(r: _Replica) -> Optional[dict]:
      # A compact that stopped refreshing is history, not evidence.
      if (r.history is None or r.history_at is None
          or now - r.history_at > max(10.0 * self.poll_s, 30.0)):
        return None
      return r.history

    peers = [h for r in self.replicas.values()
             if r is not rep and r.reachable and r.lifecycle.routable
             for h in (fresh(r),) if h is not None]
    if not peers:
      # No reference fleet, no verdict: a confirmed name must not clear for want of
      # peers.
      rep.drift_hit = None
      return
    hit = name_drift(fresh(rep), fleet_trailing_medians(peers, min_n=self.drift_min_samples),
                     self.drift_peer_ratio, min_n=self.drift_min_samples)
    rep.drift_hit = hit
    if hit is None:
      rep.drift_polls = 0
      rep.drift = None
      return
    # One suspect at a time: while another replica is out the median is no steady
    # reference, and the debounce restarts.
    if not all(r.lifecycle.state == "healthy" for r in self.replicas.values() if r is not rep):
      rep.drift_polls = 0
      return
    rep.drift_polls += 1
    if rep.drift_polls >= self.drift_polls_required and rep.drift is None:
      rep.drift = f"perf_drift:{hit['metric']}"
      rep.drift_last = {"name": rep.drift, "at": time.time(), **hit}
      rep.drift_named_total += 1
      self.flight.record("drift.replica", None, replica=rep.name, metric=hit["metric"],
                         value=hit["value"], peer_median=hit["peer_median"],
                         worse_by=hit["worse_by"])
      if DEBUG >= 0:
        print(f"router: replica {rep.name} named {rep.drift} "
              f"({hit['value']} vs fleet median {hit['peer_median']})", flush=True)

  async def poll_tick(self) -> None:
    """One pass: poll every replica, the drift detector, the lifecycles, canaries to
    probing replicas, then the fleet controller."""
    now = time.monotonic()
    await asyncio.gather(*(self._poll_one(r) for r in self.replicas.values()))
    if self.drift_enabled:
      for rep in self.replicas.values():
        if rep.reachable:
          self._note_drift(rep)
    for rep in self.replicas.values():
      inflight = rep.active_requests
      q = rep.queue or {}
      if q.get("max_inflight"):
        inflight = max(inflight, int(q.get("inflight") or 0))
      ev = rep.lifecycle.note_status(now, firing=rep.firing, suspect=rep.suspect or rep.drift,
                                     inflight=inflight, reachable=rep.reachable)
      if ev is not None:
        if ev["transition"] == "draining":
          self.flight.record("replica.draining", None, replica=rep.name, reason=ev["reason"])
        elif ev["transition"] == "probing":
          self.flight.record("replica.probing", None, replica=rep.name)
        if DEBUG >= 0:
          print(f"router: replica {rep.name} -> {ev['transition']} ({ev.get('reason') or ''})",
                flush=True)
      if rep.lifecycle.state == "probing" and rep.reachable and not rep.probe_inflight:
        spawn_detached(self._probe_one(rep), self._tasks)
    if self.fleet is not None:
      self.fleet.tick(now)  # after the lifecycles it reads; never raises

  async def _poll_loop(self) -> None:
    while True:
      await asyncio.sleep(self.poll_s)
      try:
        await self.poll_tick()
      except Exception as e:
        if DEBUG >= 1:
          print(f"router poll error: {e!r}")

  # ------------------------------------------------------------------ HTTP

  async def _handle_connection(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
    try:
      method, path, query, body, _ = await http.read_request(reader)
      await self._dispatch(method, path, query, body, writer)
    except (asyncio.IncompleteReadError, ConnectionError):
      pass  # the client went away: closing its upstream cancels the request there
    except http.BadRequest as e:
      await http.write_json(writer, 400, {"error": {"type": "invalid_request_error",
                                                    "message": str(e)}})
    except Exception as e:
      print(f"router error: {e!r}")
      try:
        await http.write_json(writer, 500, {"error": {"type": "server_error",
                                                      "message": repr(e)}})
      except ConnectionError:
        pass
    finally:
      await http.close_writer(writer)

  async def _dispatch(self, method: str, path: str, query: dict, body: bytes,
                      writer: asyncio.StreamWriter) -> None:
    if path in ("/v1/chat/completions", "/chat/completions") and method == "POST":
      await self.handle_chat(body, writer)
    elif method != "GET":
      await http.write_json(writer, 405, {"detail": f"{method} not allowed on {path}"})
    elif path == "/healthcheck":
      await http.write_json(writer, 200, {"status": "ok", "replicas": len(self.replicas),
                                          "routable": len(self.routable())})
    elif path == "/v1/router":
      await http.write_json(writer, 200, self.status())
    elif path == "/v1/debug/flight":
      await http.write_json(writer, 200, {"node_id": "router", **self.flight.stats(),
                                          "snapshots": self.flight.snapshots(),
                                          "events": self.flight.tail(0)})
    elif path in PROXY_GETS:
      await self.handle_proxy_get(path + (f"?{urlencode(query)}" if query else ""), writer)
    else:
      await http.write_json(writer, 404, {"detail": f"no route {method} {path}"})

  def status(self) -> dict:
    reps = self.replicas.values()
    return {
      "router_id": self.router_id,
      "replicas": {name: rep.snapshot() for name, rep in self.replicas.items()},
      "routable": [r.name for r in self.routable()],
      "proxied_total": self.proxied_total,
      "no_replica_503_total": self.no_replica_503_total,
      "prefetch_announced_total": self.prefetch_announced_total,
      "fabric_chained_total": self.fabric_chained_total,
      "fabric_chain_failures_total": self.fabric_chain_failures_total,
      "hedges_fired_total": self.hedges_fired_total,
      "hedges_won_total": self.hedges_won_total,
      "hedge_cancelled_total": self.hedge_cancelled_total,
      "hedge_both_streamed_total": self.hedge_both_streamed_total,
      "scrape_failures_total": sum(r.scrape_failures_total for r in reps),
      "prefill_replicas": [r.name for r in self.prefill_replicas()],
      "drains_total": sum(r.lifecycle.drains_total for r in reps),
      "readmits_total": sum(r.lifecycle.readmits_total for r in reps),
      "drift_named_total": sum(r.drift_named_total for r in reps),
      "poll_s": self.poll_s, "spill_depth": self.spill_depth,
      "fleet": self.fleet.status() if self.fleet is not None else None,
    }

  async def handle_proxy_get(self, path_qs: str, writer: asyncio.StreamWriter) -> None:
    targets = self.routable() or [r for r in self.replicas.values() if r.reachable]
    if not targets:
      await http.write_json(writer, 503, {"detail": "no reachable replica"})
      return
    rep = targets[0]
    try:
      resp = await http.request("GET", rep.url + path_qs, timeout=_POLL_TIMEOUT)
      data = await asyncio.wait_for(resp.read(), _POLL_TIMEOUT)
    except Exception as e:
      await http.write_json(writer, 502, {"detail": f"replica {rep.name} failed: {e!r}"})
      return
    await http.write_response(writer, resp.status, data, resp.content_type)

  def _post_prefetch(self, rep: _Replica, payload: dict) -> "asyncio.Task":
    async def announce():
      try:
        status, _ = await http.fetch_json("POST", rep.url + "/v1/prefetch", payload,
                                          timeout=_POLL_TIMEOUT)
        if status == 202:
          self.prefetch_announced_total += 1
      except Exception as e:
        if DEBUG >= 2:
          print(f"router: prefetch announce to {rep.name} failed: {e!r}")
    return spawn_detached(announce(), self._tasks)

  def _announce_prefetch(self, rep: _Replica, body: dict, force: bool = False) -> None:
    """Ship the request's messages to the target's /v1/prefetch, so that its host tier
    starts the warm-prefix restore while the request waits. Only where the target has a
    wait (its slots full or its queue non-empty), or has just been readmitted, or when
    `force`d: a spill target is by construction not the prefix's affinity owner, and
    the announce is what starts its fabric fetch from the sibling that is."""
    q = rep.queue or {}
    waiting = (int(q.get("queued") or 0) > 0
               or (int(q.get("max_inflight") or 0) > 0
                   and int(q.get("inflight") or 0) >= int(q.get("max_inflight") or 0)))
    readmit_at = rep.lifecycle.readmitted_at
    fresh_readmit = readmit_at is not None and time.monotonic() - readmit_at < 10.0 * self.poll_s
    if force or waiting or fresh_readmit:
      self._post_prefetch(rep, _prompt_of(body))

  def spawn_warm_announce(self, rep: _Replica, n: int) -> None:
    """The fleet's warm start: post the last `n` recent prompts to a freshly booted
    replica's /v1/prefetch (each one restores from its host tier or, where a sibling
    holds the KV, fetches over the fabric), then clear `warming` so that it enters
    rotation. Every failure is absorbed."""
    bodies = list(self.recent_bodies)[-n:] if n > 0 else []

    async def warm():
      try:
        for payload in bodies:
          await self._post_prefetch(rep, payload)
      finally:
        rep.warming = False

    spawn_detached(warm(), self._tasks)

  async def _chain_prefill(self, rep: _Replica, body: dict) -> None:
    """Disaggregated serving: prefill the prompt on a prefill-role replica, then offer
    its KV handle at the decode target (`/v1/kv/offer`), awaited, so that the offer
    lands before the decode replica's prefix lookup runs. Every failure (no prefill
    replica is not one) is counted and the request is forwarded plainly."""
    pre = next((r for r in self.prefill_replicas() if r is not rep), None)
    if pre is None:
      return
    payload = {**_prompt_of(body), "stream": False}
    try:
      status, handle = await http.fetch_json("POST", pre.url + "/v1/chat/completions", payload,
                                             timeout=self.proxy_timeout)
      if (status != 200 or not isinstance(handle, dict) or handle.get("object") != "kv.handle"
          or not handle.get("tokens")):
        raise ValueError(f"no kv.handle from {pre.name}")
      pre.routed_total += 1
      offer = {"model": body.get("model"), "tokens": handle["tokens"],
               "length": handle.get("length"), "nbytes": handle.get("nbytes"), "url": pre.url}
      status, _ = await http.fetch_json("POST", rep.url + "/v1/kv/offer", offer,
                                        timeout=_POLL_TIMEOUT)
      if status != 202:
        raise ValueError(f"offer to {rep.name} rejected ({status})")
      self.fabric_chained_total += 1
    except Exception as e:
      self.fabric_chain_failures_total += 1
      if DEBUG >= 1:
        print(f"router: prefill chain via {pre.name} failed (decode target prefills cold): {e!r}")

  async def _no_replica_503(self, writer: asyncio.StreamWriter) -> None:
    self.no_replica_503_total += 1
    await http.write_json(
      writer, 503, {"error": {"type": "server_error", "code": "no_replica",
                              "message": "no healthy replica is accepting traffic"}},
      headers={"Retry-After": str(int(self.poll_s * 2) or 1)})

  async def handle_chat(self, raw: bytes, writer: asyncio.StreamWriter) -> None:
    try:
      body = json.loads(raw or b"{}")
    except (json.JSONDecodeError, UnicodeDecodeError):
      await http.write_json(writer, 400, {"error": {"type": "invalid_request_error",
                                                    "message": "body must be JSON"}})
      return
    if not isinstance(body, dict):
      await http.write_json(writer, 400, {"error": {"type": "invalid_request_error",
                                                    "message": "body must be a JSON object"}})
      return
    views = [r.view() for r in self.routable()]
    picked = route(prefix_key(body), views, self.spill_depth)
    if picked is None:
      await self._no_replica_503(writer)
      return
    name, spilled = picked
    rep = self.replicas[name]
    rep.routed_total += 1
    if spilled:
      rep.spilled_to_total += 1
    self.proxied_total += 1
    self.recent_bodies.append(_prompt_of(body))
    self._announce_prefetch(rep, body, force=spilled)
    await self._chain_prefill(rep, body)
    if await self._forward_hedged(rep, body, writer):
      return
    # Shed (429) or never reached: one retry on the least loaded other replica, by queue
    # depth, not affinity, re-read against the live routable set.
    routable_now = {r.name for r in self.routable()}
    least = least_loaded([v for v in views if v["name"] != name and v["name"] in routable_now])
    if least is not None:
      alt = self.replicas[str(least["name"])]
      alt.routed_total += 1
      alt.spilled_to_total += 1
      self._announce_prefetch(alt, body, force=True)
      if await self._forward(alt, body, writer):
        return
    # The final attempt relays a 429 if it still sheds; an admitted request streams as
    # any other.
    final_now = {r.name for r in self.routable()}
    final = rep if rep.name in final_now else None
    if final is None:
      fallback = least_loaded([r.view() for r in self.routable()])
      final = self.replicas[str(fallback["name"])] if fallback else None
    if final is None:
      await self._no_replica_503(writer)
      return
    final.routed_total += 1
    await self._forward(final, body, writer, final=True)

  async def _forward(self, rep: _Replica, body: dict, writer: asyncio.StreamWriter,
                     final: bool = False) -> bool:
    """Proxy one completion. False when the replica answered 429 or could not be
    reached and `final` is not set (the caller may retry elsewhere); `final` relays the
    429, or answers 502. Streams are relayed chunk for chunk as they arrive."""
    try:
      upstream = await http.request("POST", rep.url + "/v1/chat/completions", body,
                                    timeout=self.proxy_timeout)
    except _UPSTREAM_ERRORS as e:
      return await self._connect_failed(rep, e, final, writer)
    try:
      if upstream.status == 429 and not final:
        return False
      if not body.get("stream") or upstream.status != 200:
        try:
          data = await asyncio.wait_for(upstream.read(), self.proxy_timeout)
        except _UPSTREAM_ERRORS as e:
          return await self._connect_failed(rep, e, final, writer)
        if upstream.status == 429:
          rep.relayed_429_total += 1
        await http.write_response(writer, upstream.status, data, upstream.content_type,
                                  _passthrough_headers(upstream.headers))
        return True
      await self._relay_chunks(upstream, b"", writer)
      return True
    finally:
      upstream.close()

  async def _relay_chunks(self, upstream: http.Response, first: bytes,
                          writer: asyncio.StreamWriter) -> None:
    writer.write(http.response_head(
      200, upstream.headers.get("content-type", "text/event-stream"),
      headers={"Access-Control-Allow-Origin": "*", **_passthrough_headers(upstream.headers)}))
    if first:
      writer.write(first)
    await writer.drain()
    async for chunk in upstream.chunks():
      writer.write(chunk)
      await writer.drain()

  async def _connect_failed(self, rep: _Replica, e: Exception, final: bool,
                            writer: asyncio.StreamWriter) -> bool:
    """A request that never reached the replica is safe to retry elsewhere: mark the
    replica unreachable now (the next tick drains it) and let the caller retry. On the
    final attempt there is nowhere left to go: 502."""
    rep.reachable = False
    if DEBUG >= 1:
      print(f"router: forward to {rep.name} failed: {e!r}")
    if not final:
      return False
    await http.write_json(writer, 502, {"error": {"type": "server_error",
                                                  "message": f"replica {rep.name} failed: {e!r}"}})
    return True

  # ---------------------------------------------------------------- hedging

  def _hedge_delay(self) -> float:
    return hedge_delay_s((r.history for r in self.routable() if r.history is not None),
                         self.hedge_factor, self.hedge_min_s)

  async def _forward_hedged(self, rep: _Replica, body: dict, writer: asyncio.StreamWriter) -> bool:
    """The first forward, with tail hedging: if the primary has produced no byte after
    the hedge delay, the request is duplicated at the least loaded other replica and
    the first attempt to produce a byte wins; the loser's connection is closed, which
    ends it on its replica. No hedge after a first byte: an attempt settles at its
    first byte and a hedge fires only while the primary is unsettled. At 0% this is
    `_forward`."""
    if self.hedge_pct <= 0:
      return await self._forward(rep, body, writer)
    others = [r for r in self.routable() if r is not rep]
    budget_ok = self.hedges_fired_total + 1 <= self.hedge_pct / 100.0 * max(1, self.proxied_total)
    if not others or not budget_ok:
      return await self._forward(rep, body, writer)
    streaming = bool(body.get("stream"))
    delay = self._hedge_delay()
    primary = spawn_detached(self._open_attempt(rep, body, streaming), self._tasks)
    done, _ = await asyncio.wait({primary}, timeout=delay)
    if done:
      return await self._settle_attempts(None, [(primary, rep)], writer)
    rid = f"hedge-{self.hedges_fired_total}-{int(time.time() * 1000) % 1000000}"
    alt = self.replicas[str(least_loaded([r.view() for r in others])["name"])]
    self.hedges_fired_total += 1
    alt.routed_total += 1
    self.flight.record("hedge.fired", rid, primary=rep.name, alt=alt.name, delay_s=round(delay, 3))
    alt_task = spawn_detached(self._open_attempt(alt, body, streaming), self._tasks)
    return await self._settle_attempts(rid, [(primary, rep), (alt_task, alt)], writer)

  async def _open_attempt(self, rep: _Replica, body: dict, streaming: bool) -> dict:
    """POST one attempt and wait for its first byte, touching no client: a streaming 200
    settles on its first chunk, anything else (a JSON completion, a 429, an error) on
    its whole body. On an error the upstream connection is closed here."""
    resp = await http.request("POST", rep.url + "/v1/chat/completions", body,
                              timeout=self.proxy_timeout)
    try:
      if not streaming or resp.status != 200:
        data = await asyncio.wait_for(resp.read(), self.proxy_timeout)
        return {"rep": rep, "resp": resp, "status": resp.status, "body": data, "streaming": False}
      first = await asyncio.wait_for(resp.first_chunk(), self.proxy_timeout)
      return {"rep": rep, "resp": resp, "status": resp.status, "first": first, "streaming": True}
    except BaseException:
      resp.close()
      raise

  async def _settle_attempts(self, rid: Optional[str], attempts, writer) -> bool:
    """Race the attempts to the first usable one (opened, not a 429), end every other,
    relay the winner. With one attempt this is `_forward`'s contract: a 429 or a failed
    connection gives False."""
    tasks = [t for t, _ in attempts]
    rep_of = {id(t): r for t, r in attempts}
    hedged = len(tasks) > 1
    pending = {t for t in tasks if not t.done()}
    settled = [t for t in tasks if t.done()]
    winner, saw_429, last_fail = None, False, None
    while True:
      for t in (t for t in tasks if t in settled):
        if t.cancelled():
          continue
        if t.exception() is not None:
          last_fail = (rep_of[id(t)], t.exception())
          continue
        att = t.result()
        if winner is not None:
          self._abort_attempt(rid, att, hedged)
        elif att["status"] == 429:
          saw_429 = True
          att["resp"].close()
        else:
          winner = att
      settled = []
      if winner is not None or not pending:
        break
      done, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
      settled = list(done)
    for t in pending:
      self._cancel_task(rid, t, hedged)
    if winner is None:
      if saw_429:
        return False
      rep, exc = last_fail if last_fail else (attempts[0][1], RuntimeError("no attempt ran"))
      return await self._connect_failed(rep, exc, False, writer)
    if hedged and winner["rep"] is not attempts[0][1]:
      self.hedges_won_total += 1
      self.flight.record("hedge.won", rid, winner=winner["rep"].name, primary=attempts[0][1].name)
    return await self._relay_attempt(winner, writer)

  def _abort_attempt(self, rid: Optional[str], att: dict, hedged: bool) -> None:
    """End a losing attempt on its replica: closing its connection before the body is
    read trips the replica's disconnect path, which cancels the request."""
    att["resp"].close()
    if hedged:
      self.hedge_cancelled_total += 1
      self.flight.record("hedge.cancelled", rid, loser=att["rep"].name)
      self.flight.freeze(rid, reason="hedge.cancelled")

  def _cancel_task(self, rid: Optional[str], task, hedged: bool) -> None:
    """Cancel an unsettled attempt; one that settled meanwhile is aborted by the done
    callback."""
    if task.done():
      if not task.cancelled() and task.exception() is None:
        self._abort_attempt(rid, task.result(), hedged)
      return
    task.cancel()

    def _reap(t):
      if not t.cancelled() and t.exception() is None:
        t.result()["resp"].close()

    task.add_done_callback(_reap)
    if hedged:
      self.hedge_cancelled_total += 1
      self.flight.record("hedge.cancelled", rid, loser="(unsettled)")
      self.flight.freeze(rid, reason="hedge.cancelled")

  async def _relay_attempt(self, att: dict, writer: asyncio.StreamWriter) -> bool:
    """Relay the winner. One attempt a request gets here; a second is counted, never
    relayed."""
    if att.get("relayed"):
      self.hedge_both_streamed_total += 1
      return True
    att["relayed"] = True
    resp = att["resp"]
    try:
      if not att["streaming"]:
        await http.write_response(writer, att["status"], att["body"], resp.content_type,
                                  _passthrough_headers(resp.headers))
      else:
        await self._relay_chunks(resp, att.get("first") or b"", writer)
      return True
    finally:
      resp.close()
