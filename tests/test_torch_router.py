"""The port's front door (xotorch_tpu_torch/router) against the JAX package's, on the CPU.

The pure half: JAX's lifecycle scenarios (tests/test_router.py) replayed op by op
through both packages' ReplicaLifecycle, every transition and snapshot equal; prefix
keys, rendezvous picks, routes with spill, the least loaded view, replica names, the
hedge delay and the drift verdicts equal on the same inputs.

The router process, on the standard library, over two port API servers with the dummy
engine: it proxies plain and streaming completions with affinity and reports at
/v1/router; skips a drained replica and answers 503 with none left; spills on a 429
(forcing the prefix pre-announce at the spill target) and relays the last one
well-formed; fails over when a replica's server is gone; degrades a failed prefill
chain to a plain forward; hedges a silent primary (the winner's stream equal to an
unhedged one, the loser cancelled on its replica) and never hedges a settled one; turns
scrape failures into the down streak. The replicas' new routes: /v1/queue's fabric
role, the /v1/kv/* validation and clean misses, /modelpool and /initial_models against
the JAX handler's, and /quit.
"""
import asyncio
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import xotorch_tpu.router as j_router
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch import router as p_router
from xotorch_tpu_torch.api import http
from xotorch_tpu_torch.router.app import RouterApp, _Replica


# ------------------------------------------------------------ the pure half

# JAX's lifecycle scenarios as op scripts: ("status", now, kwargs) or ("probe", ok, now).
LIFECYCLE_SCRIPTS = {
  "drains_on_firing": [("status", 100.0, {"firing": 1})],
  "drains_on_suspect": [("status", 100.0, {"firing": 0, "suspect": "node-b"})],
  "drains_when_lost": [("status", 99.0, {"reachable": True}), ("status", 100.0, {"reachable": False})],
  "healthy_traffic_stays": [("status", 100.0, {"firing": 0, "inflight": 5})],
  "draining_waits": [("status", 0.0, {"firing": 1}), ("status", 1.0, {"firing": 1, "inflight": 3}),
                     ("status", 2.0, {"firing": 1, "inflight": 0}),
                     ("status", 3.0, {"firing": 0, "inflight": 0})],
  "probe_failure_keeps_out": [("status", 0.0, {"firing": 1}), ("status", 1.0, {"firing": 0, "inflight": 0}),
                              ("probe", True, 20.0), ("probe", False, 21.0), ("probe", True, 22.0),
                              ("probe", True, 23.0)],
  "refire_while_probing": [("status", 0.0, {"firing": 1}), ("status", 1.0, {"firing": 0, "inflight": 0}),
                           ("status", 8.0, {"firing": 1}), ("probe", True, 9.0),
                           ("status", 10.0, {"firing": 0, "inflight": 0}), ("probe", True, 11.0),
                           ("probe", True, 12.0), ("probe", True, 18.5)],
  "flap_hysteresis": [("status", 0.0, {"firing": 1}), ("status", 1.0, {"firing": 0, "inflight": 0}),
                      ("probe", True, 5.0), ("probe", True, 6.0), ("probe", True, 11.0),
                      ("status", 16.0, {"firing": 1}), ("status", 17.0, {"firing": 0, "inflight": 0}),
                      ("probe", True, 20.0), ("probe", True, 30.0), ("probe", True, 37.0),
                      ("status", 300.0, {"firing": 1})],
  "joining_is_not_drained": [("status", 0.0, {"reachable": False}), ("status", 1.0, {"reachable": False}),
                             ("status", 2.0, {"reachable": True}), ("status", 3.0, {"reachable": False})],
  "suspect_while_probing": [("status", 0.0, {"suspect": "x"}), ("status", 1.0, {"inflight": 0}),
                            ("status", 2.0, {"suspect": "x"}), ("status", 3.0, {"reachable": False})],
}


@pytest.mark.parametrize("script", sorted(LIFECYCLE_SCRIPTS))
def test_lifecycle_scenarios_match_jax(script):
  """Each op's transition (or None), the state, the out-time and the snapshot are
  equal after every op of the script."""
  kw = {"probes_required": 2, "min_out_s": 10.0, "flap_window_s": 60.0}
  lcs = [p_router.ReplicaLifecycle("r0", **kw), j_router.ReplicaLifecycle("r0", **kw)]
  for op in LIFECYCLE_SCRIPTS[script]:
    outs = []
    for lc in lcs:
      ev = (lc.note_status(op[1], **op[2]) if op[0] == "status" else lc.note_probe(op[1], op[2]))
      outs.append((ev, lc.state, lc.routable, lc.required_out_s(), lc.snapshot()))
    assert outs[0] == outs[1], (script, op)
  assert lcs[0].snapshot() == lcs[1].snapshot()


def test_lifecycle_reads_the_same_knobs(monkeypatch):
  for name, value in (("XOT_ROUTER_PROBES", "3"), ("XOT_ROUTER_MIN_OUT_S", "4"),
                      ("XOT_ROUTER_FLAP_S", "7")):
    monkeypatch.setenv(name, value)
  p, j = p_router.ReplicaLifecycle("r1"), j_router.ReplicaLifecycle("r1")
  assert (p.probes_required, p.min_out_s, p.flap_window_s) == (j.probes_required, j.min_out_s,
                                                                 j.flap_window_s) == (3, 4.0, 7.0)


PREFIX_BODIES = [
  {"user": "alice", "messages": [{"role": "user", "content": "hi"}]},
  {"messages": [{"role": "system", "content": "sys"},
                {"role": "user", "content": "session-3 turn words " * 20}]},
  {"messages": [{"role": "user", "content": [{"type": "text", "text": "look at"},
                                             {"type": "image_url", "image_url": {}},
                                             {"type": "text", "text": "this"}]}]},
  {}, {"user": ""}, {"messages": ["not a dict", {"role": "user", "content": None}]},
]


def test_placement_matches_jax():
  """prefix_key, rendezvous, route (with and without spill), least_loaded and
  replica_names give the same answers on the same inputs."""
  for body in PREFIX_BODIES:
    assert p_router.prefix_key(body) == j_router.prefix_key(body)
  names = ["r0", "r1", "r2", "r3"]
  for i in range(200):
    key = f"session-{i}"
    assert p_router.rendezvous(key, names) == j_router.rendezvous(key, names)
    assert p_router.rendezvous(key, names[:2]) == j_router.rendezvous(key, names[:2])
  rng = np.random.default_rng(5)
  for i in range(200):
    views = [{"name": n, "queued": int(rng.integers(0, 4)), "est_wait_s": float(rng.integers(0, 3))}
             for n in names[:int(rng.integers(1, 5))]]
    for depth in (0, 1, 2, 3):
      assert p_router.route(f"k{i}", views, depth) == j_router.route(f"k{i}", views, depth)
    assert p_router.least_loaded(views) == j_router.least_loaded(views)
  assert p_router.route("k", [], 2) is None is j_router.route("k", [], 2)
  assert p_router.least_loaded([]) is None
  urls = ["http://a:1/", "http://b:2"]
  assert p_router.replica_names(urls) == j_router.replica_names(urls) == {"r0": "http://a:1",
                                                                          "r1": "http://b:2"}


def test_hedge_delay_and_drift_match_jax():
  """The hedge delay and the differential drift verdict over the same /v1/history
  compacts (counts present, absent and thin) are equal."""
  rng = np.random.default_rng(11)
  metrics = ["ttft_p50_s", "request_p50_s", "request_p99_s", "hop_rtt_s", "decode_tok_s",
             "unattributed_share", "spec_accept_rate"]
  for trial in range(60):
    compacts = []
    for _ in range(int(rng.integers(0, 5))):
      trailing = {m: float(rng.uniform(0.01, 3.0)) for m in metrics if rng.random() < 0.7}
      c = {"trailing": trailing}
      if rng.random() < 0.7:
        c["trailing_n"] = {m: int(rng.integers(0, 6)) for m in trailing}
      compacts.append(c)
    compacts.append(None)
    for factor, floor in ((2.0, 0.5), (3.0, 0.0), (0.0, 1.5)):
      assert p_router.hedge_delay_s(compacts, factor, floor) == j_router.hedge_delay_s(
        compacts, factor, floor)
    for min_n in (1, 3):
      pm = p_router.fleet_trailing_medians(compacts, min_n=min_n)
      assert pm == j_router.fleet_trailing_medians(compacts, min_n=min_n)
      for own in compacts[:2]:
        for ratio in (0.2, 0.5):
          assert (p_router.name_drift(own, pm, ratio, min_n=min_n)
                  == j_router.name_drift(own, pm, ratio, min_n=min_n))


def test_replica_view_fails_closed_and_prefill_role_is_not_routable():
  """An unknown load ranks as heaviest; a prefill replica stays out of the routable set
  but is the chain's first leg."""
  rep = _Replica("r9", "http://unused")
  assert rep.view()["queued"] >= 1 << 30
  rep.queue = {"queued": 1, "est_wait_s": 0.5}
  assert rep.view() == {"name": "r9", "queued": 1, "est_wait_s": 0.5}
  router = RouterApp(["http://a", "http://b"])
  for r in router.replicas.values():
    r.reachable, r.queue = True, {}
  assert sorted(r.name for r in router.routable()) == ["r0", "r1"]
  router.replicas["r0"].role = "prefill"
  assert [r.name for r in router.routable()] == ["r1"]
  assert [r.name for r in router.prefill_replicas()] == ["r0"]


# ------------------------------------------------- the router over replicas


def _call(url, body=None, method=None, timeout=60):
  """(status, lower-cased headers, body bytes) of one request, errors included."""
  data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
  req = urllib.request.Request(url, data=data, method=method or ("POST" if data is not None else "GET"),
                               headers={"Content-Type": "application/json"})
  try:
    with urllib.request.urlopen(req, timeout=timeout) as r:
      return r.status, {k.lower(): v for k, v in r.headers.items()}, r.read()
  except urllib.error.HTTPError as e:
    return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read()


async def _acall(*args, **kw):
  loop = asyncio.get_running_loop()
  return await loop.run_in_executor(None, lambda: _call(*args, **kw))


async def _replica():
  args = port_main.build_parser().parse_args(
    ["--inference-engine", "dummy", "--device", "cpu", "--default-model", "dummy",
     "--chatgpt-api-host", "127.0.0.1", "--chatgpt-api-port", "0", "--default-temp", "0",
     "--chatgpt-api-response-timeout", "30"])
  node, engine, _, api = port_main.build_node(args)
  server = await api.start("127.0.0.1", 0)
  return {"node": node, "api": api, "server": server,
          "url": f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"}


class _Fleet:
  """Two dummy replicas and a router over them, polled every 0.25 s."""

  async def start(self, monkeypatch, **env):
    monkeypatch.setenv("XOT_ROUTER_POLL_S", "0.25")
    monkeypatch.setenv("XOT_ROUTER_MIN_OUT_S", "0")
    for k, v in env.items():
      monkeypatch.setenv(k, v)
    self.reps = [await _replica(), await _replica()]
    self.router = RouterApp([r["url"] for r in self.reps])
    server = await self.router.run("127.0.0.1", 0)
    self.url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"
    for _ in range(80):
      if len(self.router.routable()) == 2:
        break
      await asyncio.sleep(0.05)
    assert len(self.router.routable()) == 2
    return self

  def target(self, body) -> str:
    return p_router.route(p_router.prefix_key(body), [r.view() for r in self.router.routable()], 0)[0]

  def node(self, name):
    return self.reps[int(name[1:])]["node"]

  async def stop(self):
    await self.router.stop()
    for r in self.reps:
      r["server"].close()
      await r["node"].stop()


class _fleet:
  """`async with _fleet(monkeypatch, **env) as f`: a started _Fleet, stopped after."""

  def __init__(self, monkeypatch, **env):
    self.monkeypatch, self.env = monkeypatch, env

  async def __aenter__(self) -> _Fleet:
    self.f = await _Fleet().start(self.monkeypatch, **self.env)
    return self.f

  async def __aexit__(self, *exc):
    await self.f.stop()


def _sse(raw: bytes):
  """The stream's chunk objects without the per-request id and created."""
  out = []
  for line in raw.decode().split("\n"):
    if line.startswith("data: ") and line != "data: [DONE]":
      obj = json.loads(line[6:])
      obj.pop("id", None)
      obj.pop("created", None)
      out.append(obj)
  return out


BODY = {"model": "dummy", "messages": [{"role": "user", "content": "hello"}]}


async def test_router_proxies_and_reports(monkeypatch):
  async with _fleet(monkeypatch) as f:
    status, _, raw = await _acall(f.url + "/v1/chat/completions", BODY)
    data = json.loads(raw)
    assert status == 200 and data["object"] == "chat.completion"
    status, headers, raw = await _acall(f.url + "/v1/chat/completions", {**BODY, "stream": True})
    assert status == 200 and headers["content-type"].startswith("text/event-stream")
    assert raw.decode().rstrip().endswith("data: [DONE]") and _sse(raw)
    status, _, raw = await _acall(f.url + "/v1/router")
    rs = json.loads(raw)
    assert rs["proxied_total"] == 2 and sorted(r["routed_total"] for r in rs["replicas"].values()) == [0, 2]
    # The read-only routes are answered by a replica through the router.
    status, headers, raw = await _acall(f.url + "/modelpool")
    assert status == 200 and headers["content-type"].startswith("text/event-stream")
    assert raw.decode().endswith("data: [DONE]\n\n")
    assert json.loads((await _acall(f.url + "/v1/models"))[2])["data"]
    assert json.loads((await _acall(f.url + "/healthcheck"))[2]) == {"status": "ok", "replicas": 2,
                                                                     "routable": 2}
    assert "events" in json.loads((await _acall(f.url + "/v1/debug/flight"))[2])


async def test_router_skips_drained_replica_and_503s_when_none(monkeypatch):
  async with _fleet(monkeypatch) as f:
    f.router.replicas["r0"].lifecycle.note_status(0.0, firing=1)
    for _ in range(3):
      assert (await _acall(f.url + "/v1/chat/completions", BODY))[0] == 200
    assert f.router.replicas["r0"].routed_total == 0 and f.router.replicas["r1"].routed_total == 3
    f.router.replicas["r1"].lifecycle.note_status(0.0, firing=1)
    status, headers, raw = await _acall(f.url + "/v1/chat/completions", BODY)
    assert status == 503 and headers.get("retry-after")
    assert json.loads(raw)["error"]["code"] == "no_replica"


async def test_router_rejects_bad_bodies(monkeypatch):
  async with _fleet(monkeypatch) as f:
    assert (await _acall(f.url + "/v1/chat/completions", [1, 2]))[0] == 400
    assert (await _acall(f.url + "/v1/chat/completions", b"not json"))[0] == 400


async def test_router_spills_on_429_and_preannounces_at_the_target(monkeypatch):
  """The affinity replica's only slot is taken: the forward gets a 429 and the request
  is served by the other replica, which gets the forced /v1/prefetch pre-announce."""
  async with _fleet(monkeypatch, XOT_MAX_INFLIGHT="1", XOT_ADMIT_QUEUE_DEPTH="0") as f:
    body = {"model": "dummy", "messages": [{"role": "user", "content": "session-9 hi"}]}
    target = f.target(body)
    other = "r1" if target == "r0" else "r0"
    announced = []

    async def spy(shard, prompt):
      announced.append(prompt)
      return False
    f.node(other).prefetch_prompt = spy
    f.node(target).admission.admit("occupier")
    status, _, _ = await _acall(f.url + "/v1/chat/completions", body)
    assert status == 200 and f.router.replicas[other].spilled_to_total >= 1
    for _ in range(40):
      if f.router.prefetch_announced_total and announced:
        break
      await asyncio.sleep(0.05)
    assert f.router.prefetch_announced_total >= 1 and "session-9 hi" in announced[0]
    f.node(target).admission.release()


async def test_router_relays_the_final_429(monkeypatch):
  async with _fleet(monkeypatch, XOT_MAX_INFLIGHT="1", XOT_ADMIT_QUEUE_DEPTH="0") as f:
    for r in f.reps:
      r["node"].admission.admit(f"occupier-{r['node'].id}")
    for stream in (False, True):
      status, headers, raw = await _acall(f.url + "/v1/chat/completions", {**BODY, "stream": stream})
      assert status == 429 and headers.get("retry-after")
      assert json.loads(raw)["error"]["type"] == "rate_limit_error"
    assert sum(r.relayed_429_total for r in f.router.replicas.values()) == 2


async def test_router_fails_over_on_a_connection_failure(monkeypatch):
  """The affinity replica's server is gone between poll ticks: the request is served by
  the survivor and the lost replica is marked unreachable at once."""
  async with _fleet(monkeypatch) as f:
    f.router._poll_task.cancel()  # the poll must not notice first
    body = {"model": "dummy", "messages": [{"role": "user", "content": "session-7 hi"}]}
    target = f.target(body)
    server = f.reps[int(target[1:])]["server"]
    server.close()
    await server.wait_closed()
    status, _, _ = await _acall(f.url + "/v1/chat/completions", body)
    assert status == 200 and f.router.replicas[target].reachable is False
    other = "r1" if target == "r0" else "r0"
    assert f.router.replicas[other].routed_total >= 1


async def test_router_chain_degrades_to_a_plain_forward(monkeypatch):
  """A prefill-role replica that answers no KV handle (the dummy engine has no export)
  costs one counted chain failure, and the request is forwarded to the decode leg."""
  async with _fleet(monkeypatch) as f:
    f.router._poll_task.cancel()
    f.router.replicas["r0"].role = "prefill"
    status, _, raw = await _acall(f.url + "/v1/chat/completions", BODY)
    assert status == 200 and json.loads(raw)["object"] == "chat.completion"
    assert (f.router.fabric_chain_failures_total, f.router.fabric_chained_total) == (1, 0)
    assert f.router.replicas["r1"].routed_total == 1
    rs = json.loads((await _acall(f.url + "/v1/router"))[2])
    assert rs["prefill_replicas"] == ["r0"] and rs["fabric_chain_failures_total"] == 1


async def test_router_hedges_a_silent_primary(monkeypatch):
  """The affinity primary sends no byte past the hedge delay: the duplicate at the
  other replica wins, its stream equals an unhedged one, the loser is cancelled (its
  replica ends with no request outstanding) and its timeline frozen."""
  async with _fleet(monkeypatch, XOT_ROUTER_HEDGE_PCT="100", XOT_ROUTER_HEDGE_MIN_S="0.2") as f:
    body = {"model": "dummy", "stream": True,
            "messages": [{"role": "user", "content": "session-4 hello there"}]}
    target = f.target(body)
    other = "r1" if target == "r0" else "r0"
    f.router.hedge_pct = 0.0
    status, _, raw = await _acall(f.url + "/v1/chat/completions", body)
    baseline = _sse(raw)
    assert status == 200 and baseline and f.router.hedges_fired_total == 0
    slow = f.node(target)
    real, ran = slow.process_prompt, []

    async def delayed(*a, **kw):
      ran.append(True)
      await asyncio.sleep(1.2)
      return await real(*a, **kw)
    slow.process_prompt = delayed
    f.router.hedge_pct = 100.0
    status, _, raw = await _acall(f.url + "/v1/chat/completions", body)
    assert status == 200 and _sse(raw) == baseline
    r = f.router
    assert (r.hedges_fired_total, r.hedges_won_total, r.hedge_cancelled_total,
            r.hedge_both_streamed_total) == (1, 1, 1, 0)
    assert r.replicas[other].routed_total >= 1
    events = [e["event"] for e in r.flight.tail(0)]
    assert "hedge.fired" in events and "hedge.won" in events
    for _ in range(100):
      if ran and not slow.outstanding_requests:
        break
      await asyncio.sleep(0.1)
    assert ran and not slow.outstanding_requests
    snaps = [s for s in r.flight.snapshots() if s["reason"] == "hedge.cancelled"]
    assert snaps and "hedge.cancelled" in [e["event"] for e in snaps[-1]["events"]]
    slow.process_prompt = real


async def test_router_never_hedges_a_settled_primary_and_hedged_429_spills(monkeypatch):
  async with _fleet(monkeypatch, XOT_ROUTER_HEDGE_PCT="100", XOT_ROUTER_HEDGE_MIN_S="5",
                      XOT_MAX_INFLIGHT="1", XOT_ADMIT_QUEUE_DEPTH="0") as f:
    for stream in (False, True):
      assert (await _acall(f.url + "/v1/chat/completions", {**BODY, "stream": stream}))[0] == 200
    assert f.router.hedges_fired_total == 0 and f.router.hedge_cancelled_total == 0
    body = {"model": "dummy", "messages": [{"role": "user", "content": "session-9 hi"}]}
    target = f.target(body)
    f.node(target).admission.admit("occupier")
    assert (await _acall(f.url + "/v1/chat/completions", body))[0] == 200
    other = "r1" if target == "r0" else "r0"
    assert f.router.replicas[other].spilled_to_total >= 1
    f.node(target).admission.release()


async def test_router_scrape_failure_feeds_down_streak(monkeypatch):
  """A reachable replica whose scrapes fail builds the same down streak an unreachable
  one does, every failure counted; one clean poll resets the streak, not the count."""
  monkeypatch.setenv("XOT_ROUTER_DRIFT", "0")
  failing = {"on": True}

  async def handle(reader, writer):
    _, path, _, _, _ = await http.read_request(reader)
    if path == "/healthcheck":
      await http.write_json(writer, 200, {"status": "ok"})
    elif failing["on"]:
      await http.write_response(writer, 500, b"boom", "text/plain")
    elif path == "/v1/queue":
      await http.write_json(writer, 200, {"admission": {"queued": 0, "est_wait_s": 0.0},
                                          "active_requests": 0, "fabric_role": "mixed"})
    else:
      await http.write_json(writer, 200, {"cluster": {"firing": 0, "active": []}})
    await http.close_writer(writer)
  server = await asyncio.start_server(handle, "127.0.0.1", 0)
  router = RouterApp([f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"])
  try:
    rep = router.replicas["r0"]
    await router._poll_one(rep)
    assert rep.reachable and rep.scrape_failures_total == 2 and rep.down_streak == 1
    await router._poll_one(rep)
    assert (rep.down_streak, rep.scrape_failures_total) == (2, 4)
    failing["on"] = False
    await router._poll_one(rep)
    assert (rep.down_streak, rep.scrape_failures_total) == (0, 4)
    assert rep.snapshot()["scrape_failures_total"] == 4
  finally:
    await router.stop()
    server.close()


# ------------------------------------------------------ the replicas' routes


async def test_queue_reports_fabric_role_and_kv_routes_validate(monkeypatch):
  """/v1/queue names XOT_FABRIC_ROLE; with no host tier a probe is a clean miss, an
  unknown key 404, a malformed body 400 (JAX's messages), and the dummy engine
  declines an offer with a 202."""
  monkeypatch.setenv("XOT_FABRIC_ROLE", "decode")
  rep = await _replica()
  base = rep["url"]
  try:
    assert json.loads((await _acall(base + "/v1/queue"))[2])["fabric_role"] == "decode"
    status, _, raw = await _acall(base + "/v1/kv/match", {"shard": "m:0:1:2", "toks": [1, 2, 3]})
    assert status == 200 and json.loads(raw) == {"key": None}
    for bad in ({"shard": "m", "toks": []}, {"toks": [1]}, [1, 2], {"shard": "m", "toks": [True]}):
      status, _, raw = await _acall(base + "/v1/kv/match", bad)
      assert status == 400 and json.loads(raw)["error"]["message"] == (
        "body must carry `shard` (string) and `toks` (list of ints)")
    assert (await _acall(base + "/v1/kv/match", b"{nope"))[0] == 400
    assert (await _acall(base + "/v1/kv/match"))[0] == 405
    for path in ("/v1/kv/deadbeef", "/v1/kv/deadbeef?payload=1"):
      assert (await _acall(base + path))[0] == 404
    status, _, raw = await _acall(base + "/v1/kv/offer", {
      "model": "dummy", "tokens": [1, 2, 3], "length": 3, "nbytes": 10, "url": "http://peer"})
    assert status == 202 and json.loads(raw) == {"accepted": False, "detail": "engine has no KV fabric"}
    status, _, raw = await _acall(base + "/v1/kv/offer", {"model": "dummy", "url": "x"})
    assert status == 400 and json.loads(raw)["error"]["message"] == (
      "an offer must carry `tokens` (list of ints) and `url`")
    assert (await _acall(base + "/v1/kv/offer", {"model": "nope", "tokens": [1], "url": "x"}))[0] == 400
  finally:
    rep["server"].close()
    await rep["node"].stop()


async def test_model_pool_routes_match_jax_and_quit(monkeypatch, tmp_path):
  """/initial_models equals the JAX handler's for the same engine and an empty models
  directory, /modelpool streams the same statuses as events ending in [DONE], and
  /quit answers, then interrupts the process as SIGINT does."""
  from aiohttp.test_utils import TestClient, TestServer
  from xotorch_tpu.api.chatgpt_api import ChatGPTAPI as JAPI
  from xotorch_tpu.inference.dummy import DummyInferenceEngine as JDummy
  from tests.test_orchestration import _caps, _make_node
  monkeypatch.setenv("XOT_HOME", str(tmp_path))
  jnode = await _make_node("pool-node", JDummy())
  jnode.topology.update_node("pool-node", _caps())
  client = TestClient(TestServer(JAPI(jnode, "DummyInferenceEngine", default_model="dummy").app))
  await client.start_server()
  try:
    want = await (await client.get("/initial_models")).json()
    jpool = await (await client.get("/modelpool")).text()
  finally:
    await client.close()
    await jnode.stop()
  rep = await _replica()
  kills = []
  monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append((pid, sig)))
  try:
    status, _, raw = await _acall(rep["url"] + "/initial_models")
    assert status == 200 and json.loads(raw) == want
    status, headers, raw = await _acall(rep["url"] + "/modelpool")
    assert headers["content-type"].startswith("text/event-stream")
    assert raw.decode() == jpool
    status, _, raw = await _acall(rep["url"] + "/quit", b"", method="POST")
    import signal
    assert status == 200 and json.loads(raw) == {"detail": "Quit signal received"}
    assert kills == [(os.getpid(), signal.SIGINT)]
  finally:
    rep["server"].close()
    await rep["node"].stop()
