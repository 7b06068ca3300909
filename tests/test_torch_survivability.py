"""The port's request survivability on the CPU, held to the JAX package's.

Each scenario of tests/test_fault_injection.py runs here on both packages: JAX's Node
on JAX's DummyInferenceEngine over the transport JAX's own test takes (in-process
handles, or gRPC where its test builds the two-node ring), and the port's Node on the
port's dummy engine, in one process (InProcessPeerHandle) and over TCP. Each side
reports an outcome (the tokens delivered, the error kind every node holds, the
survivability counters that moved, and the survivability events of the flight
recorder in order), and the two outcomes must be equal; the scenario's own
assertions hold on each side too. A model-backed case kills one node of a two-node
TCP ring of synthetic-tiny (JAX's weights) in mid-decode under XOT_REQUEST_RESTARTS=1:
the API's restarted greedy stream equals the port's solo stream and JAX's.
"""
import asyncio
import json
import time

import jax
import numpy as np
import pytest

from tests.test_orchestration import StaticDiscovery as JStaticDiscovery
from tests.test_orchestration import _caps as j_caps
from tests.test_orchestration import _make_node as j_make_node
from tests.test_orchestration import _two_node_ring as j_two_node_ring
from xotorch_tpu.inference.dummy import DummyInferenceEngine as JDummy
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.networking import faults as j_faults
from xotorch_tpu.networking.inprocess import InProcessPeerHandle as JInProcess
from xotorch_tpu.utils import knobs as j_knobs
from tests.test_torch_ring import GEN, MODEL, Ring, jax_weights  # noqa: F401  (a fixture)
from xotorch_tpu_torch.inference.dummy import DummyInferenceEngine as PDummy
from xotorch_tpu_torch.inference.shard import Shard as PShard
from xotorch_tpu_torch.networking import faults as p_faults
from xotorch_tpu_torch.networking.discovery import Discovery as PDiscovery
from xotorch_tpu_torch.networking.inprocess import InProcessPeerHandle as PInProcess
from xotorch_tpu_torch.networking.tcp import TCPPeerHandle, TCPServer
from xotorch_tpu_torch.orchestration.node import Node as PNode
from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities as PCaps
from xotorch_tpu_torch.topology.device_capabilities import DeviceFlops as PFlops
from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy as PStrategy
from xotorch_tpu_torch.utils import knobs as p_knobs
from xotorch_tpu_torch.utils.helpers import find_available_port

PORT_TRANSPORTS = ("inprocess", "tcp")
# The flight recorder's survivability vocabulary: the events an outcome compares.
SURVIVAL_EVENTS = ("request.admitted", "watchdog.armed", "watchdog.deferred", "watchdog.fired",
                   "deadline.expired", "request.aborted", "peer.evicted", "hop.dedup_drop")
ERROR_KINDS = ("stalled", "deadline_exceeded", "context_length_exceeded", "injected fault",
               "tensor hop failed", "prompt processing failed", "fused decode failed")
SURVIVAL_KNOBS = ("XOT_REQUEST_DEADLINE_S", "XOT_STALL_TIMEOUT_S", "XOT_HEALTH_INTERVAL_S",
                  "XOT_HEALTH_FAILS", "XOT_EVICT_COOLDOWN_S", "XOT_REQUEST_RESTARTS",
                  "XOT_FAULT_SPEC")


@pytest.fixture(autouse=True)
def _scoped_injectors():
  """Every test leaves both packages' process-wide injectors clean."""
  yield
  j_faults.install(None)
  p_faults.install(None)


def _count(metric) -> int:
  """A counter's value: a prometheus_client counter (JAX) or the port's cell."""
  value = getattr(metric, "_value", None)
  return int(value.get()) if hasattr(value, "get") else int(metric.get())


def error_kind(error):
  if error is None:
    return None
  return next((k for k in ERROR_KINDS if error.startswith(k)), f"other: {error[:40]}")


def survival_events(events) -> list:
  """The survivability events of a flight timeline, in order, each kept once (the
  number of hops or checks before an abort is timing)."""
  out = []
  for e in events:
    name = e["event"]
    if name in SURVIVAL_EVENTS and name not in out:
      out.append(name)
  return out


class _PortNullServer:
  async def start(self):
    pass

  async def stop(self):
    pass


class _PortStaticDiscovery(PDiscovery):
  def __init__(self, peers):
    self._peers = list(peers)

  async def start(self):
    pass

  async def stop(self):
    pass

  async def discover_peers(self, wait_for_peers: int = 0):
    return list(self._peers)


class Kit:
  """One package's pieces and the ways of wiring its nodes: `transport` is
  "inprocess", "grpc" (JAX) or "tcp" (port)."""

  def __init__(self, pkg: str, transport: str):
    self.pkg, self.transport = pkg, transport
    jax_side = pkg == "jax"
    self.faults = j_faults if jax_side else p_faults
    self.Shard = JShard if jax_side else PShard
    self.Dummy = JDummy if jax_side else PDummy
    self.InProcess = JInProcess if jax_side else PInProcess
    self.Discovery = JStaticDiscovery if jax_side else _PortStaticDiscovery

  def caps(self):
    return j_caps() if self.pkg == "jax" else PCaps("test", "chip", 1024, PFlops(1, 2, 4))

  def shard(self):
    return self.Shard("dummy", 0, 0, 8)

  async def node(self, node_id: str, engine, **kw):
    """A node with no server and no peers (JAX: tests.test_orchestration._make_node)."""
    if self.pkg == "jax":
      node = await j_make_node(node_id, engine, **kw)
    else:
      node = PNode(node_id, _PortNullServer(), engine, _PortStaticDiscovery([]), PStrategy(), **kw)
      node.device_capabilities = self.caps()
    node.topology.update_node(node_id, self.caps())
    return node

  async def ring(self, engine_a, engine_b, ids=("node-a", "node-b")):
    """Two nodes that know each other, by this kit's transport; each node's discovery
    lists its peer (so an eviction's cooldown can be shown against it)."""
    if self.transport == "grpc":
      assert ids == ("node-a", "node-b")
      return await j_two_node_ring(engine_a, engine_b)
    a, b = await self.node(ids[0], engine_a), await self.node(ids[1], engine_b)
    if self.transport == "inprocess":
      for node in (a, b):
        for other in (a, b):
          node.topology.update_node(other.id, self.caps())
      a.peers, b.peers = [self.InProcess(b)], [self.InProcess(a)]
      a.discovery, b.discovery = self.Discovery(list(a.peers)), self.Discovery(list(b.peers))
      return a, b
    ports = {n.id: find_available_port() for n in (a, b)}
    for node, other in ((a, b), (b, a)):
      node.server = TCPServer(node, "127.0.0.1", ports[node.id])
      node.discovery = self.Discovery([TCPPeerHandle(other.id, f"127.0.0.1:{ports[other.id]}", "test",
                                                     self.caps())])
      await node.server.start()
    for node in (a, b):
      await node.update_peers()
    for node in (a, b):
      await node.collect_topology(set())
    return a, b

  async def stop(self, *nodes):
    for node in nodes:
      await node.stop()  # its server and its loops

  def api(self, node, timeout=15):
    return _JaxApi(node, timeout) if self.pkg == "jax" else _PortApi(node, timeout)


def _kits(transport):
  """(JAX kit, port kit) for a scenario: JAX on the transport its own test takes."""
  return Kit("jax", transport[0]), Kit("port", transport[1])


class _JaxApi:
  def __init__(self, node, timeout):
    from aiohttp.test_utils import TestClient, TestServer

    from xotorch_tpu.api.chatgpt_api import ChatGPTAPI
    self.api = ChatGPTAPI(node, "DummyInferenceEngine", response_timeout=timeout, default_model="dummy")
    self.client = TestClient(TestServer(self.api.app))

  async def __aenter__(self):
    await self.client.start_server()
    return self

  async def __aexit__(self, *exc):
    await self.client.close()

  async def request(self, method, path, body=None):
    resp = await self.client.request(method, path, json=body)
    return resp.status, await resp.text(), dict(resp.headers)


class _PortApi:
  def __init__(self, node, timeout):
    from xotorch_tpu_torch.api.chatgpt_api import ChatGPTAPI
    self.api = ChatGPTAPI(node, "DummyInferenceEngine", response_timeout=timeout, default_model="dummy")
    self.port = find_available_port()
    self.server = None

  async def __aenter__(self):
    self.server = await self.api.start("127.0.0.1", self.port)
    return self

  async def __aexit__(self, *exc):
    self.server.close()
    await self.server.wait_closed()

  async def request(self, method, path, body=None):
    """One HTTP/1.1 request (the server closes each connection): status, body text and
    headers."""
    reader, writer = await asyncio.open_connection("127.0.0.1", self.port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\nContent-Type: application/json\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, text = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:] if ": " in line)
    return int(lines[0].split(" ")[1]), text.decode(), headers


def _sse(text):
  """(chunk ids, content, [DONE] markers, error events) of an event stream."""
  ids, content, done, errors = set(), "", 0, []
  for line in text.splitlines():
    line = line.strip()
    if not line.startswith("data: "):
      continue
    payload = line[len("data: "):]
    if payload == "[DONE]":
      done += 1
      continue
    event = json.loads(payload)
    if "error" in event:
      errors.append(event["error"])
      continue
    ids.add(event["id"])
    content += event["choices"][0]["delta"].get("content") or ""
  return ids, content, done, errors


async def _generate(kit, origin, nodes, rid, timeout=20, prompt="hello world", shard=None):
  """One dummy-ring generation (tests/test_fault_injection.py's): the tokens and each
  node's error."""
  done = asyncio.Event()
  out = {}

  def on_token(request_id, tokens, fin):
    if request_id == rid:
      out["tokens"] = list(tokens)
      if fin:
        done.set()

  for n in nodes:
    n.on_token.register(f"fi-{rid}-{n.id}").on_next(on_token)
  await origin.process_prompt(shard or kit.shard(), prompt, rid)
  await asyncio.wait_for(done.wait(), timeout=timeout)
  await asyncio.sleep(0.3)  # let the finish broadcasts land everywhere
  for n in nodes:
    n.on_token.deregister(f"fi-{rid}-{n.id}")
  return out.get("tokens", []), {n.id: n.request_errors.get(rid) for n in nodes}


def _assert_no_leaks(*nodes):
  for node in nodes:
    assert node.outstanding_requests == {}, (node.id, node.outstanding_requests)
    assert node.buffered_token_output == {}, node.id
    assert node._request_max_tokens == {}, node.id
    assert node._request_deadline == {}, node.id


def _counters(nodes, *names) -> dict:
  return {name: sum(_count(getattr(n.metrics, name)) for n in nodes) for name in names}


async def _poll(predicate, secs=5.0):
  deadline = time.monotonic() + secs
  while not predicate() and time.monotonic() < deadline:
    await asyncio.sleep(0.05)


class _TrackingMixin:
  """Records clear_request calls: the proxy for 'no KV entry leaked'."""

  def __init__(self):
    super().__init__()
    self.cleared = []

  async def clear_request(self, request_id):
    self.cleared.append(request_id)


def _tracking(kit):
  return type("Tracking", (_TrackingMixin, kit.Dummy), {})()


async def _both(scenario, transports, port_transport, *args):
  """Run `scenario(kit, *args) -> outcome` on JAX and on the port; the outcomes must be
  equal."""
  j_kit, p_kit = _kits((transports, port_transport))
  want = await scenario(j_kit, *args)
  got = await scenario(p_kit, *args)
  assert got == want, f"port ({port_transport}) {got} != JAX {want}"
  return want


# ------------------------------------------------------ (a) transient hops

async def _fault_free(kit):
  a, b = await kit.ring(kit.Dummy(), kit.Dummy())
  try:
    tokens, errors = await _generate(kit, a, (a, b), "baseline-req")
    assert not any(errors.values())
    return tokens
  finally:
    await kit.stop(a, b)


async def _transient(kit, action):
  baseline = await _fault_free(kit)
  retries_before = kit.faults.COUNTERS["hop_retries"]
  kit.faults.install(kit.faults.FaultInjector([
    {"rpc": "SendTensor", "nth": 3, "action": action, "delay_s": 0.05}]))
  a, b = await kit.ring(kit.Dummy(), kit.Dummy())
  try:
    tokens, errors = await _generate(kit, a, (a, b), "fault-req")
    assert tokens == baseline, f"{action}: completion diverged from the fault-free run"
    assert not any(errors.values()), errors
    _assert_no_leaks(a, b)
    return {"tokens": tokens, "errors": {k: error_kind(e) for k, e in errors.items()},
            "retried": kit.faults.COUNTERS["hop_retries"] > retries_before}
  finally:
    kit.faults.install(None)
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
@pytest.mark.parametrize("action", ["error", "drop", "delay"])
async def test_transient_send_tensor_fault_is_invisible(monkeypatch, action, transport):
  monkeypatch.setenv("XOT_HOP_RETRIES", "2")
  monkeypatch.setenv("XOT_HOP_BACKOFF_S", "0.01")
  out = await _both(_transient, "grpc", transport, action)
  assert out["retried"] is (action != "delay")  # a delayed hop needs no retry


# --------------------------------------------------- (b) lost ack + dedup

async def _lost_ack(kit):
  baseline = await _fault_free(kit)
  kit.faults.install(kit.faults.FaultInjector([{"rpc": "SendTensor", "nth": 4, "action": "lost_ack"}]))
  a, b = await kit.ring(kit.Dummy(), kit.Dummy())
  try:
    tokens, errors = await _generate(kit, a, (a, b), "ack-req")
    assert tokens == baseline, "a redelivered hop decoded a position twice"
    # The retry runs beside the continuing generation, so its dedup drop can land after
    # the completion.
    await _poll(lambda: _counters((a, b), "dedup_drops_total")["dedup_drops_total"] >= 1)
    _assert_no_leaks(a, b)
    return {"tokens": tokens, "errors": {k: error_kind(e) for k, e in errors.items()},
            **_counters((a, b), "dedup_drops_total", "watchdog_aborts_total")}
  finally:
    kit.faults.install(None)
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_lost_ack_redelivery_is_deduped(monkeypatch, transport):
  monkeypatch.setenv("XOT_HOP_RETRIES", "2")
  monkeypatch.setenv("XOT_HOP_BACKOFF_S", "0.01")
  out = await _both(_lost_ack, "grpc", transport)
  assert out["dedup_drops_total"] == 1


async def _dedup_unit(kit):
  node = await kit.node("dedup-unit", kit.Dummy())
  seen = [node.note_hop_delivery("r", "s1"), node.note_hop_delivery("r", "s1"),
          node.note_hop_delivery("r", "s2"), node.note_hop_delivery("r", None)]
  drops = _count(node.metrics.dedup_drops_total)
  node.finish_request_state("r")
  after_finish = node.note_hop_delivery("r", "s1")  # rows outlive the request
  for i in range(300):
    node.note_hop_delivery(f"bulk-{i}", "s")
  await node.stop()
  return {"seen": seen, "drops": drops, "after_finish": after_finish,
          "bounded": len(node._hop_seen) <= 256 and "r" not in node._hop_seen}


async def test_note_hop_delivery_dedup_and_cleanup():
  out = await _both(_dedup_unit, "inprocess", "inprocess")
  assert out == {"seen": [True, False, True, True], "drops": 1, "after_finish": False, "bounded": True}


# ------------------------- (c) dead peer: watchdog, eviction, API restart

async def _killed_peer_restarted(kit, prefix):
  engine_a, engine_b = _tracking(kit), _tracking(kit)
  a, b = await kit.ring(engine_a, engine_b, ids=(f"{prefix}-a", f"{prefix}-b"))
  a.start_health_monitor()
  # The b node (partition 0: equal memories order the ring by id, descending) dies at
  # the second tensor hop it is sent.
  kit.faults.install(kit.faults.FaultInjector([
    {"rpc": "SendTensor", "peer": f"{prefix}-b", "nth": 2, "action": "kill"}]))
  try:
    async with kit.api(a) as api:
      t0 = time.monotonic()
      status, text, _ = await api.request("POST", "/v1/chat/completions", {
        "model": "dummy", "messages": [{"role": "user", "content": "hello"}]})
      elapsed = time.monotonic() - t0
      assert status == 200, text
      content = json.loads(text)["choices"][0]["message"]["content"]
      assert content, "the restarted completion is empty"
      assert elapsed < 10, f"took {elapsed:.1f}s"
      assert a.peers == [], "the dead peer is still in the ring"
      await asyncio.sleep(0.3)
      _assert_no_leaks(a)  # b is dead: only the survivor must be clean
      assert engine_a.cleared, "the survivor never released the engine's state"
      _, metrics, _ = await api.request("GET", "/metrics")
      for family in ("xot_request_restarts_total", f'xot_peer_evictions_total{{node_id="{prefix}-a"}}',
                     "xot_hop_retries_total", "xot_health_check_failures_total"):
        assert family in metrics, family
      _, flight, _ = await api.request("GET", "/v1/debug/flight")
      snaps = json.loads(flight)["snapshots"]
      req = [s for s in snaps if s["request_id"]]
      assert req, "no snapshot of the aborted request"
      events = survival_events(req[0]["events"])
      assert any("peer.evicted" in [e["event"] for e in s["events"]] for s in snaps)
      # The cooldown: discovery still lists the dead peer, and a reconcile keeps it out.
      await a.update_peers()
      assert a.peers == []
      return {"content": content, "events": events,
              **_counters((a,), "request_restarts_total", "peer_evictions_total")}
  finally:
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_killed_peer_evicted_and_request_restarted(monkeypatch, transport):
  for var, val in (("XOT_STALL_TIMEOUT_S", "0.6"), ("XOT_HEALTH_INTERVAL_S", "0.1"),
                   ("XOT_REQUEST_RESTARTS", "1"), ("XOT_HOP_RETRIES", "1"), ("XOT_HOP_BACKOFF_S", "0.01")):
    monkeypatch.setenv(var, val)
  out = await _both(_killed_peer_restarted, "inprocess", transport, "fk")
  assert out["request_restarts_total"] == 1 and out["peer_evictions_total"] >= 1
  ev = out["events"]
  assert "request.admitted" in ev and "watchdog.armed" in ev and "request.aborted" in ev, ev
  assert ev.index("watchdog.armed") < ev.index("request.aborted")


async def _sunk_hop(kit):
  a, b = await kit.ring(kit.Dummy(), kit.Dummy(), ids=("fs-a", "fs-b"))
  kit.faults.install(kit.faults.FaultInjector([
    {"rpc": "SendTensor", "peer": "fs-b", "nth": 2, "action": "sink"}]))
  try:
    t0 = time.monotonic()
    tokens, errors = await _generate(kit, a, (a, b), "sink-req", timeout=10)
    assert time.monotonic() - t0 < 8
    snaps = [s for s in (n.flight.snapshot("sink-req") for n in (a, b)) if s is not None]
    assert snaps, "no flight snapshot frozen for the watchdog's abort"
    events = [e["event"] for e in snaps[0]["events"]]
    assert any(e in ("request.admitted", "hop.recv") for e in events), events
    _assert_no_leaks(a, b)
    # Both nodes may see the stall before the first abort's broadcast lands: the count
    # is timing, its being at least one is not.
    aborts = _counters((a, b), "watchdog_aborts_total")["watchdog_aborts_total"]
    return {"tokens": tokens, "errors": sorted(filter(None, map(error_kind, errors.values()))),
            "events": survival_events(snaps[0]["events"]), "aborted": aborts >= 1}
  finally:
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_silently_sunk_hop_hits_stall_watchdog(monkeypatch, transport):
  monkeypatch.setenv("XOT_STALL_TIMEOUT_S", "0.4")
  out = await _both(_sunk_hop, "inprocess", transport)
  assert "stalled" in out["errors"] and out["aborted"]
  ev = out["events"]
  assert "watchdog.armed" in ev and "watchdog.fired" in ev and "request.aborted" in ev, ev
  assert ev.index("watchdog.armed") < ev.index("watchdog.fired")


async def _origin_forwarded(kit):
  a, b = await kit.ring(kit.Dummy(), kit.Dummy(), ids=("fo-a", "fo-b"))
  # fo-b owns partition 0: the origin's prompt forward to it vanishes.
  kit.faults.install(kit.faults.FaultInjector([
    {"rpc": "SendPrompt", "peer": "fo-b", "nth": 1, "action": "sink"}]))
  try:
    done = asyncio.Event()
    a.on_token.register("t").on_next(lambda rid, toks, fin: done.set() if fin else None)
    await a.process_prompt(kit.shard(), "hello", "fo-req")
    assert a.outstanding_requests == {}  # the origin really is not outstanding
    t0 = time.monotonic()
    await asyncio.wait_for(done.wait(), timeout=6)
    assert time.monotonic() - t0 < 4
    await asyncio.sleep(0.2)
    _assert_no_leaks(a, b)
    return {"error": error_kind(a.request_errors.get("fo-req")),
            "events": survival_events(a.flight.snapshot("fo-req")["events"])}
  finally:
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_stall_watchdog_covers_origin_forwarded_prompt(monkeypatch, transport):
  monkeypatch.setenv("XOT_STALL_TIMEOUT_S", "0.4")
  out = await _both(_origin_forwarded, "inprocess", transport)
  assert out["error"] == "stalled"


async def _hung_prefill(kit, forwarded_deadline):
  engine = kit.Dummy()

  async def hang(*args, **kwargs):
    await asyncio.sleep(30)

  engine.infer_prompt = hang
  engine.infer_sample_tensor = hang  # the port prefills a whole-model shard here
  node = await kit.node("fd-solo", engine)
  if forwarded_deadline is not None:
    assert node.request_deadline_s == 0 and node.stall_timeout_s == 0
  done = asyncio.Event()
  node.on_token.register("t").on_next(lambda rid, toks, fin: done.set() if fin else None)
  kw = {} if forwarded_deadline is None else {"deadline": forwarded_deadline}
  task = asyncio.get_running_loop().create_task(node.process_prompt(kit.shard(), "hi", "fd-req", **kw))
  t0 = time.monotonic()
  try:
    await asyncio.wait_for(done.wait(), timeout=6)
    assert time.monotonic() - t0 < 4
    assert node.outstanding_requests == {}
    return {"error": error_kind(node.request_errors.get("fd-req")),
            "events": survival_events(node.flight.snapshot("fd-req")["events"]),
            **_counters((node,), "watchdog_aborts_total")}
  finally:
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    await node.stop()


async def test_request_deadline_aborts_hung_prefill(monkeypatch):
  monkeypatch.setenv("XOT_REQUEST_DEADLINE_S", "0.4")
  out = await _both(_hung_prefill, "inprocess", "inprocess", None)
  assert out["error"] == "deadline_exceeded" and out["watchdog_aborts_total"] >= 1
  assert "deadline.expired" in out["events"] and "watchdog.fired" in out["events"]


async def test_hop_carried_deadline_enforced_without_local_knobs(monkeypatch):
  """A peer whose own knobs are off still enforces a deadline that came with the hop:
  the origin that set it may be the node that died."""
  for var in ("XOT_REQUEST_DEADLINE_S", "XOT_STALL_TIMEOUT_S"):
    monkeypatch.setenv(var, "0")
  out = await _both(_hung_prefill, "inprocess", "inprocess", 0.3)
  assert out["error"] == "deadline_exceeded"


async def _deadline_rides_the_hops(kit):
  """The origin's remaining budget reaches the peer it forwards to, which then holds
  a deadline of its own."""
  engine_b = kit.Dummy()

  async def hang(*args, **kwargs):
    await asyncio.sleep(30)

  engine_b.infer_prompt = hang
  a, b = await kit.ring(kit.Dummy(), engine_b, ids=("dh-a", "dh-b"))
  try:
    tokens, errors = await _generate(kit, a, (a, b), "dh-req", timeout=6)
    return {"errors": {k: error_kind(e) for k, e in errors.items()},
            "b_aborts": _count(b.metrics.watchdog_aborts_total)}
  finally:
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_forwarded_prompt_carries_the_deadline(monkeypatch, transport):
  monkeypatch.setenv("XOT_REQUEST_DEADLINE_S", "0.5")
  monkeypatch.setenv("XOT_STALL_TIMEOUT_S", "0")
  out = await _both(_deadline_rides_the_hops, "inprocess", transport)
  assert out["errors"]["dh-a"] == "deadline_exceeded"
  assert out["b_aborts"] == 1  # the peer's own watchdog fired on the carried budget


async def _health_eviction(kit):
  a, b = await kit.ring(kit.Dummy(), kit.Dummy(), ids=("fe-a", "fe-b"))
  injector = kit.faults.FaultInjector([])
  kit.faults.install(injector)
  a.start_health_monitor()
  try:
    await asyncio.sleep(0.2)
    assert [p.id() for p in a.peers] == ["fe-b"]  # a healthy peer survives sweeps
    fails_before = kit.faults.COUNTERS["health_check_failures"]
    injector.kill_peer("fe-b")
    await _poll(lambda: not a.peers, 3)
    assert a.peers == [], "the dead peer was never evicted"
    failed = kit.faults.COUNTERS["health_check_failures"] - fails_before
    repartitioned = "fe-b" not in a.topology.nodes
    await a.update_peers()  # the cooldown outlives discovery's stale listing
    return {"peers": [p.id() for p in a.peers], "failed_at_least_2": failed >= 2,
            "repartitioned": repartitioned, "events": survival_events(a.flight.tail(0)),
            **_counters((a,), "peer_evictions_total")}
  finally:
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_health_monitor_evicts_after_consecutive_failures(monkeypatch, transport):
  monkeypatch.setenv("XOT_HEALTH_INTERVAL_S", "0.05")
  monkeypatch.setenv("XOT_HEALTH_FAILS", "2")
  out = await _both(_health_eviction, "inprocess", transport)
  assert out == {"peers": [], "failed_at_least_2": True, "repartitioned": True,
                 "events": ["peer.evicted"], "peer_evictions_total": 1}


@pytest.mark.parametrize("dead", (True, False), ids=("dead", "left"))
@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_peer_dropped_by_discovery_is_evicted_only_when_dead(transport, dead):
  """Port only (JAX drops both uncounted): a ring peer that discovery stops listing
  before the health monitor's threshold is evicted when it fails a check then, with
  the counter, the flight event and the cooldown; a peer that left but answers is
  dropped plainly. The race of a killed peer in a manual-discovery ring, where the
  discovery's poll can see the death before the monitor's second check."""
  kit = Kit("port", transport)
  a, b = await kit.ring(kit.Dummy(), kit.Dummy(), ids=("dd-a", "dd-b"))
  injector = kit.faults.FaultInjector([])
  kit.faults.install(injector)
  try:
    if dead:
      injector.kill_peer("dd-b")
    listed = list(a.discovery._peers)
    a.discovery._peers = []
    await a.update_peers()
    repartitioned = "dd-b" not in a.topology.nodes  # an eviction repartitions at once
    a.discovery._peers = listed
    await a.update_peers()  # a dead peer's cooldown keeps it out when listed again
    out = {"peers": [p.id() for p in a.peers], "repartitioned": repartitioned,
           "barred": a._is_evicted("dd-b"), "events": survival_events(a.flight.tail(0)),
           **_counters((a,), "peer_evictions_total")}
  finally:
    await kit.stop(a, b)
  if dead:
    assert out == {"peers": [], "repartitioned": True, "barred": True, "events": ["peer.evicted"],
                   "peer_evictions_total": 1}
  else:
    assert out == {"peers": ["dd-b"], "repartitioned": False, "barred": False, "events": [],
                   "peer_evictions_total": 0}


async def _restart_budget(kit):
  engine_a, engine_b = kit.Dummy(), kit.Dummy()

  async def exploding(request_id, shard, tensor, inference_state=None):
    raise RuntimeError("persistent engine fault")

  engine_b.infer_tensor = exploding  # the transport is healthy, the engine broken
  a, b = await kit.ring(engine_a, engine_b, ids=("fp-a", "fp-b"))
  try:
    async with kit.api(a) as api:
      status, text, _ = await api.request("POST", "/v1/chat/completions", {
        "model": "dummy", "messages": [{"role": "user", "content": "hello"}]})
      assert "persistent engine fault" in json.loads(text)["error"]["message"]
      assert [p.id() for p in a.peers] == ["fp-b"], "a healthy peer was evicted"
      await asyncio.sleep(0.3)
      _assert_no_leaks(a, b)
      return {"status": status, **_counters((a,), "request_restarts_total", "peer_evictions_total")}
  finally:
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_restart_budget_is_one_shot(monkeypatch, transport):
  monkeypatch.setenv("XOT_REQUEST_RESTARTS", "1")
  out = await _both(_restart_budget, "inprocess", transport)
  assert out == {"status": 500, "request_restarts_total": 1, "peer_evictions_total": 0}


# ------------------------------------------- the stall deferral on a busy engine

def _compile_heavy(kit):
  """Prefill takes 3x the stall timeout while it reports a dispatch in flight: the
  shape of a first request's compile or graph captures."""

  class CompileHeavy(kit.Dummy):
    def __init__(self):
      super().__init__()
      self._busy = False

    def dispatch_inflight(self) -> bool:
      return self._busy

    async def _slow(self):
      self._busy = True
      try:
        await asyncio.sleep(1.2)
      finally:
        self._busy = False

    async def infer_prompt(self, request_id, shard, prompt, images=None, **kw):
      await self._slow()
      tokens = await self.encode(shard, prompt)
      return await self.infer_tensor(request_id, shard, tokens[None, :])

  if kit.pkg == "port":
    class CompileHeavy(CompileHeavy):  # the port prefills a whole-model shard here
      async def infer_sample_tensor(self, request_id, shard, input_data, **kw):
        if np.asarray(input_data).shape[-1] > 1:  # the prefill, not a decode step
          await self._slow()
        return await super().infer_sample_tensor(request_id, shard, input_data, **kw)

  return CompileHeavy()


async def _deferred(kit):
  node = await kit.node("cj-solo", _compile_heavy(kit))
  try:
    tokens, errors = await _generate(kit, node, (node,), "cj-req", timeout=15)
    assert tokens, "the compile-heavy request produced no tokens"
    assert not any(errors.values()), errors
    return {"tokens": tokens, "events": survival_events(node.flight.tail(0)),
            **_counters((node,), "watchdog_aborts_total")}
  finally:
    await node.stop()


async def test_compile_heavy_first_request_defers_stall_watchdog(monkeypatch):
  monkeypatch.setenv("XOT_STALL_TIMEOUT_S", "0.4")
  out = await _both(_deferred, "inprocess", "inprocess")
  assert out["watchdog_aborts_total"] == 0
  assert "watchdog.deferred" in out["events"] and "watchdog.fired" not in out["events"]


async def _stall_with_engine(kit, busy: bool):
  engine = kit.Dummy()
  engine.dispatch_inflight = lambda: busy
  node = await kit.node("cb-solo", engine)
  try:
    node.outstanding_requests["cb-req"] = "waiting"
    node._note_progress("cb-req")
    await _poll(lambda: _count(node.metrics.watchdog_aborts_total) > 0, 8)
    return {"error": error_kind(node.request_errors.get("cb-req")),
            "events": survival_events(node.flight.tail(0)),
            **_counters((node,), "watchdog_aborts_total")}
  finally:
    await node.stop()


async def test_engine_idle_stall_still_fires_with_dispatch_inflight_attr(monkeypatch):
  monkeypatch.setenv("XOT_STALL_TIMEOUT_S", "0.3")
  out = await _both(_stall_with_engine, "inprocess", "inprocess", False)
  assert out["error"] == "stalled" and out["watchdog_aborts_total"] == 1
  assert "watchdog.deferred" not in out["events"]


async def test_stall_deferral_is_bounded_by_busy_engine(monkeypatch):
  """An engine kept busy for ever by other requests must not shield a dead peer's
  hang: past 4 stall timeouts the abort fires in mid-dispatch."""
  monkeypatch.setenv("XOT_STALL_TIMEOUT_S", "0.3")
  out = await _both(_stall_with_engine, "inprocess", "inprocess", True)
  assert out["error"] == "stalled" and out["watchdog_aborts_total"] == 1
  assert out["events"].index("watchdog.deferred") < out["events"].index("watchdog.fired")


# ------------------------------------------------------ production defaults

async def _defaults(kit):
  node = await kit.node("pd-solo", kit.Dummy())
  knobs = j_knobs if kit.pkg == "jax" else p_knobs
  try:
    return {"retries": kit.faults.hop_retries(), "seqs": kit.faults.hop_seqs_enabled(),
            "stall": node.stall_timeout_s, "health": node.health_interval_s,
            "fails": node.health_fail_threshold, "cooldown": node.evict_cooldown_s,
            "deadline": node.request_deadline_s, "restarts": knobs.get_int("XOT_REQUEST_RESTARTS"),
            "watchdog_task": node._watchdog_task, "health_task": node._health_task}
  finally:
    await node.stop()


async def test_production_defaults_are_on(monkeypatch):
  for var in ("XOT_HOP_RETRIES", *SURVIVAL_KNOBS):
    monkeypatch.delenv(var, raising=False)
  out = await _both(_defaults, "inprocess", "inprocess")
  assert out == {"retries": 2, "seqs": True, "stall": 30.0, "health": 5.0, "fails": 2,
                 "cooldown": 30.0, "deadline": 0.0, "restarts": 0,
                 "watchdog_task": None, "health_task": None}


@pytest.mark.parametrize("name", SURVIVAL_KNOBS)
def test_survivability_knobs_match_jax(name):
  j, p = j_knobs.REGISTRY[name], p_knobs.REGISTRY[name]
  assert (p.kind, p.default, p.doc) == (j.kind, j.default, j.doc)


async def test_start_arms_the_watchdog_and_the_monitor_and_stop_cancels_them(monkeypatch):
  """Node.start() arms both loops with the defaults; stop() cancels them (a port Node
  on TCP with no peers)."""
  for var in SURVIVAL_KNOBS:
    monkeypatch.delenv(var, raising=False)
  kit = Kit("port", "tcp")
  node = await kit.node("st-solo", kit.Dummy())
  node.server = TCPServer(node, "127.0.0.1", find_available_port())
  await node.start(topology_interval=5.0)
  try:
    assert node._watchdog_task is not None and not node._watchdog_task.done()
    assert node._health_task is not None and not node._health_task.done()
    assert survival_events(node.flight.tail(0)) == ["watchdog.armed"]
  finally:
    await node.stop()
  assert node._watchdog_task is None and node._health_task is None


# -------------------------------------------- streaming restarts via the API

async def _streaming_restart(kit):
  engine_a, engine_b = _tracking(kit), _tracking(kit)
  a, b = await kit.ring(engine_a, engine_b, ids=("sk-a", "sk-b"))
  a.start_health_monitor()
  # sk-b (partition 0) dies before the sampler produces a token: the stream has sent
  # nothing, so the restart window is open.
  kit.faults.install(kit.faults.FaultInjector([
    {"rpc": "SendPrompt", "peer": "sk-b", "nth": 1, "action": "kill"}]))
  try:
    async with kit.api(a) as api:
      status, text, _ = await api.request("POST", "/v1/chat/completions", {
        "model": "dummy", "messages": [{"role": "user", "content": "hello"}], "stream": True})
      assert status == 200, text
      ids, content, done, errors = _sse(text)
      assert not errors, errors
      assert len(ids) == 1, f"chunks of more than one attempt leaked: {ids}"
      assert a.peers == [], "the dead peer is still in the ring"
      await asyncio.sleep(0.3)
      _assert_no_leaks(a)
      # The words, not the spaces: the port's fused decode sends a chunk of tokens
      # where JAX's per-token ring sends one, and the dummy decodes a chunk with spaces.
      return {"content": content.replace(" ", ""), "done": done,
              **_counters((a,), "request_restarts_total", "peer_evictions_total")}
  finally:
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_streaming_request_restarted_before_first_chunk(monkeypatch, transport):
  for var, val in (("XOT_STALL_TIMEOUT_S", "0.6"), ("XOT_HEALTH_INTERVAL_S", "0.1"),
                   ("XOT_REQUEST_RESTARTS", "1"), ("XOT_HOP_RETRIES", "1"), ("XOT_HOP_BACKOFF_S", "0.01")):
    monkeypatch.setenv(var, val)
  out = await _both(_streaming_restart, "inprocess", transport)
  assert out["content"] and out["done"] == 1 and out["request_restarts_total"] == 1


async def _mid_stream_failure(kit):
  engine = _tracking(kit)
  calls = {"n": 0}
  orig_sample = engine.sample

  async def sample_then_die(x, **kw):
    calls["n"] += 1
    if calls["n"] == 4:  # a few tokens stream out, then the engine dies
      raise RuntimeError("engine died mid-stream")
    return await orig_sample(x, **{k: v for k, v in kw.items() if k in ("temp", "top_k", "top_p")})

  engine.sample = sample_then_die
  node = await kit.node("sm-solo", engine, decode_chunk_size=1)
  try:
    async with kit.api(node) as api:
      status, text, _ = await api.request("POST", "/v1/chat/completions", {
        "model": "dummy", "messages": [{"role": "user", "content": "hello"}], "stream": True})
      ids, content, done, errors = _sse(text)
      return {"status": status, "error_types": [e["type"] for e in errors], "content": content,
              **_counters((node,), "request_restarts_total")}
  finally:
    await node.stop()


async def test_streaming_restart_never_fires_after_first_chunk(monkeypatch):
  """Once content reached the client, a failure is the stream's error event, never a
  restart that could contradict what was sent. (One partition per token on both
  sides: the port's fused chunk would hold the first tokens back until it ends.)"""
  monkeypatch.setenv("XOT_REQUEST_RESTARTS", "1")
  out = await _both(_mid_stream_failure, "inprocess", "inprocess")
  assert out["status"] == 200 and out["error_types"] == ["server_error"] and out["content"]
  assert out["request_restarts_total"] == 0


# --------------------------------------------------------- (d) knobs off

_OFF_KNOBS = {"XOT_HOP_RETRIES": "0", "XOT_REQUEST_DEADLINE_S": "0", "XOT_STALL_TIMEOUT_S": "0",
              "XOT_HEALTH_INTERVAL_S": "0", "XOT_REQUEST_RESTARTS": "0"}


async def _fail_fast(kit):
  retries_before = kit.faults.COUNTERS["hop_retries"]
  kit.faults.install(kit.faults.FaultInjector([{"rpc": "SendTensor", "nth": 2, "action": "error"}]))
  a, b = await kit.ring(kit.Dummy(), kit.Dummy())
  try:
    tokens, errors = await _generate(kit, a, (a, b), "ff-req")
    assert any(e and "injected error" in e for e in errors.values()), errors
    _assert_no_leaks(a, b)
    return {"tokens": tokens, "errors": sorted(filter(None, map(error_kind, errors.values()))),
            "retried": kit.faults.COUNTERS["hop_retries"] != retries_before,
            "tasks": (a._watchdog_task, a._health_task)}
  finally:
    kit.faults.install(None)
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_knobs_off_keeps_fail_fast_semantics(monkeypatch, transport):
  for var, off in _OFF_KNOBS.items():
    monkeypatch.setenv(var, off)
  monkeypatch.delenv("XOT_HOP_BACKOFF_S", raising=False)
  out = await _both(_fail_fast, "grpc", transport)
  assert out["retried"] is False and out["tasks"] == (None, None)


async def _knobs_off_bytes(kit):
  baseline = await _fault_free(kit)
  a, b = await kit.ring(kit.Dummy(), kit.Dummy())
  try:
    tokens, errors = await _generate(kit, a, (a, b), "plain-req")
    assert not any(errors.values())
    return {"same": tokens == baseline, "hop_seen": (dict(a._hop_seen), dict(b._hop_seen)),
            **_counters((a, b), "dedup_drops_total")}
  finally:
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_knobs_off_completion_bytes_unchanged(monkeypatch, transport):
  monkeypatch.setenv("XOT_HOP_RETRIES", "0")
  monkeypatch.delenv("XOT_FAULT_SPEC", raising=False)
  out = await _both(_knobs_off_bytes, "grpc", transport)
  assert out == {"same": True, "hop_seen": ({}, {}), "dedup_drops_total": 0}


# ------------------------------------------- a gray failure, localized

async def _gray_failure(kit, monkeypatch):
  """A delayed peer that still answers health checks drives the e2e burn-rate alert to
  firing, names the slow peer, and resolves when the fault clears."""
  for var, val in {
    "XOT_ALERT_FAST_S": "2", "XOT_ALERT_SLOW_S": "4", "XOT_ALERT_BURN_FAST": "1",
    "XOT_ALERT_BURN_SLOW": "1", "XOT_ALERT_PENDING_S": "0.05", "XOT_ALERT_RESOLVE_S": "0.3",
    "XOT_ALERT_EVAL_S": "0.2", "XOT_SLO_E2E_S": "0.4", "XOT_SLO_TTFT_S": "5",
    "XOT_SLO_TARGET": "0.9", "XOT_ALERT_HOP_DEGRADED_S": "0.02", "XOT_ALERT_RTT_TAU_S": "0.3",
  }.items():
    monkeypatch.setenv(var, val)
  kit.faults.install(kit.faults.FaultInjector([
    {"rpc": "SendTensor", "peer": "node-b", "nth": 1, "action": "delay", "times": 100000,
     "delay_s": 0.08}]))
  a, b = await kit.ring(kit.Dummy(), kit.Dummy())
  try:
    healthy = await a.peers[0].health_check()
    a.alerts.evaluate()  # the pre-traffic snapshot opens the window
    b.alerts.evaluate()
    tokens, errors = await _generate(kit, a, (a, b), "gray-req-1")
    slow_rtt = a.peers[0].hop_rtt is not None and a.peers[0].hop_rtt.value() >= 0.04
    st = a.alerts._states["slo_e2e"]
    for _ in range(50):
      a.alerts.evaluate()
      b.alerts.evaluate()
      if st["state"] == "firing":
        break
      await asyncio.sleep(0.1)
    loc = st.get("localization") or {}
    fired = (st["state"], loc.get("suspect"), loc.get("stage"),
             (loc.get("peers") or {}).get("node-b", {}).get("degraded"),
             any(x["reason"] == "alert_firing:slo_e2e" for x in a.flight.snapshots()))
    kit.faults.install(None)
    _, errors2 = await _generate(kit, a, (a, b), "gray-req-2")
    await asyncio.sleep(2.2)  # the slow requests leave the 2 s fast window
    resolved = False
    for _ in range(40):
      if any(t["to"] == "resolved" and t["rule"] == "slo_e2e" for t in a.alerts.evaluate()):
        resolved = True
        break
      await asyncio.sleep(0.1)
    return {"healthy": healthy, "errors": [error_kind(e) for e in (*errors.values(), *errors2.values())],
            "slow_rtt": slow_rtt, "fired": fired, "resolved": resolved}
  finally:
    await kit.stop(a, b)


@pytest.mark.parametrize("transport", PORT_TRANSPORTS)
async def test_gray_failure_alert_names_slow_peer(monkeypatch, transport):
  out = await _both(_gray_failure, "grpc", transport, monkeypatch)
  assert out == {"healthy": True, "errors": [None] * 4, "slow_rtt": True,
                 "fired": ("firing", "node-b", "hop", True, True), "resolved": True}


# --------------------------------------------------------- spec parsing

async def _spec_parsing(kit, monkeypatch):
  f = kit.faults
  f.install(None)
  spec = '[{"rpc": "SendTensor", "nth": 1, "action": "error"}]'
  monkeypatch.setenv("XOT_FAULT_SPEC", spec)
  inj = f.active()
  out = {"parsed": inj is not None}
  try:
    await inj.apply("SendTensor", "anyone")
    out["first"] = "passed"
  except f.TransientHopError:
    out["first"] = "raised"
  out["second"] = await inj.apply("SendTensor", "anyone")  # a one-shot rule
  out["cached"] = f.active() is inj
  monkeypatch.delenv("XOT_FAULT_SPEC")
  out["unset"] = f.active() is None
  monkeypatch.setenv("XOT_FAULT_SPEC", spec)  # the same spec again: a fresh injector
  fresh = f.active()
  out["fresh"] = fresh is not None and fresh is not inj
  try:
    await fresh.apply("SendTensor", "anyone")
    out["fresh_first"] = "passed"
  except f.TransientHopError:
    out["fresh_first"] = "raised"
  monkeypatch.delenv("XOT_FAULT_SPEC")
  return out


async def test_fault_spec_env_parsing(monkeypatch):
  out = await _both(_spec_parsing, "inprocess", "inprocess", monkeypatch)
  assert out == {"parsed": True, "first": "raised", "second": {"lost_ack": False, "sink": False},
                 "cached": True, "unset": True, "fresh": True, "fresh_first": "raised"}


@pytest.mark.parametrize("rule", [
  {"rpc": "SendTensor", "peer": "p", "nth": 2, "times": 2, "action": "sink"},
  {"rpc": "SendResult", "action": "lost_ack"},
  {"nth": 3, "action": "drop"},
  {"rpc": "SendTensor", "nth": 2, "action": "delay", "delay_s": 0.01},
  {"peer": "q", "action": "kill"},
  {"peer": "p", "nth": 2, "action": "kill"},
])
async def test_injector_rules_fire_as_jax_rules_do(rule):
  """Each action, the nth and times window and the rpc and peer filters, call by call
  on both packages' injectors."""
  async def calls(f):
    inj, out = f.FaultInjector([rule]), []
    for rpc, peer in (("SendTensor", "p"), ("SendResult", "p"), ("SendTensor", "p"),
                      ("SendTensor", "q"), ("SendTensor", "p"), ("SendTensor", "q")):
      try:
        flags = await inj.apply(rpc, peer)
        out.append(next((k for k, v in flags.items() if v), "ok"))
      except f.TransientHopError:
        out.append("raised")
    return out, [r.calls for r in inj.rules], sorted(inj.dead_peers)
  got = await calls(p_faults)
  assert got == await calls(j_faults)
  assert set(got[0]) != {"ok"} or rule["action"] == "delay"


# ------------------------------------------- (e) admission at the front door

async def _overload(kit, monkeypatch):
  monkeypatch.setenv("XOT_MAX_INFLIGHT", "1")
  monkeypatch.setenv("XOT_ADMIT_QUEUE_DEPTH", "1")
  monkeypatch.setenv("XOT_STALL_TIMEOUT_S", "5")  # armed, to show overload never trips it

  class Slow(kit.Dummy):
    """Each sampled token takes 10 ms, so the eight requests arrive while the first
    still runs, whichever server reads them."""

    async def sample(self, x, temp=0.0, top_k=0, top_p=0.0):
      await asyncio.sleep(0.01)
      return await super().sample(x, temp=temp, top_k=top_k, top_p=top_p)

  node = await kit.node("adm-node", Slow())
  try:
    async with kit.api(node, timeout=30) as api:
      body = {"model": "dummy", "messages": [{"role": "user", "content": "hello"}]}
      status, text, _ = await api.request("POST", "/v1/chat/completions", body)
      assert status == 200
      expected = json.loads(text)["choices"][0]["message"]["content"]
      resps = await asyncio.gather(*[api.request("POST", "/v1/chat/completions", body) for _ in range(8)])
      rejections = []
      for status, text, headers in resps:
        data = json.loads(text)
        if status == 429:
          assert headers.get("Retry-After"), "a 429 without Retry-After"
          err = data["error"]
          rejections.append((err["code"], err["queue_depth"], err["queue_position"], err["est_wait_s"] >= 0))
        else:
          assert data["choices"][0]["message"]["content"] == expected
      gate = node.admission
      _assert_no_leaks(node)
      return {"statuses": sorted(s for s, _, _ in resps), "rejections": rejections,
              "admitted": gate.admitted_total, "rejected": gate.rejected_total,
              "inflight": gate.inflight, "queued": len(gate._queue),
              **_counters((node,), "watchdog_aborts_total", "admission_rejections_total")}
  finally:
    await node.stop()


async def test_overload_sheds_as_429s_never_watchdog_aborts(monkeypatch):
  out = await _both(_overload, "inprocess", "inprocess", monkeypatch)
  assert out["statuses"] == [200, 200] + [429] * 6
  assert out["rejections"] == [("overloaded", 1, 2, True)] * 6
  assert (out["admitted"], out["rejected"], out["inflight"], out["queued"]) == (3, 6, 0, 0)
  assert out["watchdog_aborts_total"] == 0 and out["admission_rejections_total"] == 6


async def _admission_off(kit, monkeypatch):
  monkeypatch.delenv("XOT_MAX_INFLIGHT", raising=False)
  monkeypatch.setenv("XOT_ADMIT_QUEUE_DEPTH", "32")
  node = await kit.node("adm-node", kit.Dummy())
  try:
    async with kit.api(node, timeout=30) as api:
      body = {"model": "dummy", "messages": [{"role": "user", "content": "hello"}]}
      first = json.loads((await api.request("POST", "/v1/chat/completions", body))[1])
      status, text, _ = await api.request("POST", "/v1/chat/completions", body)
      gate = node.admission
      q = json.loads((await api.request("GET", "/v1/queue"))[1])
      _assert_no_leaks(node)
      return {"status": status, "same": json.loads(text)["choices"][0]["message"]["content"]
              == first["choices"][0]["message"]["content"],
              "gate": (gate.enabled, gate.admitted_total, gate.rejected_total, gate.inflight, len(gate._queue)),
              "summary_key": "admission" in node.metrics_summary(),
              "queue": (q["enabled"], q["cluster"])}
  finally:
    await node.stop()


async def test_admission_knobs_off_parity(monkeypatch):
  out = await _both(_admission_off, "inprocess", "inprocess", monkeypatch)
  assert out == {"status": 200, "same": True, "gate": (False, 0, 0, 0, 0), "summary_key": False,
                 "queue": (False, {})}


# --------------------------------------------------- the origin-only tap

async def _origin_tap(kit):
  node = await kit.node("tap-node", kit.Dummy())

  async def run(rid):
    done = asyncio.Event()
    out = {}

    def on_token(request_id, tokens, fin):
      if request_id == rid:
        out["tokens"] = list(tokens)
        if fin:
          done.set()

    node.on_token.register(f"tap-{rid}").on_next(on_token)
    t0 = time.monotonic()
    await node.process_prompt(kit.shard(), "hello", rid)
    await asyncio.wait_for(done.wait(), timeout=15)
    node.on_token.deregister(f"tap-{rid}")
    return out["tokens"], time.monotonic() - t0

  try:
    base_tokens, base_secs = await run("tap-base")
    kit.faults.install(kit.faults.FaultInjector([
      {"rpc": "ProcessPrompt", "action": "delay", "nth": 1, "times": 1, "delay_s": 0.6}]))
    slow_tokens, slow_secs = await run("tap-slow")
    kit.faults.install(kit.faults.FaultInjector([{"rpc": "ProcessPrompt", "action": "error", "nth": 1}]))
    err_tokens, _ = await run("tap-err")
    _assert_no_leaks(node)
    return {"same": slow_tokens == base_tokens, "slower": slow_secs >= base_secs + 0.5,
            "err_tokens": err_tokens, "error": error_kind(node.request_errors.get("tap-err"))}
  finally:
    await node.stop()


async def test_process_prompt_delay_tap_is_origin_only_and_observed():
  out = await _both(_origin_tap, "inprocess", "inprocess")
  assert out == {"same": True, "slower": True, "err_tokens": [], "error": "injected fault"}


async def _wildcard_tap(kit):
  engine = kit.Dummy()
  node = await kit.node("wild-node", engine)
  inj = kit.faults.FaultInjector([{"action": "error", "nth": 1, "times": 1}])
  kit.faults.install(inj)
  try:
    tokens, errors = await _generate(kit, node, (node,), "wild-req", prompt="hello")
    return {"error": errors["wild-node"], "calls": inj.rules[0].calls,
            "tokens": len(tokens) == engine.num_generate_dummy_tokens}
  finally:
    await node.stop()


async def test_process_prompt_tap_ignores_wildcard_rules():
  """A rule with no rpc keeps to the peer handles: the origin tap neither fires it nor
  spends its calls."""
  out = await _both(_wildcard_tap, "inprocess", "inprocess")
  assert out == {"error": None, "calls": 0, "tokens": True}


# ------------------------------------------------ the API's control routes

async def test_debug_faults_and_topology_routes(monkeypatch):
  """/v1/debug/faults installs, reports and removes the process-wide injector with the
  JAX handler's bodies; /v1/topology shows the healed ring's partitions."""
  kit = Kit("port", "inprocess")
  a, b = await kit.ring(kit.Dummy(), kit.Dummy(), ids=("tp-a", "tp-b"))
  try:
    async with kit.api(a) as api:
      assert json.loads((await api.request("GET", "/v1/debug/faults"))[1]) == {
        "installed": False, "rules": 0, "dead_peers": []}
      for bad in ({}, {"rules": []}, {"rules": [{"rpc": "SendTensor"}]}):
        status, text, _ = await api.request("POST", "/v1/debug/faults", bad)
        assert status == 400 and json.loads(text)["error"]["type"] == "invalid_request_error"
      status, text, _ = await api.request("POST", "/v1/debug/faults", {"rules": [
        {"rpc": "SendTensor", "peer": "tp-b", "action": "kill"}]})
      assert (status, json.loads(text)) == (200, {"installed": True, "rules": 1})
      p_faults.active().kill_peer("tp-b")
      assert json.loads((await api.request("GET", "/v1/debug/faults"))[1]) == {
        "installed": True, "rules": 1, "dead_peers": ["tp-b"]}
      topo = json.loads((await api.request("GET", "/v1/topology"))[1])
      assert set(topo["nodes"]) == {"tp-a", "tp-b"}
      assert topo["partitions"] == [{"node_id": "tp-b", "start_layer": 0, "end_layer": 3},
                                    {"node_id": "tp-a", "start_layer": 4, "end_layer": 7}]
      await a.heal_ring()
      topo = json.loads((await api.request("GET", "/topology"))[1])
      assert list(topo["nodes"]) == ["tp-a"]
      assert topo["partitions"] == [{"node_id": "tp-a", "start_layer": 0, "end_layer": 7}]
      assert json.loads((await api.request("DELETE", "/v1/debug/faults"))[1]) == {"installed": False}
      assert p_faults.active() is None
  finally:
    await kit.stop(a, b)


# ------------------------------------ a model ring killed in mid-decode

async def _jax_solo_tokens(prompt, gen):
  """JAX's solo greedy stream of `prompt` on synthetic-tiny (fp32)."""
  from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
  from xotorch_tpu.orchestration.node import Node as JNode
  from xotorch_tpu.topology.partitioning import RingMemoryWeightedPartitioningStrategy

  node = JNode("jax-solo", None, JAXShardInferenceEngine(dtype="float32"), JStaticDiscovery([]), None,
               RingMemoryWeightedPartitioningStrategy(), max_generate_tokens=gen, default_sample_temp=0.0)
  node.device_capabilities = j_caps()
  node.topology.update_node(node.id, j_caps())
  done = asyncio.Event()
  out = {}

  def on_token(rid, tokens, finished):
    out["tokens"] = list(tokens)
    if finished:
      done.set()
  node.on_token.register("t").on_next(on_token)
  with jax.default_matmul_precision("highest"):
    await node.process_prompt(JShard("synthetic-tiny", 0, 0, 4), prompt, "jax-solo")
    await asyncio.wait_for(done.wait(), timeout=120)
  return out["tokens"]


async def test_model_ring_killed_mid_decode_restarts_to_the_solo_stream(jax_weights, tmp_path, monkeypatch):
  """Two port peers over TCP serve synthetic-tiny (layers 0-1 on node-b, 2-3 on node-a,
  the sampler and API node). node-b dies at the third token hop sent to it; node-a's
  API heals the ring to itself and restarts the request, whose greedy tokens equal the
  port's solo stream and JAX's."""
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer
  from xotorch_tpu_torch.models.registry import get_model_card

  class WordIds(DummyTokenizer):
    def decode(self, tokens) -> str:
      return "".join(f" w{int(t)}" for t in tokens)

  monkeypatch.setenv("XOT_REQUEST_RESTARTS", "1")
  monkeypatch.setenv("XOT_HOP_BACKOFF_S", "0.01")
  ring = await Ring(tmp_path, ["node-b", "node-a"]).start()
  origin = ring.nodes["node-a"]
  client = _PortApi(origin, 60)
  client.api.inference_engine_classname = ring.classname
  client.api._tokenizers[MODEL] = WordIds()
  messages = [{"role": "user", "content": "hello world test prompt for the ring"}]
  prompt, _ = await client.api._request_prompt(MODEL, messages, None)
  p_faults.install(p_faults.FaultInjector([
    {"rpc": "SendTensor", "peer": "node-b", "nth": 3, "action": "kill"}]))
  try:
    async with client:
      status, text, _ = await client.request("POST", "/v1/chat/completions",
                                             {"model": MODEL, "messages": messages, "temperature": 0})
    assert status == 200, text
    got = [int(w[1:]) for w in json.loads(text)["choices"][0]["message"]["content"].split()]
    assert _count(origin.metrics.request_restarts_total) == 1
    assert _count(origin.metrics.peer_evictions_total) == 1 and origin.peers == []
    assert origin.get_current_shard(PShard(MODEL, 0, 0, 4)) == PShard(MODEL, 0, 3, 4)
  finally:
    p_faults.install(None)
    await ring.stop()
  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-temp", "0", "--max-generate-tokens", str(GEN)])
  node, engine, _, _ = port_main.build_node(args)
  try:
    solo, errors = await _generate(Kit("port", "inprocess"), node, (node,), "solo", timeout=60,
                                   prompt=prompt, shard=PShard(MODEL, 0, 0, 4))
  finally:
    await node.stop()
    engine.executor.shutdown(wait=True)
  assert not any(errors.values()) and len(solo) == GEN
  eos = get_model_card(MODEL)["synthetic_config"]["eos_token_id"]
  assert got == [t for t in solo if t != eos]
  assert solo == await _jax_solo_tokens(prompt, GEN)
