"""The port's observability layer against the JAX package's.

The recorders (NodeMetrics, Tracer, FlightRecorder, the latency anatomy, the admission
gate, the alert engine and the metrics history) of both packages are fed the same
scripted events under one injected clock, and must give the same exposition, summaries,
exports, snapshots and status dicts (floats within 1e-9). A W3C traceparent crosses
between the packages both ways. On the CPU the port's server answers every
observability route with the JAX server's keys, sheds overload as a 429 with
Retry-After, writes a torch.profiler device trace, and a two-peer ring keeps one trace
id across its hops, rolls both peers' metrics up and breaks a request down into stages
with its hop.
"""
import asyncio
import itertools
import json
import math
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from xotorch_tpu.orchestration import admission as j_admission
from xotorch_tpu.orchestration import alerts as j_alerts
from xotorch_tpu.orchestration import anatomy as j_anatomy
from xotorch_tpu.orchestration import flight as j_flight
from xotorch_tpu.orchestration import history as j_history
from xotorch_tpu.orchestration import metrics as j_metrics
from xotorch_tpu.orchestration import tracing as j_tracing
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.orchestration import admission, alerts, anatomy, flight, history, metrics, tracing

from tests.test_torch_ring import MODEL, Ring, _generate, _wait_idle

torch.set_num_threads(2)


class FakeClock:
  """time.time/monotonic/time_ns/perf_counter for the recorders under test: one
  instant both packages read, moved by the test."""

  def __init__(self, t: float = 1_700_000_000.0):
    self.t = t

  def time(self) -> float:
    return self.t

  def monotonic(self) -> float:
    return self.t - 1_699_000_000.0

  def time_ns(self) -> int:
    return int(round(self.t * 1e9))

  def perf_counter(self) -> float:
    return self.monotonic()


@pytest.fixture()
def clock(monkeypatch):
  c = FakeClock()
  for mod in (flight, j_flight, anatomy, j_anatomy, admission, j_admission, alerts, j_alerts,
              history, j_history):
    monkeypatch.setattr(mod, "time", c)
  return c


def _close(a, b, path="") -> None:
  """Equal dicts/lists/values, floats within 1e-9 (relative above 1)."""
  if isinstance(a, dict):
    assert isinstance(b, dict) and set(a) == set(b), f"{path}: keys {sorted(a)} != {sorted(b)}"
    for k in a:
      _close(a[k], b[k], f"{path}.{k}")
  elif isinstance(a, (list, tuple)):
    assert isinstance(b, (list, tuple)) and len(a) == len(b), f"{path}: {a} != {b}"
    for i, (x, y) in enumerate(zip(a, b)):
      _close(x, y, f"{path}[{i}]")
  elif isinstance(a, float) or isinstance(b, float):
    assert isinstance(b, (int, float)) and abs(a - b) <= 1e-9 * max(1.0, abs(b)), f"{path}: {a} != {b}"
  else:
    assert a == b, f"{path}: {a!r} != {b!r}"


# ------------------------------------------------------------------ metrics


def _feed_metrics(m) -> None:
  m.requests_total.inc()
  m.requests_total.inc(2)
  m.tokens_total.inc(37)
  m.tensor_hops_total.inc(5)
  m.active_requests.set(3)
  m.peers.set(1)
  m.dedup_drops_total.inc()
  m.requests_failed_total.inc()
  m.admission_rejections_total.inc()
  m.admit_queue_depth.set(2)
  for v in (0.004, 0.3, 0.7, 12.0, 99.0):
    m.ttft.observe(v)
    m.request_latency.observe(v * 3)
  for v in (0.0009, 0.02, 0.2, 7.0):
    m.token_latency.observe(v)
    m.hop_latency.observe(v / 2)
    m.queue_wait_decode.observe(v / 10)
  m.queue_wait_prefill.observe(0.04)


def _samples(text: str) -> dict:
  """Exposition sample lines as {series: value}, without the creation stamps and the
  uptime (wall-clock readings), and the HELP/TYPE lines as a set."""
  out, meta = {}, set()
  for line in text.splitlines():
    if line.startswith("#"):
      meta.add(line)
      continue
    series, value = line.rsplit(" ", 1)
    if "_created" in series or series.startswith("xot_uptime_seconds"):
      continue
    out[series] = float(value)
  return out, meta


def test_node_metrics_exposition_and_summary_equal_jax(monkeypatch):
  # The transport counters are process-wide: other tests in this process move them.
  from xotorch_tpu.networking import faults as j_faults
  from xotorch_tpu_torch.networking import faults
  for mod in (faults, j_faults):
    monkeypatch.setattr(mod, "COUNTERS", {"hop_retries": 2, "health_check_failures": 0})
  port, jax_m = metrics.NodeMetrics("n1"), j_metrics.NodeMetrics("n1")
  for m in (port, jax_m):
    _feed_metrics(m)
  assert _samples(port.exposition().decode()) == _samples(jax_m.exposition().decode())
  _close(port.summary(), jax_m.summary())
  nodes = [port.summary(), metrics.NodeMetrics("n2").summary()]
  _close(metrics.aggregate_histograms(nodes), j_metrics.aggregate_histograms(nodes))
  rows = port.summary()["ttft_seconds"]["buckets"]
  for q in (0.0, 0.5, 0.9, 0.99, 1.0):
    assert metrics.quantile_from_buckets(rows, q) == j_metrics.quantile_from_buckets(rows, q)
    assert metrics.quantile_bucket_span(rows, q) == j_metrics.quantile_bucket_span(rows, q)
  # The exposition's float formatting is the Go text format's.
  for v in (0.0, 1.0, 0.3, 123456.0, 1234567.0, 1.7e9, float("inf"), float("nan")):
    from prometheus_client.utils import floatToGoString
    assert metrics.format_value(v) == floatToGoString(v)


# ------------------------------------------------------------------ tracing


def _ids(monkeypatch, mod) -> None:
  counter = itertools.count(1)

  class Ids:
    @staticmethod
    def token_hex(n: int) -> str:
      return f"{next(counter):0{2 * n}x}"
  monkeypatch.setattr(mod, "secrets", Ids)


def _script_tracer(t) -> list:
  clock = itertools.count(1000, 7)
  t.now_ns = lambda: next(clock)
  with t.start_span("process_prompt", attributes={"request.id": "r1"}) as root:
    ctx = root.context()
    with t.start_span("engine.prefill", parent=ctx, attributes={"tokens": 12}):
      pass
  for _ in range(23):
    t.record_token("r1", ctx)
  t.finish_request("r1")
  with t.start_span("process_tensor", parent=tracing.TraceContext("ab" * 16, "cd" * 8, sampled=False)):
    pass  # an unsampled trace's span is never buffered
  try:
    with t.start_span("failing", parent=ctx):
      raise RuntimeError("boom")
  except RuntimeError:
    pass
  remote = [{"traceId": ctx.trace_id, "spanId": "ee" * 8, "parentSpanId": ctx.span_id,
             "name": "process_tensor", "startTimeUnixNano": 1100, "endTimeUnixNano": 1300,
             "attributes": [{"key": "node.id", "value": "peer"}], "status": "OK"}]
  added = [t.ingest(remote), t.ingest(remote)]  # a redelivery adds nothing
  return [added, t.export(), t.export(node_id="n1"), t.export(trace_id=ctx.trace_id, clear=True),
          t.export()]


def test_tracer_export_equals_jax(monkeypatch):
  _ids(monkeypatch, tracing)
  _ids(monkeypatch, j_tracing)
  port = _script_tracer(tracing.Tracer(node_id="n1"))
  want = _script_tracer(j_tracing.Tracer(node_id="n1"))
  assert port == want
  names = [s["name"] for s in port[1]]
  assert names == ["engine.prefill", "process_prompt", "tokens[0..9]", "tokens[10..19]",
                   "tokens[20..29]", "failing", "process_tensor"]


def test_traceparent_round_trips_between_the_packages():
  ctx = tracing.TraceContext.new()
  back = j_tracing.TraceContext.from_traceparent(ctx.traceparent())
  assert (back.trace_id, back.span_id, back.sampled) == (ctx.trace_id, ctx.span_id, True)
  jctx = j_tracing.TraceContext("12" * 16, "34" * 8, sampled=False)
  again = tracing.TraceContext.from_traceparent(jctx.traceparent())
  assert again == tracing.TraceContext("12" * 16, "34" * 8, sampled=False)
  assert again.traceparent() == jctx.traceparent()
  for bad in (None, "", "00-xyz", "00-" + "a" * 31 + "-" + "b" * 16 + "-01"):
    assert tracing.TraceContext.from_traceparent(bad) is None
    assert j_tracing.TraceContext.from_traceparent(bad) is None
  assert tracing.TRACEPARENT_KEY == j_tracing.TRACEPARENT_KEY


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
  """torch.profiler in place of jax.profiler: one session at a time, a Chrome trace
  written at the stop, and the XOT_DEVICE_TRACE_MAX_S auto-stop."""
  logdir = str(tmp_path / "trace")
  assert tracing.start_device_trace(logdir) is True
  assert tracing.start_device_trace(logdir) is False
  torch.ones(64, 64) @ torch.ones(64, 64)
  assert tracing.stop_device_trace() is True
  assert tracing.stop_device_trace() is False
  path = tracing.DEVICE_TRACE.last_file
  assert path.startswith(logdir) and "traceEvents" in json.loads(open(path).read())
  monkeypatch.setenv("XOT_DEVICE_TRACE_MAX_S", "0.2")
  assert tracing.start_device_trace(logdir) is True
  for _ in range(100):
    if tracing.DEVICE_TRACE.prof is None:
      break
    import time
    time.sleep(0.05)
  assert tracing.DEVICE_TRACE.prof is None and tracing.DEVICE_TRACE.last_file != path
  assert len(os.listdir(logdir)) == 2


# ------------------------------------------------------------------- flight


def _script_flight(fl, clock, tmp) -> list:
  out = []
  for i in range(30):
    clock.t += 0.25
    fl.record("hop.send" if i % 3 else "pool.alloc", f"r{i % 4}" if i % 5 else None, seq=i)
  with pytest.raises(ValueError):
    fl.record("no.such.event")
  clock.t += 1
  out.append(fl.freeze("r1", reason="watchdog"))
  out.append(fl.freeze(None, reason="evicted"))
  for i in range(4):
    fl.freeze(f"x{i}", reason="many")
  out += [fl.snapshot("r1"), fl.snapshots(), fl.tail(5), fl.tail(), fl.stats()]
  path = fl.dump_to(tmp, reason="shutdown")
  out.append(json.loads(open(path).read()))
  return out


def test_flight_recorder_equals_jax(clock, tmp_path):
  assert flight.EVENTS == j_flight.EVENTS
  port = _script_flight(flight.FlightRecorder("n1", capacity=20, max_snapshots=3), clock,
                        tmp_path / "p")
  clock.t = FakeClock().t
  want = _script_flight(j_flight.FlightRecorder("n1", capacity=20, max_snapshots=3), clock,
                        tmp_path / "j")
  _close(port, want)


# ------------------------------------------------------------------ anatomy


def _span(name, node, start, end, trace="t" * 32):
  return {"traceId": trace, "spanId": f"{name}{node}{start}", "parentSpanId": "",
          "name": name, "startTimeUnixNano": start, "endTimeUnixNano": end,
          "attributes": [{"key": "node.id", "value": node}], "status": "OK"}


def _script_anatomy(mod, clock) -> list:
  a, b = mod.ClockSkew("a"), mod.ClockSkew("b")
  b.skew_ns = 3_000_000
  for i in range(6):
    clock.t += 0.01
    b.note(a.stamp())
    clock.t += 0.002
    a.note(b.stamp())
  clocks = {"a": a.deltas(), "b": b.deltas(), "c": {"b": {"min_ns": 4_000_000, "n": 2}}}
  offsets = mod.ring_offsets("a", clocks, {"b": {"c": 0.004}})
  spans = [_span("process_prompt", "a", 0, 100_000_000),
           _span("engine.prefill", "a", 5_000_000, 40_000_000),
           _span("process_tensor", "b", 45_000_000, 70_000_000),
           _span("tokens[0..9]", "a", 40_000_000, 98_000_000),
           _span("process_tensor", "a", 75_000_000, 90_000_000)]
  breakdowns = []
  store = mod.AnatomyStore()
  for i in range(5):
    clock.t += 30.0
    bd = mod.extract_breakdown(spans, offsets, f"r{i}", "t" * 32)
    breakdowns.append(bd)
    store.add(bd)
  return [a.deltas(), b.deltas(), offsets, breakdowns, store.percentiles(), store.stage_summary(),
          store.diff(60.0), store.gauge_stats(), store.get("r2"), mod.chrome_trace(spans, offsets),
          mod.pair_offset(5.0, 3.0)]


def test_anatomy_equals_jax(clock):
  start = clock.t
  port = _script_anatomy(anatomy, clock)
  clock.t = start
  want = _script_anatomy(j_anatomy, clock)
  _close(port, want)
  stages = port[3][0]["stages"]
  assert "hop:b" in stages and "dispatch:b" in stages and "prefill" in stages


# ---------------------------------------------------------------- admission


class _FakeNode:
  """What the gate, the alert engine and the history read of a Node."""

  def __init__(self, metrics_mod, flight_mod, anatomy_mod, perf=None):
    self.id = "n1"
    self.metrics = metrics_mod.NodeMetrics("n1")
    self.metrics.uptime_s = lambda: 12.5
    self.flight = flight_mod.FlightRecorder("n1")
    self.anatomy = anatomy_mod.AnatomyStore()
    self.peers = []
    self.peer_metrics = {}
    perf = perf or {}

    class Engine:
      def perf_stats(self):
        return perf.get("stats")

      def perf_compact(self):
        return perf.get("compact")

      def history_gauges(self):
        return perf.get("history")
    self.inference_engine = Engine()

  def peer_metrics_stale(self, node_id):
    return True


async def _script_gate(mods, clock) -> list:
  metrics_mod, flight_mod, anatomy_mod, gate_mod = mods
  node = _FakeNode(metrics_mod, flight_mod, anatomy_mod,
                   {"stats": {"decode_tok_s": 40.0}})
  node.metrics.requests_total.inc(4)
  node.metrics.tokens_total.inc(200)
  gate = gate_mod.AdmissionGate(node)
  out = [await gate.acquire("r1")]
  waiter = asyncio.ensure_future(gate.acquire("r2"))
  await asyncio.sleep(0)
  out.append(gate.compact())
  with pytest.raises(gate_mod.AdmissionRejected) as e:
    await gate.acquire("r3")
  out.append((e.value.queued, e.value.limit, e.value.retry_after_s))
  clock.t += 1.0
  gate.release()
  out.append(await asyncio.wait_for(waiter, 5))
  out += [gate.compact(), gate.estimate_wait_s(5), gate.service_time_s(),
          node.metrics.summary(), node.flight.tail()]
  gate.release()
  out.append(gate.compact())
  return out


def test_admission_gate_equals_jax(clock, monkeypatch):
  monkeypatch.setenv("XOT_MAX_INFLIGHT", "1")
  monkeypatch.setenv("XOT_ADMIT_QUEUE_DEPTH", "1")
  start = clock.t
  port = asyncio.run(_script_gate((metrics, flight, anatomy, admission), clock))
  clock.t = start
  want = asyncio.run(_script_gate((j_metrics, j_flight, j_anatomy, j_admission), clock))
  _close(port, want)
  assert port[2][0] == 1 and port[3] is True


def test_admission_gate_is_off_by_default():
  node = _FakeNode(metrics, flight, anatomy)
  gate = admission.AdmissionGate(node)
  assert not gate.enabled and asyncio.run(gate.acquire("r")) is False
  assert gate.estimate_wait_s() == 0.0


# --------------------------------------------------------- alerts, history


def _script_alerts(mods, clock) -> list:
  metrics_mod, flight_mod, anatomy_mod, alerts_mod, history_mod = mods
  engine_state = {"compact": {"dispatches": 4, "secs": 0.4},
                  "history": {"decode_tok_s": 50.0, "hbm_util_pct": 20.0, "mfu_pct": 1.0,
                              "jit_first_dispatches": 1, "jit_cached_dispatches": 3,
                              "host_fetch_bytes": 0}}
  node = _FakeNode(metrics_mod, flight_mod, anatomy_mod, engine_state)
  node.history = history_mod.MetricsHistory(node)
  al = alerts_mod.AlertEngine(node)
  out = []
  for tick in range(40):
    clock.t += 5.0
    m = node.metrics
    m.requests_total.inc(3)
    m.tokens_total.inc(60)
    if tick >= 10:  # a burst of slow first tokens and failures: the SLO rules burn
      m.ttft.observe(45.0)
      m.request_latency.observe(90.0)
      m.requests_failed_total.inc()
    else:
      m.ttft.observe(0.2)
      m.request_latency.observe(1.5)
    m.token_latency.observe(0.02)
    engine_state["history"] = {**engine_state["history"],
                               "decode_tok_s": 50.0 - tick, "jit_cached_dispatches": 3 + tick}
    now = clock.monotonic()
    out.append(al.evaluate(now=now))
    out.append(node.history.observe(now=now))
  now = clock.monotonic()
  out += [al.status(), al.compact(), al.gauge_stats(), al.burn_gauges(), al.peer_hop_gauges(),
          node.history.status(), node.history.status(window_s=60.0, metric="decode_tok_s"),
          node.history.compact(now=now), node.history.diff(50.0, now=now),
          node.history.rows(window_s=30.0, now=now), node.flight.tail()]
  return out


def test_alerts_and_history_equal_jax(clock, monkeypatch):
  monkeypatch.setenv("XOT_ALERT_PENDING_S", "10")
  monkeypatch.setenv("XOT_HISTORY_SAMPLES", "8")
  monkeypatch.setenv("XOT_HISTORY_MERGE", "2")
  monkeypatch.setenv("XOT_HISTORY_COARSE", "8")
  monkeypatch.setenv("XOT_DRIFT_WINDOW_S", "30")
  monkeypatch.setenv("XOT_DRIFT_BASELINE_S", "60")
  start = clock.t
  port = _script_alerts((metrics, flight, anatomy, alerts, history), clock)
  clock.t = start
  want = _script_alerts((j_metrics, j_flight, j_anatomy, j_alerts, j_history), clock)
  _close(port, want)
  assert port[-11]["active"], "the scripted burn must fire an alert"


# ------------------------------------------------------------- HTTP routes

ROUTES = ("/v1/traces", "/v1/perf", "/v1/queue", "/v1/debug/flight", "/v1/cluster/metrics",
          "/v1/anatomy", "/v1/alerts", "/v1/history")
BODY = {"model": "synthetic-tiny", "temperature": 0, "max_tokens": 6,
        "messages": [{"role": "user", "content": "one two three four five"}]}


def _http(url, body=None, method=None):
  req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"}, method=method)
  try:
    with urllib.request.urlopen(req, timeout=120) as r:
      return r.status, dict(r.headers), r.read()
  except urllib.error.HTTPError as e:
    return e.code, dict(e.headers), e.read()


def _shape(d, depth=2):
  """Key structure of a payload, `depth` levels down (keys only: values differ by run)."""
  if depth == 0 or not isinstance(d, dict):
    return type(d).__name__ if not isinstance(d, dict) else "dict"
  return {k: _shape(v, depth - 1) for k, v in d.items()}


def _families(text: str) -> set:
  return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}


async def _jax_routes():
  from aiohttp.test_utils import TestClient, TestServer
  from xotorch_tpu.api.chatgpt_api import ChatGPTAPI
  from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
  from tests.test_orchestration import _caps, _make_node
  node = await _make_node("routes", JAXShardInferenceEngine(), max_generate_tokens=8,
                          default_sample_temp=0.0, decode_chunk_size=4)
  node.topology.update_node("routes", _caps())
  client = TestClient(TestServer(ChatGPTAPI(node, "JAXShardInferenceEngine", response_timeout=60,
                                            default_model="synthetic-tiny").app))
  await client.start_server()
  try:
    resp = await client.post("/v1/chat/completions", json=BODY)
    assert resp.status == 200
    await asyncio.sleep(0.6)
    out = {path: await (await client.get(path)).json() for path in ROUTES}
    out["/metrics"] = await (await client.get("/metrics")).text()
    return out
  finally:
    await client.close()
    await node.stop()


async def _port_server(env=()):
  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-model", MODEL, "--chatgpt-api-host", "127.0.0.1",
     "--chatgpt-api-port", "0", "--default-temp", "0", "--max-generate-tokens", "8"])
  node, engine, _, api = port_main.build_node(args)
  server = await api.start("127.0.0.1", 0)
  return node, engine, server, f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"


async def _port_routes(tmp_path):
  node, engine, server, base = await _port_server()
  loop = asyncio.get_running_loop()
  call = lambda *a: loop.run_in_executor(None, _http, *a)  # noqa: E731
  try:
    for _ in range(2):
      status, _, _ = await call(base + "/v1/chat/completions", BODY)
      assert status == 200
    await asyncio.sleep(0.6)
    out = {}
    for path in ROUTES:
      status, _, raw = await call(base + path)
      assert status == 200, path
      out[path] = json.loads(raw)
    status, headers, raw = await call(base + "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    out["/metrics"] = raw.decode()
    logdir = str(tmp_path / "device")
    status, _, raw = await call(base + "/v1/trace/device/start", {"logdir": logdir})
    out["start"] = json.loads(raw)
    await call(base + "/v1/chat/completions", BODY)
    status, _, raw = await call(base + "/v1/trace/device/stop", {})
    out["stop"] = json.loads(raw)
    out["trace_files"] = os.listdir(logdir)
    for path, want in (("/v1/anatomy?request_id=nope", 404), ("/v1/debug/flight?request_id=nope", 404),
                       ("/v1/anatomy?diff=x", 400), ("/v1/debug/flight?live=x", 400),
                       ("/v1/history?window=x", 400), ("/v1/nothing", 404)):
      status, _, _ = await call(base + path)
      assert status == want, path
    out["flight_live"] = json.loads((await call(base + "/v1/debug/flight?live=3"))[2])
    out["history_compact"] = json.loads((await call(base + "/v1/history?compact=1"))[2])
    out["traces_chrome"] = json.loads((await call(base + "/v1/traces?format=chrome"))[2])
    return out
  finally:
    server.close()
    await node.stop()
    engine.executor.shutdown(wait=True)


def test_routes_answer_with_the_jax_servers_keys(tmp_path, monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_ANATOMY_DELAY_S", "0.1")
  want = asyncio.run(_jax_routes())
  got = asyncio.run(_port_routes(tmp_path))
  # Both engines' host KV tier exists once a prefill has consulted it (XOT_KV_HOST_BYTES),
  # empty: nothing was evicted.
  assert got["/v1/perf"]["byte_flows"]["host_tier"] == {"bytes": 0, "entries": 0,
                                                        "restore_fallbacks": 0}
  assert want["/v1/perf"]["byte_flows"]["host_tier"] == {"bytes": 0, "entries": 0}
  diffs = {}
  for path in ROUTES:
    depth = 1 if path in ("/v1/history", "/v1/alerts") else 2
    if path == "/v1/perf":  # the ring-wide view is keyed by node id
      got[path].pop("cluster"), want[path].pop("cluster")
      # The port's own key: each resident model context's graph and slab bytes (the JAX
      # engine has no captured graphs).
      assert [c["model_id"] for c in got[path].pop("contexts")] == ["synthetic-tiny"]
    key = {"/v1/cluster/metrics": "nodes", "/v1/anatomy": "offsets"}.get(path)
    if key:
      got[path][key] = list(got[path][key].values())[0]  # keyed by node id: one node each
      want[path][key] = list(want[path][key].values())[0]
    if _shape(got[path], depth) != _shape(want[path], depth):
      diffs[path] = (_shape(got[path], depth), _shape(want[path], depth))
  assert not diffs, diffs
  assert _families(got["/metrics"]) == _families(want["/metrics"])
  text = got["/metrics"]
  samples, _ = _samples(text)
  node_label = next(k for k in samples if k.startswith("xot_requests_total"))
  assert samples[node_label] == 2  # the two completions before the scrape
  ttft = next(v for k, v in samples.items() if k.startswith("xot_ttft_seconds_count"))
  assert ttft == 2
  perf = got["/v1/perf"]
  assert perf["model"]["weight_bytes_predicted"] == perf["model"]["weight_bytes_actual"]
  lanes = perf["lanes"]
  assert sum(r["dispatches"] for r in lanes.values()) == (
    perf["dispatch"]["jit_first_dispatches"] + perf["dispatch"]["jit_cached_dispatches"])
  assert got["start"]["started"] is True and set(got["start"]) == {"started", "logdir", "max_s"}
  assert got["stop"] == {"stopped": True} and len(got["trace_files"]) == 1
  spans = got["/v1/traces"]["spans"]
  by_trace = {}
  for s in spans:
    by_trace.setdefault(s["traceId"], []).append(s)
  assert len(by_trace) == 2  # one trace per request
  for trace in by_trace.values():
    ids = {s["spanId"] for s in trace}
    names = {s["name"] for s in trace}
    assert {"process_prompt", "engine.prefill", "tokens[0..9]"} <= names
    for s in trace:
      assert s["parentSpanId"] in ids or s["name"] == "process_prompt"
      assert 0 < s["startTimeUnixNano"] <= s["endTimeUnixNano"]
  assert got["/v1/anatomy"]["breakdowns"] == 2
  assert set(got["flight_live"]) >= {"events", "snapshots"} and len(got["flight_live"]["events"]) == 3
  assert got["history_compact"]["enabled"] is True
  assert got["traces_chrome"]["traceEvents"]


async def _admission_429():
  node, engine, server, base = await _port_server()
  loop = asyncio.get_running_loop()
  call = lambda *a: loop.run_in_executor(None, _http, *a)  # noqa: E731
  try:
    gate = node.admission
    assert await gate.acquire("held") is True  # the one slot, taken by another caller
    queued = asyncio.ensure_future(call(base + "/v1/chat/completions", BODY))
    for _ in range(200):
      if gate.compact()["queued"] == 1:
        break
      await asyncio.sleep(0.02)
    status, headers, raw = await call(base + "/v1/chat/completions", BODY)
    queue = json.loads((await call(base + "/v1/queue"))[2])
    gate.release()
    served = await asyncio.wait_for(queued, 120)
    return status, headers, json.loads(raw), queue, served, gate.compact()
  finally:
    server.close()
    await node.stop()
    engine.executor.shutdown(wait=True)


def test_overload_is_a_429_with_retry_after(monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_MAX_INFLIGHT", "1")
  monkeypatch.setenv("XOT_ADMIT_QUEUE_DEPTH", "1")
  status, headers, body, queue, served, after = asyncio.run(_admission_429())
  assert status == 429
  assert int(headers["Retry-After"]) >= 1
  assert headers["x-ratelimit-remaining-requests"] == "0" and headers["x-ratelimit-limit-requests"] == "2"
  assert body["error"]["type"] == "rate_limit_error" and body["error"]["queue_depth"] == 1
  adm = queue["admission"]
  assert queue["enabled"] and adm["inflight"] == 1 and adm["queued"] == 1 and adm["rejected_total"] == 1
  assert served[0] == 200 and "x-ratelimit-limit-requests" in served[1]
  assert after["inflight"] == 0 and after["queued"] == 0 and after["admitted_total"] == 2


# ----------------------------------------------------------------- the ring


async def _ring_observability(tmp_path):
  ring = await Ring(tmp_path, ["node-b", "node-a"]).start()
  origin, other = ring.nodes["node-a"], ring.nodes["node-b"]
  try:
    tokens, error = await _generate(origin, "traced")
    assert error is None and tokens
    await _wait_idle(ring)
    await asyncio.sleep(float(os.environ["XOT_ANATOMY_DELAY_S"]) + 0.3)
    for node in ring.nodes.values():  # one rollup tick, as the topology cadence sends it
      await node.broadcast_opaque_status("", json.dumps(
        {"type": "node_metrics", "node_id": node.id, "metrics": node.metrics_summary()}))
    return (origin.tracer.export(), other.tracer.export(), origin.cluster_metrics_view(),
            origin.anatomy.get("traced"), origin.metrics.summary(), other.metrics.summary())
  finally:
    await ring.stop()


def test_a_ring_keeps_one_trace_and_rolls_up_both_peers(tmp_path, monkeypatch):
  monkeypatch.setenv("XOT_DTYPE", "float32")
  monkeypatch.setenv("XOT_ANATOMY_DELAY_S", "0.3")
  spans, other_spans, (nodes, aggregate), breakdown, origin_m, other_m = asyncio.run(
    _ring_observability(tmp_path))
  assert len({s["traceId"] for s in spans}) == 1
  by_node = {}
  for s in spans:
    node = next(a["value"] for a in s["attributes"] if a["key"] == "node.id")
    by_node.setdefault(node, set()).add(s["name"])
  assert set(by_node) == {"node-a", "node-b"}
  assert "process_prompt" in by_node["node-a"] and "process_prompt.forwarded" in by_node["node-b"]
  assert "process_tensor" in by_node["node-a"] and "process_tensor" in by_node["node-b"]
  ids = {s["spanId"] for s in spans}
  assert all(s["parentSpanId"] in ids for s in spans if s["name"] != "process_prompt")
  assert {s["traceId"] for s in other_spans} == {spans[0]["traceId"]}
  assert set(nodes) == {"node-a", "node-b"} and not any(n.get("stale") for n in nodes.values())
  assert aggregate["ttft_seconds"]["count"] == 1
  assert origin_m["requests"] == 1 and other_m["requests"] == 0  # counted at the origin only
  assert origin_m["tensor_hops"] > 0 and other_m["tensor_hops"] > 0
  assert breakdown is not None and any(k.startswith("hop:") for k in breakdown["stages"])
  assert math.isclose(sum(v["secs"] for v in breakdown["stages"].values()), breakdown["e2e_s"],
                      rel_tol=1e-3, abs_tol=1e-5)


# ------------------------------------------------------- KV reuse's flight events

KV_EVENTS = ("host.spill", "host.restore", "host.evict", "engine.oom_recovery",
             "batcher.prefill_slice")


async def _kv_reuse_events(eng, shard, recorder) -> dict:
  """One prefix cache entry and a host tier of one entry's bytes (set by the caller):
  A, then B while A was just active (co-scheduled: its prologue, one whole segment of
  XOT_PREFILL_CHUNK 24 and its tail; B's store spills A), an OOM recovery (spills B,
  which evicts A from the tier), then a short request C decoding while B's next turn
  restores B's two pages from the tier in its co-scheduled prologue and samples its
  tail (its store spills B again). The events' counts."""
  eng.flight = recorder
  a = np.arange(44, dtype=np.int64)[None, :] % 250 + 1
  b = (a * 3) % 250 + 1
  for rid, p in (("a", a), ("b", b)):
    await eng.infer_sample_tensor(rid, shard, p, temp=0.0, top_k=0)
  eng._free_device_memory()
  tok, _ = await eng.infer_sample_tensor("c", shard, np.array([[7, 3, 11, 2]]), temp=0.0, top_k=0)
  turn = np.concatenate([b, np.array([[5, 6, 7, 8]])], axis=1)
  await asyncio.gather(eng.generate_chunk("c", shard, int(tok), 8, temp=0.0, top_k=0),
                       eng.infer_sample_tensor("b2", shard, turn, temp=0.0, top_k=0))
  eng.executor.shutdown(wait=True)
  events = [e["event"] for e in recorder.tail()]
  return {name: events.count(name) for name in KV_EVENTS}


def test_kv_reuse_flight_events_fire_as_jax(monkeypatch):
  """The host tier's spill, restore and budget eviction, the OOM recovery and the
  co-scheduled prefill slices each fire, as many times as on the JAX engine."""
  from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
  from xotorch_tpu.inference.shard import Shard as JShard
  from xotorch_tpu_torch.inference.shard import Shard
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  # One entry is 2 pages x 16 tokens x 4 layers x 2 kv heads x 16 x 4 bytes x K,V plus
  # its 44 token ids: 33120 bytes.
  for name, value in (("XOT_DTYPE", "float32"), ("XOT_PAGED_KV", "1"), ("XOT_KV_PAGE", "16"),
                      ("XOT_KV_POOL_TOKENS", "512"), ("XOT_PREFIX_CACHE", "1"),
                      ("XOT_PREFIX_CACHE_MIN", "16"), ("XOT_PREFILL_CHUNK", "24"),
                      ("XOT_KV_HOST_BYTES", "40000")):
    monkeypatch.setenv(name, value)
  got = asyncio.run(_kv_reuse_events(TorchShardInferenceEngine(device="cpu", seed=0),
                                     Shard(MODEL, 0, 3, 4), flight.FlightRecorder("n", 256)))
  want = asyncio.run(_kv_reuse_events(JAXShardInferenceEngine(dtype="float32"),
                                      JShard(MODEL, 0, 3, 4), j_flight.FlightRecorder("n", 256)))
  assert got == want
  assert got == {"host.spill": 3, "host.restore": 1, "host.evict": 1, "engine.oom_recovery": 1,
                 "batcher.prefill_slice": 5}
