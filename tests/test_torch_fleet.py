"""The port's elastic fleet (xotorch_tpu_torch/fleet) against the JAX package's, on the CPU.

The template validator and the file TTL lease take the same inputs to the same answers.
JAX's controller scenarios (tests/test_fleet.py: a dead replica respawned into the warm
path, scale-up debounce and the boot-timeout revert, fleet-wide pressure only, adoption
after a lease handover, an idle spare retired through the drain, a non-holder that
observes and never acts, a tick that never raises) run through both packages'
FleetController over a fake router (a replica table, a flight recorder, the warm
announce hook) and a fake spawner; after every tick the actuations (spawns, signals,
reaps), the warm announces, the flight events, each replica's gates and the status
report are equal. The port's spawner starts a real process with the slot's argv, env
and log, writes its pid to the sidecar, signals and reaps it.
"""
import json
import signal
import sys

import pytest

import xotorch_tpu.fleet as j_fleet
import xotorch_tpu.fleet.controller as j_controller
import xotorch_tpu.router.app as j_app
from xotorch_tpu.orchestration.flight import FlightRecorder as JFlight
import xotorch_tpu_torch.fleet as p_fleet
import xotorch_tpu_torch.fleet.controller as p_controller
import xotorch_tpu_torch.router.app as p_app
from xotorch_tpu_torch.fleet.spawner import FleetSpawner
from xotorch_tpu_torch.orchestration.flight import FlightRecorder as PFlight

PACKAGES = {"port": (p_fleet, p_controller, p_app, PFlight),
            "jax": (j_fleet, j_controller, j_app, JFlight)}


def _template(path, slots):
  path.write_text(json.dumps({"slots": slots}))
  return str(path)


def _slot(name, active=False):
  return {"name": name, "url": f"http://127.0.0.1:1{name[1:]}", "active": active,
          "argv": ["/bin/true"]}


def test_load_template_matches_jax(tmp_path):
  good = _template(tmp_path / "good.json", [_slot("r0", active=True), _slot("r1")])
  assert p_fleet.load_template(good) == j_fleet.load_template(good)
  for i, bad in enumerate(([], [{"name": "r0"}], [_slot("r0"), _slot("r0")],
                           [{"name": "r0", "url": "http://x"}])):
    path = _template(tmp_path / f"bad{i}.json", bad)
    for pkg in (p_fleet, j_fleet):
      with pytest.raises(ValueError):
        pkg.load_template(path)


def test_lease_protocol_matches_jax(tmp_path):
  """Acquire, renew, expiry, takeover, loss and release: each call's answer and the
  holders' counters equal, each package on its own lease file."""
  outs = {}
  for name, (fleet, *_) in PACKAGES.items():
    path = str(tmp_path / f"{name}.lease")
    a, b = fleet.FleetLease(path, "router-a", ttl_s=10.0), fleet.FleetLease(path, "router-b", ttl_s=10.0)
    trace = [a.try_acquire(now=0.0), b.try_acquire(now=1.0), a.try_acquire(now=8.0),
             b.try_acquire(now=12.0), b.try_acquire(now=18.5), a.try_acquire(now=19.0)]
    b.release()
    trace += [b.held, a.try_acquire(now=19.5), a.acquired_total, a.lost_total, b.acquired_total,
              {k: v for k, v in a.peek().items() if k != "at"}]
    solo = fleet.FleetLease(None, "router", ttl_s=5.0)
    trace += [solo.held, solo.try_acquire(), solo.peek(), solo.status()["mode"]]
    outs[name] = trace
  assert outs["port"] == outs["jax"]
  assert outs["port"][:6] == [True, False, True, False, True, False]


class _FakeRouter:
  def __init__(self, app, flight_cls, names):
    self.replicas = {n: app._Replica(n, f"http://127.0.0.1:1{n[1:]}") for n in names}
    self.flight = flight_cls(node_id="fake-router")
    self.warm_calls = []

  def routable(self):
    return [r for r in self.replicas.values()
            if r.lifecycle.routable and r.reachable and not r.warming and not r.retiring]

  def spawn_warm_announce(self, rep, n):
    self.warm_calls.append((rep.name, n))
    rep.warming = False


def _controller(pkg, tmp_path, monkeypatch, slots, env):
  fleet, controller, app, flight_cls = PACKAGES[pkg]
  defaults = {"XOT_FLEET_UP_POLLS": "2", "XOT_FLEET_UP_QUEUE": "1", "XOT_FLEET_IDLE_POLLS": "2",
              "XOT_FLEET_DEAD_POLLS": "3", "XOT_FLEET_COOLDOWN_S": "0",
              "XOT_FLEET_BOOT_TIMEOUT_S": "30", **env}
  for k, v in defaults.items():
    monkeypatch.setenv(k, str(v))
  d = tmp_path / pkg
  d.mkdir(exist_ok=True)
  router = _FakeRouter(app, flight_cls, [s["name"] for s in slots])
  ctl = controller.FleetController(router, _template(d / "fleet.json", slots), "router-test")
  acts = []
  ctl.spawner.spawn = lambda name: acts.append(("spawn", name)) or 40000 + int(name[1:])
  ctl.spawner.terminate = lambda name, sig=None: acts.append(("terminate", name, int(sig))) or True
  ctl.spawner.reap = lambda name, timeout_s=0: acts.append(("reap", name, timeout_s))
  return ctl, router, acts


def _alive(rep, queued=0, hwm=None, active=0):
  rep.lifecycle.note_status(0.0, reachable=True)
  rep.reachable = True
  rep.queue = {"queued": queued, "queued_hwm": hwm if hwm is not None else queued, "est_wait_s": 0.0}
  rep.active_requests = active


def _state(ctl, router, acts):
  status = {k: v for k, v in ctl.status().items() if k not in ("template", "lease", "pids")}
  reps = {n: (r.warming, r.retiring, r.reachable, r.down_streak, r.lifecycle.state,
              r.lifecycle.drains_total) for n, r in router.replicas.items()}
  events = [(e["event"], e.get("slot")) for e in router.flight.tail(0)]
  return (list(acts), list(router.warm_calls), events, reps, status, sorted(ctl._warm_deadline),
          ctl._up_ticks, dict(ctl._idle_ticks))


def _respawn(ctl, router, step):
  r0, r1 = router.replicas["r0"], router.replicas["r1"]
  _alive(r0)
  _alive(r1)
  r1.reachable = False
  r1.down_streak = 2
  step(10.0)  # below the streak threshold
  r1.down_streak = 3
  step(11.0)  # dead: killed, respawned, warming
  r1.reachable = True
  step(12.0)  # booted: the warm announce, back in rotation
  step(13.0)


def _scale_up_revert(ctl, router, step):
  _alive(router.replicas["r0"], queued=2, hwm=2)
  step(1.0)
  step(2.0)  # the second pressed poll: scale-up
  step(8.0)  # past the 5 s boot deadline: given back


def _pressure_not_fleet_wide(ctl, router, step):
  _alive(router.replicas["r0"], queued=5, hwm=5)
  _alive(router.replicas["r1"], queued=0, hwm=0)
  for now in (1.0, 2.0, 3.0):
    step(now)


def _adopt(ctl, router, step):
  _alive(router.replicas["r0"])
  _alive(router.replicas["r1"])
  step(1.0)


def _retire(ctl, router, step):
  r0, r1 = router.replicas["r0"], router.replicas["r1"]
  _alive(r0)
  _alive(r1)
  step(1.0)  # adopted as a spare
  r1.active_requests = 1
  step(2.0)  # busy
  r1.active_requests = 0
  step(3.0)
  step(4.0)  # retiring: out of rotation
  step(5.0)  # drained: stopped, latent again


def _non_holder(ctl, router, step):
  r0 = router.replicas["r0"]
  _alive(r0, queued=5, hwm=5)
  r0.reachable = False
  r0.down_streak = 99
  for now in (1.0, 2.0, 3.0, 4.0):
    step(now)


def _never_raises(ctl, router, step):
  ctl._adopt = None
  step(1.0)


SCENARIOS = {
  "respawn_dead": ([_slot("r0", True), _slot("r1", True)], {}, _respawn),
  "scale_up_debounce_and_revert": ([_slot("r0", True), _slot("r1")],
                                   {"XOT_FLEET_BOOT_TIMEOUT_S": "5"}, _scale_up_revert),
  "scale_up_needs_fleet_wide_pressure": ([_slot("r0", True), _slot("r1", True), _slot("r2")], {},
                                         _pressure_not_fleet_wide),
  "adopt_after_handover": ([_slot("r0", True), _slot("r1")], {}, _adopt),
  "retire_idle_spare": ([_slot("r0", True), _slot("r1")], {}, _retire),
  "non_holder_never_acts": ([_slot("r0", True), _slot("r1")], {"lease": True}, _non_holder),
  "tick_never_raises": ([_slot("r0", True)], {}, _never_raises),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controller_scenarios_match_jax(scenario, tmp_path, monkeypatch):
  slots, env, drive = SCENARIOS[scenario]
  env = dict(env)
  if env.pop("lease", False):
    lease = tmp_path / "lease.json"
    j_fleet.FleetLease(str(lease), "other-router", ttl_s=3600.0).try_acquire()
    env["XOT_FLEET_LEASE_PATH"] = str(lease)
  traces = {}
  for pkg in PACKAGES:
    ctl, router, acts = _controller(pkg, tmp_path, monkeypatch, slots, env)
    trace = []

    def step(now):
      ctl.tick(now)
      trace.append(_state(ctl, router, acts))
    drive(ctl, router, step)
    traces[pkg] = trace
  assert traces["port"] == traces["jax"]
  final = traces["port"][-1]
  if scenario == "respawn_dead":
    assert ("terminate", "r1", int(signal.SIGKILL)) in final[0] and ("spawn", "r1") in final[0]
    assert final[1] == [("r1", 4)]
  if scenario == "non_holder_never_acts":
    assert final[0] == []


def test_spawner_runs_a_slot_and_keeps_its_pid(tmp_path):
  """A slot's argv runs with its env, its output in its log; the pid reaches the sidecar
  and leaves it when the process is reaped."""
  log = tmp_path / "r0.log"
  slots = [{"name": "r0", "url": "http://127.0.0.1:1", "active": True, "log": str(log),
            "env": {"FLEET_SLOT_WORD": "hello"},
            "argv": [sys.executable, "-c",
                     "import os, time; print(os.environ['FLEET_SLOT_WORD'], flush=True); "
                     "time.sleep(60)"]}]
  sidecar = tmp_path / "fleet.json.pids"
  sp = FleetSpawner(slots, pid_path=str(sidecar))
  pid = sp.spawn("r0")
  assert pid and json.loads(sidecar.read_text()) == {"r0": pid} and sp.pids() == {"r0": pid}
  assert sp.spawn("missing") is None and sp.spawn_failures_total == 1
  for _ in range(200):
    if log.exists() and "hello" in log.read_text():
      break
    import time
    time.sleep(0.02)
  assert "hello" in log.read_text()
  assert sp.exited("r0") is None
  assert sp.terminate("r0", signal.SIGTERM)
  sp.reap("r0", timeout_s=10.0)
  assert sp.exited("r0") == -signal.SIGTERM
  assert json.loads(sidecar.read_text()) == {}
