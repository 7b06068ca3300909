"""FleetController: one actuation tick per router poll.

The port's copy of xotorch_tpu/fleet/controller.py.

The controller rides the router's poll loop (it has no clock of its own)
and consumes only what the poll loop already observed: per-replica
reachability, the unified unreachable/scrape-failure streak, admission
compacts (`queued_hwm`, the trailing high-water mark), and lifecycle
state. Every tick:

1. **Lease**: renew/acquire the actuation lease. A non-holder router
   observes and routes but actuates nothing — and resets its own
   debounce counters so a takeover starts from fresh evidence, not from
   pressure it watched while powerless to act.
2. **Adoption**: a latent slot that is REACHABLE was spawned by a
   previous lease holder — adopt it as a controller-scaled spare so this
   holder can retire it later.
3. **Warm-up completion**: a spawned slot that has come up gets the
   PRESERVE-style prefix pre-announce (the router posts its recent
   prompt prefixes to `/v1/prefetch`, which chains into the host tier's
   restore and the KV fabric's fetch) and only THEN clears `warming` — the replica enters
   rotation with its host tier already filling. A slot that misses its
   boot deadline is a counted respawn failure.
4. **Dead detection + respawn**: a desired-active, ever-reachable slot
   whose down-streak (unreachable OR repeated scrape failure — one
   signal, per the observation-loss-is-liveness-loss rule) reaches
   `XOT_FLEET_DEAD_POLLS` is declared dead, killed for certain, and
   respawned into the warm path. Respawns are exempt from the scale
   cooldown: restoring capacity is never rate-limited.
5. **Scale-up**: when EVERY routable replica's trailing queue high-water
   mark sits at `XOT_FLEET_UP_QUEUE`+ for `XOT_FLEET_UP_POLLS`
   consecutive ticks (spill already balances a lopsided fleet; only
   fleet-wide pressure justifies capacity), spawn the next latent slot.
6. **Scale-down**: only controller-scaled spares, only after
   `XOT_FLEET_IDLE_POLLS` idle ticks, and only through the drain
   discipline — `retiring` removes the slot from rotation, in-flight
   work finishes, and the process is terminated at zero inflight. The
   slot's lifecycle is reset to latent-boot semantics (the process is
   intentionally gone; mourning it as "unreachable" would burn a
   drain/probe cycle on a planned exit).
"""
from __future__ import annotations

import signal
import time
from typing import Any, Dict, List, Optional

from xotorch_tpu_torch.fleet import FleetLease, load_template
from xotorch_tpu_torch.fleet.spawner import FleetSpawner
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG


class FleetController:

  def __init__(self, router, template_path: str, router_id: str):
    self.router = router
    self.router_id = router_id
    self.template_path = template_path
    slots = load_template(template_path)
    self.slot_names = [s["name"] for s in slots]
    pid_path = template_path + ".pids"
    self.spawner = FleetSpawner(slots, pid_path=pid_path)
    lease_path = knobs.get_str("XOT_FLEET_LEASE_PATH")
    self.lease = FleetLease(lease_path, router_id,
                            knobs.get_float("XOT_FLEET_LEASE_TTL_S"))
    self.min_replicas = max(1, knobs.get_int("XOT_FLEET_MIN"))
    raw_max = knobs.get_int("XOT_FLEET_MAX")
    self.max_replicas = raw_max if raw_max > 0 else len(slots)
    self.up_queue = max(1, knobs.get_int("XOT_FLEET_UP_QUEUE"))
    self.up_polls = max(1, knobs.get_int("XOT_FLEET_UP_POLLS"))
    self.idle_polls = max(1, knobs.get_int("XOT_FLEET_IDLE_POLLS"))
    self.dead_polls = max(1, knobs.get_int("XOT_FLEET_DEAD_POLLS"))
    self.cooldown_s = max(0.0, knobs.get_float("XOT_FLEET_COOLDOWN_S"))
    self.boot_timeout_s = max(1.0, knobs.get_float("XOT_FLEET_BOOT_TIMEOUT_S"))
    self.warm_prefixes = max(0, knobs.get_int("XOT_FLEET_WARM_PREFIXES"))
    # Desired world: which slots SHOULD be running. Seeded from the
    # template's `active` flags; actuation mutates it.
    self.desired: Dict[str, bool] = {s["name"]: bool(s.get("active")) for s in slots}
    self.scaled: set = set()          # controller-added spares (retire-eligible)
    self._warm_deadline: Dict[str, float] = {}   # name -> monotonic boot deadline
    self._idle_ticks: Dict[str, int] = {}
    self._up_ticks = 0
    self._last_scale_mono: Optional[float] = None
    self.spawns_total = 0
    self.respawns_total = 0
    self.respawn_failures_total = 0
    self.deaths_total = 0
    self.scale_ups_total = 0
    self.scale_downs_total = 0
    self.retires_total = 0
    self.adopted_total = 0

  # ------------------------------------------------------------------- tick

  def tick(self, now: float) -> None:
    """One controller pass; `now` is the router's monotonic poll stamp.
    Never raises — the poll loop that hosts us must survive anything."""
    try:
      self._tick(now)
    except Exception as e:
      if DEBUG >= 1:
        print(f"fleet[{self.router_id}]: tick failed: {e!r}")

  def _tick(self, now: float) -> None:
    flight = self.router.flight
    was_held = self.lease.held
    held = self.lease.try_acquire()
    if held and not was_held:
      flight.record("lease.acquired", None, holder=self.router_id,
                    path=self.lease.path)
      if DEBUG >= 0:
        print(f"fleet[{self.router_id}]: lease acquired")
    elif was_held and not held:
      flight.record("lease.lost", None, holder=self.router_id,
                    now_held_by=(self.lease.peek() or {}).get("holder"))
      if DEBUG >= 0:
        print(f"fleet[{self.router_id}]: lease lost")
    if not held:
      # Observe-only: debounces restart from scratch if we later acquire,
      # so a takeover acts on pressure IT confirmed, not inherited counts.
      self._up_ticks = 0
      self._idle_ticks.clear()
      return
    self._adopt(now)
    self._warmups(now)
    self._respawn_dead(now)
    self._scale_up(now)
    self._scale_down(now)

  # ------------------------------------------------------------ tick stages

  def _rep(self, name: str):
    return self.router.replicas.get(name)

  def _adopt(self, now: float) -> None:
    """A reachable slot we believe latent was spawned by a previous lease
    holder: adopt it as desired + controller-scaled so it can be retired
    when pressure subsides."""
    for name in self.slot_names:
      rep = self._rep(name)
      if rep is None or self.desired.get(name) or not rep.reachable:
        continue
      self.desired[name] = True
      self.scaled.add(name)
      self.adopted_total += 1
      if DEBUG >= 0:
        print(f"fleet[{self.router_id}]: adopted running slot {name}")

  def _spawn(self, name: str, respawn: bool, now: float) -> bool:
    """Start one slot into the warm path: `warming` keeps it out of
    rotation until the boot + pre-announce completes."""
    rep = self._rep(name)
    if rep is None:
      return False
    rep.warming = True
    rep.retiring = False
    pid = self.spawner.spawn(name)
    if pid is None:
      rep.warming = False
      if respawn:
        self.respawn_failures_total += 1
      return False
    self.desired[name] = True
    self._warm_deadline[name] = now + self.boot_timeout_s
    rep.down_streak = 0  # the streak now judges the NEW process
    if respawn:
      self.router.flight.record("fleet.respawn", None, slot=name, pid=pid,
                                holder=self.router_id)
      self.respawns_total += 1
    else:
      self.router.flight.record("fleet.spawn", None, slot=name, pid=pid,
                                holder=self.router_id)
      self.spawns_total += 1
    return True

  def _warmups(self, now: float) -> None:
    for name in list(self._warm_deadline):
      rep = self._rep(name)
      if rep is None:
        del self._warm_deadline[name]
        continue
      if rep.reachable:
        # Booted: fire the prefix pre-announce; the router clears
        # `warming` (-> eligible for rotation) once the posts settle.
        del self._warm_deadline[name]
        self.router.spawn_warm_announce(rep, self.warm_prefixes)
      elif now >= self._warm_deadline[name]:
        del self._warm_deadline[name]
        rep.warming = False
        self.respawn_failures_total += 1
        if DEBUG >= 0:
          print(f"fleet[{self.router_id}]: slot {name} missed its "
                f"{self.boot_timeout_s:.0f}s boot deadline")
        if name in self.scaled and not rep.lifecycle.ever_reachable:
          # A scale-up that never came alive: give the slot back. The
          # next sustained surge retries it. Crash respawns stay desired
          # — the dead-detector will try again after a fresh streak.
          self.desired[name] = False
          self.scaled.discard(name)

  def _respawn_dead(self, now: float) -> None:
    for name in self.slot_names:
      rep = self._rep(name)
      if (rep is None or not self.desired.get(name) or rep.retiring
          or name in self._warm_deadline):
        continue
      if not rep.lifecycle.ever_reachable or rep.down_streak < self.dead_polls:
        continue
      self.deaths_total += 1
      self.router.flight.record("fleet.dead", None, slot=name,
                                down_streak=rep.down_streak,
                                scrape_failures=rep.scrape_failures_total)
      if DEBUG >= 0:
        print(f"fleet[{self.router_id}]: slot {name} declared dead "
              f"(streak {rep.down_streak}) — respawning")
      # Kill for certain first: a zombie that still holds the port (alive
      # but unscrapable — the observation-loss case) would beat the
      # respawn to the bind.
      self.spawner.terminate(name, signal.SIGKILL)
      self.spawner.reap(name, timeout_s=2.0)
      self._spawn(name, respawn=True, now=now)

  def _scale_up(self, now: float) -> None:
    routable = self.router.routable()
    hwms = []
    for rep in routable:
      q = rep.queue or {}
      hwms.append(int(q.get("queued_hwm") or q.get("queued") or 0))
    pressed = bool(hwms) and min(hwms) >= self.up_queue
    self._up_ticks = self._up_ticks + 1 if pressed else 0
    if self._up_ticks < self.up_polls:
      return
    if sum(1 for v in self.desired.values() if v) >= self.max_replicas:
      return
    if (self._last_scale_mono is not None
        and now - self._last_scale_mono < self.cooldown_s):
      return
    latent = next((n for n in self.slot_names if not self.desired.get(n)), None)
    if latent is None:
      return
    if self._spawn(latent, respawn=False, now=now):
      self.scaled.add(latent)
      self.scale_ups_total += 1
      self._last_scale_mono = now
      self._up_ticks = 0
      if DEBUG >= 0:
        print(f"fleet[{self.router_id}]: scale-up -> {latent} "
              f"(fleet hwm floor {min(hwms)})")

  def _scale_down(self, now: float) -> None:
    active = sum(1 for v in self.desired.values() if v)
    for name in sorted(self.scaled):
      rep = self._rep(name)
      if rep is None or not self.desired.get(name) or name in self._warm_deadline:
        continue
      if rep.retiring:
        if rep.active_requests <= 0 and int((rep.queue or {}).get("queued") or 0) <= 0:
          self._finish_retire(name, rep)
          active -= 1
        continue
      q = rep.queue or {}
      idle = (rep.reachable and rep.active_requests <= 0
              and int(q.get("queued_hwm") or q.get("queued") or 0) <= 0)
      self._idle_ticks[name] = self._idle_ticks.get(name, 0) + 1 if idle else 0
      if self._idle_ticks[name] < self.idle_polls or active <= self.min_replicas:
        continue
      if (self._last_scale_mono is not None
          and now - self._last_scale_mono < self.cooldown_s):
        continue
      rep.retiring = True
      self._last_scale_mono = now
      self.retires_total += 1
      self.router.flight.record("fleet.retire", None, slot=name,
                                idle_ticks=self._idle_ticks[name])
      if DEBUG >= 0:
        print(f"fleet[{self.router_id}]: retiring idle spare {name}")

  def _finish_retire(self, name: str, rep) -> None:
    """Inflight has drained: stop the process and return the slot to
    latent. Lifecycle resets to boot semantics — a PLANNED exit must not
    register as an unreachable drain."""
    self.spawner.terminate(name, signal.SIGTERM)
    self.spawner.reap(name, timeout_s=10.0)
    self.desired[name] = False
    self.scaled.discard(name)
    self._idle_ticks.pop(name, None)
    rep.retiring = False
    rep.warming = False
    rep.reachable = False
    rep.queue = None
    rep.down_streak = 0
    rep.lifecycle = type(rep.lifecycle)(name)
    self.scale_downs_total += 1
    if DEBUG >= 0:
      print(f"fleet[{self.router_id}]: slot {name} retired (latent again)")

  # ----------------------------------------------------------------- export

  def status(self) -> dict:
    return {
      "router_id": self.router_id,
      "template": self.template_path,
      "lease": self.lease.status(),
      "desired": dict(self.desired),
      "scaled": sorted(self.scaled),
      "warming": sorted(self._warm_deadline),
      "pids": self.spawner.pids(),
      "limits": {"min": self.min_replicas, "max": self.max_replicas,
                 "up_queue": self.up_queue, "up_polls": self.up_polls,
                 "idle_polls": self.idle_polls, "dead_polls": self.dead_polls,
                 "cooldown_s": self.cooldown_s,
                 "boot_timeout_s": self.boot_timeout_s},
      "spawns_total": self.spawns_total,
      "respawns_total": self.respawns_total,
      "respawn_failures_total": self.respawn_failures_total,
      "deaths_total": self.deaths_total,
      "scale_ups_total": self.scale_ups_total,
      "scale_downs_total": self.scale_downs_total,
      "retires_total": self.retires_total,
      "adopted_total": self.adopted_total,
      "spawn_failures_total": self.spawner.spawn_failures_total,
    }
