"""The front door's pure half: N independent replicas behind one endpoint.

The port's copy of xotorch_tpu/router/__init__.py. One replica (one ring, its own
discovery domain and OpenAI API) is one failure domain and one throughput ceiling; the
router (router/app.py) serves several behind one OpenAI endpoint and acts on what they
report:

- placement (`route`): a request hashes by its session or prefix key (`prefix_key`,
  rendezvous hashing) to the replica whose device cache or host tier already holds its
  prefix, and spills to the least loaded replica when that one's admission queue (its
  `/v1/queue`) is backed up;
- the lifecycle (`ReplicaLifecycle`): a firing burn-rate alert, a named suspect or a
  lost replica moves it healthy -> draining -> probing -> readmitted. Draining stops new
  admissions and lets in-flight streams finish; probing sends canary completions;
  readmission takes XOT_ROUTER_PROBES successes in a row and a minimum out-time that
  doubles while the replica flaps;
- the drift rules (`fleet_trailing_medians`, `name_drift`) and the hedge delay
  (`hedge_delay_s`) over the replicas' `/v1/history` compacts
  (orchestration/history.py's DRIFT_RULES).

All of it is state machine, hashing and placement with injected clocks: no process,
no socket, no torch.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from xotorch_tpu_torch.orchestration.history import DRIFT_RULES, median, worse_by
from xotorch_tpu_torch.utils import knobs

# Escalation cap for the flap hysteresis: a replica that keeps flapping
# waits at most 8x the base out-time between readmissions.
MAX_OUT_MULTIPLIER = 8


def fleet_trailing_medians(compacts: Iterable[dict],
                           min_n: int = 1) -> Dict[str, float]:
  """Per-metric median of the fleet's trailing history gauges. `compacts`
  are /v1/history compact dicts from the replicas a drifting one should be
  judged against (healthy + reachable only — a drained replica's polluted
  gauges must not drag the fleet's definition of normal). A peer's value
  joins the median only when it rests on at least `min_n` samples: one
  cold-start observation is not a reference."""
  by_metric: Dict[str, List[float]] = {}
  for c in compacts:
    trailing = (c or {}).get("trailing")
    if not isinstance(trailing, dict):
      continue
    counts = (c or {}).get("trailing_n")
    for metric, v in trailing.items():
      # A compact without counts (older peer) reports unknown depth = 1.
      n = int(counts.get(metric) or 0) if isinstance(counts, dict) else 1
      if n >= min_n:
        by_metric.setdefault(metric, []).append(float(v))
  out = {}
  for metric, vals in by_metric.items():
    m = median(vals)
    if m is not None:
      out[metric] = m
  return out


def name_drift(own: Optional[dict], peer_medians: Dict[str, float],
               ratio: float, min_n: int = 1) -> Optional[dict]:
  """The differential-drift verdict for one replica: its worst watched
  DIFFERENTIAL gauge deviating (direction-aware, past the rule's absolute
  floor) from the PEER median by at least `ratio`, or None when it tracks
  the fleet. Volume-coupled gauges (tok/s, jit-miss, fetch bytes) are
  excluded: they diverge whenever load is uneven — which the router's own
  drains and spills cause — so comparing them across replicas is a
  feedback loop, and a deviation resting on fewer than `min_n` samples
  (a cold-start compile's lone TTFT) is not chronic evidence. Pure — the
  router's poll loop feeds it compacts and debounces the result over
  consecutive polls."""
  trailing = (own or {}).get("trailing")
  if not isinstance(trailing, dict):
    return None
  counts = (own or {}).get("trailing_n")
  worst = None
  for rule in DRIFT_RULES:
    if not rule.differential:
      continue
    v = trailing.get(rule.metric)
    ref = peer_medians.get(rule.metric)
    # A compact without counts (older peer) reports unknown depth = 1.
    n = int(counts.get(rule.metric) or 0) if isinstance(counts, dict) else 1
    if v is None or ref is None or n < min_n:
      continue
    dev = worse_by(float(v), float(ref), rule.worse)
    if dev < ratio or abs(float(v) - float(ref)) < rule.floor:
      continue
    if worst is None or dev > worst["worse_by"]:
      worst = {"metric": rule.metric, "value": round(float(v), 6),
               "peer_median": round(float(ref), 6), "worse_by": round(dev, 4)}
  return worst


def hedge_delay_s(compacts: Iterable[dict], factor: float, min_s: float) -> float:
  """The hedge trigger delay: `factor` x the fleet's trailing p99 request
  latency (median across the routable replicas' /v1/history compacts — a
  single slow replica must not inflate the delay that exists to route
  around it), floored at `min_s`. Falls back to the p50 when no replica
  has served enough traffic for a p99, and to the bare floor on a cold
  fleet — hedging never waits on data that does not exist."""
  p99s, p50s = [], []
  for c in compacts:
    trailing = (c or {}).get("trailing")
    if not isinstance(trailing, dict):
      continue
    if trailing.get("request_p99_s") is not None:
      p99s.append(float(trailing["request_p99_s"]))
    if trailing.get("request_p50_s") is not None:
      p50s.append(float(trailing["request_p50_s"]))
  m = median(p99s)
  if m is None:
    m = median(p50s)
  return max(min_s, factor * m) if m is not None else max(0.0, min_s)


def prefix_key(body: dict) -> str:
  """Stable session/prefix affinity key for an OpenAI chat body: the first
  user message's leading characters — exactly the shared session head a
  returning chat user re-sends verbatim, so session traffic rendezvous-hashes
  to the replica whose device cache or host tier already holds the prefix. An explicit `user` field (the
  OpenAI end-user id) wins when present: it is the stronger session
  signal and survives prompt edits."""
  user = body.get("user")
  if isinstance(user, str) and user:
    return f"user:{user}"
  for m in body.get("messages") or []:
    if not isinstance(m, dict) or m.get("role") != "user":
      continue
    content = m.get("content")
    if isinstance(content, list):  # multi-part: concatenate the text parts
      content = " ".join(p.get("text", "") for p in content
                         if isinstance(p, dict) and p.get("type") == "text")
    return str(content or "")[:160]
  return ""


def rendezvous(key: str, names: Sequence[str]) -> Optional[str]:
  """Highest-random-weight (rendezvous) choice: every router instance maps
  the same key to the same replica with no shared state, and removing a
  replica only remaps the keys that lived on it."""
  best, best_score = None, None
  for name in names:
    score = hashlib.sha1(f"{key}|{name}".encode()).digest()
    if best_score is None or score > best_score:
      best, best_score = name, score
  return best


def least_loaded(views: List[dict]) -> Optional[dict]:
  """The lightest replica view by (admission queue depth, estimated wait,
  name) — ONE definition of "least loaded", shared by route()'s spill and
  the router's 429 retry so placement and retry can never disagree."""
  if not views:
    return None
  return min(views, key=lambda v: (int(v.get("queued") or 0),
                                   float(v.get("est_wait_s") or 0.0),
                                   str(v["name"])))


def route(key: str, views: List[dict], spill_depth: int) -> Optional[Tuple[str, bool]]:
  """Pick a replica for one request. `views` are the ROUTABLE replicas'
  load compacts: {name, queued, est_wait_s} (from each replica's
  /v1/queue poll). Affinity first — rendezvous on the prefix key — then
  queue-depth-aware spill: when the affinity target's admission queue is
  at least `spill_depth` deep and another replica is strictly less
  loaded, the request goes to the least-loaded one instead (warm prefix
  lost, but a queue wait is lost time for certain). Returns
  (replica_name, spilled) or None when nothing is routable."""
  if not views:
    return None
  by_name = {str(v["name"]): v for v in views}
  pick = rendezvous(key, sorted(by_name))
  if spill_depth > 0:
    target_q = int(by_name[pick].get("queued") or 0)
    if target_q >= spill_depth:
      least = least_loaded(views)
      if str(least["name"]) != pick and int(least.get("queued") or 0) < target_q:
        return str(least["name"]), True
  return pick, False


class ReplicaLifecycle:
  """healthy -> draining -> probing -> readmitted (healthy), per replica.

  Pure and clock-injected: `note_status` consumes one poll observation
  (firing alert count, named suspect, inflight requests, reachability) and
  `note_probe` one canary outcome; both return a transition dict (what the
  router records as a flight event) or None. Only `healthy` replicas are
  routable — draining/probing replicas accept no new traffic, which is
  what lets their inflight streams finish undisturbed."""

  def __init__(self, name: str, probes_required: Optional[int] = None,
               min_out_s: Optional[float] = None,
               flap_window_s: Optional[float] = None):
    self.name = name
    self.probes_required = (probes_required if probes_required is not None
                            else max(1, knobs.get_int("XOT_ROUTER_PROBES")))
    self.min_out_s = (min_out_s if min_out_s is not None
                      else max(0.0, knobs.get_float("XOT_ROUTER_MIN_OUT_S")))
    self.flap_window_s = (flap_window_s if flap_window_s is not None
                          else max(0.0, knobs.get_float("XOT_ROUTER_FLAP_S")))
    self.state = "healthy"
    self.drained_at: Optional[float] = None
    self.drain_reason: Optional[str] = None
    self.readmitted_at: Optional[float] = None
    self.out_multiplier = 1
    self.probe_successes = 0
    self.drains_total = 0
    self.readmits_total = 0
    self.probe_failures_total = 0
    # A replica that has NEVER answered a poll is JOINING (booting, port
    # not bound yet), not failing: unreachability only drains once the
    # replica has been seen alive — otherwise every boot would burn a
    # drain/probe/readmit cycle and pollute the lifecycle counters.
    self.ever_reachable = False

  @property
  def routable(self) -> bool:
    return self.state == "healthy"

  def required_out_s(self) -> float:
    """Current minimum out-time: the flap-escalated hysteresis floor."""
    return self.min_out_s * self.out_multiplier

  def _transition(self, to: str, now: float, reason: str = "") -> dict:
    self.state = to
    return {"replica": self.name, "transition": to, "at": now, "reason": reason}

  def note_status(self, now: float, firing: int = 0, suspect: Optional[str] = None,
                  inflight: int = 0, reachable: bool = True) -> Optional[dict]:
    """One poll observation. Transitions:
    - healthy -> draining on a firing alert, a named suspect, or an
      unreachable replica (flap escalation applies when the drain lands
      inside the flap window of the last readmission);
    - draining -> probing once the replica is reachable, its inflight
      count has drained to zero, and the ACCUSATION has cleared — the
      firing alert resolved AND no suspect (gray localization or
      perf_drift) is still named. Probing while the cause persists sends
      canaries INTO the fault: they pollute the replica's latency
      histograms with traffic no client sees and can readmit a replica
      whose rot merely paused;
    - probing -> draining when the burn re-fires mid-probe.
    A never-yet-reachable replica (still booting) takes no transition:
    it is not routable anyway, and draining it would burn a
    probe/readmit cycle on every boot."""
    if reachable:
      self.ever_reachable = True
    elif not self.ever_reachable:
      return None
    bad = bool(firing) or bool(suspect) or not reachable
    if self.state == "healthy":
      if not bad:
        return None
      if (self.readmitted_at is not None and self.flap_window_s > 0
          and now - self.readmitted_at < self.flap_window_s):
        self.out_multiplier = min(MAX_OUT_MULTIPLIER, self.out_multiplier * 2)
      else:
        self.out_multiplier = 1
      self.drained_at = now
      self.probe_successes = 0
      self.drains_total += 1
      why = ("unreachable" if not reachable
             else f"suspect:{suspect}" if suspect else f"alerts_firing:{firing}")
      self.drain_reason = why
      return self._transition("draining", now, why)
    if self.state == "draining":
      if reachable and inflight <= 0 and not firing and not suspect:
        return self._transition("probing", now, "drained")
      return None
    if self.state == "probing" and bad:
      # The accusation came back mid-probe (burn re-fired, suspect
      # re-named, or the replica vanished): a full re-drain, not a pause —
      # the minimum out-time restarts from NOW (otherwise the original
      # drain's clock would let a replica whose alert merely dips readmit
      # seconds after each dip, the oscillation the hysteresis exists to
      # prevent). Without the suspect arm, note_probe could readmit a
      # still-accused replica and the next poll would instantly re-drain
      # it with flap escalation.
      self.probe_successes = 0
      self.drained_at = now
      self.drains_total += 1
      why = ("alert re-fired" if firing
             else f"suspect:{suspect}" if suspect else "unreachable")
      self.drain_reason = why
      return self._transition("draining", now, why)
    return None

  def note_probe(self, ok: bool, now: float) -> Optional[dict]:
    """One synthetic canary outcome (probing state only). Readmission takes
    `probes_required` CONSECUTIVE successes and at least the (flap-
    escalated) minimum out-time since the drain; any failure resets the
    streak — a replica that can't serve a 2-token canary stays out."""
    if self.state != "probing":
      return None
    if not ok:
      self.probe_failures_total += 1
      self.probe_successes = 0
      return None
    self.probe_successes += 1
    out_for = now - (self.drained_at if self.drained_at is not None else now)
    if self.probe_successes >= self.probes_required and out_for >= self.required_out_s():
      self.readmitted_at = now
      self.readmits_total += 1
      self.drain_reason = None
      return self._transition("healthy", now, "readmitted")
    return None

  def snapshot(self) -> dict:
    """JSON row for /v1/router."""
    return {
      "name": self.name, "state": self.state,
      "drain_reason": self.drain_reason,
      "drained_at": self.drained_at, "readmitted_at": self.readmitted_at,
      "out_multiplier": self.out_multiplier,
      "probe_successes": self.probe_successes,
      "drains_total": self.drains_total, "readmits_total": self.readmits_total,
      "probe_failures_total": self.probe_failures_total,
    }


def replica_names(urls: Iterable[str]) -> Dict[str, str]:
  """Stable short names for replica base URLs: r0, r1, ... in the order
  given (the CLI's --replica order), so logs and /v1/router rows agree on
  identity without parsing URLs."""
  return {f"r{i}": url.rstrip("/") for i, url in enumerate(urls)}
