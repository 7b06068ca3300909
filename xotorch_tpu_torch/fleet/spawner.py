"""FleetSpawner: slot-template process management for the elastic fleet.

The port's copy of xotorch_tpu/fleet/spawner.py.

One spawner per router process. It can start any slot in the template and
stop any slot whose pid it knows — including processes a DIFFERENT router
spawned before dying, because every spawn writes the pid into a sidecar
JSON next to the template (atomic replace, same shared-host discipline as
the actuation lease). Liveness is NOT judged here: the router's poll loop
owns reachability; the spawner only answers "did the process I started
exit" for boot-failure attribution.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional

from xotorch_tpu_torch.utils.helpers import DEBUG


class FleetSpawner:

  def __init__(self, slots: List[Dict[str, Any]], pid_path: Optional[str] = None):
    self.slots = {s["name"]: s for s in slots}
    self.pid_path = pid_path
    self._procs: Dict[str, subprocess.Popen] = {}
    self.spawned_total = 0
    self.spawn_failures_total = 0

  # ------------------------------------------------------------ pid sidecar

  def _read_pids(self) -> Dict[str, int]:
    if not self.pid_path:
      return {}
    try:
      with open(self.pid_path) as f:
        doc = json.load(f)
      return {str(k): int(v) for k, v in doc.items()} if isinstance(doc, dict) else {}
    except (OSError, ValueError):
      return {}

  def _write_pids(self, pids: Dict[str, int]) -> None:
    if not self.pid_path:
      return
    try:
      d = os.path.dirname(self.pid_path) or "."
      os.makedirs(d, exist_ok=True)
      fd, tmp = tempfile.mkstemp(dir=d, prefix=".pids.")
      with os.fdopen(fd, "w") as f:
        f.write(json.dumps(pids))
      os.replace(tmp, self.pid_path)
    except OSError as e:
      if DEBUG >= 1:
        print(f"fleet: pid sidecar write failed: {e!r}")

  def pids(self) -> Dict[str, int]:
    """Union of our live Popen handles over the sidecar: the handover
    surface a new lease holder (and a harness's teardown) reads."""
    out = self._read_pids()
    for name, proc in self._procs.items():
      if proc.poll() is None:
        out[name] = proc.pid
    return out

  # ---------------------------------------------------------------- process

  def spawn(self, name: str) -> Optional[int]:
    """Start one slot. Returns the pid, or None when the template has no
    such slot or the exec itself failed (missing binary, bad log path) —
    a spawn that EXITS later is the boot-timeout's business, not ours."""
    slot = self.slots.get(name)
    if slot is None:
      self.spawn_failures_total += 1
      return None
    env = dict(os.environ)
    env.update({str(k): str(v) for k, v in (slot.get("env") or {}).items()})
    try:
      log_path = slot.get("log")
      logf = open(log_path, "ab") if log_path else subprocess.DEVNULL
      try:
        proc = subprocess.Popen([str(a) for a in slot["argv"]], env=env,
                                stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True)
      finally:
        if log_path:
          logf.close()
    except OSError as e:
      self.spawn_failures_total += 1
      if DEBUG >= 0:
        print(f"fleet: spawn of {name} failed: {e!r}")
      return None
    old = self._procs.get(name)
    if old is not None:
      old.poll()  # reap a previous incarnation if it already exited
    self._procs[name] = proc
    self.spawned_total += 1
    pids = self._read_pids()
    pids[name] = proc.pid
    self._write_pids(pids)
    if DEBUG >= 0:
      print(f"fleet: spawned {name} pid {proc.pid}")
    return proc.pid

  def terminate(self, name: str, sig: int = signal.SIGTERM) -> bool:
    """Signal one slot's process — ours via the Popen handle, an inherited
    one (spawned by a dead previous lease holder) via the pid sidecar.
    Returns whether a signal was delivered."""
    proc = self._procs.get(name)
    if proc is not None and proc.poll() is None:
      try:
        proc.send_signal(sig)
        return True
      except OSError:
        pass
    pid = self._read_pids().get(name)
    if pid:
      try:
        os.kill(pid, sig)
        return True
      except OSError:
        pass
    return False

  def reap(self, name: str, timeout_s: float = 5.0) -> None:
    """Wait (bounded) for one of OUR processes to exit after terminate();
    inherited pids have no handle to reap and are left to init."""
    proc = self._procs.get(name)
    if proc is None:
      return
    deadline = time.monotonic() + timeout_s
    while proc.poll() is None and time.monotonic() < deadline:
      time.sleep(0.05)
    if proc.poll() is None:
      try:
        proc.kill()
        proc.wait(timeout=2.0)
      except OSError:
        pass
    pids = self._read_pids()
    if pids.pop(name, None) is not None:
      self._write_pids(pids)

  def exited(self, name: str) -> Optional[int]:
    """Exit code of a slot WE spawned that has exited, else None (alive,
    never ours, or inherited)."""
    proc = self._procs.get(name)
    return None if proc is None else proc.poll()
