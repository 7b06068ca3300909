"""Debug levels, async pub/sub, detached tasks, ports and network interfaces.

The port's copy of the parts of xotorch_tpu/utils/helpers.py that its Node, API and
discovery use: `DEBUG`, `DEBUG_DISCOVERY`, `AsyncCallbackSystem`, `spawn_detached`,
`find_available_port`, `get_all_ip_addresses_and_interfaces` and
`get_interface_priority_and_type`.
"""
from __future__ import annotations

import asyncio
import contextlib
import os
import random
import socket
import sys
import tempfile
from typing import Callable, Dict, Generic, List, Optional, Tuple, TypeVar

DEBUG = int(os.getenv("DEBUG", "0"))
DEBUG_DISCOVERY = int(os.getenv("DEBUG_DISCOVERY", "0"))

T = TypeVar("T")
K = TypeVar("K")


class AsyncCallback(Generic[T]):
  """A single awaitable event stream: observers plus a predicate-gated wait."""

  def __init__(self) -> None:
    self.condition: asyncio.Condition = asyncio.Condition()
    self.result: Optional[Tuple[T, ...]] = None
    self.observers: List[Callable[..., None]] = []

  async def wait(self, check_condition: Callable[..., bool], timeout: Optional[float] = None) -> Tuple[T, ...]:
    async with self.condition:
      await asyncio.wait_for(
        self.condition.wait_for(lambda: self.result is not None and check_condition(*self.result)),
        timeout,
      )
      assert self.result is not None
      return self.result

  def on_next(self, callback: Callable[..., None]) -> None:
    self.observers.append(callback)

  def set(self, *args: T) -> None:
    self.result = args
    for observer in self.observers:
      observer(*args)
    spawn_detached(self._notify())

  async def _notify(self) -> None:
    async with self.condition:
      self.condition.notify_all()


class AsyncCallbackSystem(Generic[K, T]):
  """Named registry of AsyncCallbacks with broadcast trigger."""

  def __init__(self) -> None:
    self.callbacks: Dict[K, AsyncCallback[T]] = {}

  def register(self, name: K) -> AsyncCallback[T]:
    if name not in self.callbacks:
      self.callbacks[name] = AsyncCallback[T]()
    return self.callbacks[name]

  def deregister(self, name: K) -> None:
    self.callbacks.pop(name, None)

  def trigger(self, name: K, *args: T) -> None:
    if name in self.callbacks:
      self.callbacks[name].set(*args)

  def trigger_all(self, *args: T) -> None:
    for callback in list(self.callbacks.values()):
      callback.set(*args)


_DETACHED_TASKS: set = set()


def _report_task_exception(task: "asyncio.Task") -> None:
  """Done-callback: log a detached task that died of an exception at the next loop
  tick, unless an awaiter retrieved the exception first."""
  if task.cancelled():
    return

  def _check() -> None:
    if getattr(task, "_log_traceback", True) is False:
      return  # an awaiter retrieved the exception and owns handling it
    exc = task.exception()
    if exc is not None:
      print(f"detached task {task.get_name()} failed: {exc!r}", file=sys.stderr)

  try:
    asyncio.get_running_loop().call_soon(_check)
  except RuntimeError:  # loop already closed: report synchronously
    _check()


def spawn_detached(coro, registry: Optional[set] = None) -> "asyncio.Task":
  """create_task with a strong reference (asyncio keeps only weak refs to tasks) and
  deterministic exception logging."""
  reg = registry if registry is not None else _DETACHED_TASKS
  task = asyncio.create_task(coro)
  reg.add(task)
  task.add_done_callback(reg.discard)
  task.add_done_callback(_report_task_exception)
  return task


def is_port_available(port: int, host: str = "") -> bool:
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
      s.bind((host, port))
      return True
    except OSError:
      return False


def _used_ports_file() -> str:
  return os.path.join(tempfile.gettempdir(), "xot_tpu_used_ports")


def _ephemeral_range() -> Tuple[int, int]:
  """The host's range of ports for outgoing connections (Linux; IANA's elsewhere)."""
  try:
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
      low, high = (int(v) for v in f.read().split())
    return low, high
  except (OSError, ValueError):
    return 49152, 65535


def default_port_range() -> Tuple[int, int]:
  """Where find_available_port draws: below the host's ephemeral range, so an outgoing
  connection of another process cannot take the port between the draw and the bind
  (it can when the two overlap: Linux gives 32768-60999 to outgoing connections); at
  or above 10000, clear of the well-known and the usual service ports."""
  low, _ = _ephemeral_range()
  if low > 11000:
    return 10000, low - 1
  return 49152, 65535  # the host hands out nearly every port: the JAX package's range


def find_available_port(host: str = "", min_port: Optional[int] = None,
                        max_port: Optional[int] = None) -> int:
  """A random free port (default_port_range), avoiding the last 100 ports this host's
  processes claimed: a used-ports file in the temporary directory, read and rewritten
  under an exclusive lock, so peers starting at once in several processes never draw
  one port."""
  lo, hi = default_port_range()
  min_port = lo if min_port is None else min_port
  max_port = hi if max_port is None else max_port
  try:
    f = open(_used_ports_file(), "a+")
  except OSError:
    f = None  # no shared record: draw without it
  with f or contextlib.nullcontext():
    used: List[int] = []
    if f is not None:
      try:
        import fcntl
        fcntl.flock(f, fcntl.LOCK_EX)  # released when the file closes
      except (ImportError, OSError):
        pass
      f.seek(0)
      used = [int(line) for line in f.read().split() if line.strip().isdigit()][-100:]
    for _ in range(200):
      port = random.randint(min_port, max_port)
      if port not in used and is_port_available(port, host):
        if f is not None:
          f.seek(0)
          f.truncate()
          f.write("\n".join(str(p) for p in used + [port]))
        return port
  raise RuntimeError("No available ports in range")


def get_all_ip_addresses_and_interfaces() -> List[Tuple[str, str]]:
  """All (ipv4, interface) pairs on this host, loopback last, from psutil where it is
  installed; otherwise (or when it finds none) loopback alone, so discovery on one
  machine still works."""
  try:
    import psutil
    pairs: List[Tuple[str, str]] = []
    for ifname, addrs in psutil.net_if_addrs().items():
      for addr in addrs:
        if addr.family == socket.AF_INET and addr.address:
          pairs.append((addr.address, ifname))
    pairs.sort(key=lambda p: p[0].startswith("127."))
    if pairs:
      return pairs
  except (ImportError, OSError) as e:
    if DEBUG >= 1:
      print(f"NIC enumeration failed ({e!r}); falling back to loopback only")
  return [("127.0.0.1", "lo")]


def get_interface_priority_and_type(ifname: str) -> Tuple[int, str]:
  """Rank an interface for peer-address conflicts: container > loopback > fabric >
  ethernet > wifi > other > vpn."""
  name = ifname.lower()
  if name.startswith(("docker", "br-", "veth", "cni", "flannel", "calico")):
    return (7, "Container Virtual")
  if name.startswith("lo"):
    return (6, "Loopback")
  if name.startswith(("ib", "bond", "thunderbolt")):
    return (5, "Fabric")
  if name.startswith(("eth", "en", "eno", "ens", "enp")):
    return (4, "Ethernet")
  if name.startswith(("wl", "wifi", "wlan")):
    return (3, "WiFi")
  if name.startswith(("tun", "tap", "vpn", "wg", "utun", "zt", "ts")):
    return (1, "VPN")
  return (2, "Other")
