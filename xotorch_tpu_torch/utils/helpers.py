"""Debug level, async pub/sub and detached tasks.

The port's copy of the parts of xotorch_tpu/utils/helpers.py that its Node and API
use: `DEBUG`, `AsyncCallbackSystem` and `spawn_detached`.
"""
from __future__ import annotations

import asyncio
import os
import sys
from typing import Callable, Dict, Generic, List, Optional, Tuple, TypeVar

DEBUG = int(os.getenv("DEBUG", "0"))

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
