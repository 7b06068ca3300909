"""Server ABC: the port's copy of xotorch_tpu/networking/server.py."""
from __future__ import annotations

from abc import ABC, abstractmethod


class Server(ABC):
  @abstractmethod
  async def start(self) -> None:
    ...

  @abstractmethod
  async def stop(self) -> None:
    ...
