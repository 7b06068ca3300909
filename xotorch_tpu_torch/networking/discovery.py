"""Discovery ABC: the port's copy of xotorch_tpu/networking/discovery.py."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

from xotorch_tpu_torch.networking.peer_handle import PeerHandle


class Discovery(ABC):
  @abstractmethod
  async def start(self) -> None:
    ...

  @abstractmethod
  async def stop(self) -> None:
    ...

  @abstractmethod
  async def discover_peers(self, wait_for_peers: int = 0) -> List[PeerHandle]:
    ...
