"""Manual discovery: poll a JSON topology file and health-check the peers it names.

The port's copy of xotorch_tpu/networking/manual/discovery.py: the file is reloaded
when its mtime changes; a bad edit keeps the last good config; an unhealthy peer is
left out of discover_peers until it answers again; a peer dropped from the file is
dropped.
"""
from __future__ import annotations

import asyncio
import os
from typing import Callable, Dict, List, Optional

from xotorch_tpu_torch.networking.discovery import Discovery
from xotorch_tpu_torch.networking.manual.network_topology_config import NetworkTopology
from xotorch_tpu_torch.networking.peer_handle import PeerHandle
from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities
from xotorch_tpu_torch.utils.helpers import DEBUG_DISCOVERY, spawn_detached


class ManualDiscovery(Discovery):
  def __init__(
    self,
    network_config_path: str,
    node_id: str,
    create_peer_handle: Callable[[str, str, str, DeviceCapabilities], PeerHandle],
    poll_interval: float = 5.0,
  ):
    self.network_config_path = network_config_path
    self.node_id = node_id
    self.create_peer_handle = create_peer_handle
    self.poll_interval = poll_interval
    self.known_peers: Dict[str, PeerHandle] = {}
    self._config: Optional[NetworkTopology] = None
    self._mtime: Optional[float] = None
    self._task: Optional[asyncio.Task] = None

  async def start(self) -> None:
    self._task = spawn_detached(self._poll_loop())

  async def stop(self) -> None:
    if self._task is not None:
      self._task.cancel()
      try:
        await self._task
      except asyncio.CancelledError:
        pass
      self._task = None

  async def discover_peers(self, wait_for_peers: int = 0) -> List[PeerHandle]:
    if wait_for_peers > 0:
      while len(self.known_peers) < wait_for_peers:
        await asyncio.sleep(0.1)
    return list(self.known_peers.values())

  async def _poll_loop(self) -> None:
    while True:
      try:
        await self._refresh()
      except Exception as e:  # the poll loop must outlive one bad round
        if DEBUG_DISCOVERY >= 1:
          print(f"Manual discovery refresh error: {e!r}")
      await asyncio.sleep(self.poll_interval)

  def _load_config(self) -> Optional[NetworkTopology]:
    try:
      mtime = os.path.getmtime(self.network_config_path)
      if self._config is not None and mtime == self._mtime:
        return self._config
      config = NetworkTopology.from_path(self.network_config_path)
      self._config = config
      self._mtime = mtime
      return config
    except (OSError, ValueError) as e:
      if DEBUG_DISCOVERY >= 1:
        print(f"Config load failed ({e!r}); keeping last good config")
      return self._config

  async def _refresh(self) -> None:
    config = self._load_config()
    if config is None:
      return
    for peer_id, peer_config in config.peers.items():
      if peer_id == self.node_id:
        continue
      handle = self.known_peers.get(peer_id)
      if handle is None:
        handle = self.create_peer_handle(
          peer_id, f"{peer_config.address}:{peer_config.port}", "manual config",
          peer_config.device_capabilities)
      if await handle.health_check():
        self.known_peers[peer_id] = handle
      else:
        self.known_peers.pop(peer_id, None)
        await handle.disconnect()  # idle connections only: a call in flight keeps its own
        if DEBUG_DISCOVERY >= 2:
          print(f"Manual peer {peer_id} unhealthy; excluded")
    for peer_id in list(self.known_peers):
      if peer_id not in config.peers:
        await self.known_peers.pop(peer_id).disconnect()
