"""UDP broadcast discovery, the default of `main.py`.

The port's copy of xotorch_tpu/networking/udp/discovery.py (standard library only):
a JSON presence broadcast every `broadcast_interval` on every NIC, a listener that
health-checks a peer before admitting it, interface-priority conflict resolution when
one peer is seen through two NICs, and eviction of peers unseen and unhealthy past
`discovery_timeout`. The message keeps the JAX package's keys: the node's TCP port
travels under `grpc_port`.
"""
from __future__ import annotations

import asyncio
import json
import socket
import time
from typing import Callable, Dict, List, Optional, Tuple

from xotorch_tpu_torch.networking.discovery import Discovery
from xotorch_tpu_torch.networking.peer_handle import PeerHandle
from xotorch_tpu_torch.topology.device_capabilities import (
  DeviceCapabilities,
  UNKNOWN_DEVICE_CAPABILITIES,
  device_capabilities,
)
from xotorch_tpu_torch.utils.helpers import (
  DEBUG_DISCOVERY,
  spawn_detached,
  get_all_ip_addresses_and_interfaces,
  get_interface_priority_and_type,
)

# peer_id -> (peer_handle, interface_name, last_seen, interface_priority)
_PeerEntry = Tuple[PeerHandle, str, float, int]


class ListenProtocol(asyncio.DatagramProtocol):
  def __init__(self, on_message: Callable[[bytes, Tuple[str, int]], None]):
    # Strong refs for per-datagram dispatch tasks: the loop holds only weak
    # refs, and a GC'd task would silently drop a discovery message.
    self._inflight: set = set()
    super().__init__()
    self.on_message = on_message
    self.loop = asyncio.get_event_loop()

  def connection_made(self, transport):
    self.transport = transport

  def datagram_received(self, data, addr):
    spawn_detached(self.on_message(data, addr), self._inflight)


def subnet_broadcast_address(ip_addr: str) -> Optional[str]:
  """/24 directed-broadcast address for the NIC's subnet, or None for
  non-IPv4 sources. Matters on multi-NIC hosts: the global broadcast is
  routed out ONE interface chosen by the OS, while the directed address
  always leaves the NIC that owns `ip_addr`."""
  parts = ip_addr.split(".")
  if len(parts) != 4:
    return None
  try:
    if not all(0 <= int(p) <= 255 for p in parts):
      return None
  except ValueError:
    return None
  return ".".join(parts[:3] + ["255"])


class BroadcastProtocol(asyncio.DatagramProtocol):
  def __init__(self, message: str, broadcast_port: int, source_ip: str):
    self.message = message
    self.broadcast_port = broadcast_port
    self.source_ip = source_ip

  def connection_made(self, transport):
    sock = transport.get_extra_info("socket")
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    payload = self.message.encode("utf-8")
    # Subnet-directed first (pins the egress NIC), then the global broadcast
    # for containers/VPNs whose subnet mask isn't /24.
    directed = subnet_broadcast_address(self.source_ip)
    if directed is not None:
      try:
        transport.sendto(payload, (directed, self.broadcast_port))
      except OSError:
        pass
    transport.sendto(payload, ("<broadcast>", self.broadcast_port))
    transport.close()


class UDPDiscovery(Discovery):
  def __init__(
    self,
    node_id: str,
    node_port: int,
    listen_port: int,
    broadcast_port: Optional[int] = None,
    create_peer_handle: Callable[[str, str, str, DeviceCapabilities], PeerHandle] = None,
    broadcast_interval: float = 2.5,
    discovery_timeout: float = 30.0,
    device_capabilities: Optional[DeviceCapabilities] = None,
  ):
    self.node_id = node_id
    self.node_port = node_port
    self.listen_port = listen_port
    self.broadcast_port = broadcast_port if broadcast_port is not None else listen_port
    self.create_peer_handle = create_peer_handle
    self.broadcast_interval = broadcast_interval
    self.discovery_timeout = discovery_timeout
    self.device_capabilities = device_capabilities
    self.known_peers: Dict[str, _PeerEntry] = {}
    self._tasks: List[asyncio.Task] = []
    self._listen_transport = None
    self._admitting: set = set()

  async def start(self) -> None:
    if self.device_capabilities is None:
      from xotorch_tpu_torch.topology import device_capabilities as probe
      self.device_capabilities = await probe()
    self._tasks = [
      spawn_detached(self._broadcast_presence()),
      spawn_detached(self._listen_for_peers()),
      spawn_detached(self._cleanup_peers()),
    ]

  async def stop(self) -> None:
    for task in self._tasks:
      task.cancel()
    await asyncio.gather(*self._tasks, return_exceptions=True)
    self._tasks = []
    if self._listen_transport is not None:
      self._listen_transport.close()
      self._listen_transport = None

  async def discover_peers(self, wait_for_peers: int = 0) -> List[PeerHandle]:
    if wait_for_peers > 0:
      while len(self.known_peers) < wait_for_peers:
        if DEBUG_DISCOVERY >= 2:
          print(f"Waiting for {wait_for_peers} peers, have {len(self.known_peers)}")
        await asyncio.sleep(0.1)
    return [entry[0] for entry in self.known_peers.values()]

  # ----------------------------------------------------------- broadcast

  async def _broadcast_presence(self) -> None:
    while True:
      try:
        for ip, ifname in get_all_ip_addresses_and_interfaces():
          priority, iftype = get_interface_priority_and_type(ifname)
          message = json.dumps({
            "type": "discovery",
            "node_id": self.node_id,
            "grpc_port": self.node_port,
            "device_capabilities": self.device_capabilities.to_dict(),
            "priority": priority,
            "interface_name": ifname,
            "interface_type": iftype,
          })
          try:
            transport, _ = await asyncio.get_event_loop().create_datagram_endpoint(
              lambda msg=message: BroadcastProtocol(msg, self.broadcast_port, ip),
              local_addr=(ip, 0),
              family=socket.AF_INET,
            )
          except Exception as e:
            if DEBUG_DISCOVERY >= 2:
              print(f"Broadcast failed on {ifname}/{ip}: {e!r}")
      except Exception as e:
        if DEBUG_DISCOVERY >= 1:
          print(f"Broadcast loop error: {e!r}")
      await asyncio.sleep(self.broadcast_interval)

  # -------------------------------------------------------------- listen

  async def _listen_for_peers(self) -> None:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
      sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except (AttributeError, OSError):
      pass
    sock.bind(("", self.listen_port))
    self._listen_transport, _ = await asyncio.get_event_loop().create_datagram_endpoint(
      lambda: ListenProtocol(self._on_listen_message), sock=sock
    )
    if DEBUG_DISCOVERY >= 1:
      print(f"UDP discovery listening on :{self.listen_port}")
    while True:
      await asyncio.sleep(3600)

  async def _on_listen_message(self, data: bytes, addr: Tuple[str, int]) -> None:
    if not data:
      return
    try:
      decoded = data.decode("utf-8", errors="ignore")
      start = decoded.find("{")
      if start < 0:
        return
      message = json.loads(decoded[start:])
    except json.JSONDecodeError:
      return
    if message.get("type") != "discovery":
      return
    peer_id = message.get("node_id")
    if not peer_id or peer_id == self.node_id:
      return

    peer_host = addr[0]
    peer_port = message.get("grpc_port")
    peer_prio = int(message.get("priority", 0))
    caps = DeviceCapabilities.from_dict(message.get("device_capabilities", {}))

    existing = self.known_peers.get(peer_id)
    if existing is not None:
      handle, ifname, _, prio = existing
      # Re-admit only on a STRICTLY better interface (prevents two equal-
      # priority NICs from flapping the peer and leaking a connection per
      # broadcast); otherwise just refresh liveness.
      if handle.addr() != f"{peer_host}:{peer_port}" and peer_prio > prio:
        await self._admit_peer(peer_id, peer_host, peer_port, message, caps, peer_prio, replacing=handle)
      else:
        self.known_peers[peer_id] = (handle, ifname, time.time(), prio)
      return
    await self._admit_peer(peer_id, peer_host, peer_port, message, caps, peer_prio)

  async def _admit_peer(self, peer_id, host, port, message, caps, priority, replacing=None) -> None:
    if peer_id in self._admitting:
      return  # an admission (with its health check) is already in flight
    self._admitting.add(peer_id)
    try:
      await self._admit_peer_inner(peer_id, host, port, message, caps, priority, replacing)
    finally:
      self._admitting.discard(peer_id)

  async def _admit_peer_inner(self, peer_id, host, port, message, caps, priority, replacing=None) -> None:
    handle = self.create_peer_handle(
      peer_id, f"{host}:{port}", f"{message.get('interface_name')} ({message.get('interface_type')})", caps
    )
    # Health-gate admission so dead addresses never join.
    if not await handle.health_check():
      if DEBUG_DISCOVERY >= 2:
        print(f"Peer {peer_id}@{host}:{port} failed health check; not admitting")
      disconnect = getattr(handle, "disconnect", None)
      if disconnect is not None:
        try:
          await disconnect()
        except Exception as e:
          if DEBUG_DISCOVERY >= 2:
            print(f"closing unadmitted handle for {peer_id} failed: {e!r}")
      return
    if replacing is not None:
      try:
        # Graceful: the SAME peer re-admitted via a better interface must
        # not cut short a call still riding the old handle; new calls use the
        # new handle.
        await replacing.disconnect(grace=600.0)
      except Exception as e:
        if DEBUG_DISCOVERY >= 1:
          print(f"graceful close of the replaced handle for {peer_id} failed: {e!r}")
    self.known_peers[peer_id] = (handle, message.get("interface_name", "?"), time.time(), priority)
    if DEBUG_DISCOVERY >= 1:
      print(f"Discovered peer {peer_id}@{host}:{port} prio={priority}")

  # ------------------------------------------------------------- cleanup

  async def _cleanup_peers(self) -> None:
    while True:
      try:
        now = time.time()
        for peer_id, (handle, ifname, last_seen, prio) in list(self.known_peers.items()):
          stale = now - last_seen > self.discovery_timeout
          healthy = await handle.health_check() if stale else True
          if stale and not healthy:
            if DEBUG_DISCOVERY >= 1:
              print(f"Evicting peer {peer_id}: unseen {now-last_seen:.0f}s and unhealthy")
            self.known_peers.pop(peer_id, None)
          elif stale and healthy:
            self.known_peers[peer_id] = (handle, ifname, now, prio)
      except Exception as e:
        if DEBUG_DISCOVERY >= 1:
          print(f"Cleanup loop error: {e!r}")
      await asyncio.sleep(self.broadcast_interval)
