"""Cluster topology graph: nodes with capabilities and directed peer edges.

The port's copy of xotorch_tpu/topology/topology.py, with the same merge rule and the
same JSON form on the wire: merging a peer's gossiped view accepts only the edges and
capabilities that originate from that peer's own observations, so a stale peer cannot
overwrite the rest of the graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Set

from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities


@dataclass(frozen=True)
class PeerConnection:
  from_id: str
  to_id: str
  description: Optional[str] = None


class Topology:
  def __init__(self) -> None:
    self.nodes: Dict[str, DeviceCapabilities] = {}
    self.peer_graph: Dict[str, Set[PeerConnection]] = {}
    self.active_node_id: Optional[str] = None

  def update_node(self, node_id: str, device_capabilities: DeviceCapabilities) -> None:
    self.nodes[node_id] = device_capabilities

  def get_node(self, node_id: str) -> Optional[DeviceCapabilities]:
    return self.nodes.get(node_id)

  def all_nodes(self):
    return self.nodes.items()

  def add_edge(self, from_id: str, to_id: str, description: Optional[str] = None) -> None:
    self.peer_graph.setdefault(from_id, set()).add(PeerConnection(from_id, to_id, description))

  def get_neighbors(self, node_id: str) -> Set[str]:
    return {conn.to_id for conn in self.peer_graph.get(node_id, set())}

  def merge(self, peer_node_id: str, other: "Topology") -> None:
    """Accept only what originates from `peer_node_id`."""
    for node_id, caps in other.nodes.items():
      if node_id == peer_node_id:
        self.update_node(node_id, caps)
    for connections in other.peer_graph.values():
      for conn in connections:
        if conn.from_id == peer_node_id:
          self.add_edge(conn.from_id, conn.to_id, conn.description)

  def to_json(self) -> Dict[str, Any]:
    return {
      "nodes": {node_id: caps.to_dict() for node_id, caps in self.nodes.items()},
      "peer_graph": {
        node_id: [{"from_id": c.from_id, "to_id": c.to_id, "description": c.description} for c in conns]
        for node_id, conns in self.peer_graph.items()
      },
      "active_node_id": self.active_node_id,
    }

  @classmethod
  def from_json(cls, data: Dict[str, Any]) -> "Topology":
    topo = cls()
    for node_id, caps in data.get("nodes", {}).items():
      topo.update_node(node_id, DeviceCapabilities.from_dict(caps))
    for conns in data.get("peer_graph", {}).values():
      for c in conns:
        topo.add_edge(c["from_id"], c["to_id"], c.get("description"))
    topo.active_node_id = data.get("active_node_id")
    return topo

  def __str__(self) -> str:
    return f"Topology(nodes={list(self.nodes)}, edges={ {k: len(v) for k, v in self.peer_graph.items()} })"
