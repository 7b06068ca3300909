"""Layer partitioning: [0, 1) fractions of the model to contiguous layer ranges.

The port's copy of xotorch_tpu/topology/partitioning.py, unchanged in behaviour. The
strategy is deterministic given a topology, so every peer computes the same ring
without a coordination round.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List

from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.topology.topology import Topology


@dataclass(frozen=True)
class Partition:
  node_id: str
  start: float  # inclusive, in [0, 1)
  end: float  # exclusive


class PartitioningStrategy(ABC):
  @abstractmethod
  def partition(self, topology: Topology) -> List[Partition]:
    ...


def map_partitions_to_shards(partitions: List[Partition], num_layers: int, model_id: str) -> List[Shard]:
  """Contiguous layer ranges covering exactly [0, num_layers): the last shard takes
  the tail, and every peer gets at least one layer. More peers than layers raises."""
  if not partitions:
    return []
  if len(partitions) > num_layers:
    raise ValueError(f"Cannot partition {num_layers} layers across {len(partitions)} peers")
  shards: List[Shard] = []
  for i, partition in enumerate(partitions):
    start_layer = shards[-1].end_layer + 1 if shards else 0
    end_layer = num_layers - 1 if i == len(partitions) - 1 else int(round(partition.end * num_layers)) - 1
    end_layer = min(max(end_layer, start_layer), num_layers - (len(partitions) - i))
    shards.append(Shard(model_id, start_layer, end_layer, num_layers))
  return shards


class RingMemoryWeightedPartitioningStrategy(PartitioningStrategy):
  """Fractions proportional to each node's accelerator memory, nodes ordered by
  (memory, id) descending so the ring is the same on every peer; an equal split when
  every memory is 0."""

  def partition(self, topology: Topology) -> List[Partition]:
    nodes = sorted(topology.all_nodes(), key=lambda x: (x[1].memory, x[0]), reverse=True)
    total_memory = sum(caps.memory for _, caps in nodes)
    if total_memory == 0:
      n = max(1, len(nodes))
      return [Partition(node_id, i / n, (i + 1) / n) for i, (node_id, _) in enumerate(nodes)]
    partitions: List[Partition] = []
    start = 0.0
    for node_id, caps in nodes:
      end = round(start + caps.memory / total_memory, 5)
      partitions.append(Partition(node_id, start, end))
      start = end
    return partitions
