from xotorch_tpu_torch.topology.device_capabilities import (
  DeviceCapabilities,
  DeviceFlops,
  UNKNOWN_DEVICE_CAPABILITIES,
  device_capabilities,
)
from xotorch_tpu_torch.topology.topology import PeerConnection, Topology
from xotorch_tpu_torch.topology.partitioning import (
  Partition,
  PartitioningStrategy,
  RingMemoryWeightedPartitioningStrategy,
  map_partitions_to_shards,
)

__all__ = [
  "DeviceCapabilities",
  "DeviceFlops",
  "UNKNOWN_DEVICE_CAPABILITIES",
  "device_capabilities",
  "PeerConnection",
  "Topology",
  "Partition",
  "PartitioningStrategy",
  "RingMemoryWeightedPartitioningStrategy",
  "map_partitions_to_shards",
]
