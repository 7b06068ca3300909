from xotorch_tpu_torch.networking.manual.discovery import ManualDiscovery
from xotorch_tpu_torch.networking.manual.network_topology_config import NetworkTopology, PeerConfig

__all__ = ["ManualDiscovery", "NetworkTopology", "PeerConfig"]
