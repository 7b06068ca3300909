from xotorch_tpu_torch.networking.udp.discovery import UDPDiscovery

__all__ = ["UDPDiscovery"]
