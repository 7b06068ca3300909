from xotorch_tpu_torch.networking.discovery import Discovery
from xotorch_tpu_torch.networking.peer_handle import PeerHandle
from xotorch_tpu_torch.networking.server import Server

__all__ = ["Discovery", "PeerHandle", "Server"]
