from xotorch_tpu_torch.networking.tcp.peer_handle import TCPPeerHandle
from xotorch_tpu_torch.networking.tcp.server import TCPServer

__all__ = ["TCPServer", "TCPPeerHandle"]
