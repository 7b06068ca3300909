from xotorch_tpu_torch.viz.topology_viz import TopologyViz

__all__ = ["TopologyViz"]
