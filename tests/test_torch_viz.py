"""The port's topology TUI (viz/topology_viz.py, ANSI text on the standard library)
against the JAX package's rich one: test_viz.py's four cases one for one, the same
ids, layer ranges and endpoints in a two-node render with the ANSI codes stripped as
in rich's recorded text, and the frame on a pipe (written once, at stop) and on a
terminal (redrawn in place while it runs). Also the chat TUI over the dummy engine.
"""
import io
import json
import re
import time

from rich.console import Console

from xotorch_tpu.topology.device_capabilities import DeviceCapabilities as JCaps, DeviceFlops as JFlops
from xotorch_tpu.topology.partitioning import Partition as JPartition
from xotorch_tpu.topology.topology import Topology as JTopology
from xotorch_tpu.viz.topology_viz import TopologyViz as JTopologyViz
from xotorch_tpu_torch.inference.dummy import DummyInferenceEngine
from xotorch_tpu_torch.orchestration.node import Node
from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities, DeviceFlops
from xotorch_tpu_torch.topology.partitioning import Partition, RingMemoryWeightedPartitioningStrategy
from xotorch_tpu_torch.topology.topology import Topology
from xotorch_tpu_torch.viz.topology_viz import TopologyViz, strip_ansi

ENDPOINTS = dict(chatgpt_api_endpoints=["http://10.0.0.2:52415/v1/chat/completions"],
                 web_chat_urls=["http://10.0.0.2:52415"])


def _viz_with_ring(n_layers=None, model_id=None, jax=False, **kw):
  """test_viz.py's two-node ring on either package."""
  caps_cls, flops_cls, topo_cls, part_cls, viz_cls = (
    (JCaps, JFlops, JTopology, JPartition, JTopologyViz) if jax else
    (DeviceCapabilities, DeviceFlops, Topology, Partition, TopologyViz))
  viz = viz_cls(**kw)
  topo = topo_cls()
  caps = caps_cls(model="m", chip="v5e", memory=16384, flops=flops_cls(fp32=99, fp16=197, int8=394))
  topo.update_node("node-a", caps)
  topo.update_node("node-b", caps)
  viz.update_visualization(topo, [part_cls("node-a", 0.0, 0.5), part_cls("node-b", 0.5, 1.0)], "node-a")
  if n_layers is not None:
    viz.update_model(model_id, n_layers)
  return viz


def _render(viz) -> str:
  return strip_ansi(viz._render_ring())


def _jax_text(viz) -> str:
  console = Console(width=120, record=True, force_terminal=False, file=io.StringIO())
  console.print(viz._render_ring())
  return console.export_text()


def test_layer_ranges_use_active_model_depth_16():
  out = _render(_viz_with_ring(16, "llama-3.2-1b"))
  assert "layers[0..7]" in out
  assert "layers[8..15]" in out


def test_layer_ranges_use_active_model_depth_80():
  out = _render(_viz_with_ring(80, "llama-3.1-70b"))
  assert "layers[0..39]" in out
  assert "layers[40..79]" in out


def test_no_ranges_without_an_active_model():
  out = _render(_viz_with_ring())
  assert "layers[" not in out
  assert "node-a" in out


def test_status_bus_feeds_model_depth():
  """Node.on_node_status hands base_shard's n_layers to the TUI, the node's own
  broadcast included; an end status clears the active node."""
  viz = TopologyViz()
  node = Node("viz-node", None, DummyInferenceEngine(), None, RingMemoryWeightedPartitioningStrategy(),
              topology_viz=viz)
  node.on_node_status("req-1", json.dumps({
    "type": "node_status", "node_id": "viz-node", "status": "start_process_prompt",
    "request_id": "req-1",
    "base_shard": {"model_id": "llama-3.2-1b", "start_layer": 0, "end_layer": 15, "n_layers": 16},
  }))
  assert viz.model_layers == 16
  assert viz.model_id == "llama-3.2-1b"
  assert node.topology.active_node_id == "viz-node" and viz.node_id == "viz-node"
  assert "layers[0..15]" in _render(viz) and "●" in _render(viz)
  node.on_node_status("req-1", json.dumps({"type": "node_status", "node_id": "viz-node",
                                           "status": "end_process_prompt", "request_id": "req-1"}))
  assert node.topology.active_node_id is None
  node.on_node_status("", json.dumps({"type": "download_progress", "node_id": "peer-x",
                                      "progress": {"percentage": 42.0}}))
  assert node.node_download_progress == {"peer-x": {"percentage": 42.0}}
  assert "↓ peer-x: 42%" in _render(viz)


def _facts(text: str):
  """The ids, layer ranges and endpoints a render names."""
  return (re.findall(r"[○●] (\S+)", text), re.findall(r"layers\[\d+\.\.\d+\]", text),
          re.findall(r"(?:web chat|api): (\S+)", text), re.findall(r"(\d+) bf16 TFLOPS", text))


def test_two_node_render_names_what_jaxs_does():
  for depth in (None, 16, 26):
    port = _render(_viz_with_ring(depth, "m", **ENDPOINTS))
    jax_ = _jax_text(_viz_with_ring(depth, "m", jax=True, **ENDPOINTS))
    assert _facts(port) == _facts(jax_), (depth, port, jax_)
    assert _facts(port)[2] == ["http://10.0.0.2:52415", "http://10.0.0.2:52415/v1/chat/completions"]
  viz, jviz = _viz_with_ring(16, "m"), _viz_with_ring(16, "m", jax=True)
  for v in (viz, jviz):
    for i in range(5):
      v.update_prompt(f"r{i}", f"prompt {i}")
    v.update_prompt_output("r4", "an answer")
  assert list(viz.prompts) == list(jviz.prompts) == ["r2", "r3", "r4"]
  chat = strip_ansi(viz._render_chat())
  assert "prompt: prompt 4" in chat and "output: an answer" in chat and "prompt 1" not in chat


class _Tty(io.StringIO):
  def isatty(self):
    return True


def test_frame_on_a_pipe_and_on_a_terminal():
  """On a pipe nothing is drawn while the TUI runs; stop writes the last frame once, as
  plain text ending in a newline. On a terminal each change is redrawn in place."""
  pipe = io.StringIO()
  viz = _viz_with_ring(16, "m", stream=pipe, **ENDPOINTS)
  viz.start()
  viz.update_prompt("r1", "hello")
  time.sleep(0.6)
  assert pipe.getvalue() == ""
  viz.stop()
  text = pipe.getvalue()
  assert "\x1b[" not in text and text.endswith("\n")
  assert "xot cluster" in text and "layers[8..15]" in text and "prompt: hello" in text
  viz.stop()  # a second stop writes nothing more
  assert pipe.getvalue() == text
  tty = _Tty()
  viz = _viz_with_ring(16, "m", stream=tty)
  viz.start()
  deadline = time.monotonic() + 5
  while "layers[0..7]" not in tty.getvalue() and time.monotonic() < deadline:
    time.sleep(0.05)
  first = len(tty.getvalue())
  viz.update_model("m", 80)
  while "layers[0..39]" not in tty.getvalue() and time.monotonic() < deadline:
    time.sleep(0.05)
  viz.stop()
  redraw = tty.getvalue()[first:]
  assert redraw.startswith(f"\x1b[{len(viz.frame())}F\x1b[J") and "layers[40..79]" in redraw
