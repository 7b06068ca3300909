"""The topology TUI: the ring of peers with each partition's layer range, drawn with
ANSI text.

The port's twin of xotorch_tpu/viz/topology_viz.py on the standard library (JAX's draws
with rich, which the card's machine is not known to have): the same methods and the
same content. A cluster bf16 TFLOPS gauge, the ring in partition order (the active
node marked, this node highlighted, each partition's real layer range once the status
bus has named the active model and its depth), each node's download progress, the web
chat and API addresses, and a chat panel of the last three prompts and outputs.

On a terminal `start` redraws the frame in place at 4 Hz while anything changed; on a
pipe nothing is drawn while it runs and `stop` writes the last frame once, as plain
text with a newline after it (rich's Live writes the same frame there, without the
newline), so a log that a pipe collects keeps its lines.
"""
from __future__ import annotations

import math
import re
import shutil
import sys
import threading
from collections import OrderedDict
from typing import List, Optional

from xotorch_tpu_torch.topology.partitioning import Partition, map_partitions_to_shards
from xotorch_tpu_torch.topology.topology import Topology

_CODES = {"bold": "1", "dim": "2", "underline": "4", "green": "32", "yellow": "33", "blue": "34",
          "magenta": "35", "cyan": "36", "white": "37"}
_ANSI = re.compile(r"\x1b\[[0-9;]*[A-Za-z]")
REFRESH_S = 0.25  # 4 frames a second, rich's refresh_per_second=4
# The gauge's scale: tanh(TFLOPS / this), "GPU rich" past one half (four H100s' dense
# bf16 peak reach 0.96).
GAUGE_TFLOPS = 2000.0


def styled(text: str, style: str = "") -> str:
  """`text` in `style` (words of _CODES, e.g. "bold green") as ANSI codes."""
  codes = ";".join(_CODES[w] for w in style.split() if w in _CODES)
  return f"\x1b[{codes}m{text}\x1b[0m" if codes else text


def strip_ansi(text: str) -> str:
  return _ANSI.sub("", text)


def pretty_bytes(size_in_bytes: float) -> str:
  for unit, divisor in (("TB", 1 << 40), ("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10)):
    if size_in_bytes >= divisor:
      return f"{size_in_bytes / divisor:.2f} {unit}"
  return f"{int(size_in_bytes)} B"


def panel(title: str, lines: List[str], width: int, style: str) -> List[str]:
  """`lines` in a rounded box `width` columns wide with `title` in its top edge; a line
  too long for it is cut."""
  inner = width - 4
  top = f"─ {title} ─" if title else ""
  side = (width - 2 - len(top)) // 2
  out = [styled("╭" + "─" * side + top + "─" * (width - 2 - side - len(top)) + "╮", style)]
  for line in lines:
    plain = strip_ansi(line)
    if len(plain) > inner:
      line = plain = plain[:inner]
    out.append(styled("│", style) + " " + line + " " * (inner - len(plain)) + " " + styled("│", style))
  out.append(styled("╰" + "─" * (width - 2) + "╯", style))
  return out


class TopologyViz:
  def __init__(self, chatgpt_api_endpoints: Optional[List[str]] = None,
               web_chat_urls: Optional[List[str]] = None, stream=None):
    self.chatgpt_api_endpoints = chatgpt_api_endpoints or []
    self.web_chat_urls = web_chat_urls or []
    self.topology = Topology()
    self.partitions: List[Partition] = []
    self.node_id: Optional[str] = None
    # The active model's id and depth, from the status bus: the ring's layer ranges are
    # its real partition-to-layer map.
    self.model_id: Optional[str] = None
    self.model_layers: Optional[int] = None
    self.prompts: "OrderedDict[str, str]" = OrderedDict()
    self.outputs: "OrderedDict[str, str]" = OrderedDict()
    self.node_download_progress = {}
    self.stream = stream if stream is not None else sys.stdout
    self._lock = threading.Lock()
    self._dirty = threading.Event()
    self._stopped = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self._drawn = 0  # lines of the frame on the terminal now

  # ------------------------------------------------------------- updates

  def start(self) -> None:
    if self._thread is None:
      self._stopped.clear()
      self._dirty.set()
      self._thread = threading.Thread(target=self._run, name="topology-viz", daemon=True)
      self._thread.start()

  def stop(self) -> None:
    if self._thread is None:
      return
    self._stopped.set()
    self._dirty.set()
    self._thread.join(timeout=5)
    self._thread = None
    if not self._is_terminal():
      self._write("\n".join(strip_ansi(line) for line in self.frame()) + "\n")

  def update_visualization(self, topology: Topology, partitions: List[Partition],
                           node_id: Optional[str] = None, node_download_progress=None) -> None:
    self.topology = topology
    self.partitions = partitions
    self.node_id = node_id
    if node_download_progress is not None:
      self.node_download_progress = node_download_progress
    self.refresh()

  def update_model(self, model_id: Optional[str], n_layers: Optional[int]) -> None:
    """The model the cluster serves now (the start_process_prompt status), so that the
    ring shows its real layer ranges."""
    self.model_id = model_id
    self.model_layers = int(n_layers) if n_layers else None
    self.refresh()

  def update_prompt(self, request_id: str, prompt: str) -> None:
    self.prompts[request_id] = prompt
    while len(self.prompts) > 3:
      self.prompts.popitem(last=False)
    self.refresh()

  def update_prompt_output(self, request_id: str, output: str) -> None:
    self.outputs[request_id] = output
    while len(self.outputs) > 3:
      self.outputs.popitem(last=False)
    self.refresh()

  def refresh(self) -> None:
    """Mark the frame for the next redraw (at most 4 a second, on the drawing thread)."""
    self._dirty.set()

  # ------------------------------------------------------------ drawing

  def _is_terminal(self) -> bool:
    isatty = getattr(self.stream, "isatty", None)
    return bool(isatty and isatty())

  def _write(self, text: str) -> None:
    try:
      self.stream.write(text)
      self.stream.flush()
    except (OSError, ValueError):  # a closed stream: the TUI is cosmetic
      pass

  def _run(self) -> None:
    while not self._stopped.is_set():
      self._dirty.wait()
      if self._stopped.is_set():
        return
      self._dirty.clear()
      if self._is_terminal():
        self._draw()
      self._stopped.wait(REFRESH_S)

  def _draw(self) -> None:
    lines = self.frame()
    with self._lock:
      # Back to the previous frame's first line, erase to the end, draw this one.
      back = f"\x1b[{self._drawn}F\x1b[J" if self._drawn else ""
      self._write(back + "\n".join(lines) + "\n")
      self._drawn = len(lines)

  def frame(self) -> List[str]:
    """The whole frame: the cluster panel over the chat panel, as wide as the terminal
    (80 columns on a pipe)."""
    width = max(40, shutil.get_terminal_size((80, 24)).columns)
    return (panel("xot cluster", self._render_ring().split("\n"), width, "blue")
            + panel("chat", self._render_chat().split("\n"), width, "magenta"))

  # ------------------------------------------------------------ renderers

  def _flops_gauge(self) -> str:
    total_tflops = sum(caps.flops.fp16 for _, caps in self.topology.all_nodes())
    frac = math.tanh(total_tflops / GAUGE_TFLOPS)
    width = 30
    filled = int(frac * width)
    bar = "█" * filled + "░" * (width - filled)
    label = "GPU rich" if frac > 0.5 else "GPU poor"
    return (styled(f"{total_tflops:.0f} bf16 TFLOPS ", "bold")
            + styled(bar, "green" if frac > 0.5 else "yellow") + styled(f" {label}", "dim"))

  def _render_ring(self) -> str:
    lines = [self._flops_gauge(), ""]
    shard_ranges = {}
    # Ranges only while a model is served (its real depth from update_model).
    if self.partitions and self.model_layers:
      try:
        shards = map_partitions_to_shards(self.partitions, self.model_layers, self.model_id or "model")
        shard_ranges = {p.node_id: (s.start_layer, s.end_layer) for p, s in zip(self.partitions, shards)}
      except ValueError:
        shard_ranges = {}
    order = [p.node_id for p in self.partitions] or [nid for nid, _ in self.topology.all_nodes()]
    for i, nid in enumerate(order):
      caps = self.topology.get_node(nid)
      if caps is None:
        continue
      is_active = nid == self.topology.active_node_id
      style = "bold green" if is_active else ("bold cyan" if nid == self.node_id else "white")
      arrow = " ─▶ " if i < len(order) - 1 else " ─▶ (ring wraps)"
      range_txt = ""
      if nid in shard_ranges:
        lo, hi = shard_ranges[nid]
        range_txt = f" layers[{lo}..{hi}]"
      lines.append(styled(f" {'●' if is_active else '○'} ", style) + styled(f"{nid[:12]:<14}", style)
                   + styled(f"{caps.chip} {pretty_bytes(caps.memory * 1024 * 1024)}", "dim")
                   + styled(range_txt, "yellow") + styled(arrow, "dim"))
    if self.node_download_progress:
      lines.append("")
      for nid, progress in self.node_download_progress.items():
        pct = progress.get("percentage", 0) if isinstance(progress, dict) else 0
        lines.append(styled(f" ↓ {nid[:12]}: {pct:.0f}%", "dim"))
    for url in self.web_chat_urls:
      lines += ["", styled(f" web chat: {url}", "blue underline")]
    for ep in self.chatgpt_api_endpoints:
      lines.append(styled(f" api: {ep}", "dim"))
    return "\n".join(lines)

  def _render_chat(self) -> str:
    rows = []
    for request_id in list(self.prompts.keys())[-3:]:
      rows.append(styled("prompt: ", "bold yellow") + self.prompts[request_id][-200:])
      if request_id in self.outputs:
        rows.append(styled("output: ", "bold green") + self.outputs[request_id][-400:])
      rows.append("")
    return "\n".join(rows) if rows else styled("no requests yet", "dim")
