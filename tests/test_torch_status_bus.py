"""The status bus between the port's peers and the command line around it, against
the JAX package: two dummy-engine peers built by main.build_node talk over the TCP
transport, where a peer that starts a prompt makes the other load its own layers at
once (the preemptive load) and a peer's download progress reaches the other's
`node_download_progress`, thinned to 5 a second and the final event always. Then
`--chat-tui` over the dummy engine, fed stdin lines, against JAX's chat TUI; and every
flag of JAX's parser (an ast walk of xotorch_tpu/main.py) accepted by the port's.
"""
import ast
import asyncio
import builtins
import json
import re
import time
from pathlib import Path

import pytest

from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.download.download_progress import RepoProgressEvent
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.utils.helpers import find_available_port

ROOT = Path(__file__).resolve().parent.parent
CAPS = {"model": "cpu", "chip": "cpu", "memory": 1024, "flops": {"fp32": 1, "fp16": 2, "int8": 4}}


def _config(tmp_path, ids):
  ports = {i: find_available_port("127.0.0.1") for i in ids}
  path = tmp_path / "peers.json"
  path.write_text(json.dumps({"peers": {
    i: {"address": "127.0.0.1", "port": p, "device_capabilities": CAPS} for i, p in ports.items()}}))
  return ports, path


def _args(i, port, path, *extra):
  return port_main.build_parser().parse_args(
    ["--inference-engine", "dummy", "--node-id", i, "--node-host", "127.0.0.1",
     "--node-port", str(port), "--discovery-module", "manual", "--discovery-config-path", str(path),
     "--default-temp", "0", *extra])


async def _pair(tmp_path):
  ports, path = _config(tmp_path, ("b", "a"))
  built = {i: port_main.build_node(_args(i, ports[i], path)) for i in ports}
  for node, *_ in built.values():
    node.discovery.poll_interval = 0.05
  await asyncio.gather(*(built[i][0].start(wait_for_peers=1) for i in built))
  return built


async def test_a_prompt_makes_the_other_peer_load_its_layers(tmp_path):
  built = await _pair(tmp_path)
  nodes = {i: b[0] for i, b in built.items()}
  try:
    loads = {i: [] for i in nodes}
    for i, (_, engine, *_rest) in built.items():
      real = engine.ensure_shard

      async def record(shard, i=i, real=real):
        loads[i].append(shard)
        return await real(shard)
      engine.ensure_shard = record
    base = Shard("dummy", 0, 0, 8)
    a_shard = nodes["a"].get_current_shard(base)
    b_shard = nodes["b"].get_current_shard(base)
    assert (b_shard.start_layer, a_shard.end_layer) == (0, 7) and b_shard != a_shard
    # "a" announces a prompt alone: "b" loads its own range; "a" loads nothing of it.
    await nodes["a"].broadcast_opaque_status("r0", json.dumps({
      "type": "node_status", "node_id": "a", "status": "start_process_prompt",
      "base_shard": base.to_dict(), "request_id": "r0"}))
    for _ in range(100):
      if loads["b"]:
        break
      await asyncio.sleep(0.02)
    assert loads == {"b": [b_shard], "a": []}
    assert nodes["b"].topology.active_node_id == "a" == nodes["a"].topology.active_node_id
    # A real prompt broadcasts its start and end: each peer names the active node, then
    # none; the other peer's TUI (not drawn) holds the model's depth.
    done = asyncio.Event()
    nodes["a"].on_token.register("t").on_next(lambda rid, toks, fin: fin and rid == "r1" and done.set())
    await nodes["a"].process_prompt(base, "one two three", "r1")
    await asyncio.wait_for(done.wait(), 30)
    assert nodes["b"].topology_viz.model_layers == 8 and nodes["b"].topology_viz.model_id == "dummy"
    for _ in range(100):
      if nodes["b"].topology.active_node_id is None:
        break
      await asyncio.sleep(0.02)
    assert nodes["b"].topology.active_node_id is None
  finally:
    for node in nodes.values():
      await node.stop()


async def test_download_progress_is_thinned_and_reaches_the_peer(tmp_path):
  built = await _pair(tmp_path)
  nodes = {i: b[0] for i, b in built.items()}
  try:
    seen = []
    nodes["b"].on_opaque_status.register("t").on_next(
      lambda rid, s: json.loads(s).get("type") == "download_progress" and seen.append(json.loads(s)))
    downloader = nodes["a"].shard_downloader
    shard = Shard("dummy", 0, 3, 8)
    for k in range(1, 51):  # a burst well inside one 0.2 s interval
      downloader.on_progress.trigger_all(shard, RepoProgressEvent("org/m", 0, 2, k, 100, 1.0, "in_progress"))
    await asyncio.sleep(0.3)
    downloader.on_progress.trigger_all(shard, RepoProgressEvent("org/m", 1, 2, 60, 100, 1.0, "in_progress"))
    downloader.on_progress.trigger_all(shard, RepoProgressEvent("org/m", 2, 2, 100, 100, 1.0, "complete"))
    for _ in range(100):
      if nodes["b"].node_download_progress.get("a", {}).get("status") == "complete":
        break
      await asyncio.sleep(0.02)
    assert [(s["progress"]["downloaded_bytes"], s["progress"]["status"]) for s in seen] == [
      (1, "in_progress"), (60, "in_progress"), (100, "complete")]
    assert nodes["b"].node_download_progress["a"] == seen[-1]["progress"]
    assert nodes["a"].node_download_progress["a"] == seen[-1]["progress"]  # its own echo
  finally:
    for node in nodes.values():
      await node.stop()


def _fed(monkeypatch, lines):
  feed = iter(lines)

  def fake_input(prompt=""):
    try:
      return next(feed)
    except StopIteration:
      raise EOFError from None
  monkeypatch.setattr(builtins, "input", fake_input)


async def _jax_chat(lines, monkeypatch, capsys):
  from xotorch_tpu.inference.dummy import DummyInferenceEngine as JDummy
  from xotorch_tpu.inference.tokenizers import DummyTokenizer as JDummyTokenizer
  from xotorch_tpu.viz.chat_tui import run_chat_tui as j_run_chat_tui
  from tests.test_orchestration import _make_node
  node = await _make_node("chat", JDummy(), default_sample_temp=0.0)
  node.topology.update_node("chat", node.device_capabilities)
  _fed(monkeypatch, lines)
  await j_run_chat_tui(node, "DummyInferenceEngine", "dummy", JDummyTokenizer())
  await node.stop()
  return capsys.readouterr().out


@pytest.mark.parametrize("lines", [["hello there", "", "and again", "exit"], ["one", "quit", "never"],
                                   ["only line"]], ids=["exit", "quit", "eof"])
async def test_chat_tui_over_the_dummy_engine_matches_jax(tmp_path, monkeypatch, capsys, lines):
  """`main.py --chat-tui` reads stdin lines until `exit`, `quit` or EOF: each non-empty
  line is a turn whose reply streams and ends in `[n tokens, r tok/s]`; the turns and
  token counts are JAX's."""
  ports, path = _config(tmp_path, ("chat",))
  args = _args("chat", ports["chat"], path, "--chat-tui", "--default-model", "dummy")
  _fed(monkeypatch, lines)
  await port_main.async_main(args)
  port = capsys.readouterr().out
  jax_ = await _jax_chat(lines, monkeypatch, capsys)
  turns = lambda out: re.findall(r"\[(\d+) tokens, [\d.]+ tok/s\]", out)  # noqa: E731
  want = [s for s in lines[:next((k for k, s in enumerate(lines) if s in ("exit", "quit")), len(lines))] if s]
  assert turns(port) == turns(jax_) and len(turns(port)) == len(want)
  assert "Chatting with dummy. Ctrl-D or 'exit' to quit." in port
  assert "dummy" in port.split("quit.", 1)[1]


def _jax_flags():
  """Every option string JAX's build_parser adds, from an ast walk of its main.py."""
  tree = ast.parse((ROOT / "xotorch_tpu" / "main.py").read_text())
  flags = set()
  for node in ast.walk(tree):
    if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
        and node.args and isinstance(node.args[0], ast.Constant)):
      flags.add(node.args[0].value)
  return flags


def test_every_flag_of_jaxs_parser_is_the_ports():
  flags = _jax_flags()
  assert {"--disable-tui", "--chat-tui", "--draft-model", "--run-gc", "command", "model_name"} <= flags
  parser = port_main.build_parser()
  port_flags = {s for a in parser._actions for s in a.option_strings} | {
    a.dest for a in parser._actions if not a.option_strings}
  assert sorted(flags - port_flags) == []
  args = parser.parse_args(["--disable-tui", "--chat-tui", "--run-gc", "--draft-model", "llama-3.2-1b",
                            "--inference-engine", "native"])
  assert (args.disable_tui, args.chat_tui, args.run_gc, args.draft_model, args.inference_engine) == (
    True, True, True, "llama-3.2-1b", "native")


def test_flags_reach_the_node(tmp_path, monkeypatch):
  """--draft-model sets XOT_DRAFT_MODEL (the node reads it when built), --disable-tui and
  --chat-tui build no TUI, --run-gc changes nothing."""
  monkeypatch.setenv("XOT_DRAFT_MODEL", "")  # undone at teardown: build_node sets it
  ports, path = _config(tmp_path, ("n",))
  built = {}
  for extra in ((), ("--disable-tui",), ("--chat-tui",), ("--run-gc", "--draft-model", "dummy")):
    node, *_ = port_main.build_node(_args("n", ports["n"], path, *extra))
    built[extra] = node
  assert built[()].topology_viz is not None
  assert built[("--disable-tui",)].topology_viz is None and built[("--chat-tui",)].topology_viz is None
  assert built[("--run-gc", "--draft-model", "dummy")].draft_model == "dummy"
  assert built[("--run-gc", "--draft-model", "dummy")].speculate_tokens == 8
