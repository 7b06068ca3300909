"""The port's CLI: a peer of the token ring that serves OpenAI chat completions, or runs
one completion.

    python -m xotorch_tpu_torch.main [--device cuda|cpu] [--chatgpt-api-port N]
    python -m xotorch_tpu_torch.main run synthetic-llama-1b --prompt "..."
    python -m xotorch_tpu_torch.main --quantize int4   # or int8: quantized weights
    python -m xotorch_tpu_torch.main --kv-quantize int8  # int8 KV cache
    python -m xotorch_tpu_torch.main --adapters fin=/a/fin.safetensors,med=/a/med_dir
        # multi-LoRA: requests name "<model>@fin" or "<model>@med" over one base
    python -m xotorch_tpu_torch.main run gemma2-2b --models-seed-dir /data/seed
    python -m xotorch_tpu_torch.main run dummy --inference-engine dummy   # no model, no device
    python -m xotorch_tpu_torch.main --inference-engine native   # the C++ sidecar (native/)
    python -m xotorch_tpu_torch.main --chat-tui --default-model llama-3.2-1b  # chat in the terminal
    python -m xotorch_tpu_torch.main --serve-tp 2 [--serve-sp 2] [--serve-ep 2]
        # one peer over a mesh of its local cards (parallel/mesh.py); XOT_VIRTUAL_DEVICES=N
        # repeats one card N times instead
    python -m xotorch_tpu_torch.main train synthetic-llama-1b --iters 8 --batch-size 4 \\
        --save-every 4 --save-checkpoint-dir ckpt [--lora-rank 8] [--quantize int8]
    python -m xotorch_tpu_torch.main train synthetic-llama-1b --iters 8 --batch-size 4 \\
        --resume-checkpoint ckpt/synthetic-llama-1b/0-15-4.safetensors
    python -m xotorch_tpu_torch.main eval synthetic-llama-1b --batch-size 4
    python -m xotorch_tpu_torch.main train synthetic-llama-1b --serve-tp 2 --lora-rank 8 ...
        # train, eval, checkpoints and adapters over the peer's mesh, as JAX's main
        # sets the mesh knobs for every command

A card other than a synthetic one serves the HF checkpoint in
`XOT_HOME/models/<org>--<name>` (XOT_HOME defaults to `~/.xot_tpu`; `--models-seed-dir`
moves prepared directories there first); the files of the peer's layers that are not
there are fetched from `HF_ENDPOINT` (download/hf_shard_download.py), and every
peer's download progress goes to the others over the status bus, at most 5 times a
second but always the last event. When a peer starts a prompt, every other peer loads
its own layers of that model at once.

The topology TUI (viz/topology_viz.py) draws the ring on a terminal unless
`--disable-tui` or `--chat-tui` is given (on a pipe it writes its last frame once, at
exit); `--chat-tui` chats on the terminal instead of serving the API.
`--draft-model` names the speculative draft model (as XOT_DRAFT_MODEL); `--run-gc` is
accepted and does nothing, as in the JAX package.

The names and defaults follow xotorch_tpu/main.py. A peer finds the others by UDP
broadcast (`--discovery-module udp`, the default) or from a JSON file
(`--discovery-module manual --discovery-config-path peers.json`, the schema of
networking/manual/network_topology_config.py), talks to them over TCP on
`--node-port`, and takes its share of the model's layers by accelerator memory. Two
peers on one machine:

    python -m xotorch_tpu_torch.main --node-id b --node-port 50051 --chatgpt-api-port 52415 \\
        --discovery-module manual --discovery-config-path peers.json --wait-for-peers 1
    python -m xotorch_tpu_torch.main --node-id a --node-port 50052 --chatgpt-api-port 52416 \\
        --discovery-module manual --discovery-config-path peers.json --wait-for-peers 1

Every peer runs on `cuda` by default; with no GPU the engine raises unless
`--device cpu` is given.

`train` and `eval` (JAX's commands, flags and defaults) read `--data`
(`train.jsonl` / `test.jsonl` with a "text" field a line; the port's own copy of the
repo's small set by default) and send each batch through the ring
(`Node.enqueue_example`); `train` steps AdamW at XOT_LR (default 1e-5) and every
`--save-every` steps saves each peer's shard under
`--save-checkpoint-dir/<model>/<start>-<end>-<iteration>.safetensors`, the moments
beside it. `--resume-checkpoint` loads a save on every peer first and, where it names
the iteration (a shard save or a directory of them), goes on from the batch after it
(the JAX command restarts at batch 0): `--iters` counts the steps from the start.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import time
import uuid
from pathlib import Path
from typing import Optional

from xotorch_tpu_torch import VERSION
from xotorch_tpu_torch.api.chatgpt_api import ChatGPTAPI
from xotorch_tpu_torch.download.hf_shard_download import HFShardDownloader, seed_models
from xotorch_tpu_torch.download.shard_download import NoopShardDownloader
from xotorch_tpu_torch.inference.engine import get_inference_engine, inference_engine_classes
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models.registry import build_base_shard, get_repo
from xotorch_tpu_torch.networking.tcp import TCPPeerHandle, TCPServer
from xotorch_tpu_torch.orchestration.node import Node
from xotorch_tpu_torch.parallel.multihost import init_multihost, multihost_requested
from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy
from xotorch_tpu_torch.train.dataset import DEFAULT_DATA
from xotorch_tpu_torch.utils.helpers import DEBUG, find_available_port, get_all_ip_addresses_and_interfaces

# The download-progress broadcast's least interval (s): at most 5 a second.
PROGRESS_INTERVAL_S = 0.2


def build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(prog="xot-torch",
                                   description="xotorch_tpu_torch: the PyTorch/CUDA port of xot")
  parser.add_argument("command", nargs="?", choices=["run", "eval", "train"], help="one-shot command")
  parser.add_argument("model_name", nargs="?", help="model id (see models registry)")
  parser.add_argument("--version", action="version", version=f"xot-torch {VERSION}")
  parser.add_argument("--node-id", type=str, default=None)
  parser.add_argument("--node-host", type=str, default="0.0.0.0")
  parser.add_argument("--node-port", type=int, default=None)
  parser.add_argument("--listen-port", type=int, default=5678, help="UDP discovery listen port")
  parser.add_argument("--broadcast-port", type=int, default=5678)
  parser.add_argument("--discovery-module", type=str, choices=["udp", "manual"], default="udp")
  parser.add_argument("--discovery-timeout", type=int, default=30)
  parser.add_argument("--discovery-config-path", type=str, default=None)
  parser.add_argument("--wait-for-peers", type=int, default=0)
  parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
  parser.add_argument("--inference-engine", type=str, default="torch",
                      help="torch | native (sidecar) | dummy")
  parser.add_argument("--chatgpt-api-host", type=str, default="0.0.0.0")
  parser.add_argument("--chatgpt-api-port", type=int, default=52415)
  parser.add_argument("--chatgpt-api-response-timeout", type=int, default=90)
  parser.add_argument("--max-generate-tokens", type=int, default=1024)
  parser.add_argument("--default-temp", type=float, default=0.6)
  parser.add_argument("--default-top-k", type=int, default=35)
  parser.add_argument("--system-prompt", type=str, default=None)
  parser.add_argument("--default-model", type=str, default=None)
  parser.add_argument("--disable-tui", action="store_true", help="do not draw the topology TUI")
  parser.add_argument("--chat-tui", action="store_true",
                      help="chat on the terminal with live tok/s instead of serving the API")
  parser.add_argument("--prompt", type=str, default="Who are you?")
  parser.add_argument("--run-gc", action="store_true",
                      help="accepted for the JAX package's command line; does nothing")
  parser.add_argument("--draft-model", type=str, default=None,
                      help="model id to greedy-draft speculative tokens with (sharing the "
                           "target's tokenizer); implies speculation on (as XOT_DRAFT_MODEL)")
  parser.add_argument("--models-seed-dir", type=str, default=None,
                      help="move the model dirs in this directory into XOT_HOME/models first")
  parser.add_argument("--quantize", type=str, default=None, choices=["int8", "int4"],
                      help="weight-only quantization of the served model (as XOT_QUANTIZE)")
  parser.add_argument("--kv-quantize", type=str, default=None, choices=["int8"],
                      help="int8 KV cache with a scale per (position, head) (as XOT_KV_QUANT)")
  parser.add_argument("--lora-rank", type=int, default=0,
                      help="attach rank-r LoRA adapters to every loaded model (as XOT_LORA_RANK)")
  parser.add_argument("--adapters", type=str, default=None,
                      help="multi-LoRA serving registry: 'name=/path/to/adapter,name2=/dir'. "
                           "Requests select an adapter via the model id 'base@name'; all "
                           "adapters share one resident base (as XOT_ADAPTERS)")
  parser.add_argument("--serve-tp", type=int, default=None,
                      help="tensor-parallel width over this peer's local devices (default: every "
                           "local card when there are several; 0/1 disables; as XOT_SERVE_TP)")
  parser.add_argument("--serve-sp", type=int, default=None,
                      help="sequence-parallel width for long-prompt prefill: the from-zero "
                           "segment ring-attends over this many local devices (composes with "
                           "--serve-tp; power of two; as XOT_SERVE_SP)")
  parser.add_argument("--serve-ep", type=int, default=None,
                      help="expert-parallel width for MoE models: expert weights distribute "
                           "over this many local devices, each computing its resident experts "
                           "(composes with --serve-tp; must divide the expert count; as "
                           "XOT_SERVE_EP)")
  # train and eval (JAX's flags and defaults; --data defaults to the port's own copy)
  parser.add_argument("--data", type=str, default=DEFAULT_DATA)
  parser.add_argument("--iters", type=int, default=100)
  parser.add_argument("--batch-size", type=int, default=1)
  parser.add_argument("--sequence-length", type=int, default=512)
  parser.add_argument("--save-every", type=int, default=5)
  parser.add_argument("--save-checkpoint-dir", type=str, default="checkpoints")
  parser.add_argument("--resume-checkpoint", type=str, default=None)
  return parser


def build_node(args) -> tuple:
  """Engine, node (with its TCP server and discovery, not started) and API for `args`;
  the engine raises here when the device is missing. `--lora-rank`, `--adapters`,
  `--draft-model` and `--serve-tp/-sp/-ep` go to the environment (XOT_LORA_RANK,
  XOT_ADAPTERS, XOT_DRAFT_MODEL, XOT_SERVE_TP/SP/EP), where the engine reads them when it
  is built or loads a shard and the registry and the API when they resolve an adapter
  id. When the launcher gives a process group (XOT_COORDINATOR or XOT_MULTIHOST), this
  process joins it before any device use (parallel/multihost.py); its engine then
  serves over its own local devices and its Node is a peer of its own, as every rank of
  JAX's main.py is. The node's topology TUI (not started), when there is one, is
  `node.topology_viz`."""
  if getattr(args, "lora_rank", 0):
    os.environ["XOT_LORA_RANK"] = str(args.lora_rank)
  if getattr(args, "adapters", None):
    os.environ["XOT_ADAPTERS"] = args.adapters
  if getattr(args, "draft_model", None):
    os.environ["XOT_DRAFT_MODEL"] = args.draft_model
  for flag, knob in (("serve_tp", "XOT_SERVE_TP"), ("serve_sp", "XOT_SERVE_SP"),
                     ("serve_ep", "XOT_SERVE_EP")):
    if getattr(args, flag, None) is not None:
      os.environ[knob] = str(getattr(args, flag))
  if multihost_requested():
    n_proc, rank = init_multihost()
    print(f"multi-host: process {rank}/{n_proc}", flush=True)
  is_dummy = inference_engine_classes.get(args.inference_engine) == "DummyInferenceEngine"
  downloader = NoopShardDownloader() if is_dummy else HFShardDownloader()
  engine = get_inference_engine(args.inference_engine, downloader, device=args.device,
                                quantize=getattr(args, "quantize", None),
                                kv_quant=getattr(args, "kv_quantize", None))
  engine_classname = type(engine).__name__
  node_id = args.node_id or str(uuid.uuid4())
  node_port = args.node_port or find_available_port()
  if args.discovery_module == "udp":
    from xotorch_tpu_torch.networking.udp.discovery import UDPDiscovery
    discovery = UDPDiscovery(node_id, node_port, args.listen_port, args.broadcast_port,
                             TCPPeerHandle, discovery_timeout=args.discovery_timeout)
  else:
    from xotorch_tpu_torch.networking.manual.discovery import ManualDiscovery
    if not args.discovery_config_path:
      raise SystemExit("--discovery-config-path is required with --discovery-module manual")
    discovery = ManualDiscovery(args.discovery_config_path, node_id, TCPPeerHandle)
  # The chat TUI owns the terminal: the topology TUI is not drawn under it.
  topology_viz = None
  if not getattr(args, "disable_tui", False) and not getattr(args, "chat_tui", False):
    from xotorch_tpu_torch.viz.topology_viz import TopologyViz
    ips = [ip for ip, _ in get_all_ip_addresses_and_interfaces()][:2]
    topology_viz = TopologyViz(
      chatgpt_api_endpoints=[f"http://{ip}:{args.chatgpt_api_port}/v1/chat/completions" for ip in ips],
      web_chat_urls=[f"http://{ip}:{args.chatgpt_api_port}" for ip in ips])
  node = Node(node_id, None, engine, discovery, RingMemoryWeightedPartitioningStrategy(),
              max_generate_tokens=args.max_generate_tokens,
              default_sample_temp=args.default_temp,
              default_sample_top_k=args.default_top_k,
              shard_downloader=downloader, topology_viz=topology_viz)
  node.server = TCPServer(node, args.node_host, node_port)
  api = ChatGPTAPI(node, engine_classname, response_timeout=args.chatgpt_api_response_timeout,
                   default_model=args.default_model, system_prompt=args.system_prompt,
                   on_chat_completion_request=None if topology_viz is None else (
                     lambda rid, _body, prompt: topology_viz.update_prompt(rid, prompt)))
  wire_events(node, engine, downloader)
  return node, engine, engine_classname, api


def wire_events(node: Node, engine, downloader) -> None:
  """The status bus's two uses in a peer (JAX main's `_wire_events`): when another peer
  starts a prompt, this one loads its own layers of that model at once (the preemptive
  shard load); and the downloader's progress goes to every peer as `download_progress`,
  at most every PROGRESS_INTERVAL_S, the final event always."""
  def on_opaque_status(request_id: str, status: str) -> None:
    try:
      data = json.loads(status)
      if (data.get("type") == "node_status" and data.get("status") == "start_process_prompt"
          and data.get("node_id") != node.id):
        current = node.get_current_shard(Shard.from_dict(data.get("base_shard", {})))
        node._spawn(engine.ensure_shard(current))
    except Exception as e:  # a malformed status never breaks the bus
      if DEBUG >= 2:
        print(f"preemptive load error: {e!r}")

  node.on_opaque_status.register("main-preemptive-load").on_next(on_opaque_status)
  last = {"t": float("-inf")}

  def on_progress(shard, event) -> None:
    now = time.monotonic()
    if now - last["t"] < PROGRESS_INTERVAL_S and not event.is_complete:
      return
    last["t"] = now
    node._spawn(node.broadcast_opaque_status("", json.dumps({
      "type": "download_progress", "node_id": node.id, "progress": event.to_dict()})))

  downloader.on_progress.register("main-progress").on_next(on_progress)


async def run_model_cli(node: Node, engine_classname: str, model_name: str, prompt: str) -> list:
  """One completion of `prompt`, printed; returns the tokens."""
  shard = build_base_shard(model_name, engine_classname)
  if shard is None:
    raise SystemExit(f"Error: unsupported model '{model_name}' for engine {engine_classname}")
  request_id = str(uuid.uuid4())
  done = asyncio.Event()
  out = {"tokens": []}

  def on_token(req_id, tokens, is_finished):
    if req_id == request_id:
      out["tokens"] = list(tokens)
      if is_finished:
        done.set()

  node.on_token.register("cli-wait-response").on_next(on_token)
  started = time.monotonic()
  await node.process_prompt(shard, prompt, request_id)
  await asyncio.wait_for(done.wait(), timeout=300)
  elapsed = time.monotonic() - started
  error = node.request_errors.pop(request_id, None)
  if error is not None:
    raise SystemExit(f"Error: {error}")
  tokens = out["tokens"]
  print(node.inference_engine.tokenizer.decode(tokens))
  print(f"\n[{len(tokens)} tokens in {elapsed:.1f}s = {len(tokens) / max(elapsed, 1e-9):.1f} tok/s]",
        file=sys.stderr)
  return tokens


async def resolve_cli_tokenizer(model_name: str, engine_classname: str):
  """The tokenizer of the train and eval commands: the fake for synthetic cards and the
  dummy model (they never touch a checkpoint), else the model directory's own."""
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer, resolve_tokenizer
  if model_name.startswith("synthetic") or model_name == "dummy":
    return DummyTokenizer()
  return await resolve_tokenizer(get_repo(model_name, engine_classname))


def resumed_iteration(path: Optional[str]) -> int:
  """The iteration a resume checkpoint was saved at: a shard save's own
  (`<start>-<end>-<iteration>[-opt].safetensors`), the latest shard save's in a
  directory, else 0."""
  from xotorch_tpu_torch.train.lora import SHARD_SAVE_RE
  if not path:
    return 0
  p = Path(path)
  files = sorted(p.glob("*.safetensors")) if p.is_dir() else [p]
  its = [int(m.group(3)) for f in files
         if (m := SHARD_SAVE_RE.fullmatch(f.name[:-len(".safetensors")].removesuffix("-opt")))]
  return max(its, default=0)


async def train_model_cli(node: Node, engine_classname: str, model_name: str, args) -> list:
  """The train command: (iteration, loss) of each step, printed as it goes."""
  from xotorch_tpu_torch.train.dataset import iterate_batches, load_dataset
  shard = build_base_shard(model_name, engine_classname)
  if shard is None:
    raise SystemExit(f"Error: unsupported model '{model_name}' for engine {engine_classname}")
  train_set, _, _ = load_dataset(args.data)
  tokenizer = await resolve_cli_tokenizer(model_name, engine_classname)
  start = 0
  if args.resume_checkpoint:
    # Every peer loads its own layer range before the first step.
    await node.coordinate_resume(shard, args.resume_checkpoint)
    start = resumed_iteration(args.resume_checkpoint)
  losses = []
  for it, (inputs, targets, lengths) in enumerate(
      iterate_batches(train_set, tokenizer, args.batch_size, args.sequence_length)):
    if it >= args.iters:
      break
    if it < start:
      continue  # the resumed checkpoint's steps
    loss, _ = await node.enqueue_example(shard, inputs, targets, lengths, train=True)
    losses.append((it + 1, loss))
    print(f"iter {it}: loss={loss:.4f}", flush=True)
    if args.save_every > 0 and (it + 1) % args.save_every == 0:
      await node.coordinate_save(shard, it + 1, args.save_checkpoint_dir)
  return losses


async def eval_model_cli(node: Node, engine_classname: str, model_name: str, args) -> Optional[float]:
  """The eval command: the test split's mean loss, printed."""
  from xotorch_tpu_torch.train.dataset import iterate_batches, load_dataset
  shard = build_base_shard(model_name, engine_classname)
  if shard is None:
    raise SystemExit(f"Error: unsupported model '{model_name}' for engine {engine_classname}")
  _, _, test_set = load_dataset(args.data)
  tokenizer = await resolve_cli_tokenizer(model_name, engine_classname)
  losses = []
  for inputs, targets, lengths in iterate_batches(test_set, tokenizer, args.batch_size,
                                                  args.sequence_length):
    loss, _ = await node.enqueue_example(shard, inputs, targets, lengths, train=False)
    losses.append(loss)
  if not losses:
    return None
  mean = sum(losses) / len(losses)
  print(f"eval loss: {mean:.4f} over {len(losses)} batches", flush=True)
  return mean


def wire_counts(node: Node) -> dict:
  """What this node sent over TCP, by method: {method: [calls, bytes sent, bytes
  received]}, summed over its peers."""
  total: dict = {}
  for peer in node.peers:
    for method, counts in getattr(peer, "wire", {}).items():
      row = total.setdefault(method, [0, 0, 0])
      for i, c in enumerate(counts):
        row[i] += c
  return total


def kernel_launches() -> dict:
  """Each counted kernel wrapper's launches in this process, by name (0 on the CPU, where
  no kernel launches)."""
  from xotorch_tpu_torch.models import graphs
  return {fn.__name__: fn.launches for fn in graphs.counted_wrappers()}


def decode_steps(engine) -> int:
  """The decode steps the engine's batchers ran, over every model context (each step
  launches K2, or K3 on the page pool, once a layer)."""
  return sum(c.batcher.steps for c in engine._contexts.values() if c.batcher is not None)


async def async_main(args) -> None:
  if args.models_seed_dir:
    # Before anything resolves a model, so that ensure_shard's offline fast path and
    # the tokenizer find the seeded dirs.
    await seed_models(args.models_seed_dir)
  node, engine, engine_classname, api = build_node(args)
  main_task = asyncio.current_task()
  loop = asyncio.get_running_loop()
  for sig in (signal.SIGINT, signal.SIGTERM):
    loop.add_signal_handler(sig, main_task.cancel)
  try:
    await node.start(wait_for_peers=args.wait_for_peers)
    if node.topology_viz is not None:
      node.topology_viz.start()
    if args.chat_tui:
      from xotorch_tpu_torch.viz.chat_tui import run_chat_tui
      model = args.model_name or args.default_model or "llama-3.2-1b"
      await run_chat_tui(node, engine_classname, model, await resolve_cli_tokenizer(model, engine_classname))
      return
    if args.command == "run":
      await run_model_cli(node, engine_classname, args.model_name or args.default_model
                          or "synthetic-llama-1b", args.prompt)
      return
    if args.command == "train":
      await train_model_cli(node, engine_classname, args.model_name or "synthetic-tiny", args)
      return
    if args.command == "eval":
      await eval_model_cli(node, engine_classname, args.model_name or "synthetic-tiny", args)
      return
    server = await api.start(args.chatgpt_api_host, args.chatgpt_api_port)
    async with server:
      await server.serve_forever()
  finally:
    if DEBUG >= 1:
      print(f"wire {node.id}: {json.dumps(wire_counts(node))}", flush=True)
      if engine_classname == "TorchShardInferenceEngine":
        print(f"launches {node.id}: {json.dumps(kernel_launches())}", flush=True)
        print(f"decode steps {node.id}: {decode_steps(engine)}", flush=True)
    node.spool_flight(reason="shutdown")  # XOT_FLIGHT_DUMP_DIR, when set
    if node.topology_viz is not None:
      node.topology_viz.stop()
    await node.stop()
    stop = getattr(engine, "stop", None)  # the native engine's sidecar process
    if stop is not None:
      await stop()
    executor = getattr(engine, "executor", None)  # the dummy engine has none
    if executor is not None:
      executor.shutdown(wait=False)


def run() -> None:
  args = build_parser().parse_args()
  try:
    asyncio.run(async_main(args))
  except (KeyboardInterrupt, asyncio.CancelledError):
    pass


if __name__ == "__main__":
  run()
