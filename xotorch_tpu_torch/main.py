"""The port's CLI: a peer of the token ring that serves OpenAI chat completions, or runs
one completion.

    python -m xotorch_tpu_torch.main [--device cuda|cpu] [--chatgpt-api-port N]
    python -m xotorch_tpu_torch.main run synthetic-llama-1b --prompt "..."
    python -m xotorch_tpu_torch.main --quantize int4   # or int8: quantized weights
    python -m xotorch_tpu_torch.main --kv-quantize int8  # int8 KV cache
    python -m xotorch_tpu_torch.main run gemma2-2b --models-seed-dir /data/seed

A card other than a synthetic one serves the HF checkpoint in
`XOT_HOME/models/<org>--<name>` (XOT_HOME defaults to `~/.xot_tpu`; `--models-seed-dir`
moves prepared directories there first). Fetching a checkpoint over the network is
not ported yet: the directory must hold config.json, a tokenizer file and the
safetensors files of the peer's layers.

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
"""
from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys
import time
import uuid

from xotorch_tpu_torch import VERSION
from xotorch_tpu_torch.api.chatgpt_api import ChatGPTAPI
from xotorch_tpu_torch.download.hf_shard_download import HFShardDownloader, seed_models
from xotorch_tpu_torch.inference.engine import get_inference_engine
from xotorch_tpu_torch.models.registry import build_base_shard
from xotorch_tpu_torch.networking.tcp import TCPPeerHandle, TCPServer
from xotorch_tpu_torch.orchestration.node import Node
from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy
from xotorch_tpu_torch.utils.helpers import DEBUG, find_available_port


def build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(prog="xot-torch",
                                   description="xotorch_tpu_torch: the PyTorch/CUDA port of xot")
  parser.add_argument("command", nargs="?", choices=["run"], help="one-shot command")
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
  parser.add_argument("--inference-engine", type=str, default="torch")
  parser.add_argument("--chatgpt-api-host", type=str, default="0.0.0.0")
  parser.add_argument("--chatgpt-api-port", type=int, default=52415)
  parser.add_argument("--chatgpt-api-response-timeout", type=int, default=90)
  parser.add_argument("--max-generate-tokens", type=int, default=1024)
  parser.add_argument("--default-temp", type=float, default=0.6)
  parser.add_argument("--default-top-k", type=int, default=35)
  parser.add_argument("--system-prompt", type=str, default=None)
  parser.add_argument("--default-model", type=str, default=None)
  parser.add_argument("--prompt", type=str, default="Who are you?")
  parser.add_argument("--models-seed-dir", type=str, default=None,
                      help="move the model dirs in this directory into XOT_HOME/models first")
  parser.add_argument("--quantize", type=str, default=None, choices=["int8", "int4"],
                      help="weight-only quantization of the served model (as XOT_QUANTIZE)")
  parser.add_argument("--kv-quantize", type=str, default=None, choices=["int8"],
                      help="int8 KV cache with a scale per (position, head) (as XOT_KV_QUANT)")
  return parser


def build_node(args) -> tuple:
  """Engine, node (with its TCP server and discovery, not started) and API for `args`;
  the engine raises here when the device is missing."""
  engine = get_inference_engine(args.inference_engine, HFShardDownloader(), device=args.device,
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
  node = Node(node_id, None, engine, discovery, RingMemoryWeightedPartitioningStrategy(),
              max_generate_tokens=args.max_generate_tokens,
              default_sample_temp=args.default_temp,
              default_sample_top_k=args.default_top_k)
  node.server = TCPServer(node, args.node_host, node_port)
  api = ChatGPTAPI(node, engine_classname, response_timeout=args.chatgpt_api_response_timeout,
                   default_model=args.default_model, system_prompt=args.system_prompt)
  return node, engine, engine_classname, api


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
    if args.command == "run":
      await run_model_cli(node, engine_classname, args.model_name or args.default_model
                          or "synthetic-llama-1b", args.prompt)
      return
    server = await api.start(args.chatgpt_api_host, args.chatgpt_api_port)
    async with server:
      await server.serve_forever()
  finally:
    if DEBUG >= 1:
      print(f"wire {node.id}: {json.dumps(wire_counts(node))}", flush=True)
    await node.stop()
    engine.executor.shutdown(wait=False)


def run() -> None:
  args = build_parser().parse_args()
  try:
    asyncio.run(async_main(args))
  except (KeyboardInterrupt, asyncio.CancelledError):
    pass


if __name__ == "__main__":
  run()
