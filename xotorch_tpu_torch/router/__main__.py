"""CLI: `python -m xotorch_tpu_torch.router`, the front door over port replicas.

  python -m xotorch_tpu_torch.router --port 52400 \\
      --replica http://127.0.0.1:52415 --replica http://127.0.0.1:52416
  python -m xotorch_tpu_torch.router --port 52400 --fleet-template fleet.json

Each --replica is one independent ring's OpenAI API base URL (any node of it). With
--fleet-template the replica set comes from a fleet template (fleet/__init__.py) and the
router runs the elastic controller: it respawns a replica that died, scales up on
fleet-wide queue pressure and retires idle spares through the drain path, its
actuation gated by the XOT_FLEET_LEASE_PATH lease when several routers share one
template (the replicas it starts outlive the router; their pids are in the template's
`.pids` sidecar). The router serves /v1/chat/completions with affinity placement and spill,
drains replicas on their own firing alerts, probes them back with canaries, chains
requests through prefill-role replicas (XOT_FABRIC_ROLE=prefill), optionally hedges
(XOT_ROUTER_HEDGE_PCT), and reports at /v1/router. Its knobs are XOT_ROUTER_* and
XOT_FLEET_* (utils/knobs.py).
"""
from __future__ import annotations

import argparse
import asyncio
import signal
import sys


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(
    prog="python -m xotorch_tpu_torch.router",
    description="OpenAI-compatible front door over N independent ring replicas: affinity "
                "and load routing, admission-aware spill, alert-driven drain/probe/readmit, "
                "prefill/decode chaining, elastic fleet control, hedging.")
  parser.add_argument("--replica", action="append", default=None,
                      help="replica API base URL (repeatable, one per ring); not needed with "
                           "--fleet-template")
  parser.add_argument("--fleet-template", default=None,
                      help="fleet template JSON: the slots the elastic controller may "
                           "spawn and retire (enables the controller)")
  parser.add_argument("--router-id", default="router",
                      help="this router's identity for the actuation lease and its flight "
                           "recorder (unique per router when several share a template)")
  parser.add_argument("--host", default="0.0.0.0")
  parser.add_argument("--port", type=int, default=52400)
  args = parser.parse_args(argv)
  if not args.replica and not args.fleet_template:
    parser.error("need --replica (repeatable) or --fleet-template")

  from xotorch_tpu_torch.router.app import RouterApp

  async def run():
    router = RouterApp(args.replica or [], fleet_template=args.fleet_template,
                       router_id=args.router_id)
    await router.run(host=args.host, port=args.port)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
      loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await router.stop()

  asyncio.run(run())
  return 0


if __name__ == "__main__":
  sys.exit(main())
