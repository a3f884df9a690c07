"""Arm and disarm fault-injection points on a running deployment (a copy
of the JAX package's tools/chaos.py on the port's HTTP client).

Drives a worker system server's /chaos control (resilience/chaos.py):

  # what can be injected, and each point's arm state and counter
  python -m dynamo_tpu_torch.tools.chaos --target 127.0.0.1:9345 list

  # kill the worker's streams after 3 outputs, 20% of requests
  python -m dynamo_tpu_torch.tools.chaos --target 127.0.0.1:9345 \\
      arm kill_worker --probability 0.2 --after 3

  # one-shot stall (disarms itself after firing once)
  python -m dynamo_tpu_torch.tools.chaos --target 127.0.0.1:9345 \\
      arm stall_stream --delay 30 --once

  # stand down (one point, or everything)
  python -m dynamo_tpu_torch.tools.chaos --target 127.0.0.1:9345 \\
      disarm kill_worker
  python -m dynamo_tpu_torch.tools.chaos --target 127.0.0.1:9345 disarm

The injections show on the same server's /metrics as
dynamo_resilience_chaos_injections_total, and the frontend's
dynamo_migration_total / dynamo_resilience_reroute_total show the
recovery machinery absorbing them.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

from dynamo_tpu_torch.frontend.http import HttpClient


async def _req(target: str, method: str, path: str, body=None):
    host, _, port = target.rpartition(":")
    try:
        async with HttpClient(host or "127.0.0.1", int(port)) as c:
            r = await c.request(method, path, json_body=body)
    except (OSError, ValueError, EOFError) as e:
        print(f"cannot reach http://{target}{path}: {e}", file=sys.stderr)
        raise SystemExit(1)
    try:
        payload = json.loads(r.body)
    except ValueError:
        payload = {"raw": r.body.decode(errors="replace")}
    return r.status, payload


def _fmt_point(p: dict) -> str:
    state = "ARMED" if p.get("armed") else "idle "
    extra = []
    if p.get("probability", 1.0) != 1.0:
        extra.append(f"p={p['probability']}")
    if p.get("delay_s"):
        extra.append(f"t={p['delay_s']}s")
    if p.get("after_outputs"):
        extra.append(f"after={p['after_outputs']}")
    if p.get("once"):
        extra.append("once")
    return (f"  {p['name']:<14} [{state}] injected={p['injected_total']}"
            + (("  " + " ".join(extra)) if extra else ""))


async def main_async(args) -> int:
    if args.action == "list":
        status, out = await _req(args.target, "GET", "/chaos")
        if status != 200:
            print(f"error {status}: {out}", file=sys.stderr)
            return 1
        print(f"chaos points on {args.target} "
              f"(worker {out.get('worker_id', '?')}):")
        for p in out.get("points", []):
            print(_fmt_point(p))
        return 0
    if args.action == "arm":
        body = {
            "point": args.point,
            "probability": args.probability,
            "delay_s": args.delay,
            "after_outputs": args.after,
            "once": args.once,
        }
        status, out = await _req(args.target, "POST", "/chaos", body)
        if status != 200:
            print(f"error {status}: {out}", file=sys.stderr)
            return 1
        print("armed:")
        print(_fmt_point(out))
        return 0
    # disarm
    path = "/chaos" + (f"?point={args.point}" if args.point else "")
    status, out = await _req(args.target, "DELETE", path)
    if status != 200:
        print(f"error {status}: {out}", file=sys.stderr)
        return 1
    print("disarmed; current state:")
    for p in out.get("points", []):
        print(_fmt_point(p))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.tools.chaos",
        description="list/arm chaos injection points on a running worker")
    p.add_argument("--target", required=True, metavar="HOST:PORT",
                   help="a worker's system server (--system-port)")
    sub = p.add_subparsers(dest="action", required=True)
    sub.add_parser("list", help="show points, arm state and counters")
    parm = sub.add_parser("arm", help="arm one injection point")
    parm.add_argument("point", choices=(
        "kill_worker", "stall_stream", "drop_response", "delay",
        "kill_store", "partition_store"))
    parm.add_argument("--probability", type=float, default=1.0)
    parm.add_argument("--delay", type=float, default=0.0,
                      help="seconds (stall_stream / delay points)")
    parm.add_argument("--after", type=int, default=0,
                      help="trigger after N outputs (kill/stall)")
    parm.add_argument("--once", action="store_true",
                      help="disarm after the first injection")
    pdis = sub.add_parser("disarm", help="disarm one point (or all)")
    pdis.add_argument("point", nargs="?", default=None)
    args = p.parse_args(argv)
    return asyncio.run(main_async(args))


if __name__ == "__main__":
    raise SystemExit(main())
