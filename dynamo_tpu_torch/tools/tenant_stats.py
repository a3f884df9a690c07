"""Dump a serving process's live tenancy plane (a copy of the JAX
package's tools/tenant_stats.py).

Reads ``GET /debug/tenants`` off a running frontend
(frontend/service.py) or worker system server (runtime/system_server.py)
and prints the per-tenant quota/queue/metric view as JSON — the
operator's answer to "which tenants are on this box, how deep are their
backlogs, and who is eating the 429s":

  python -m dynamo_tpu_torch.tools.tenant_stats --frontend 127.0.0.1:8080
  python -m dynamo_tpu_torch.tools.tenant_stats --frontend 127.0.0.1:8080 \
      --tenant acme

Exit contract (the JAX package's):
  0  tenancy view fetched, at least one tenant observed
  1  endpoint reachable but no tenant has been seen yet (no traffic)
  2  usage error, unknown --tenant, or the endpoint is unreachable
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request


def fetch_view(frontend: str) -> dict:
    """GET the tenancy view; raises urllib errors on transport failure."""
    base = frontend if "://" in frontend else f"http://{frontend}"
    url = f"{base}/debug/tenants"
    with urllib.request.urlopen(url, timeout=10.0) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _tenant_names(body: dict) -> set:
    """Every tenant id visible anywhere in the view: the process-local
    metric snapshot plus each engine's quota/queue view (the frontend
    nests engines by model; a worker serves a single ``engine`` key)."""
    names = set(body.get("tenants") or {})
    engines = body.get("engines") or {}
    if body.get("engine"):
        engines = {"_": body["engine"]}
    for dbg in engines.values():
        names.update((dbg or {}).get("tenants") or {})
    return names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dump a frontend/worker's per-tenant serving stats"
    )
    ap.add_argument("--frontend", required=True, metavar="HOST:PORT",
                    help="frontend or worker system-server address "
                         "(serves /debug/tenants)")
    ap.add_argument("--tenant", default=None,
                    help="restrict to one tenant id")
    try:
        args = ap.parse_args(argv)
    except SystemExit:
        # argparse exits 2 on usage errors already; normalize regardless
        return 2

    try:
        body = fetch_view(args.frontend)
    except urllib.error.HTTPError as e:
        print(f"endpoint rejected the request: HTTP {e.code}",
              file=sys.stderr)
        return 2
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"cannot reach {args.frontend}: {e}", file=sys.stderr)
        return 2

    names = _tenant_names(body)
    if args.tenant is not None:
        if args.tenant not in names:
            print(f"tenant {args.tenant!r} not seen by {args.frontend} "
                  f"(known: {sorted(names) or 'none'})", file=sys.stderr)
            return 2
        # filter every tenant-keyed dict in the view down to the one id
        body["tenants"] = {
            t: v for t, v in (body.get("tenants") or {}).items()
            if t == args.tenant
        }
        for dbg in (body.get("engines") or {}).values():
            if isinstance(dbg, dict) and "tenants" in dbg:
                dbg["tenants"] = {
                    t: v for t, v in dbg["tenants"].items()
                    if t == args.tenant
                }
        if isinstance(body.get("engine"), dict):
            eng = body["engine"]
            eng["tenants"] = {
                t: v for t, v in (eng.get("tenants") or {}).items()
                if t == args.tenant
            }
    print(json.dumps(body, indent=2, sort_keys=True))
    return 0 if names else 1


if __name__ == "__main__":
    sys.exit(main())
