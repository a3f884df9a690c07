"""Dump a frontend's live fleet prefix-economy view (a copy of the JAX
package's tools/kv_fleet.py).

Reads ``GET /debug/kv_fleet`` off a running dynamic frontend
(frontend/service.py) and prints each model's replica map and top-K hot
prefixes as JSON: which prefixes are hot, how many copies the fleet
holds, and who holds them:

  python -m dynamo_tpu_torch.tools.kv_fleet --frontend 127.0.0.1:8080
  python -m dynamo_tpu_torch.tools.kv_fleet --frontend 127.0.0.1:8080 \\
      --model m --top 8

Exit codes:
  0  the view was fetched, and at least one model has indexed blocks
  1  the frontend answered, but the view is empty (no KV-routed model,
     or no block indexed yet)
  2  a usage error, an unknown --model, or the frontend is unreachable
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.parse
import urllib.request


def fetch_view(frontend: str, model: str | None, top: int) -> dict:
    """GET the fleet view; raises urllib's errors on a transport failure."""
    base = frontend if "://" in frontend else f"http://{frontend}"
    query = {"top": str(top)}
    if model:
        query["model"] = model
    url = f"{base}/debug/kv_fleet?{urllib.parse.urlencode(query)}"
    with urllib.request.urlopen(url, timeout=10.0) as resp:
        return json.loads(resp.read().decode("utf-8"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.tools.kv_fleet",
        description="dump a frontend's fleet KV replica map + hot set")
    ap.add_argument("--frontend", required=True, metavar="HOST:PORT",
                    help="dynamic frontend address (serves /debug/kv_fleet)")
    ap.add_argument("--model", default=None,
                    help="restrict to one served model name")
    ap.add_argument("--top", type=int, default=32,
                    help="hot prefixes per model (default 32)")
    try:
        args = ap.parse_args(argv)
    except SystemExit:
        # argparse exits 2 on usage errors already; normalize regardless
        return 2
    if args.top < 1:
        print("--top must be >= 1", file=sys.stderr)
        return 2

    try:
        body = fetch_view(args.frontend, args.model, args.top)
    except urllib.error.HTTPError as e:
        # the frontend answered: 404 = unknown model / no debug route
        print(f"frontend rejected the request: HTTP {e.code}",
              file=sys.stderr)
        return 2
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"cannot reach {args.frontend}: {e}", file=sys.stderr)
        return 2

    models = body.get("models", {})
    print(json.dumps(body, indent=2, sort_keys=True))
    populated = any(
        (view or {}).get("total_blocks", 0) > 0 for view in models.values()
    )
    return 0 if populated else 1


if __name__ == "__main__":
    sys.exit(main())
