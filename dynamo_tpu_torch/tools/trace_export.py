"""Export a request's observability data as a Perfetto/Chrome trace (a
copy of the JAX package's tools/trace_export.py, fetching over the
port's HTTP client).

Merges up to four sources into one Trace Event Format JSON
(telemetry/timeline.py) loadable at https://ui.perfetto.dev or
chrome://tracing:

  - a /debug/trace/{request_id} span tree (frontend and worker spans,
    disagg kv chunks, spec draft/verify children)
  - a /debug/flight dump (recent engine dispatches, as instants)
  - kv_transfer stream events of a pre-merged bundle
  - host-round segment records of a pre-merged bundle

Usage:
    python -m dynamo_tpu_torch.tools.trace_export \
        http://HOST:PORT/debug/trace/REQ_ID \
        [--flight http://HOST:PORT/debug/flight] [-o trace.json]
    python -m dynamo_tpu_torch.tools.trace_export dossier.json -o out.json
    python -m dynamo_tpu_torch.tools.trace_export --base http://HOST:PORT \
        --request REQ_ID
    python -m dynamo_tpu_torch.tools.trace_export --base http://HOST:PORT \
        --outlier 0

A file or stdin source may be a raw trace dict ({"trace_id", "spans"}) or
a pre-merged bundle {"trace": ..., "flight": [...], "stream": [...],
"rounds": [[end_s, wall_s, [seg_s, ...]], ...]} (a dossier's shape).

Forensics modes (--base): ``--request <id>`` fetches the dossier at
/debug/outliers/<id>, falling back to /debug/trace/<id> when none was
captured; ``--outlier <n>`` picks the n-th most recent entry of the
/debug/outliers index (0 = newest).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Optional

from dynamo_tpu_torch.telemetry.timeline import to_chrome_trace
from dynamo_tpu_torch.tools.trace_dump import FetchError, fetch_json, load


def build(doc: dict[str, Any],
          flight: Optional[list[dict[str, Any]]] = None) -> dict[str, Any]:
    """One source document (and optional flight events) -> Chrome trace."""
    if "trace" in doc or "stream" in doc or "rounds" in doc:
        # a pre-merged bundle
        trace = doc.get("trace") or {}
        spans = list(trace.get("spans") or [])
        label = str(trace.get("trace_id", ""))
        stream = list(doc.get("stream") or [])
        rounds = [(float(r[0]), float(r[1]), tuple(float(x) for x in r[2]))
                  for r in doc.get("rounds") or []]
        fl = list(doc.get("flight") or []) + list(flight or [])
    else:
        spans = list(doc.get("spans") or [])
        label = str(doc.get("trace_id", ""))
        stream, rounds, fl = [], [], list(flight or [])
    return to_chrome_trace(spans=spans, round_records=rounds,
                           flight_events=fl, stream_events=stream,
                           label=label)


def resolve_forensics(base: str, request: Optional[str],
                      outlier: Optional[int]) -> dict[str, Any]:
    """A dossier bundle from a frontend or system server at ``base``: by
    request id (the dossier first, the raw trace as fallback) or by index
    into the outlier ring (0 = newest)."""
    base = base.rstrip("/")
    if outlier is not None:
        entries = load(f"{base}/debug/outliers").get("outliers") or []
        if outlier >= len(entries):
            return {"error": f"outlier index {outlier} out of range "
                             f"({len(entries)} retained)"}
        request = entries[outlier]["request_id"]
    try:
        return fetch_json(f"{base}/debug/outliers/{request}")
    except FetchError:
        return load(f"{base}/debug/trace/{request}")


def _flight_events(fdoc: Any) -> list:
    """A /debug/flight answer's events: a worker system server's
    {"events": [...]} or a frontend's {"engines": {name: {"events"}}}."""
    if not isinstance(fdoc, dict):
        return list(fdoc)
    events = list(fdoc.get("events") or [])
    for eng in (fdoc.get("engines") or {}).values():
        events.extend(eng.get("events") or [])
    return events


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("source", nargs="?", default=None,
                    help="/debug/trace URL, JSON file, or - for stdin")
    ap.add_argument("--base", default=None,
                    help="frontend or system-server base URL for the "
                         "forensics modes (--request / --outlier)")
    ap.add_argument("--request", default=None,
                    help="with --base: export this request id's dossier "
                         "(/debug/outliers/<id>), falling back to its "
                         "raw /debug/trace")
    ap.add_argument("--outlier", type=int, default=None,
                    help="with --base: export the n-th most recent "
                         "outlier dossier (0 = newest)")
    ap.add_argument("--flight", default=None,
                    help="optional /debug/flight URL or JSON file to "
                         "merge as instant events")
    ap.add_argument("-o", "--output", default="trace.json",
                    help="output path (default trace.json); - for stdout")
    args = ap.parse_args(argv)
    if args.base is not None:
        if args.request is None and args.outlier is None:
            ap.error("--base needs --request or --outlier")
        doc = resolve_forensics(args.base, args.request, args.outlier)
    elif args.source is None:
        ap.error("a source (or --base with --request/--outlier) is "
                 "required")
    else:
        doc = load(args.source)
    if "error" in doc:
        print(f"error: {doc['error']}", file=sys.stderr)
        return 1
    flight = _flight_events(load(args.flight)) if args.flight else None
    chrome = build(doc, flight=flight)
    out = json.dumps(chrome)
    if args.output == "-":
        print(out)
    else:
        with open(args.output, "w") as f:
            f.write(out)
        print(f"wrote {args.output} ({len(chrome['traceEvents'])} events)"
              f"; open at https://ui.perfetto.dev", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
