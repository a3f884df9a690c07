"""The port's CLI (``python -m dynamo_tpu_torch.cli <command>``; a copy of
the JAX package's cli.py, cut to the commands the port serves).

Commands:
  run   ``run in=<input> out=<engine> ...``: the launcher
        (dynamo_tpu_torch/launch/run.py; distributed mode with
        --control-plane HOST:PORT: workers use in=endpoint, frontends
        in=http and discover the workers' models)
  cp    the control-plane store (runtime/store.py):
        ``cp --port 7111 [--store-journal PATH] [--store-fsync
        always|batch]``; with --port 0 it prints the port it bound;
        SIGTERM stops it with exit code 0
  router
        the standalone KV router (router_service.py): ``router
        --control-plane HOST:PORT [--namespace N] [--component C]
        [--endpoint-name E] [--block-size 64] [--router-temperature
        0.0]`` serves find_best on {component}-router; SIGTERM stops it
        with exit code 0

The JAX package's other commands (serve, metrics, planner, llmctl,
profile, datagen, operator) are refused by name: their planes are not
ported yet.
"""
from __future__ import annotations

import sys

_UNPORTED = {
    "serve": "the serving-graph supervisor",
    "metrics": "the load-metrics exporter",
    "planner": "the planner",
    "llmctl": "model registration by hand",
    "profile": "the profiler",
    "datagen": "the trace generator",
    "operator": "the k8s operator",
}


def _run_cp(rest: list[str]) -> int:
    import argparse
    import asyncio

    from dynamo_tpu_torch.launch.run import sigterm_event
    from dynamo_tpu_torch.runtime.store import serve_store

    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli cp")
    p.add_argument("--port", type=int, default=7111)
    p.add_argument("--store-journal", metavar="PATH", default=None,
                   help="WAL journal path: keys/leases/queues survive a "
                        "store restart (replayed at startup with a lease "
                        "grace window); the file is the JAX package's "
                        "format, either package's store replays it")
    p.add_argument("--store-fsync", choices=("always", "batch"),
                   default="always",
                   help="WAL durability mode: 'always' flushes per "
                        "mutation; 'batch' coalesces all mutations landed "
                        "in one event-loop drain into a single "
                        "write+flush+fsync")
    args = p.parse_args(rest)

    async def _serve():
        server, store = await serve_store(
            port=args.port, journal_path=args.store_journal,
            fsync_mode=args.store_fsync,
        )
        port = server.sockets[0].getsockname()[1]
        # the handler goes in before the ready line, so a SIGTERM sent
        # on seeing that line exits 0
        stop = sigterm_event()
        extra = ""
        if args.store_journal:
            extra = (f" (journal {args.store_journal}: "
                     f"{store.replayed_keys} keys, "
                     f"{store.replayed_queue_items} queue items replayed)")
        print(f"dcp-server (python) listening on 127.0.0.1:{port}{extra}",
              flush=True)
        async with server:
            await stop.wait()
        store.close_journal()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass
    return 0


def _run_router(rest: list[str]) -> int:
    """Standalone KV-router service (reference components/router binary,
    src/main.rs:53-77), with the JAX package's flags."""
    import argparse
    import asyncio

    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli router")
    p.add_argument("--control-plane", required=True, metavar="HOST:PORT")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint-name", default="generate")
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--router-temperature", type=float, default=0.0)
    args = p.parse_args(rest)
    from dynamo_tpu_torch.router_service import run_router

    try:
        asyncio.run(run_router(args))
    except KeyboardInterrupt:
        pass
    return 0


def main(argv: list[str] | None = None) -> int:
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "run":
        from dynamo_tpu_torch.launch.run import run_cli

        return run_cli(rest)
    if cmd == "cp":
        return _run_cp(rest)
    if cmd == "router":
        return _run_router(rest)
    if cmd in _UNPORTED:
        print(f"{cmd}: {_UNPORTED[cmd]} is not served by the PyTorch port "
              f"yet", file=sys.stderr)
        return 2
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
