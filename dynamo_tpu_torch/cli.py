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
  metrics
        the Prometheus re-exporter of the worker load plane
        (metrics_exporter.py): ``metrics --control-plane HOST:PORT
        [--host 0.0.0.0] [--port 9090]``; SIGTERM stops it
  planner
        the autoscaler over a local worker pool (planner.py): ``planner
        --control-plane HOST:PORT [--engine mocker] [--sla-profile
        PROFILE --ttft-sla S --itl-sla S]``, load, SLA or predictive
        mode; SIGTERM stops it and its workers
  profile
        the SLA profiler (profiler.py): ``profile --engine mocker|torch
        [--model-config tiny] [--device cuda] [--slots 4 8 16]
        [--concurrency 1 2 4 8] [--output profile.json]``; --engine
        torch runs TorchEngine on --device (default cuda: without a card
        it fails, it does not fall back to the CPU)
  datagen
        the mooncake-style trace generator and analyzer
        (data_generator.py): ``datagen --num 100 --output trace.jsonl``
        or ``datagen --analyze trace.jsonl``
  serve the serving-graph supervisor (launch/serve.py): ``serve
        graph.json [--log-dir DIR]`` runs the graph's store, workers and
        frontend as children of this CLI, restarts a child that exits,
        and drains them on SIGTERM (exit code 0); ``serve graph.json
        --emit-k8s [--image IMG] [--k8s-namespace NS]`` prints the
        graph's Deployments and Services instead (k8s.py)
  operator
        the k8s operator (k8s.py DynamoOperator): ``operator
        --control-plane HOST:PORT [--namespace N] [--api-base URL]
        [--apply graph.json]`` reconciles the graph held in the store
        into Deployments and Services
  llmctl
        model registrations on the store: ``llmctl --control-plane
        HOST:PORT list|add NAME [--model-path DIR]|remove NAME``
"""
from __future__ import annotations

import sys


def _run_cp(rest: list[str]) -> int:
    import argparse
    import asyncio

    from dynamo_tpu_torch.launch.run import sigterm_event
    from dynamo_tpu_torch.runtime.store import serve_store

    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli cp")
    p.add_argument("--host", default="127.0.0.1",
                   help="address to listen on (0.0.0.0 in a container "
                        "other pods reach)")
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
            host=args.host, port=args.port,
            journal_path=args.store_journal, fsync_mode=args.store_fsync,
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
        print(f"dcp-server (python) listening on {args.host}:{port}{extra}",
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


def _run_datagen(rest: list[str]) -> int:
    """Synthesize/analyze mooncake-style request traces (reference
    benchmarks/data_generator), with the JAX package's flags."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli "
                                     "datagen")
    p.add_argument("--num", type=int, default=100)
    p.add_argument("--rate", type=float, default=2.0,
                   help="Poisson arrival rate (req/s)")
    p.add_argument("--isl", type=int, default=256)
    p.add_argument("--osl", type=int, default=128)
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--sessions", type=int, default=20)
    p.add_argument("--turns", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="trace.jsonl")
    p.add_argument("--analyze", default=None, metavar="TRACE",
                   help="analyze an existing trace instead of generating")
    args = p.parse_args(rest)
    from dynamo_tpu_torch.data_generator import run_datagen

    run_datagen(args)
    return 0


def _run_metrics(rest: list[str]) -> int:
    import argparse
    import asyncio

    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli "
                                     "metrics")
    p.add_argument("--control-plane", required=True, metavar="HOST:PORT")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9090)
    args = p.parse_args(rest)
    from dynamo_tpu_torch.metrics_exporter import run_exporter

    try:
        asyncio.run(run_exporter(args))
    except KeyboardInterrupt:
        pass
    return 0


def _run_planner(rest: list[str]) -> int:
    """The planner, with the JAX package's flags."""
    import argparse
    import asyncio

    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli "
                                     "planner")
    p.add_argument("--control-plane", required=True, metavar="HOST:PORT")
    p.add_argument("--engine", default="mocker",
                   help="worker engine for spawned replicas")
    p.add_argument("--model-name", default="model")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--adjustment-interval", type=float, default=10.0)
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=8)
    p.add_argument("--predictor", default="constant",
                   choices=("constant", "moving_average", "ar", "arima"),
                   help="load forecaster filtering observations before "
                        "scaling decisions (reference load_predictor.py)")
    p.add_argument("--predictive", action="store_true",
                   help="forecast next-interval concurrent streams and "
                        "size the fleet for the forecast (scale ahead of "
                        "the wave; pair with --predictor ar and "
                        "--streams-per-replica)")
    p.add_argument("--streams-per-replica", type=float, default=0.0,
                   help="per-replica stream capacity the predictive "
                        "forecast divides by (from a profile sweep or "
                        "the engine's decode-slot count)")
    p.add_argument("--fleet-ttft-scale-up", type=float, default=0.0,
                   metavar="SECONDS",
                   help="scale up when the fleet-merged TTFT p99 over "
                        "the last decide interval exceeds this (catches "
                        "latency waves stream counts miss; 0 = off)")
    p.add_argument("--fleet-queue-scale-up", type=float, default=0.0,
                   metavar="SECONDS",
                   help="same trigger on the fleet-merged admission "
                        "queue-wait p99 (0 = off)")
    p.add_argument("--connector", default="local",
                   choices=("local", "kubernetes"),
                   help="scale actuator: local worker subprocesses, or a "
                        "k8s worker Deployment's scale subresource")
    p.add_argument("--k8s-deployment", default=None,
                   help="worker Deployment name (connector=kubernetes)")
    p.add_argument("--k8s-namespace", default="default")
    # SLA mode (reference planner_sla.py): consume a profiler table
    p.add_argument("--sla-profile", default=None, metavar="PROFILE_JSON",
                   help="profile from `python -m dynamo_tpu_torch.cli "
                        "profile`; enables SLA mode with "
                        "--ttft-sla/--itl-sla")
    p.add_argument("--ttft-sla", type=float, default=None,
                   help="target TTFT seconds (p50)")
    p.add_argument("--itl-sla", type=float, default=None,
                   help="target inter-token latency seconds (p50)")
    p.add_argument("--sla-config", default=None,
                   help="which profiled config the deployed workers run "
                        "(required when the profile has several)")
    args = p.parse_args(rest)
    from dynamo_tpu_torch.planner import run_planner

    try:
        asyncio.run(run_planner(args))
    except KeyboardInterrupt:
        pass
    return 0


def _run_profile(rest: list[str]) -> int:
    """The profiler, with the JAX package's flags; ``--engine torch`` is
    the counterpart of its ``tpu``, and ``--device`` and
    ``--cache-dtype`` are the port's own."""
    import argparse
    import asyncio

    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli "
                                     "profile")
    p.add_argument("--engine", default="mocker", choices=["mocker", "torch"])
    p.add_argument("--model-config", default="tiny")
    p.add_argument("--slots", type=int, nargs="+", default=[4, 8, 16])
    p.add_argument("--concurrency", type=int, nargs="+",
                   default=[1, 2, 4, 8])
    p.add_argument("--isl", type=int, default=64)
    p.add_argument("--osl", type=int, default=32)
    p.add_argument("--output", default="profile.json")
    p.add_argument("--device", default=None,
                   help="torch device of --engine torch (default cuda; "
                        "no fallback to the CPU)")
    p.add_argument("--cache-dtype", default="bfloat16",
                   help="--engine torch's KV cache dtype, in which its "
                        "random weights are made too")
    args = p.parse_args(rest)
    from dynamo_tpu_torch.profiler import run_profile

    try:
        asyncio.run(run_profile(args))
    except KeyboardInterrupt:
        pass
    return 0


def _run_serve(rest: list[str]) -> int:
    """The serving-graph supervisor, or with --emit-k8s the graph's k8s
    objects (the JAX package's flags; --log-dir is the port's own)."""
    import argparse
    import asyncio

    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli serve")
    p.add_argument("graph")
    p.add_argument("--emit-k8s", action="store_true")
    p.add_argument("--image", default="dynamo-tpu-torch:latest")
    p.add_argument("--k8s-namespace", default="default")
    p.add_argument("--log-dir", default=None,
                   help="each child's output into DIR/NAME.log")
    args = p.parse_args(rest)
    from dynamo_tpu_torch.launch.serve import load_graph, serve_main

    try:
        graph = load_graph(args.graph)
    except (OSError, ValueError) as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    if args.emit_k8s:
        from dynamo_tpu_torch.k8s import emit_k8s_manifests, render_manifests

        print(render_manifests(emit_k8s_manifests(
            graph, image=args.image, k8s_namespace=args.k8s_namespace)))
        return 0
    try:
        return asyncio.run(serve_main(graph, log_dir=args.log_dir))
    except KeyboardInterrupt:
        return 0


def _run_operator(rest: list[str]) -> int:
    """Operator-lite: reconcile a store-held serve graph into k8s
    Deployments and Services (reference deploy/cloud/operator
    controller), with the JAX package's flags. ``--apply graph.json``
    writes the graph to the store first, then watches. SIGTERM stops it
    with exit code 0."""
    import argparse
    import asyncio
    import json

    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli "
                                     "operator")
    p.add_argument("--control-plane", required=True, metavar="HOST:PORT")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--api-base", default=None,
                   help="k8s API base URL (default: in-cluster)")
    p.add_argument("--k8s-namespace", default="default")
    p.add_argument("--image", default="dynamo-tpu-torch:latest")
    p.add_argument("--resync-s", type=float, default=30.0)
    p.add_argument("--no-verify-ssl", action="store_true")
    p.add_argument("--apply", default=None, metavar="GRAPH_FILE",
                   help="write this graph spec to the store, then watch")
    args = p.parse_args(rest)

    from dynamo_tpu_torch.k8s import DynamoOperator, graph_key
    from dynamo_tpu_torch.launch.run import sigterm_event
    from dynamo_tpu_torch.launch.serve import load_graph
    from dynamo_tpu_torch.runtime.client import KvClient

    host, _, port = args.control_plane.partition(":")

    async def run() -> None:
        op = DynamoOperator(
            api_base=args.api_base, k8s_namespace=args.k8s_namespace,
            image=args.image, resync_s=args.resync_s,
            verify_ssl=not args.no_verify_ssl)
        kv = await KvClient(host or "127.0.0.1", int(port or 7111)).connect()
        stop = asyncio.ensure_future(sigterm_event().wait())
        task = asyncio.ensure_future(op.run(kv, args.namespace))
        try:
            if args.apply:
                await kv.put(graph_key(args.namespace),
                             json.dumps(load_graph(args.apply)))
                print(f"graph spec applied to {graph_key(args.namespace)}",
                      flush=True)
            await asyncio.wait({task, stop},
                               return_when=asyncio.FIRST_COMPLETED)
            if task.done():
                task.result()   # the watch ended or a reconcile failed
        finally:
            for t in (task, stop):
                t.cancel()
            await asyncio.gather(task, stop, return_exceptions=True)
            await op.close()
            await kv.close()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


def _run_llmctl(rest: list[str]) -> int:
    """Inspect and manage model registrations on the store (reference
    launch/llmctl main.rs:181-310), with the JAX package's flags; an
    ``add --model-path`` uploads the model card (model_card.py)."""
    import argparse
    import asyncio
    import json

    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli llmctl")
    p.add_argument("--control-plane", required=True, metavar="HOST:PORT")
    p.add_argument("--namespace", default="dynamo")
    sub = p.add_subparsers(dest="action", required=True)
    sub.add_parser("list", help="list registered models + live instances")
    padd = sub.add_parser(
        "add", help="statically register a model entry (no lease: it "
                    "persists until removed; for externally managed "
                    "workers)")
    padd.add_argument("name")
    padd.add_argument("--component", default="backend")
    padd.add_argument("--endpoint", default="generate")
    padd.add_argument("--block-size", type=int, default=64)
    padd.add_argument("--router-mode", default="kv",
                      choices=["kv", "round_robin", "random"])
    padd.add_argument("--model-path", default=None,
                      help="local HF model dir; tokenizer/config artifacts "
                           "are uploaded as the model card so frontends "
                           "tokenize correctly")
    padd.add_argument("--context-length", type=int, default=None)
    prem = sub.add_parser("remove", help="remove a model's registrations "
                                         "and card artifacts")
    prem.add_argument("name")
    args = p.parse_args(rest)

    from dynamo_tpu_torch.frontend.watcher import MODEL_PREFIX, ModelEntry
    from dynamo_tpu_torch.model_card import (
        card_bucket,
        delete_card,
        upload_card,
    )
    from dynamo_tpu_torch.runtime.client import KvClient
    from dynamo_tpu_torch.runtime.component import instance_prefix

    host, _, port = args.control_plane.partition(":")

    async def run() -> int:
        kv = await KvClient(host or "127.0.0.1", int(port or 7111)).connect()
        prefix = f"dynamo://{args.namespace}/{MODEL_PREFIX}"
        try:
            if args.action == "list":
                by_model: dict = {}
                for _k, v, lease in await kv.get_prefix(prefix):
                    e = ModelEntry.from_json(v)
                    by_model.setdefault(e.name, []).append((e, lease))
                if not by_model:
                    print("no models registered")
                for name, regs in sorted(by_model.items()):
                    e = regs[0][0]
                    inst = await kv.get_prefix(instance_prefix(
                        e.namespace, e.component, e.endpoint))
                    # instances carry their model in metadata: another
                    # model's workers sharing the component do not count
                    mine = 0
                    for _k, iv, _l in inst:
                        try:
                            meta = json.loads(iv).get("metadata", {})
                        except ValueError:
                            meta = {}
                        if meta.get("model", name) == name:
                            mine += 1
                    print(f"{name}: {len(regs)} registration(s), "
                          f"{mine} instance(s) at "
                          f"{e.component}/{e.endpoint} "
                          f"[{e.router_mode}, block={e.block_size}]")
            elif args.action == "add":
                entry = ModelEntry(
                    name=args.name, namespace=args.namespace,
                    component=args.component, endpoint=args.endpoint,
                    block_size=args.block_size,
                    router_mode=args.router_mode,
                    model_path=args.model_path,
                    context_length=args.context_length,
                )
                if args.model_path:
                    entry.card_ref = await upload_card(
                        kv, args.namespace, args.name, args.model_path)
                await kv.put(f"{prefix}{args.name}/static", entry.to_json())
                print(f"registered {args.name} -> "
                      f"{args.component}/{args.endpoint}"
                      + (f" (card {entry.card_ref})"
                         if entry.card_ref else ""))
            elif args.action == "remove":
                n = await kv.delete_prefix(f"{prefix}{args.name}/")
                await delete_card(kv, card_bucket(args.namespace, args.name))
                print(f"removed {n} registration(s) for {args.name}")
            return 0
        finally:
            await kv.close()

    return asyncio.run(run())


_COMMANDS = {"cp": _run_cp, "router": _run_router, "datagen": _run_datagen,
             "metrics": _run_metrics, "planner": _run_planner,
             "profile": _run_profile, "serve": _run_serve,
             "operator": _run_operator, "llmctl": _run_llmctl}


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
    if cmd in _COMMANDS:
        return _COMMANDS[cmd](rest)
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
