"""``python -m dynamo_tpu_torch.cli serve graph.json``: the one-command
serving-graph supervisor (a copy of the JAX package's launch/serve.py).

Parity: reference ``dynamo serve`` (deploy/sdk/src/dynamo/sdk/cli/
serving.py:66-152), a circus arbiter with one watcher per component.
Here a small asyncio supervisor launches the control-plane store, the
worker fleets and the HTTP frontend as child processes of the port's CLI
(``python -m dynamo_tpu_torch.cli cp|run``), restarts unexpected exits
with a capped backoff, and drains on SIGTERM: the workers first (their
leases revoke), then the frontend, then the store.

Graph file (JSON: the standard library has no YAML parser, so a YAML
graph is refused with a message that says to write it as JSON):

    {"namespace": "dynamo",
     "control_plane": {"port": 7111},     # or {"external": "HOST:PORT"}
     "frontend": {"http_port": 8080, "args": []},
     "workers": [
       {"name": "decode", "replicas": 2, "gpus": 1,
        "args": ["out=torch", "--model-config", "llama3_8b",
                 "--model-name", "m"]}]}

A worker's ``args`` go to the port's ``run in=endpoint`` as given, so a
graph names the port's engines (``out=torch``, ``out=mocker``,
``out=echo``). ``gpus`` is read by ``--emit-k8s`` only (k8s.py).
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Optional

log = logging.getLogger(__name__)

MAX_RESTARTS = 5          # per child, within RESTART_WINDOW_S
RESTART_WINDOW_S = 300.0
BACKOFF_BASE_S = 1.0


def load_graph(path: str) -> dict[str, Any]:
    """The graph file as a dict; JSON only."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        kind = ("a YAML file" if path.endswith((".yaml", ".yml"))
                else "not JSON")
        raise ValueError(
            f"{path}: {kind} ({e}); the PyTorch port reads serve graphs "
            f"as JSON (the standard library has no YAML parser): write "
            f"the same graph as JSON") from None


@dataclass
class _Child:
    name: str
    cmd: list[str]
    proc: Optional[subprocess.Popen] = None
    restarts: list[float] = field(default_factory=list)
    give_up: bool = False
    # restart scheduled for this deadline (0 = none): the monitor never
    # sleeps per child, so one crash-looping child cannot stall the others
    next_restart_at: float = 0.0

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class Supervisor:
    """Launch and babysit the graph's processes. With ``log_dir`` each
    child's output goes to ``{log_dir}/{name}.log`` (appended across
    restarts), else nowhere."""

    def __init__(self, graph: dict[str, Any], *, python: str = sys.executable,
                 log_dir: Optional[str] = None):
        self.graph = graph
        self.python = python
        self.log_dir = log_dir
        self.children: list[_Child] = []
        self.namespace = graph.get("namespace", "dynamo")
        cp = graph.get("control_plane", {}) or {}
        self.external_cp: Optional[str] = cp.get("external")
        self.cp_port: int = int(cp.get("port", 7111))
        self._stop = asyncio.Event()

    @property
    def cp_addr(self) -> str:
        return self.external_cp or f"127.0.0.1:{self.cp_port}"

    def _build_children(self) -> None:
        base = [self.python, "-m", "dynamo_tpu_torch.cli"]
        if self.external_cp is None:
            self.children.append(_Child(
                name="control-plane",
                cmd=base + ["cp", "--port", str(self.cp_port)],
            ))
        for spec in self.graph.get("workers", []) or []:
            name = spec.get("name", "worker")
            replicas = int(spec.get("replicas", 1))
            args = [str(a) for a in (spec.get("args") or [])]
            for i in range(replicas):
                self.children.append(_Child(
                    name=f"{name}-{i}",
                    cmd=base + ["run", "in=endpoint",
                                "--control-plane", self.cp_addr,
                                "--namespace", self.namespace] + args,
                ))
        if "frontend" in self.graph:
            # a "frontend" key holding null means the defaults
            fe = self.graph.get("frontend") or {}
            args = [str(a) for a in (fe.get("args") or [])]
            self.children.append(_Child(
                name="frontend",
                cmd=base + ["run", "in=http",
                            "--control-plane", self.cp_addr,
                            "--namespace", self.namespace,
                            "--http-port",
                            str(fe.get("http_port", 8080))] + args,
            ))

    def _spawn(self, child: _Child) -> None:
        log.info("serve: starting %s: %s", child.name, " ".join(child.cmd))
        out = subprocess.DEVNULL
        if self.log_dir is not None:
            out = open(os.path.join(self.log_dir, f"{child.name}.log"), "ab")
        try:
            child.proc = subprocess.Popen(
                child.cmd, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True, env=dict(os.environ))
        finally:
            if out is not subprocess.DEVNULL:
                out.close()   # the child holds its own descriptor

    async def start(self) -> "Supervisor":
        self._build_children()
        for child in self.children:
            self._spawn(child)
            if child.name == "control-plane":
                await asyncio.sleep(0.5)  # the store up before dependents
        self._monitor_task = asyncio.get_running_loop().create_task(
            self._monitor())
        return self

    async def _monitor(self) -> None:
        """Restart unexpected exits with capped per-child backoff (no
        inline sleeps: each child carries its own restart deadline)."""
        while not self._stop.is_set():
            await asyncio.sleep(0.5)
            now = time.monotonic()
            for child in self.children:
                if child.alive() or child.give_up:
                    continue
                if child.next_restart_at:
                    if now >= child.next_restart_at:
                        child.next_restart_at = 0.0
                        self._spawn(child)
                    continue
                child.restarts = [
                    t for t in child.restarts if now - t < RESTART_WINDOW_S]
                if len(child.restarts) >= MAX_RESTARTS:
                    log.error("serve: %s exceeded %d restarts; giving up",
                              child.name, MAX_RESTARTS)
                    child.give_up = True
                    continue
                backoff = BACKOFF_BASE_S * (2 ** len(child.restarts))
                log.warning(
                    "serve: %s exited (rc=%s); restarting in %.1fs",
                    child.name,
                    child.proc.returncode if child.proc else "?",
                    backoff)
                child.restarts.append(now)
                child.next_restart_at = now + backoff

    async def drain(self, timeout_s: float = 15.0) -> None:
        """Graceful stop: workers first (lease revocation deregisters
        them), then the frontend, then the store. A child that outlives
        its SIGTERM by ``timeout_s`` is killed."""
        self._stop.set()
        self._monitor_task.cancel()

        def group(pred):
            return [c for c in self.children if pred(c) and c.alive()]

        order = [
            lambda c: c.name not in ("frontend", "control-plane"),
            lambda c: c.name == "frontend",
            lambda c: c.name == "control-plane",
        ]
        for pred in order:
            batch = group(pred)
            for c in batch:
                c.proc.terminate()
            deadline = time.monotonic() + timeout_s
            for c in batch:
                while c.alive() and time.monotonic() < deadline:
                    await asyncio.sleep(0.1)
                if c.alive():
                    log.warning("serve: %s ignored SIGTERM; killing", c.name)
                    c.proc.kill()
                    c.proc.wait()

    def status(self) -> dict[str, str]:
        return {
            c.name: ("up" if c.alive()
                     else "failed" if c.give_up else "down")
            for c in self.children
        }


async def serve_main(graph: dict[str, Any], *,
                     log_dir: Optional[str] = None) -> int:
    """Serve ``graph`` (load_graph's dict) until SIGINT or SIGTERM, then
    drain; exit code 0."""
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    sup = await Supervisor(graph, log_dir=log_dir).start()
    names = ", ".join(c.name for c in sup.children)
    print(f"serving graph: {names} (control plane {sup.cp_addr})",
          flush=True)
    await stop.wait()
    print("draining...", flush=True)
    await sup.drain()
    return 0
