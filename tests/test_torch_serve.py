"""The port's serve supervisor (dynamo_tpu_torch/launch/serve.py; the JAX
package's tests/test_serve.py on the port): a graph file brings up the
store, two ``out=mocker`` workers and the frontend as children of the
port's CLI, serves over HTTP (the port's standard-library client),
restarts a worker killed with SIGKILL and serves after it, and drains in
the reference's order (workers, then the frontend, then the store);
``python -m dynamo_tpu_torch.cli serve`` exits 0 on SIGTERM with no
child left; a YAML graph is refused with a message naming JSON."""
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dynamo_tpu.launch import serve as rserve
from dynamo_tpu_torch.frontend.http import HttpClient
from dynamo_tpu_torch.launch import serve as pserve
from dynamo_tpu_torch.launch.serve import Supervisor, load_graph

ROOT = Path(__file__).resolve().parent.parent


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_graph(tmp_path, port_cp, port_http):
    graph = {
        "namespace": "sv",
        "control_plane": {"port": port_cp},
        "frontend": {"http_port": port_http},
        "workers": [
            {"name": "mock", "replicas": 2,
             "args": ["out=mocker", "--model-name", "svm",
                      "--page-size", "4"]},
        ],
    }
    p = tmp_path / "graph.json"
    p.write_text(json.dumps(graph))
    return str(p)


async def wait_served(port_http, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            async with HttpClient("127.0.0.1", port_http) as c:
                r = await c.request("GET", "/v1/models")
                if [m["id"] for m in r.json()["data"]] == ["svm"]:
                    return
        except (OSError, ValueError, KeyError):
            pass
        await asyncio.sleep(0.25)
    raise AssertionError("the graph never served")


async def chat(port_http, content, max_tokens):
    async with HttpClient("127.0.0.1", port_http) as c:
        r = await c.request("POST", "/v1/chat/completions", json_body={
            "model": "svm", "max_tokens": max_tokens,
            "messages": [{"role": "user", "content": content}]})
        assert r.status == 200, r.body
        return r.json()


def test_children_are_the_references_on_the_port_cli(tmp_path):
    """Each child's command is the reference supervisor's with the port's
    CLI in place of the JAX package's."""
    graph = load_graph(write_graph(tmp_path, 7111, 8080))
    ref, port = rserve.Supervisor(graph), Supervisor(graph)
    ref._build_children()
    port._build_children()
    assert [c.name for c in port.children] == [c.name for c in ref.children]
    for p, r in zip(port.children, ref.children):
        assert p.cmd[:3] == [sys.executable, "-m", "dynamo_tpu_torch.cli"]
        assert r.cmd[:3] == [sys.executable, "-m", "dynamo_tpu.cli"]
        assert p.cmd[3:] == r.cmd[3:]
    assert (pserve.MAX_RESTARTS, pserve.RESTART_WINDOW_S,
            pserve.BACKOFF_BASE_S) == (rserve.MAX_RESTARTS,
                                       rserve.RESTART_WINDOW_S,
                                       rserve.BACKOFF_BASE_S)


@pytest.mark.asyncio_timeout(300)
async def test_serve_graph_end_to_end(tmp_path):
    port_cp, port_http = free_port(), free_port()
    sup = Supervisor(load_graph(write_graph(tmp_path, port_cp, port_http)),
                     log_dir=str(tmp_path))
    await sup.start()
    order: list[str] = []
    try:
        assert set(sup.status()) == {
            "control-plane", "mock-0", "mock-1", "frontend"}
        await wait_served(port_http)
        body = await chat(port_http, "w1 w2 w3", 4)
        # mocker tokens may hit its synthetic EOS early
        assert 1 <= body["usage"]["completion_tokens"] <= 4

        # crash a worker: the supervisor restarts it and service holds
        victim = next(c for c in sup.children if c.name == "mock-0")
        old_pid = victim.proc.pid
        os.kill(old_pid, signal.SIGKILL)
        for _ in range(120):
            if victim.alive() and victim.proc.pid != old_pid:
                break
            await asyncio.sleep(0.5)
        assert victim.alive() and victim.proc.pid != old_pid
        assert len(victim.restarts) == 1
        # the new process registers (its log holds a second ready line)
        log = tmp_path / "mock-0.log"
        for _ in range(240):
            if log.read_text().count(" serving sv/backend/generate") == 2:
                break
            await asyncio.sleep(0.25)
        else:
            raise AssertionError(log.read_text()[-2000:])
        body = await chat(port_http, "w4 w5", 2)
        assert 1 <= body["usage"]["completion_tokens"] <= 2
    finally:
        # the order in which the children are sent SIGTERM
        for c in sup.children:
            if c.proc is not None:
                term = c.proc.terminate

                def logged(c=c, term=term):
                    order.append(c.name)
                    term()
                c.proc.terminate = logged
        await sup.drain()
    assert all(v != "up" for v in sup.status().values()), sup.status()
    assert set(order[:2]) == {"mock-0", "mock-1"}
    assert order[2:] == ["frontend", "control-plane"]
    logs = {c.name: (tmp_path / f"{c.name}.log").read_text()
            for c in sup.children}
    for c in sup.children:   # each exited cleanly on its SIGTERM
        assert c.proc.returncode == 0, (c.name, logs[c.name][-2000:])
    assert "drained; shutting down" in logs["mock-1"]


def _alive_with(marker: str) -> list[int]:
    """Pids of live processes whose command line holds ``marker``."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{d}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if marker in cmd and state != "Z":
            out.append(int(d))
    return out


@pytest.mark.asyncio_timeout(300)
async def test_serve_cli_exits_0_on_sigterm_with_no_child_left(tmp_path):
    port_cp, port_http = free_port(), free_port()
    path = write_graph(tmp_path, port_cp, port_http)
    logs = tmp_path / "logs"
    logs.mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "serve", path,
         "--log-dir", str(logs)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    loop = asyncio.get_running_loop()
    try:
        line = await asyncio.wait_for(
            loop.run_in_executor(None, proc.stdout.readline), 60)
        assert line.startswith("serving graph: control-plane, mock-0, "
                               "mock-1, frontend"), line
        await wait_served(port_http)
        assert len(_alive_with(f"127.0.0.1:{port_cp}")) == 3
        proc.send_signal(signal.SIGTERM)
        rc = await loop.run_in_executor(None, lambda: proc.wait(timeout=90))
        assert rc == 0, proc.stderr.read()[-3000:]
        assert _alive_with(f"127.0.0.1:{port_cp}") == []
        assert _alive_with(f"--port {port_cp}") == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_a_yaml_graph_is_refused_naming_json(tmp_path, capsys):
    from dynamo_tpu_torch import cli

    p = tmp_path / "graph.yaml"
    p.write_text("namespace: sv\nworkers: []\n")
    with pytest.raises(ValueError, match="as JSON"):
        load_graph(str(p))
    assert cli.main(["serve", str(p)]) == 2
    err = capsys.readouterr().err
    assert "a YAML file" in err and "JSON" in err
