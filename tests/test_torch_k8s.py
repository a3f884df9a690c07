"""The port's k8s plane (dynamo_tpu_torch/k8s.py) against the JAX
package's k8s.py: the reference's tests, mirrored against fake API
servers on the standard library (the port's own HttpServer), with both
packages' connector and operator driving the same fakes where they run
side by side; the manifests and their rendering equal the reference's
JSON branch (PyYAML made unimportable) but for the listed differences --
the image, the container command that runs the port's CLI, and
``nvidia.com/gpu`` for the reference's ``google.com/tpu``; and the
planner's ``--connector kubernetes`` patches the Deployment's scale."""
import asyncio
import json
import sys

import pytest

from dynamo_tpu import k8s as rk8s
from dynamo_tpu import planner as rplan
from dynamo_tpu_torch import k8s as pk8s
from dynamo_tpu_torch import planner as pplan
from dynamo_tpu_torch.frontend.http import HttpServer, Response

PKG = {"ref": rk8s, "port": pk8s}


class FakeKubeApi:
    """Minimal apps/v1 scale subresource."""

    PATH = "/apis/apps/v1/namespaces/{ns}/deployments/{name}/scale"

    def __init__(self, replicas=2):
        self.replicas = replicas
        self.patches: list[dict] = []
        self.content_types: list[str] = []
        self.auth_headers: list[str] = []
        self.server = HttpServer({("GET", self.PATH): self.get_scale,
                                  ("PATCH", self.PATH): self.patch_scale})

    def _body(self, request):
        return {
            "kind": "Scale",
            "metadata": {"name": request.match_info["name"],
                         "namespace": request.match_info["ns"]},
            "spec": {"replicas": self.replicas},
            "status": {"replicas": self.replicas},
        }

    async def get_scale(self, request):
        self.auth_headers.append(request.headers.get("Authorization", ""))
        if request.match_info["name"] == "missing":
            return Response.json(
                {"message": "deployments.apps \"missing\" not found"},
                status=404)
        return Response.json(self._body(request))

    async def patch_scale(self, request):
        self.content_types.append(request.headers.get("Content-Type", ""))
        patch = request.json()
        self.patches.append(patch)
        self.replicas = int(patch["spec"]["replicas"])
        return Response.json(self._body(request))


async def start(api):
    port = await api.server.start("127.0.0.1", 0)
    return f"http://127.0.0.1:{port}"


@pytest.mark.parametrize("pkg", ["ref", "port"])
async def test_connector_scale_cycle(pkg):
    api = FakeKubeApi()
    base = await start(api)
    conn = PKG[pkg].KubernetesConnector(
        "decode-workers", "prod", api_base=base, token="tok123")
    try:
        await conn.start()
        assert conn.current_replicas() == 2
        await conn.set_replicas(5)
        assert conn.current_replicas() == 5
        assert api.replicas == 5
        assert api.patches == [{"spec": {"replicas": 5}}]
        assert api.content_types == ["application/merge-patch+json"]
        # bearer token attached
        assert "Bearer tok123" in api.auth_headers
        # refresh observes out-of-band changes
        api.replicas = 3
        assert await conn.refresh() == 3
    finally:
        await conn.close()
        await api.server.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
async def test_connector_propagates_api_errors(pkg):
    api = FakeKubeApi()
    base = await start(api)
    conn = PKG[pkg].KubernetesConnector("missing", "prod", api_base=base)
    try:
        with pytest.raises(RuntimeError, match="scale GET 404: .*not found"):
            await conn.refresh()
    finally:
        await conn.close()
        await api.server.stop()


def test_connector_needs_a_cluster_or_an_api_base(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    for pkg in PKG.values():
        with pytest.raises(ValueError, match="not in-cluster"):
            pkg.KubernetesConnector("w")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    assert pk8s.KubernetesConnector("w").api_base == "https://10.0.0.1:443"


async def test_connector_drives_planner_decide():
    """The connector satisfies the planner's Connector protocol end to
    end: a scale-up decision patches the Deployment."""
    from dynamo_tpu_torch.planner import Planner, PlannerConfig

    api = FakeKubeApi()
    base = await start(api)
    conn = pk8s.KubernetesConnector("w", "ns", api_base=base)
    try:
        await conn.start()
        planner = Planner(
            kv=None, connector=conn,
            config=PlannerConfig(stable_intervals=1, max_replicas=8))
        planner.aggregator.update(_loaded("w0"))
        target = await planner.adjust()
        assert target == 3  # 2 observed + 1 scale-up step
        assert api.replicas == 3
    finally:
        await conn.close()
        await api.server.stop()


def _loaded(worker):
    from dynamo_tpu_torch.kv_router.protocols import (
        ForwardPassMetrics,
        KvStats,
        WorkerStats,
    )

    return ForwardPassMetrics(
        worker_id=worker,
        worker_stats=WorkerStats(request_active_slots=8,
                                 request_total_slots=8,
                                 num_requests_waiting=9),
        kv_stats=KvStats(kv_active_blocks=95, kv_total_blocks=100,
                         gpu_cache_usage_perc=0.95))


async def test_planner_cli_with_the_kubernetes_connector_patches_scale(
        monkeypatch):
    """``planner --connector kubernetes --k8s-deployment w``: the CLI's
    arguments run run_planner, whose connector (given the fake's address
    in place of the cluster's) reads 2 replicas; a loaded worker on the
    store's load plane makes it PATCH 3."""
    from dynamo_tpu_torch import cli as pcli
    from dynamo_tpu_torch.runtime.client import KvClient
    from dynamo_tpu_torch.runtime.publisher import WorkerMetricsPublisher
    from dynamo_tpu_torch.runtime.store import serve_store

    api = FakeKubeApi()
    base = await start(api)
    server, _ = await serve_store(port=0, sweep_interval_s=0.1)
    cp = f"127.0.0.1:{server.sockets[0].getsockname()[1]}"
    seen = {}

    async def capture(args):
        seen["args"] = args

    real = pplan.run_planner
    monkeypatch.setattr(pplan, "run_planner", capture)
    # the CLI runs its own loop: parse in a thread
    assert await asyncio.to_thread(pcli.main, [
        "planner", "--control-plane", cp, "--connector", "kubernetes",
        "--k8s-deployment", "w", "--k8s-namespace", "prod",
        "--adjustment-interval", "0.2"]) == 0
    real_conn = pk8s.KubernetesConnector
    monkeypatch.setattr(pk8s, "KubernetesConnector", lambda dep, ns: (
        real_conn(dep, ns, api_base=base)))
    task = asyncio.ensure_future(real(seen["args"]))
    kv = await KvClient(port=server.sockets[0].getsockname()[1]).connect()
    pub = WorkerMetricsPublisher(kv, "w0", min_interval_s=0.0)
    pub.start()
    try:
        for _ in range(100):
            pub(_loaded("w0"))
            if api.patches or task.done():
                break
            await asyncio.sleep(0.1)
        assert not task.done(), task.result()
        assert api.patches[0] == {"spec": {"replicas": 3}}
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await pub.stop()
        await kv.close()
        server.close()
        await api.server.stop()


async def test_kubernetes_connector_without_a_deployment_exits_as_the_reference():
    from types import SimpleNamespace

    from dynamo_tpu_torch.runtime.store import serve_store

    server, _ = await serve_store(port=0, sweep_interval_s=0.1)
    cp = f"127.0.0.1:{server.sockets[0].getsockname()[1]}"
    args = SimpleNamespace(
        control_plane=cp, connector="kubernetes", k8s_deployment=None,
        k8s_namespace="default", sla_profile=None, ttft_sla=None,
        itl_sla=None, sla_config=None)
    try:
        with pytest.raises(SystemExit) as ref:
            await rplan.run_planner(args)
        with pytest.raises(SystemExit) as port:
            await pplan.run_planner(args)
    finally:
        server.close()
    assert str(port.value) == str(ref.value) == \
        "--connector kubernetes needs --k8s-deployment"


# ---------------------------------------------------------------------------
# manifest generation


GRAPH = {
    "namespace": "dyn",
    "control_plane": {"port": 7111},
    "frontend": {"http_port": 8080},
    "workers": [
        {"name": "decode", "replicas": 2,
         "args": ["out=torch", "--model-config", "llama3_1b",
                  "--model-name", "m"], "gpus": 1},
        {"name": "prefill", "replicas": 1, "args": ["out=torch"]},
    ],
    "planner": {"min_replicas": 1, "max_replicas": 4},
}


def as_reference(graph):
    """The same graph for the JAX package (its accelerator key)."""
    g = json.loads(json.dumps(graph))
    for w in g.get("workers", []):
        if "gpus" in w:
            w["tpu_chips"] = w.pop("gpus")
    return g


def test_emit_k8s_manifests_shapes():
    ms = pk8s.emit_k8s_manifests(GRAPH, image="repo/dynamo-tpu:v1",
                                 k8s_namespace="prod")
    kinds = [(m["kind"], m["metadata"]["name"]) for m in ms]
    for kind, name in [("Deployment", "dyn-store"), ("Service", "dyn-store"),
                       ("Deployment", "dyn-frontend"),
                       ("Service", "dyn-frontend"),
                       ("Deployment", "dyn-decode"),
                       ("Deployment", "dyn-prefill"),
                       ("Deployment", "dyn-planner")]:
        assert (kind, name) in kinds

    by_name = {m["metadata"]["name"]: m for m in ms
               if m["kind"] == "Deployment"}
    decode = by_name["dyn-decode"]
    assert decode["spec"]["replicas"] == 2
    c = decode["spec"]["template"]["spec"]["containers"][0]
    assert c["image"] == "repo/dynamo-tpu:v1"
    assert c["command"] == ["python3", "-m", "dynamo_tpu_torch.cli"]
    # workers point at the store service, not localhost
    assert "dyn-store:7111" in c["args"]
    assert c["resources"]["limits"]["nvidia.com/gpu"] == 1
    assert "resources" not in by_name["dyn-prefill"]["spec"]["template"][
        "spec"]["containers"][0]
    # every object lands in the requested k8s namespace
    assert all(m["metadata"]["namespace"] == "prod" for m in ms)
    # planner flags carried through
    planner = by_name["dyn-planner"]
    pargs = planner["spec"]["template"]["spec"]["containers"][0]["args"]
    assert "--min-replicas" in pargs and "--max-replicas" in pargs
    assert pargs[pargs.index("--k8s-deployment") + 1] == "dyn-decode"


def test_emit_k8s_external_store_skips_store_deployment():
    graph = dict(GRAPH, control_plane={"external": "etcd.infra:7111"})
    ms = pk8s.emit_k8s_manifests(graph)
    names = [m["metadata"]["name"] for m in ms]
    assert "dyn-store" not in names
    fe = next(m for m in ms if m["metadata"]["name"] == "dyn-frontend"
              and m["kind"] == "Deployment")
    args = fe["spec"]["template"]["spec"]["containers"][0]["args"]
    assert "etcd.infra:7111" in args


def _normalized(manifests):
    """The port's manifests with the listed differences undone: no
    container command, the TPU resource name."""
    out = json.loads(json.dumps(manifests))
    for m in out:
        if m["kind"] != "Deployment":
            continue
        for c in m["spec"]["template"]["spec"]["containers"]:
            assert c.pop("command") == pk8s.COMMAND
            limits = c.get("resources", {}).get("limits")
            if limits:
                limits["google.com/tpu"] = limits.pop("nvidia.com/gpu")
    return out


@pytest.mark.parametrize("graph", [
    GRAPH,
    dict(GRAPH, control_plane={"external": "etcd.infra:7111"}),
    {"namespace": "x", "frontend": None, "workers": [
        {"name": "w", "gpus": 8, "args": ["out=mocker"]}],
     "planner": {"scales": "w", "adjustment_interval": 5,
                 "predictor": "ar"}},
], ids=["full", "external", "scales"])
def test_manifests_equal_the_reference_but_the_listed_differences(
        monkeypatch, graph):
    monkeypatch.setitem(sys.modules, "yaml", None)   # its JSON branch
    kw = dict(image="img:1", k8s_namespace="prod")
    ref = rk8s.emit_k8s_manifests(as_reference(graph), **kw)
    port = pk8s.emit_k8s_manifests(graph, **kw)
    assert _normalized(port) == ref
    assert pk8s.render_manifests(_normalized(port)) == \
        rk8s.render_manifests(ref)
    # the default image is the port's
    assert {m["spec"]["template"]["spec"]["containers"][0]["image"]
            for m in pk8s.emit_k8s_manifests(graph)
            if m["kind"] == "Deployment"} == {"dynamo-tpu-torch:latest"}


def test_render_manifests_json_roundtrip():
    ms = pk8s.emit_k8s_manifests(GRAPH)
    text = pk8s.render_manifests(ms)
    dec, pos, docs = json.JSONDecoder(), 0, []
    while pos < len(text):
        doc, pos = dec.raw_decode(text, pos)
        docs.append(doc)
        while pos < len(text) and text[pos].isspace():
            pos += 1
    assert docs == ms
    assert docs[0]["apiVersion"] in ("apps/v1", "v1")


def test_emit_k8s_cli_prints_the_manifests(tmp_path, capsys):
    from dynamo_tpu_torch import cli as pcli

    p = tmp_path / "graph.json"
    p.write_text(json.dumps(GRAPH))
    assert pcli.main(["serve", str(p), "--emit-k8s", "--image", "img:2",
                      "--k8s-namespace", "prod"]) == 0
    assert capsys.readouterr().out == pk8s.render_manifests(
        pk8s.emit_k8s_manifests(GRAPH, image="img:2",
                                k8s_namespace="prod")) + "\n"


class FakeObjectApi:
    """Minimal typed-object CRUD (apps/v1 deployments, v1 services) with a
    labelSelector list: what the operator reconciles against."""

    def __init__(self):
        self.objects = {"deployments": {}, "services": {}}
        self.rv = 0
        routes = {}
        for coll, path in (
            ("deployments", "/apis/apps/v1/namespaces/{ns}/deployments"),
            ("services", "/api/v1/namespaces/{ns}/services"),
        ):
            routes[("GET", path)] = self._mk_list(coll)
            routes[("POST", path)] = self._mk_create(coll)
            routes[("PUT", path + "/{name}")] = self._mk_replace(coll)
            routes[("DELETE", path + "/{name}")] = self._mk_delete(coll)
        self.server = HttpServer(routes)

    def _mk_list(self, coll):
        async def handler(request):
            sel = request.query.get("labelSelector", "")
            items = []
            for obj in self.objects[coll].values():
                labels = obj.get("metadata", {}).get("labels", {})
                if all(labels.get(k) == v for k, _, v in
                       (s.partition("=") for s in sel.split(",") if s)):
                    items.append(obj)
            return Response.json({"items": items})
        return handler

    def _mk_create(self, coll):
        async def handler(request):
            obj = request.json()
            name = obj["metadata"]["name"]
            if name in self.objects[coll]:
                return Response.json({"message": "already exists"},
                                     status=409)
            self.rv += 1
            obj["metadata"]["resourceVersion"] = str(self.rv)
            self.objects[coll][name] = obj
            return Response.json(obj, status=201)
        return handler

    def _mk_replace(self, coll):
        async def handler(request):
            obj = request.json()
            name = request.match_info["name"]
            if name not in self.objects[coll]:
                return Response.json({"message": "not found"}, status=404)
            self.rv += 1
            obj["metadata"]["resourceVersion"] = str(self.rv)
            self.objects[coll][name] = obj
            return Response.json(obj)
        return handler

    def _mk_delete(self, coll):
        async def handler(request):
            self.objects[coll].pop(request.match_info["name"], None)
            return Response.json({})
        return handler


OP_GRAPH = {
    "namespace": "dyn",
    "frontend": {"http_port": 8080},
    "workers": [
        {"name": "decode", "replicas": 2, "gpus": 4,
         "args": ["out=torch", "--model-config", "llama3_1b"]},
    ],
}


@pytest.mark.parametrize("pkg", ["ref", "port"])
async def test_operator_reconcile_create_update_delete(pkg):
    """Spec change -> rollout; worker removal -> orphan deletion; no-op
    pass -> all unchanged (reference operator controller semantics); both
    packages' operators count the same passes."""
    graph = OP_GRAPH if pkg == "port" else as_reference(OP_GRAPH)
    api = FakeObjectApi()
    base = await start(api)
    op = PKG[pkg].DynamoOperator(api_base=base, verify_ssl=False,
                                 k8s_namespace="default")
    try:
        c = await op.reconcile(graph)
        assert c == {"created": 5, "updated": 0, "deleted": 0,
                     "unchanged": 0}   # store, frontend, 2 services, worker
        assert api.objects["deployments"]["dyn-decode"]["spec"][
            "replicas"] == 2

        # idempotent second pass
        c = await op.reconcile(graph)
        assert c == {"created": 0, "updated": 0, "deleted": 0,
                     "unchanged": 5}

        # spec change rolls the deployment
        g2 = json.loads(json.dumps(graph))
        g2["workers"][0]["args"] += ["--max-decode-slots", "16"]
        c = await op.reconcile(g2)
        assert c["updated"] == 1
        args = api.objects["deployments"]["dyn-decode"]["spec"]["template"][
            "spec"]["containers"][0]["args"]
        assert "--max-decode-slots" in args
        # drift: an object edited behind the operator's back is replaced
        api.objects["deployments"]["dyn-frontend"]["metadata"][
            "annotations"][PKG[pkg].DynamoOperator.HASH_ANN] = "stale"
        assert (await op.reconcile(g2))["updated"] == 1

        # removing the worker deletes its deployment, keeps the rest
        g3 = json.loads(json.dumps(graph))
        g3["workers"] = []
        c = await op.reconcile(g3)
        assert c["deleted"] == 1
        assert "dyn-decode" not in api.objects["deployments"]
        assert "dyn-frontend" in api.objects["deployments"]
        assert op.reconciles == 5
    finally:
        await op.close()
        await api.server.stop()


async def test_operator_watches_store_spec():
    """The graph spec is a store key (the CRD analogue): writing it
    triggers a reconcile; updating it triggers a rollout."""
    from dynamo_tpu_torch.runtime.client import KvClient
    from dynamo_tpu_torch.runtime.store import serve_store

    api = FakeObjectApi()
    base = await start(api)
    st_server, _ = await serve_store(port=0, sweep_interval_s=0.1)
    port = st_server.sockets[0].getsockname()[1]
    kv = await KvClient(port=port).connect()
    kv2 = await KvClient(port=port).connect()
    op = pk8s.DynamoOperator(api_base=base, verify_ssl=False, resync_s=5.0)
    task = asyncio.ensure_future(op.run(kv, "dyn"))
    try:
        await kv2.put(pk8s.graph_key("dyn"), json.dumps(OP_GRAPH))
        for _ in range(100):
            if "dyn-decode" in api.objects["deployments"]:
                break
            await asyncio.sleep(0.05)
        assert "dyn-decode" in api.objects["deployments"]

        g2 = json.loads(json.dumps(OP_GRAPH))
        g2["workers"][0]["replicas"] = 5
        await kv2.put(pk8s.graph_key("dyn"), json.dumps(g2))
        for _ in range(100):
            d = api.objects["deployments"].get("dyn-decode", {})
            if d.get("spec", {}).get("replicas") == 5:
                break
            await asyncio.sleep(0.05)
        assert api.objects["deployments"]["dyn-decode"]["spec"][
            "replicas"] == 5
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await op.close()
        await kv.close()
        await kv2.close()
        st_server.close()
        await api.server.stop()


async def test_operator_cli_applies_and_reconciles(tmp_path):
    """``python -m dynamo_tpu_torch.cli operator --apply graph.json``
    writes the graph key and rolls it out; SIGTERM stops it with exit
    code 0."""
    import signal
    import subprocess
    from pathlib import Path

    from dynamo_tpu_torch.runtime.client import KvClient
    from dynamo_tpu_torch.runtime.store import serve_store

    root = Path(__file__).resolve().parent.parent
    api = FakeObjectApi()
    base = await start(api)
    st_server, _ = await serve_store(port=0, sweep_interval_s=0.1)
    port = st_server.sockets[0].getsockname()[1]
    p = tmp_path / "graph.json"
    p.write_text(json.dumps(OP_GRAPH))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "operator",
         "--control-plane", f"127.0.0.1:{port}", "--namespace", "dyn",
         "--api-base", base, "--apply", str(p)], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"})
    loop = asyncio.get_running_loop()
    kv = await KvClient(port=port).connect()
    try:
        line = await asyncio.wait_for(
            loop.run_in_executor(None, proc.stdout.readline), 60)
        assert line.strip() == \
            "graph spec applied to dynamo://dyn/_operator/graph"
        assert json.loads(await kv.get(pk8s.graph_key("dyn"))) == OP_GRAPH
        for _ in range(200):
            if "dyn-decode" in api.objects["deployments"]:
                break
            await asyncio.sleep(0.05)
        assert set(api.objects["deployments"]) == {
            "dyn-store", "dyn-frontend", "dyn-decode"}
        proc.send_signal(signal.SIGTERM)
        rc = await loop.run_in_executor(None, lambda: proc.wait(timeout=30))
        assert rc == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        await kv.close()
        st_server.close()
        await api.server.stop()
