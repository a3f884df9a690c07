"""Kubernetes integration: the planner's connector, manifest generation
and the operator's reconcile loop (a copy of the JAX package's k8s.py
on the standard library).

  - ``KubernetesConnector`` (reference components/planner/src/dynamo/
    planner/kubernetes_connector.py:79 and utils/kube.py:164): the
    planner's scale actuator. It patches the worker Deployment's
    ``scale`` subresource.
  - ``emit_k8s_manifests`` (reference deploy/cloud/operator CRDs and
    helm): a serve graph (launch/serve.py) rendered into Deployments and
    Services of the port's commands, so ``python -m dynamo_tpu_torch.cli
    serve GRAPH --emit-k8s`` gives a kubectl-appliable deployment.
  - ``DynamoOperator`` (reference dynamocomponentdeployment_controller.go):
    reconciles a graph held in the store into those objects.

The API server's REST surface is spoken with ``http.client`` in a thread,
over TLS with the service account's CA and token (``SA_DIR``) in a
cluster, or with an explicit ``api_base``, ``token`` and ``verify_ssl``.
"""
from __future__ import annotations

import asyncio
import hashlib
import http.client
import json
import logging
import os
import ssl
from typing import Any, Optional
from urllib.parse import urlencode, urlsplit

log = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
# the port's CLI in the image (the JAX package's image runs its CLI as
# the entrypoint)
COMMAND = ["python3", "-m", "dynamo_tpu_torch.cli"]
IMAGE = "dynamo-tpu-torch:latest"
# the resource a worker's ``gpus`` requests
GPU_RESOURCE = "nvidia.com/gpu"


class _Api:
    """JSON requests to the API server (one connection per request, in a
    worker thread)."""

    def __init__(self, api_base: str, token: Optional[str],
                 verify_ssl: bool):
        self.api_base = api_base.rstrip("/")
        self.token = token
        self.verify_ssl = verify_ssl

    def _headers(self, content_type: Optional[str] = None) -> dict[str, str]:
        h = {"Accept": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        if content_type:
            h["Content-Type"] = content_type
        return h

    def _context(self) -> ssl.SSLContext:
        if not self.verify_ssl:
            return ssl._create_unverified_context()
        # in a cluster the API server's certificate is signed by the
        # cluster's CA, which no system trust store holds
        ca = os.path.join(SA_DIR, "ca.crt")
        return ssl.create_default_context(
            cafile=ca if os.path.exists(ca) else None)

    def _request(self, method: str, url: str, body: Optional[str],
                 content_type: Optional[str], params: Optional[dict]
                 ) -> tuple[int, Any]:
        u = urlsplit(url)
        if u.scheme == "https":
            conn: http.client.HTTPConnection = http.client.HTTPSConnection(
                u.hostname, u.port, timeout=30, context=self._context())
        else:
            conn = http.client.HTTPConnection(u.hostname, u.port,
                                              timeout=30)
        path = u.path + (f"?{urlencode(params)}" if params else "")
        try:
            conn.request(method, path,
                         body=body.encode() if body is not None else None,
                         headers=self._headers(content_type))
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        try:
            return resp.status, json.loads(data) if data else {}
        except ValueError:
            return resp.status, {"message": data.decode(errors="replace")}

    async def call(self, method: str, url: str, *, body: Any = None,
                   content_type: Optional[str] = None,
                   params: Optional[dict] = None) -> tuple[int, Any]:
        """(status, decoded JSON body) of one request."""
        text = body if body is None or isinstance(body, str) \
            else json.dumps(body)
        return await asyncio.to_thread(self._request, method, url, text,
                                       content_type, params)

    async def close(self) -> None:
        """Nothing stays open between requests."""


def _in_cluster(api_base: Optional[str], token: Optional[str]
                ) -> tuple[str, Optional[str]]:
    """(api_base, token), the missing ones from the pod's environment:
    the API server's service address and the service account's token."""
    if api_base is None:
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise ValueError(
                "no api_base and not in-cluster "
                "(KUBERNETES_SERVICE_HOST unset)")
        api_base = f"https://{host}:{port}"
    if token is None:
        token_path = os.path.join(SA_DIR, "token")
        if os.path.exists(token_path):
            with open(token_path, encoding="utf-8") as f:
                token = f.read().strip()
    return api_base, token


def _message(body: Any) -> Any:
    return body.get("message", body) if isinstance(body, dict) else body


class KubernetesConnector:
    """Planner connector realizing replica counts through the Deployment
    scale subresource. ``current_replicas`` returns the last observed
    value (refreshed on start() and after every patch): the planner is
    the only writer, so its staleness is bounded by its own actions."""

    def __init__(
        self,
        deployment: str,
        namespace: str = "default",
        *,
        api_base: Optional[str] = None,
        token: Optional[str] = None,
        verify_ssl: bool = True,
    ):
        self.deployment = deployment
        self.namespace = namespace
        self._api = _Api(*_in_cluster(api_base, token), verify_ssl)
        self.api_base, self.token = self._api.api_base, self._api.token
        self._replicas = 0

    @property
    def _scale_url(self) -> str:
        return (f"{self.api_base}/apis/apps/v1/namespaces/{self.namespace}"
                f"/deployments/{self.deployment}/scale")

    async def start(self) -> "KubernetesConnector":
        await self.refresh()
        return self

    async def close(self) -> None:
        await self._api.close()

    async def shutdown(self) -> None:
        """The planner's connector teardown (as LocalConnector's): the
        Deployment outlives the planner, so only the client closes."""
        await self.close()

    async def refresh(self) -> int:
        """GET the scale subresource; updates and returns the replica
        count."""
        status, body = await self._api.call("GET", self._scale_url)
        if status != 200:
            raise RuntimeError(f"scale GET {status}: {_message(body)}")
        self._replicas = int(body.get("spec", {}).get("replicas", 0))
        return self._replicas

    # ---- planner Connector protocol ----

    def current_replicas(self) -> int:
        return self._replicas

    async def set_replicas(self, n: int) -> None:
        status, body = await self._api.call(
            "PATCH", self._scale_url, body={"spec": {"replicas": int(n)}},
            content_type="application/merge-patch+json")
        if status != 200:
            raise RuntimeError(f"scale PATCH {status}: {_message(body)}")
        self._replicas = int(body.get("spec", {}).get("replicas", n))
        log.info("k8s: %s/%s scaled to %d", self.namespace, self.deployment,
                 self._replicas)


# ---------------------------------------------------------------------------
# manifest generation


def _meta(name: str, namespace: str, component: str) -> dict[str, Any]:
    return {
        "name": name,
        "namespace": namespace,
        "labels": {
            "app.kubernetes.io/part-of": "dynamo-tpu",
            "app.kubernetes.io/component": component,
            "app": name,
        },
    }


def _deployment(
    name: str,
    namespace: str,
    component: str,
    image: str,
    args: list[str],
    *,
    replicas: int = 1,
    ports: Optional[list[int]] = None,
    env: Optional[dict[str, str]] = None,
    gpus: int = 0,
) -> dict[str, Any]:
    container: dict[str, Any] = {
        "name": name,
        "image": image,
        "command": list(COMMAND),
        "args": args,
    }
    if ports:
        container["ports"] = [{"containerPort": p} for p in ports]
    if env:
        container["env"] = [
            {"name": k, "value": v} for k, v in sorted(env.items())]
    if gpus:
        container["resources"] = {"limits": {GPU_RESOURCE: gpus}}
    spec: dict[str, Any] = {
        "replicas": replicas,
        "selector": {"matchLabels": {"app": name}},
        "template": {
            "metadata": {"labels": {"app": name}},
            "spec": {"containers": [container]},
        },
    }
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": _meta(name, namespace, component),
        "spec": spec,
    }


def _service(name: str, namespace: str, component: str,
             port: int) -> dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": _meta(name, namespace, component),
        "spec": {
            "selector": {"app": name},
            "ports": [{"port": port, "targetPort": port}],
        },
    }


def emit_k8s_manifests(
    graph: dict[str, Any],
    *,
    image: str = IMAGE,
    k8s_namespace: str = "default",
) -> list[dict[str, Any]]:
    """A serve graph (launch/serve.py format) as Deployments and
    Services: the control-plane store, the frontend, one Deployment per
    worker fleet (its ``replicas`` is what the planner's
    KubernetesConnector patches; a worker's ``gpus`` key is requested as
    ``nvidia.com/gpu``), and the planner when the graph has one. Every
    container runs the port's CLI (``COMMAND``) with its arguments."""
    ns = graph.get("namespace", "dynamo")
    cp = graph.get("control_plane", {}) or {}
    cp_port = int(cp.get("port", 7111))
    cp_external = cp.get("external")
    out: list[dict[str, Any]] = []

    if cp_external:
        cp_addr = cp_external
    else:
        store_name = f"{ns}-store"
        out.append(_deployment(
            store_name, k8s_namespace, "control-plane", image,
            ["cp", "--host", "0.0.0.0", "--port", str(cp_port)],
        ))
        out.append(_service(store_name, k8s_namespace, "control-plane",
                            cp_port))
        cp_addr = f"{store_name}:{cp_port}"

    fe = graph.get("frontend", {}) or {}
    http_port = int(fe.get("http_port", 8080))
    fe_name = f"{ns}-frontend"
    out.append(_deployment(
        fe_name, k8s_namespace, "frontend", image,
        ["run", "in=http", "--control-plane", cp_addr,
         "--namespace", ns, "--http-port", str(http_port)]
        + [str(a) for a in fe.get("args", []) or []],
        ports=[http_port],
    ))
    out.append(_service(fe_name, k8s_namespace, "frontend", http_port))

    for spec in graph.get("workers", []) or []:
        name = spec.get("name", "worker")
        w_name = f"{ns}-{name}"
        args = [str(a) for a in spec.get("args", []) or []]
        out.append(_deployment(
            w_name, k8s_namespace, "worker", image,
            ["run", "in=endpoint", "--control-plane", cp_addr,
             "--namespace", ns] + args,
            replicas=int(spec.get("replicas", 1)),
            gpus=int(spec.get("gpus", 0)),
        ))

    planner = graph.get("planner")
    if planner:
        p_name = f"{ns}-planner"
        # the planner patches the (first, or ``scales``-named) worker
        # Deployment's replicas through the k8s API
        target = planner.get("scales") or (
            graph["workers"][0]["name"] if graph.get("workers") else None)
        p_args = ["planner", "--control-plane", cp_addr,
                  "--namespace", ns]
        if target:
            p_args += ["--connector", "kubernetes",
                       "--k8s-deployment", f"{ns}-{target}",
                       "--k8s-namespace", k8s_namespace]
        for k in ("min_replicas", "max_replicas", "adjustment_interval",
                  "predictor"):
            if k in planner:
                p_args += [f"--{k.replace('_', '-')}", str(planner[k])]
        out.append(_deployment(
            p_name, k8s_namespace, "planner", image, p_args,
        ))
    return out


def render_manifests(manifests: list[dict[str, Any]]) -> str:
    """The manifests as indented JSON objects, one after another
    (kubectl applies a stream of them)."""
    return "\n".join(json.dumps(m, indent=1) for m in manifests)


# ---------------------------------------------------------------------------
# Operator-lite reconcile loop


def graph_key(namespace: str) -> str:
    """Store key holding the deployed graph spec (the CRD's analogue)."""
    return f"dynamo://{namespace}/_operator/graph"


class DynamoOperator:
    """Operator-lite: reconciles a serve-graph spec held in the store
    into Deployments and Services (reference deploy/cloud/operator
    dynamocomponentdeployment_controller.go: a CRD -> child objects, with
    create, update, delete and drift correction; here the spec is a
    store key, watched like everything else on the control plane).

    Reconcile = render the desired objects (emit_k8s_manifests), diff
    them against the live owned set by a spec-hash annotation, then
    create the missing, replace the drifted and delete the orphans.
    Level-triggered: every spec change and a periodic resync run the same
    pass."""

    HASH_ANN = "dynamo-tpu/spec-hash"
    OWNED_SELECTOR = "app.kubernetes.io/part-of=dynamo-tpu"

    def __init__(
        self,
        *,
        api_base: Optional[str] = None,
        token: Optional[str] = None,
        verify_ssl: bool = True,
        k8s_namespace: str = "default",
        image: str = IMAGE,
        resync_s: float = 30.0,
    ):
        # without api_base: in-cluster, with the service account's token
        self._api = _Api(*_in_cluster(api_base, token), verify_ssl)
        self.api_base = self._api.api_base
        self.k8s_namespace = k8s_namespace
        self.image = image
        self.resync_s = resync_s
        self.reconciles = 0

    async def close(self) -> None:
        await self._api.close()

    def _url(self, kind: str, name: Optional[str] = None) -> str:
        base = {
            "Deployment": (f"{self.api_base}/apis/apps/v1/namespaces/"
                           f"{self.k8s_namespace}/deployments"),
            "Service": (f"{self.api_base}/api/v1/namespaces/"
                        f"{self.k8s_namespace}/services"),
        }[kind]
        return f"{base}/{name}" if name else base

    @staticmethod
    def _hash(obj: dict[str, Any]) -> str:
        return hashlib.sha1(
            json.dumps(obj, sort_keys=True).encode()).hexdigest()[:16]

    async def _list_owned(self, kind: str) -> dict[str, dict[str, Any]]:
        status, body = await self._api.call(
            "GET", self._url(kind),
            params={"labelSelector": self.OWNED_SELECTOR})
        if status != 200:
            raise RuntimeError(f"{kind} LIST {status}: {_message(body)}")
        return {item["metadata"]["name"]: item
                for item in body.get("items", [])}

    async def _create(self, kind: str, obj: dict[str, Any]) -> None:
        status, body = await self._api.call(
            "POST", self._url(kind), body=obj,
            content_type="application/json")
        if status not in (200, 201):
            raise RuntimeError(f"{kind} CREATE {status}: {_message(body)}")

    async def _replace(self, kind: str, obj: dict[str, Any],
                       live: dict[str, Any]) -> None:
        rv = live.get("metadata", {}).get("resourceVersion")
        if rv is not None:
            obj = dict(obj)
            obj["metadata"] = dict(obj["metadata"], resourceVersion=rv)
        status, body = await self._api.call(
            "PUT", self._url(kind, obj["metadata"]["name"]), body=obj,
            content_type="application/json")
        if status != 200:
            raise RuntimeError(f"{kind} REPLACE {status}: {_message(body)}")

    async def _delete(self, kind: str, name: str) -> None:
        status, body = await self._api.call("DELETE", self._url(kind, name))
        if status not in (200, 202, 404):
            raise RuntimeError(f"{kind} DELETE {status}: {_message(body)}")

    async def reconcile(self, graph: dict[str, Any]) -> dict[str, int]:
        """One level-triggered pass; returns its counts."""
        desired = emit_k8s_manifests(
            graph, image=self.image, k8s_namespace=self.k8s_namespace)
        for obj in desired:
            ann = obj["metadata"].setdefault("annotations", {})
            ann[self.HASH_ANN] = self._hash(
                {k: v for k, v in obj.items() if k != "metadata"})
        counts = {"created": 0, "updated": 0, "deleted": 0, "unchanged": 0}
        for kind in ("Deployment", "Service"):
            live = await self._list_owned(kind)
            want = {o["metadata"]["name"]: o for o in desired
                    if o["kind"] == kind}
            for name, obj in want.items():
                cur = live.get(name)
                if cur is None:
                    await self._create(kind, obj)
                    counts["created"] += 1
                elif (cur.get("metadata", {}).get("annotations", {})
                      .get(self.HASH_ANN)
                      != obj["metadata"]["annotations"][self.HASH_ANN]):
                    await self._replace(kind, obj, cur)
                    counts["updated"] += 1
                else:
                    counts["unchanged"] += 1
            for name in live:
                if name not in want:
                    await self._delete(kind, name)
                    counts["deleted"] += 1
        self.reconciles += 1
        log.info("operator reconcile: %s", counts)
        return counts

    async def run(self, kv, namespace: str) -> None:
        """Watch the graph spec key and reconcile on every change, plus a
        periodic resync (drift repair: the operator owns its objects)."""
        key = graph_key(namespace)
        watch = await kv.watch_prefix(key)
        graph: Optional[dict[str, Any]] = None
        for _k, v, _ver in watch.initial:
            graph = json.loads(v)
        if graph is not None:
            await self.reconcile(graph)
        try:
            while True:
                try:
                    ev = await asyncio.wait_for(watch.__anext__(),
                                                timeout=self.resync_s)
                except asyncio.TimeoutError:
                    if graph is not None:
                        await self.reconcile(graph)  # resync
                    continue
                except StopAsyncIteration:
                    return
                if ev.get("event") == "put":
                    graph = json.loads(ev["value"])
                    await self.reconcile(graph)
        finally:
            await watch.cancel()
