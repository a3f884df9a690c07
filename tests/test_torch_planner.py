"""The port's planner (dynamo_tpu_torch/planner.py, planner_metrics.py)
against the JAX package's:

- fed the same ForwardPassMetrics sequence through a fake connector,
  both packages' ``Planner`` choose the same target at every interval in
  load mode (each predictor), SLA mode, predictive mode, and under the
  queue-wait and fleet-TTFT / fleet-queue triggers; ``PLANNER`` renders
  the same text after the same decisions;
- ``LocalConnector`` spawns, drains by SIGTERM (the worker exits 0) and
  kills after the grace, in both packages; the test child tells it is
  ready (its signal handler installed) through a file, so no sleep
  races it;
- an end-to-end 1 -> 2 -> 1 run: the port's planner over the port's
  store scales ``out=mocker`` workers of the port's launcher under a held
  stream and drains the newest by SIGTERM once the stream is released;
- ``_build_sla`` refuses with the reference's messages, and the
  multi-host and kubernetes connectors are refused by name."""
import asyncio
import json
import signal
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from dynamo_tpu import planner as rplan
from dynamo_tpu import profiler as rprof
from dynamo_tpu.kv_router import protocols as rproto
from dynamo_tpu.planner_metrics import PLANNER as R_PLANNER
from dynamo_tpu.telemetry import metrics as rmet
from dynamo_tpu_torch import planner as pplan
from dynamo_tpu_torch import profiler as pprof
from dynamo_tpu_torch.kv_router import protocols as pproto
from dynamo_tpu_torch.planner_metrics import PLANNER as P_PLANNER

ROOT = Path(__file__).resolve().parent.parent
PKG = {"ref": (rplan, rprof, rproto, R_PLANNER),
       "port": (pplan, pprof, pproto, P_PLANNER)}


class FakeConnector:
    def __init__(self, n: int = 1):
        self.n = n
        self.calls: list[int] = []

    def current_replicas(self) -> int:
        return self.n

    async def set_replicas(self, n: int) -> None:
        self.calls.append(n)
        self.n = n


class FakeView:
    """A WorkerLoadView stand-in: estimated admission waits per worker."""

    def __init__(self, waits):
        self.waits = waits

    def est_wait_s(self, wid):
        return self.waits.get(wid)


def _hist(values):
    """A TTFT/queue histogram snapshot holding ``values`` (the JAX
    package's canonical ladder; the snapshot is plain data)."""
    reg = rmet.request_histograms(rmet.TelemetryRegistry(), engine=True)
    for v in values:
        reg.get(rmet.TTFT[0]).observe(v)
        reg.get(rmet.QUEUE[0]).observe(v / 2)
    return {n: reg.get(n).snapshot() for n, _ in (rmet.TTFT, rmet.QUEUE)}


def _m(worker, active=0, waiting=0, usage=0.0, total=8, hist=None):
    return {"worker_id": worker,
            "worker_stats": {"request_active_slots": active,
                             "request_total_slots": total,
                             "num_requests_waiting": waiting},
            "kv_stats": {"kv_active_blocks": int(usage * 100),
                         "kv_total_blocks": 100,
                         "gpu_cache_usage_perc": usage},
            "histograms": hist or {}}


SLA_PROFILE = {"configs": [{"name": "c", "points": [
    {"concurrency": 1, "ttft_p50_s": 0.01, "itl_p50_s": 0.004},
    {"concurrency": 4, "ttft_p50_s": 0.02, "itl_p50_s": 0.006},
    {"concurrency": 8, "ttft_p50_s": 0.2, "itl_p50_s": 0.02}]}]}

# (config kwargs, sla kwargs or None, load-view waits or None, steps):
# each step is (metrics updates, connector size forced first or None)
_noise = [0.78, 0.9, 0.7, 0.85, 0.6, 0.2, 0.1, 0.05, 0.4, 0.82, 0.95,
          0.99, 0.3, 0.1, 0.1, 0.1, 0.0, 0.25]
SCENARIOS = {
    "load-thresholds": (
        dict(kv_usage_scale_up=0.8, kv_usage_scale_down=0.3,
             waiting_scale_up=4, min_replicas=1, max_replicas=4,
             stable_intervals=2),
        None, None,
        [([_m("w0", usage=0.5)], 2), ([_m("w0", usage=0.9)], None),
         ([_m("w0", usage=0.5, waiting=9)], 3), ([_m("w0", usage=0.1)], 3),
         ([], None), ([], 1), ([], None), ([_m("w0", usage=0.95)], 4),
         ([_m("w1", usage=0.1)], None)]),
    **{f"load-{pred}": (
        dict(predictor=pred, stable_intervals=1, min_replicas=1,
             max_replicas=8),
        None, None,
        [([_m("w0", active=1, usage=u, waiting=int(u * 6))], 2 if i == 0
          else None) for i, u in enumerate(_noise)])
       for pred in ("constant", "moving_average", "ar")},
    "sla": (
        dict(min_replicas=1, max_replicas=5, stable_intervals=2),
        dict(ttft_sla_s=0.1, itl_sla_s=0.01), None,
        [([_m("w0", active=6, waiting=4)], 1), ([_m("w0", active=40)], None),
         ([_m("w0")], 5), ([], None), ([], None),
         ([_m("w0", active=3), _m("w1", active=3, waiting=2)], None),
         ([_m("w1")], None), ([_m("w0")], None), ([], None)]),
    "sla-ar": (
        dict(min_replicas=1, max_replicas=6, stable_intervals=2,
             predictor="ar"),
        dict(itl_sla_s=0.008), None,
        [([_m("w0", active=a)], 1 if a == 2 else None)
         for a in (2, 4, 6, 8, 10, 12, 14, 10, 6, 2, 0, 0, 0)]),
    "predictive-ar": (
        dict(min_replicas=2, max_replicas=12, stable_intervals=3,
             predictor="ar", predictive=True, streams_per_replica=4.0),
        None, None,
        [([_m("w0", active=s, usage=0.5)], 2 if s == 4 else None)
         for s in (4, 8, 12, 16, 20, 24, 28, 30, 12, 4, 2)]),
    "predictive-inert": (
        dict(min_replicas=1, max_replicas=8, predictor="ar",
             predictive=True, streams_per_replica=0.0),
        None, None,
        [([_m("w0", active=30, usage=0.5)], 2), ([], None)]),
    "queue-wait": (
        dict(min_replicas=1, max_replicas=8, queue_wait_scale_up_s=2.0),
        None, {"w0": 9.0, "w1": 0.5},
        [([_m("w0", active=1, usage=0.5)], 2), ([], None),
         ([_m("w1", usage=0.5)], None)]),
    "fleet-ttft": (
        dict(min_replicas=1, max_replicas=8, fleet_ttft_scale_up_s=0.5,
             stable_intervals=2),
        None, None,
        [([_m("w0", usage=0.5, hist=_hist([0.1] * 20))], 2),
         ([_m("w0", usage=0.5, hist=_hist([0.1] * 20 + [2.0] * 5))], None),
         ([_m("w0", usage=0.5, hist=_hist([0.1] * 20 + [2.0] * 5))], None),
         ([_m("w0", usage=0.1, hist=_hist([0.1] * 40 + [2.0] * 5))],
          None), ([], None), ([], None)]),
    "fleet-queue": (
        dict(min_replicas=1, max_replicas=8, fleet_queue_scale_up_s=0.3),
        None, None,
        [([_m("w0", usage=0.5, hist=_hist([0.2] * 10)),
           _m("w1", usage=0.5, hist=_hist([0.1] * 10))], 2),
         ([_m("w1", usage=0.5, hist=_hist([0.1] * 10 + [3.0] * 4))],
          None), ([], None)]),
}


async def _drive(which, name):
    plan, prof, proto, registry = PKG[which]
    cfg_kw, sla_kw, waits, steps = SCENARIOS[name]
    conn = FakeConnector()
    sla = (prof.SlaCapacity(SLA_PROFILE, **sla_kw) if sla_kw is not None
           else None)
    planner = plan.Planner(
        kv=None, connector=conn, config=plan.PlannerConfig(**cfg_kw),
        sla=sla, load_view=FakeView(waits) if waits else None)
    registry.reset()
    targets = []
    for updates, force in steps:
        if force is not None:
            conn.n = force
        for d in updates:
            planner.aggregator.update(proto.ForwardPassMetrics.from_dict(d))
            planner.fleet_feed.observe(proto.ForwardPassMetrics.from_dict(d))
        targets.append(await planner.adjust())
    return targets, conn.calls, registry.render()


@pytest.mark.parametrize("name", list(SCENARIOS))
async def test_planner_decisions_equal_the_reference(name):
    ref = await _drive("ref", name)
    port = await _drive("port", name)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    # each scenario moves the fleet
    assert len(set(ref[0])) > 1 or name == "predictive-inert"
    if name.startswith("fleet"):
        assert "dynamo_planner_fleet_" in ref[2]


# ----------------------------------------------------------- connector

_READY_CHILD = (
    "import signal, sys, time\n"
    "ready, marker, ignore = sys.argv[1], sys.argv[2], sys.argv[3]\n"
    "def h(*a):\n"
    "    open(marker, 'w').write('ok')\n"
    "    sys.exit(0)\n"
    "signal.signal(signal.SIGTERM,\n"
    "              signal.SIG_IGN if ignore == '1' else h)\n"
    "print('child up', flush=True)\n"
    "open(ready, 'w').write('ready')\n"
    "time.sleep(60)\n"
)


async def _wait_for(pred, timeout_s=20.0):
    t_end = time.monotonic() + timeout_s
    while time.monotonic() < t_end:
        if pred():
            return True
        await asyncio.sleep(0.02)
    return pred()


@pytest.mark.parametrize("which", ["ref", "port"])
async def test_local_connector_drains_by_sigterm(which, tmp_path):
    plan = PKG[which][0]
    ready, marker = tmp_path / "ready", tmp_path / "drained"
    kw = {"log_dir": str(tmp_path)} if which == "port" else {}
    conn = plan.LocalConnector(
        [sys.executable, "-c", _READY_CHILD, str(ready), str(marker), "0"],
        drain_grace_s=10.0, **kw)
    try:
        await conn.set_replicas(1)
        assert conn.current_replicas() == 1
        proc = conn.procs[0]
        assert await _wait_for(ready.exists)
        await conn.set_replicas(0)
        assert conn.drains_started == 1 and conn.current_replicas() == 0
        assert await _wait_for(lambda: proc.poll() is not None)
        assert marker.read_text() == "ok"
        assert proc.returncode == 0   # a clean exit, not SIGKILL
        if which == "port":
            assert (tmp_path / "worker-0.log").read_text() == "child up\n"
    finally:
        await conn.shutdown()


@pytest.mark.parametrize("which", ["ref", "port"])
async def test_local_connector_kills_after_the_grace(which, tmp_path):
    plan = PKG[which][0]
    ready = tmp_path / "ready"
    conn = plan.LocalConnector(
        [sys.executable, "-c", _READY_CHILD, str(ready),
         str(tmp_path / "never"), "1"], drain_grace_s=0.4)
    try:
        await conn.set_replicas(1)
        proc = conn.procs[0]
        assert await _wait_for(ready.exists)
        t0 = time.monotonic()
        await conn.set_replicas(0)
        assert await _wait_for(lambda: proc.poll() is not None)
        assert proc.returncode == -signal.SIGKILL
        assert time.monotonic() - t0 >= 0.4
        assert not (tmp_path / "never").exists()
    finally:
        await conn.shutdown()


async def test_shutdown_kills_a_retiring_worker(tmp_path):
    """A worker still in its drain grace when the planner shuts down is
    killed, never left behind."""
    ready = tmp_path / "ready"
    conn = pplan.LocalConnector(
        [sys.executable, "-c", _READY_CHILD, str(ready),
         str(tmp_path / "never"), "1"], drain_grace_s=30.0)
    await conn.set_replicas(1)
    proc = conn.procs[0]
    assert await _wait_for(ready.exists)
    await conn.set_replicas(0)
    await conn.shutdown()
    assert await _wait_for(lambda: proc.poll() is not None)
    assert proc.returncode == -signal.SIGKILL


@pytest.mark.asyncio_timeout(60)
async def test_planner_scales_mocker_workers_1_2_1(tmp_path):
    """The port's planner over the port's store and LocalConnector: one
    ``out=mocker`` worker of the port's launcher; a held stream lifts its
    KV usage over the threshold, the planner spawns a second; the stream
    released, the planner drains the newest by SIGTERM (exit 0) and the
    fleet is back to one, with one scale-up and one scale-down counted."""
    from dynamo_tpu_torch.runtime.client import KvClient
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.store import serve_store

    server, _ = await serve_store(port=0, sweep_interval_s=0.05)
    port = server.sockets[0].getsockname()[1]
    cp = f"127.0.0.1:{port}"
    conn = pplan.LocalConnector(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "in=endpoint",
         "out=mocker", "--control-plane", cp, "--model-name", "pm",
         "--namespace", "plan"], drain_grace_s=20.0, log_dir=str(tmp_path))
    kv = await KvClient(port=port).connect()
    planner = pplan.Planner(kv, conn, pplan.PlannerConfig(
        adjustment_interval_s=0.5, kv_usage_scale_up=0.005,
        kv_usage_scale_down=0.001, waiting_scale_up=10_000,
        min_replicas=1, max_replicas=2, stable_intervals=2,
        metrics_stale_after_s=30.0))
    rt = await DistributedRuntime.connect(port=port)
    client = sip = None
    P_PLANNER.reset()
    try:
        await conn.set_replicas(1)
        client = await rt.namespace("plan").component("backend").endpoint(
            "generate").client()
        await client.wait_for_instances(1, timeout_s=30)
        await planner.start()
        stream = client.generate({
            "token_ids": list(range(1, 40)),
            "stop_conditions": {"max_tokens": 100000, "ignore_eos": True}})

        async def consume():
            async for _ in stream:
                await asyncio.sleep(0.01)

        sip = asyncio.create_task(consume())
        assert await _wait_for(lambda: conn.current_replicas() == 2, 20)
        await client.wait_for_instances(2, timeout_s=30)
        newest = conn.procs[-1]
        sip.cancel()
        await stream.aclose()
        assert await _wait_for(lambda: conn.current_replicas() == 1, 20)
        assert conn.drains_started == 1 and newest not in conn.procs
        assert await _wait_for(lambda: newest.poll() is not None, 15)
        assert newest.returncode == 0, (tmp_path / "worker-1.log"
                                        ).read_text()[-2000:]
        assert "drained; shutting down" in (
            tmp_path / "worker-1.log").read_text()
        assert await _wait_for(lambda: len(client.instance_ids()) == 1, 10)
        assert P_PLANNER.get("dynamo_planner_scale_ups_total") == 1
        assert P_PLANNER.get("dynamo_planner_scale_downs_total") == 1
    finally:
        if sip is not None:
            sip.cancel()
        await planner.stop()
        if client is not None:
            await client.stop()
        await conn.shutdown()
        await rt.close()
        await kv.close()
        server.close()


# ------------------------------------------------------ refusals, args


def _sla_args(tmp_path, **kw):
    prof = tmp_path / "prof.json"
    prof.write_text(json.dumps({"configs": [
        {"name": "a", "points": [{"concurrency": 4, "ttft_p50_s": 0.5,
                                  "itl_p50_s": 0.05}]},
        {"name": "b", "points": [{"concurrency": 2, "ttft_p50_s": 0.1,
                                  "itl_p50_s": 0.01}]}]}))
    base = dict(sla_profile=str(prof), ttft_sla=None, itl_sla=None,
                sla_config=None)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(ttft_sla=1.0),
    dict(ttft_sla=1.0, sla_config="zz"),
    dict(itl_sla=0.001, sla_config="a"),
    dict(ttft_sla=0.2, sla_config="b"),
    dict(sla_profile=None, ttft_sla=0.1),
    dict(sla_profile=None),
])
def test_build_sla_refuses_as_the_reference(kw, tmp_path):
    args = _sla_args(tmp_path, **kw)
    try:
        want = rplan._build_sla(args)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            pplan._build_sla(args)
        assert str(got.value) == str(e)
        return
    got = pplan._build_sla(args)
    if want is None:
        assert got is None
    else:
        assert (got.max_concurrency(), got.config_name) == (
            want.max_concurrency(), want.config_name)


def test_unported_connectors_are_refused_by_name():
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        pplan.MultihostLocalConnector(["x"], num_nodes=2)
