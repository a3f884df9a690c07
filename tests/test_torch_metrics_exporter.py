"""The port's metrics exporter (dynamo_tpu_torch/metrics_exporter.py)
against the JAX package's: both subscribe one store's load-metrics plane;
after the same publications (two workers, speculation figures, latency
histograms) both ``/metrics`` answers carry the same Content-Type and
the same sample names, and the samples of the load plane (per-worker
gauges, the shipped histograms, the worker count) the same values, in
Prometheus text and in OpenMetrics. The counters of this process's other
planes are each package's own, so only their families are compared; the
process-wide fleet latency feeds, which every exporter appends, are reset
in both packages around the comparison (an earlier test in the same
process may have fed one of them a histogram that is not yet stale).
``python -m dynamo_tpu_torch.cli metrics`` serves the same in a
subprocess and stops with exit code 0 on SIGTERM."""
import asyncio
import signal
import subprocess
import sys
from pathlib import Path

import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.metrics_exporter import MetricsExporter as RExporter
from dynamo_tpu.telemetry import metrics as rmet
from dynamo_tpu.telemetry.fleet_feed import FLEET_FEED as RFEED
from dynamo_tpu_torch.frontend.http import HttpClient
from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvStats,
    WorkerStats,
)
from dynamo_tpu_torch.metrics_exporter import MetricsExporter as PExporter
from dynamo_tpu_torch.runtime.client import KvClient
from dynamo_tpu_torch.runtime.publisher import WorkerMetricsPublisher
from dynamo_tpu_torch.runtime.store import serve_store
from dynamo_tpu_torch.telemetry.fleet_feed import FLEET_FEED as PFEED

ROOT = Path(__file__).resolve().parent.parent
LOAD_PLANE = ("dynamo_worker_", "dynamo_kv_active", "dynamo_kv_total",
              "dynamo_kv_usage", "dynamo_kv_hit", "dynamo_kv_host",
              "dynamo_spec_proposed", "dynamo_spec_accepted",
              "dynamo_spec_acceptance", "dynamo_spec_effective",
              "dynamo_request_", "dynamo_engine_round",
              "dynamo_metrics_workers")


def _metrics(worker, seed):
    reg = rmet.request_histograms(rmet.TelemetryRegistry(), engine=True)
    for i in range(5 + seed):
        reg.get(rmet.TTFT[0]).observe(0.01 * (i + 1) * (seed + 1),
                                      exemplar_id=f"r{i}")
        reg.get(rmet.ITL[0]).observe(0.002 * (i + 1))
        reg.get(rmet.QUEUE[0]).observe(0.001 * i)
    return ForwardPassMetrics(
        worker_id=worker,
        worker_stats=WorkerStats(
            request_active_slots=3 + seed, request_total_slots=8,
            num_requests_waiting=seed, num_waiting_prefill_tokens=64 * seed,
            max_waiting_requests=16, spec_proposed_total=40 * seed,
            spec_accepted_total=25 * seed, spec_acceptance_rate=0.625,
            spec_effective_k=3.5),
        kv_stats=KvStats(kv_active_blocks=10 + seed, kv_total_blocks=128,
                         gpu_cache_usage_perc=0.42 + seed / 100,
                         gpu_prefix_cache_hit_rate=0.25, host_blocks=7,
                         host_onboard_hits=2),
        histograms={n: reg.get(n).snapshot()
                    for n, _ in (rmet.TTFT, rmet.ITL, rmet.QUEUE)})


async def _scrape(port, accept=None):
    async with HttpClient("127.0.0.1", port) as c:
        r = await c.request("GET", "/metrics",
                            headers={"Accept": accept} if accept else None)
        assert r.status == 200
        return r.headers["Content-Type"], r.body.decode()


def _parse(text):
    """(family names, {(sample name, labels): value})."""
    if "# EOF" in text:
        text = "\n".join(line.split(" # ")[0]
                         for line in text.splitlines() if line != "# EOF")
    fams = list(text_string_to_metric_families(text))
    return ({f.name for f in fams},
            {(s.name, tuple(sorted(s.labels.items()))): s.value
             for f in fams for s in f.samples})


@pytest.fixture
def fresh_fleet_feeds():
    """Both packages' process-wide FLEET_FEED empty before the test
    publishes and after it ends."""
    for feed in (RFEED, PFEED):
        feed.reset()
    yield
    for feed in (RFEED, PFEED):
        feed.reset()


@pytest.mark.parametrize("accept", [None, "application/openmetrics-text"],
                         ids=["plain", "openmetrics"])
async def test_exporter_equals_the_reference(accept, fresh_fleet_feeds):
    server, _ = await serve_store(port=0)
    port = server.sockets[0].getsockname()[1]
    kvs = [await KvClient(port=port).connect() for _ in range(3)]
    ref = await RExporter(kvs[0], host="127.0.0.1", port=0).start()
    prt = await PExporter(kvs[1], host="127.0.0.1", port=0).start()
    pubs = []
    try:
        for seed, worker in enumerate(("w7", "w8")):
            pub = WorkerMetricsPublisher(kvs[2], worker, min_interval_s=0.0)
            pub.start()
            pubs.append(pub)
            pub(_metrics(worker, seed))
        for _ in range(100):
            if (len(ref.aggregator.snapshot().metrics) == 2
                    and len(prt.aggregator.snapshot().metrics) == 2):
                break
            await asyncio.sleep(0.02)
        (rt, rtext), (pt, ptext) = [await _scrape(e.port, accept)
                                    for e in (ref, prt)]
    finally:
        for pub in pubs:
            await pub.stop()
        await ref.stop()
        await prt.stop()
        for kv in kvs:
            await kv.close()
        server.close()
    assert pt == rt
    (rf, rs), (pf, ps) = _parse(rtext), _parse(ptext)
    # every family; the series of this process's labelled registries
    # (tenants) depend on what ran before in the process, so by family
    assert pf == rf
    load = {k: v for k, v in rs.items() if k[0].startswith(LOAD_PLANE)}
    assert load == {k: v for k, v in ps.items()
                    if k[0].startswith(LOAD_PLANE)}
    assert load[("dynamo_kv_usage_perc", (("worker", "w8"),))] == 0.43
    assert load[("dynamo_metrics_workers", ())] == 2
    assert load[("dynamo_request_ttft_seconds_count",
                 (("worker", "w8"),))] == 6
    assert "dynamo_planner_replicas" in rf
    if accept:
        assert "# {" in ptext   # the TTFT exemplars
        assert ptext.endswith("# EOF\n")


async def test_metrics_cli_serves_and_stops_on_sigterm():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        http_port = s.getsockname()[1]
    server, _ = await serve_store(port=0)
    cp = server.sockets[0].getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "metrics",
         "--control-plane", f"127.0.0.1:{cp}", "--host", "127.0.0.1",
         "--port", str(http_port)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    loop = asyncio.get_running_loop()
    try:
        line = await asyncio.wait_for(
            loop.run_in_executor(None, proc.stdout.readline), 60)
        assert line.strip() == (f"metrics exporter on "
                                f"http://127.0.0.1:{http_port}/metrics")
        ctype, text = await _scrape(http_port)
        assert ctype == "text/plain; charset=utf-8"
        assert "dynamo_metrics_workers 0" in text
        proc.send_signal(signal.SIGTERM)
        rc = await loop.run_in_executor(None, lambda: proc.wait(timeout=30))
        assert rc == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        server.close()
