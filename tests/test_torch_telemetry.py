"""The port's telemetry modules held against the JAX package's: the same
calls, on one injected clock, through the reference's
``dynamo_tpu.telemetry`` and the port's ``dynamo_tpu_torch.telemetry``
give byte-equal renders and equal snapshots and JSON — histograms with
exemplars, the trace store and its 404 bodies, the flight ring, the
stream-event ring and the Perfetto timeline, and the fleet latency feed.
Then the slice: the reference ``HttpService(TpuEngine)`` and the port's
``HttpService(TorchEngine, cpu)`` serve the same burst, dense and int8 KV,
and their span trees, timing annotations and ``/debug/*`` answers
match."""
import asyncio
import importlib
import json
import logging
from types import SimpleNamespace

import jax
import numpy as np
import pytest

MODULES = ("metrics", "trace", "flight", "prof", "timeline", "forensics",
           "fleet_feed")


class FakeClock:
    """time.time / time.monotonic stand-in, advanced by hand."""

    def __init__(self, t: float = 1_700_000_000.0):
        self.t = t

    def time(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t - 1_600_000_000.0

    def tick(self, dt: float) -> None:
        self.t += dt


def _ns(pkg: str, clock: FakeClock, monkeypatch) -> SimpleNamespace:
    mods = {m: importlib.import_module(f"{pkg}.telemetry.{m}")
            for m in MODULES}
    for m in MODULES:
        if hasattr(mods[m], "time"):
            monkeypatch.setattr(mods[m], "time", clock)
    return SimpleNamespace(**mods)


@pytest.fixture
def both(monkeypatch):
    """(reference, port) module namespaces on two clocks at one time."""
    rc, pc = FakeClock(), FakeClock()
    return ((_ns("dynamo_tpu", rc, monkeypatch), rc),
            (_ns("dynamo_tpu_torch", pc, monkeypatch), pc))


# ---------------------------------------------------------------------------
# module scenarios: each takes (namespace, clock) and returns JSON-able
# output; the reference's and the port's must be equal

def sc_histogram(t, clock):
    h = t.metrics.Histogram("t_seconds", "test", buckets=(0.1, 1.0, 10.0))
    for i, v in enumerate((0.05, 0.5, 0.5, 5.0, 50.0)):
        clock.tick(0.25)
        h.observe(v, exemplar_id=f"req-{i}" if i % 2 == 0 else None)
    h.observe(0.5, n=3)
    h.observe(float("nan"))
    h.observe(0.5, n=0)
    out = {
        "snap": h.snapshot(), "count": h.count, "sum": h.sum,
        "plain": h.render(), "labelled": h.render('worker="w0"'),
        "om": h.render('worker="w0"', openmetrics=True),
        "p50": h.percentile(0.5), "p99": h.percentile(0.99),
    }
    h.reset()
    out["reset"] = h.snapshot()
    return out


def sc_plain_render_ignores_exemplars(t, clock):
    a = t.metrics.Histogram("x_seconds", "x")
    b = t.metrics.Histogram("x_seconds", "x")
    for v in (0.001, 0.02, 0.3, 4.0):
        a.observe(v)
        b.observe(v, exemplar_id="rid-1")
    assert a.render() == b.render()
    assert a.render(openmetrics=True) == a.render()
    return {"plain": b.render(), "om": b.render(openmetrics=True),
            "round_trip": t.metrics.render_histogram(
                "x_seconds", "x", json.loads(json.dumps(b.snapshot())),
                openmetrics=True)}


def sc_observe_many(t, clock):
    h = t.metrics.Histogram("m", "m", buckets=(0.1, 1.0))
    h.observe_many(np.asarray([0.05, 0.1, 0.5, 2.0, np.inf, np.nan]))
    h.observe_many([])
    return h.snapshot()


def sc_registry(t, clock):
    reg = t.metrics.request_histograms(t.metrics.TelemetryRegistry(),
                                       engine=True)
    reg.get("dynamo_request_ttft_seconds").observe(0.2, exemplar_id="r1")
    reg.get("dynamo_engine_round_seconds").observe(0.004)
    return {"snap": reg.snapshot(), "plain": reg.render(),
            "labelled": reg.render('worker="w1"'),
            "om": reg.render(openmetrics=True),
            "weighted": [t.metrics.weighted_percentile(
                [(0.010, 1), (0.002, 8), (0.030, 1)], q)
                for q in (0.5, 1.0)]}


def sc_flight(t, clock):
    out = {}
    for cap, n in ((8, 20), (4, 4), (3, 0)):
        f = t.flight.FlightRecorder(capacity=cap)
        for i in range(n):
            clock.tick(0.001)
            f.record("round", n=i, slots=[i % 3])
        out[f"{cap}/{n}"] = {"len": len(f), "total": f.recorded_total,
                             "events": f.snapshot()}
    records = []

    class _Sink(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    log = logging.getLogger(f"flight_dump_{t.flight.__name__}")
    log.addHandler(_Sink())
    log.setLevel(logging.ERROR)
    f = t.flight.FlightRecorder(capacity=2)
    f.record("prefill", slots=[0, 1])
    f.dump(log, reason="boom")
    out["dump"] = records
    return out


def _no_created(d: dict) -> dict:
    """A trace dict without ``created_s`` (stamped by the real clock: the
    dataclass bound time.time when it was defined)."""
    assert isinstance(d.pop("created_s"), float)
    return d


def sc_trace_store(t, clock):
    Span = t.trace.Span
    store = t.trace.TraceStore(max_completed=3)
    tr = store.start("r1")
    out = {"active": store.has_active("r1")}
    tr.add(Span(name="tokenize", start_s=1.0, duration_s=0.1))
    out["add"] = store.add_span("r1", Span(name="route", start_s=1.1))
    out["add_missing"] = store.add_span("nope", Span("x", 0.0))
    store.merge("r1", [{"name": "queue", "start_s": 1.2,
                        "duration_s": 0.05}, {"bad": object}])
    store.alias("c1", "r1")
    out["alias_add"] = store.add_span("c1", Span("route", 1.3))
    out["r1"] = _no_created(store.finish("r1").to_dict())
    out["alias_after"] = store.has_active("c1")
    # a shell buffers, a promotion adopts its buffer
    store.start("s1", sampled=False)
    store.add_span("s1", Span("tokenize", 2.0))
    store.merge("s1", [{"name": "prefill", "start_s": 2.1}])
    out["promote"] = store.promote("s1")
    out["s1"] = _no_created(store.finish("s1").to_dict())
    # an unpromoted shell is dropped; the ring evicts the oldest
    store.start("s2", sampled=False)
    store.finish("s2")
    for i in range(5):
        clock.tick(1.0)
        store.record_remote(f"x{i}", [{"name": "prefill", "start_s": 0.0,
                                       "children": [{"name": "kv_chunk",
                                                     "start_s": 0.0}]}])
    out["recent"] = store.recent_ids()
    out["missing"] = {rid: store.describe_missing(rid)
                      for rid in ("r1", "s2", "never")}
    out["x4"] = _no_created(store.get("x4").to_dict())
    out["span_now"] = t.trace.span_now("g2_onboard", clock.monotonic()
                                       - 0.5, blocks=4).to_dict()
    sp = Span("prefill", 10.0, 0.5, {"slot": 3},
              [Span("g2_onboard", 10.1, 0.2, {"blocks": 4})])
    out["round_trip"] = Span.from_dict(
        json.loads(json.dumps(sp.to_dict()))).to_dict()
    store.clear()
    out["cleared"] = store.describe_missing("x4")
    return out


def sc_timeline(t, clock):
    tl = t.timeline
    ring = tl.StreamEventRing(capacity=3)
    for i, kind in enumerate((tl.FRAME_SEND, tl.FRAME_RECV,
                              tl.EOF_ACK_WAIT, tl.COMMIT_WAKEUP)):
        clock.tick(0.01)
        ring.record(kind, 0.002 * (i + 1), seq=i, job="j1")
    stream = ring.snapshot()
    rounds = [(1_700_000_001.0, 0.004, (0.001, 0.0, 0.002) + (0.0,) * 10
               + (0.001,))]
    flight = [{"seq": 0, "ts": 1_700_000_000.5, "kind": "round",
               "slots": [0], "dispatch_ms": 0.1}]
    trace = {"trace_id": "rid", "spans": [
        {"name": "remote_prefill", "start_s": 1_700_000_000.2,
         "duration_s": 0.3, "attrs": {"blocks": 4},
         "children": [{"name": "kv_chunk", "start_s": 1_700_000_000.25,
                       "duration_s": 0.05}]}]}
    doc = tl.to_chrome_trace(spans=trace["spans"], round_records=rounds,
                             flight_events=flight, stream_events=stream,
                             label="rid")
    ring.clear()
    return {"stream": stream, "doc": doc, "empty": tl.to_chrome_trace(),
            "from_trace": tl.trace_to_chrome(trace, stream_events=stream),
            "after_clear": ring.snapshot()}


class _M:
    def __init__(self, worker_id, histograms):
        self.worker_id = worker_id
        self.histograms = histograms


def sc_fleet_feed(t, clock):
    feed = t.fleet_feed.FleetLatencyFeed(stale_after_s=5.0,
                                         clock=clock.monotonic)
    hs = {}
    for w in ("w0", "w1", "w2"):
        reg = t.metrics.request_histograms(t.metrics.TelemetryRegistry(),
                                           engine=True)
        for v in (0.01, 0.2, 1.5):
            clock.tick(0.1)
            reg.get("dynamo_request_ttft_seconds").observe(
                v, exemplar_id=f"{w}-r")
        reg.get("dynamo_request_queue_seconds").observe(0.003)
        hs[w] = reg
    odd = {"dynamo_request_ttft_seconds": {"buckets": [1.0],
                                           "counts": [1, 2], "sum": 3.0,
                                           "count": 2}}
    feed.observe(_M("w0", hs["w0"].snapshot()))
    feed.observe(_M("w1", hs["w1"].snapshot()))
    feed.observe(_M("w2", odd))       # a ladder that does not merge
    feed.observe(_M("w3", {}))        # nothing to fold
    out = {"workers": feed.workers(), "merged": feed.merged(),
           "p50": feed.percentile("dynamo_fleet_request_ttft_seconds", 0.5),
           "first": feed.advance()}
    hs["w0"].get("dynamo_request_ttft_seconds").observe(0.05)
    feed.observe(_M("w0", hs["w0"].snapshot()))
    out["delta"] = feed.advance()
    out["plain"] = feed.render()
    out["om"] = feed.render(openmetrics=True)
    clock.tick(10.0)                  # every worker goes stale
    out["stale"] = (feed.workers(), feed.render())
    feed.reset()
    return out


SCENARIOS = {
    "histogram": sc_histogram,
    "plain_render_ignores_exemplars": sc_plain_render_ignores_exemplars,
    "observe_many": sc_observe_many,
    "registry": sc_registry,
    "flight": sc_flight,
    "trace_store": sc_trace_store,
    "timeline": sc_timeline,
    "fleet_feed": sc_fleet_feed,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_module_matches_reference(both, name):
    (ref, rc), (port, pc) = both
    want = SCENARIOS[name](ref, rc)
    got = SCENARIOS[name](port, pc)
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)


def test_package_exports_match_reference():
    import dynamo_tpu.telemetry as r
    import dynamo_tpu_torch.telemetry as p

    assert sorted(p.__all__) == sorted(r.__all__)
    assert p.SEGMENTS == r.SEGMENTS and p.HOST_BUCKETS == r.HOST_BUCKETS
    assert p.fleet_feed.FLEET_FAMILIES == r.fleet_feed.FLEET_FAMILIES
    assert p.forensics.FAMILIES == r.forensics.FAMILIES


# ---------------------------------------------------------------------------
# the slice: the reference's HttpService(TpuEngine) beside the port's
# HttpService(TorchEngine, cpu) on tiny f32

ENGINE_KW = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                 max_decode_slots=4, prefill_buckets=(32, 64),
                 cache_dtype="float32")
BURST = [list(range(5 + 7 * i, 40 + 7 * i)) for i in range(4)]
MAX_TOKENS = 9


def _managers(kv_quant: str, sample_rate: float = 0.0, **engine_kw):
    from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu.models import llama as jl
    from dynamo_tpu.models.config import ModelConfig as JConfig
    from dynamo_tpu.parallel.mesh import MeshConfig
    from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig as TConfig
    from dynamo_tpu_torch.models.llama import params_from_jax
    from tests.test_torch_frontend import _manager

    kw = dict(ENGINE_KW, kv_quant=kv_quant,
              forensics_sample_rate=sample_rate, **engine_kw)
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    ref = TpuEngine(JConfig.tiny(dtype="float32"), JEngineConfig(**kw),
                    params=jparams, mesh_config=MeshConfig(tp=1))
    port = TorchEngine(
        TConfig.tiny(dtype="float32"), TEngineConfig(**kw),
        params=params_from_jax(jax.tree.map(np.asarray, jparams),
                               device="cpu"),
        device="cpu")
    return _manager(True, "tiny", port), _manager(False, "tiny", ref)


@pytest.fixture(scope="module", params=["none", "int8"])
def tiny_pair(request):
    port_mgr, ref_mgr = _managers(request.param)
    yield request.param, port_mgr, ref_mgr
    asyncio.run(port_mgr.get("tiny").engine.stop())
    asyncio.run(ref_mgr.get("tiny").engine.stop())


def _clear_planes():
    import dynamo_tpu.telemetry as r
    import dynamo_tpu_torch.telemetry as p

    for t in (r, p):
        t.TRACES.clear()
        t.OUTLIERS.clear()
        t.FORENSICS.reset()
        t.PROF.reset()
        t.FLEET_FEED.reset()


def span_shape(spans: list) -> list:
    """A span list's names, nesting and counts, timings aside."""
    return [[s["name"], span_shape(s.get("children") or [])]
            for s in spans]


async def serve_burst(service, prompts=BURST, n=MAX_TOKENS):
    """One burst of streamed completions released together through
    ``service`` (a test_torch_frontend _Port or _Ref); returns each
    request's (X-Request-Id, joined text)."""
    gate = asyncio.Event()

    async def one(p):
        await gate.wait()
        st, h, events = await service.call(
            "POST", "/v1/completions",
            {"model": "tiny", "prompt": p, "max_tokens": n, "stream": True,
             "nvext": {"ignore_eos": True}}, stream=True)
        assert st == 200
        text = "".join(json.loads(e)["choices"][0].get("text") or ""
                       for e in events[:-1] if json.loads(e)["choices"])
        return h["x-request-id"] if "x-request-id" in h \
            else h["X-Request-Id"], text

    tasks = [asyncio.ensure_future(one(p)) for p in prompts]
    await asyncio.sleep(0)
    gate.set()
    return await asyncio.gather(*tasks)


async def _get(service, path):
    st, _, body = await service.call("GET", path)
    return st, body


def _event_keys(flight_body: dict) -> dict:
    """kind -> sorted field names, over every engine's ring."""
    out: dict = {}
    for eng in flight_body["engines"].values():
        for ev in eng["events"]:
            out.setdefault(ev["kind"], sorted(ev))
    return out


async def test_slice_trace_trees_and_debug_answers_match(tiny_pair):
    from tests.test_torch_frontend import _Port, _Ref

    kv, port_mgr, ref_mgr = tiny_pair
    _clear_planes()
    async with _Port(port_mgr) as p:
        got = await serve_burst(p)
        ptrees = [await _get(p, f"/debug/trace/{rid}") for rid, _ in got]
        pflight = await _get(p, "/debug/flight")
        pout = await _get(p, "/debug/outliers")
        pprof = await _get(p, "/debug/prof")
        pindex = await _get(p, "/debug/trace")
    async with _Ref(ref_mgr) as r:
        want = await serve_burst(r)
        rtrees = [await _get(r, f"/debug/trace/{rid}") for rid, _ in want]
        rflight = await _get(r, "/debug/flight")
        rout = await _get(r, "/debug/outliers")
    # greedy tokens identical
    assert [t for _, t in got] == [t for _, t in want]
    for (ps, ptree), (rs, rtree) in zip(ptrees, rtrees):
        assert ps == rs == 200
        assert ptree.keys() == rtree.keys()
        assert span_shape(ptree["spans"]) == span_shape(rtree["spans"])
        names = [s["name"] for s in ptree["spans"]]
        assert names[:3] == ["tokenize", "queue", "prefill"], names
        assert names.count("decode_round") == -(-(MAX_TOKENS - 1) // 4)
    assert pflight[0] == rflight[0] == 200
    assert pflight[1].keys() == rflight[1].keys() == {"engines"}
    pk, rk = _event_keys(pflight[1]), _event_keys(rflight[1])
    assert "round" in pk and pk["round"] == rk["round"]
    for kind in set(pk) & set(rk):
        assert pk[kind] == rk[kind], kind
    assert pout[0] == rout[0] == 200 and pout[1].keys() == rout[1].keys()
    assert pprof[0] == 200 and pindex[0] == 200
    eng = port_mgr.get("tiny").engine
    assert pprof[1]["engines"]["tiny"].keys() == eng.prof.summary().keys()
    assert set(pindex[1]["recent"]) >= {rid for rid, _ in got}
    # every recorded round's segments sum to its wall time
    rows = eng.prof.recent(256)
    assert rows
    for _, wall, acc in rows:
        assert abs(sum(acc) - wall) <= 0.02 * wall + 1e-9
    assert 0.98 <= eng.prof.coverage() <= 1.02


async def test_slice_finishing_annotations_match(tiny_pair):
    """The engines' own finishing outputs: the same timing keys, values
    rounded to 6 places, and the same worker-side span shape."""
    from dynamo_tpu.protocols.common import PreprocessedRequest as RReq
    from dynamo_tpu.protocols.common import StopConditions as RStop
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest as PReq
    from dynamo_tpu_torch.protocols.common import StopConditions as PStop

    kv, port_mgr, ref_mgr = tiny_pair
    _clear_planes()

    async def finish(engine, Req, Stop, detail):
        last = None
        async for out in engine.generate(Req(
                token_ids=BURST[0], request_id=f"ann-{detail}",
                annotations=["trace_detail"] if detail else [],
                stop_conditions=Stop(max_tokens=MAX_TOKENS,
                                     ignore_eos=True))):
            last = out
        return last.annotations

    for detail in (False, True):
        pa = await finish(port_mgr.get("tiny").engine, PReq, PStop, detail)
        ra = await finish(ref_mgr.get("tiny").engine, RReq, RStop, detail)
        assert pa["timing"].keys() == ra["timing"].keys()
        assert pa["timing"]["decode_rounds"] == ra["timing"]["decode_rounds"]
        for v in pa["timing"].values():
            assert v == round(v, 6)
        assert span_shape(pa["trace"]["spans"]) == \
            span_shape(ra["trace"]["spans"])


async def test_slice_system_server_debug_routes_match(tiny_pair):
    """The per-worker system server over each engine: /debug/prof,
    /debug/flight, /debug/trace and /debug/outliers answer with the
    reference's status and keys, and the metrics carry the engine's
    histograms and the PROF, FLEET_FEED and FORENSICS families."""
    from aiohttp.test_utils import TestClient, TestServer

    from dynamo_tpu.runtime.system_server import SystemServer as RSys
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.runtime.system_server import SystemServer as PSys

    kv, port_mgr, ref_mgr = tiny_pair
    peng, reng = port_mgr.get("tiny").engine, ref_mgr.get("tiny").engine
    psys = await PSys(peng, host="127.0.0.1", port=0,
                      worker_id="w0").start()
    rclient = TestClient(TestServer(RSys(reng, worker_id="w0").app))
    await rclient.start_server()
    paths = ["/debug/prof", "/debug/prof?top=3", "/debug/flight",
             "/debug/trace", "/debug/trace/never", "/debug/outliers",
             "/debug/outliers/never"]
    try:
        for path in paths:
            async with HttpClient("127.0.0.1", psys.port) as c:
                pr = await c.request("GET", path)
            rr = await rclient.get(path)
            rbody = await rr.json()
            assert pr.status == rr.status, path
            assert pr.json().keys() == rbody.keys(), path
            if path.startswith("/debug/prof"):
                assert [s.keys() for s in pr.json()["segments"]] == \
                    [s.keys() for s in rbody["segments"]]
        async with HttpClient("127.0.0.1", psys.port) as c:
            plain = (await c.request("GET", "/metrics")).body.decode()
            om = (await c.request("GET", "/metrics", headers={
                "Accept": "application/openmetrics-text"})).body.decode()
        for fam in ("dynamo_host_round_seconds_bucket{segment=",
                    "dynamo_host_round_coverage_ratio",
                    "dynamo_slo_ttft_burn_rate", "dynamo_fleet_feed_workers",
                    "dynamo_forensics_dossiers_total",
                    'dynamo_request_ttft_seconds_bucket{worker="w0"',
                    'dynamo_engine_round_seconds_count{worker="w0"}'):
            assert fam in plain, fam
        assert "# {trace_id=" not in plain and "# EOF" not in plain
        assert om.endswith("# EOF\n")
    finally:
        await psys.stop()
        await rclient.close()
