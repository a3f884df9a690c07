"""The port's SLO-breach forensics (telemetry/forensics.py) held against
the JAX package's: the dossier ring, the KV path distilled from spans and
the breach / sample decision give equal JSON and renders for the same
calls on one injected clock. Then the slice on tiny f32 on the CPU, dense
and int8 KV: a TorchEngine finishing a request no frontend traces records
its spans and (at sample rate 1.0) a worker-side dossier as TpuEngine
does; the port's HttpService over TorchEngine and the reference's over
TpuEngine capture a breach's and a sample's dossier, with the same
``/debug/outliers`` answers, 404 bodies and a Perfetto export that
parses, and the port's tools read them."""
import asyncio
import json

import pytest

from tests.test_torch_telemetry import (  # noqa: F401 — both: a fixture
    BURST,
    MAX_TOKENS,
    _clear_planes,
    _managers,
    both,
    serve_burst,
    span_shape,
)


SPANS = [
    {"name": "tokenize", "start_s": 1.0, "duration_s": 0.001},
    {"name": "route", "start_s": 1.001, "duration_s": 0.0001,
     "attrs": {"worker": "7", "overlap_blocks": 3}},
    {"name": "overload_bounce", "start_s": 1.002, "attrs": {"worker": "8"}},
    {"name": "migrate", "start_s": 1.5,
     "attrs": {"from_worker": "7", "replayed_tokens": 5}},
    {"name": "queue", "start_s": 1.003, "duration_s": 0.0421},
    {"name": "prefill", "start_s": 1.05, "duration_s": 0.02,
     "children": [{"name": "g2_onboard", "start_s": 1.05,
                   "attrs": {"blocks": 2}}]},
    {"name": "g4_fetch", "start_s": 1.01, "attrs": {"blocks": 4},
     "children": [{"name": "g4_chunk", "start_s": 1.01}]},
    {"name": "remote_prefill", "start_s": 1.02,
     "children": [{"name": "kv_chunk", "start_s": 1.03}]},
]


def sc_dossier_ring(t, clock):
    t.forensics.FORENSICS.reset()
    ring = t.forensics.DossierRing(capacity=3)
    for i in range(5):
        clock.tick(0.5)
        ring.add(t.forensics.Dossier(
            request_id=f"r{i}", reason="ttft_breach", worker_id="w",
            captured_s=clock.time(),
            timing={"ttft_s": 0.1 * i, "e2e_s": 1.0},
            trace={"spans": SPANS[:i]}, rounds=[(1.0, 0.1, [0.1])]))
    out = {"index": ring.index(), "oldest": ring.oldest_id(),
           "recent2": [d.to_dict() for d in ring.recent(2)],
           "missing": ring.get("r0"), "r4": ring.get("r4").summary(),
           "kv_path": t.forensics.kv_path_from_spans(SPANS),
           "kv_path_empty": t.forensics.kv_path_from_spans([]),
           "render": t.forensics.FORENSICS.render()}
    ring.clear()
    out["cleared"] = ring.index()
    t.forensics.FORENSICS.reset()
    return out


class _Eng:
    """An engine-like object with rings to clip."""

    def __init__(self, t, clock):
        self.prof = t.prof.RoundProf()
        self.flight = t.flight.FlightRecorder(8)
        for i in range(4):
            self.prof.begin_round()
            self.prof.enter(2)
            clock.tick(0.2)
            self.prof.end_round()
            self.flight.record("round", slots=[i])


def sc_capture(t, clock):
    f = t.forensics
    f.FORENSICS.reset()
    t.timeline.STREAM_EVENTS.clear()
    store = t.trace.TraceStore()
    ring = f.DossierRing(capacity=8)
    eng = _Eng(t, clock)
    cap = f.ForensicsCapture(ring, sample_rate=0.5, ttft_target_s=0.5,
                             itl_target_s=0.05, e2e_target_s=2.0,
                             engines_fn=lambda: [eng], traces=store,
                             seed=7)
    out = {"reasons": [cap.breach_reason(*a) for a in (
        (0.6, None, None), (0.1, 0.06, None), (0.1, 0.01, 3.0),
        (None, None, None))]}
    # a shell trace promoted by a late breach keeps its buffered spans
    store.start("shell", sampled=False)
    store.merge("shell", SPANS[:3])
    out["on_finish"] = cap.on_finish("shell", ttft_s=0.9, e2e_s=1.0,
                                     queue_s=0.02, timing={"x": 1})
    out["pending"] = cap.pending("shell")
    tr = store.finish("shell")
    tr.created_s = clock.time() - 0.5   # the window the rings clip to
    t.timeline.STREAM_EVENTS.record(t.timeline.FRAME_SEND, 0.01, seq=0)
    d = cap.on_trace_finished("shell", tr)
    out["dossier"] = dict(d.to_dict(), captured_s=None,
                          trace=dict(d.trace, created_s=None))
    out["again"] = cap.on_trace_finished("shell", tr)
    # healthy finishes: the seeded coin flip decides
    out["coin"] = [cap.on_finish(f"h{i}", ttft_s=0.1, itl_p95_s=0.01,
                                 e2e_s=0.2) for i in range(8)]
    out["none_id"] = cap.on_finish("", ttft_s=9.0)
    wd = cap.worker_finish("w1", timing={"ttft_s": 2.0, "queue_s": 0.3},
                           worker_id="7", trace_spans=SPANS[4:6])
    out["worker"] = dict(wd.to_dict(), captured_s=None)
    out["worker_healthy"] = f.ForensicsCapture(
        f.DossierRing(), traces=store).worker_finish(
            "w2", timing={"ttft_s": 0.01}, worker_id="7", trace_spans=[])
    out["index"] = [dict(s, captured_s=None)
                    for s in ring.index()["outliers"]]
    out["render"] = f.FORENSICS.render()
    f.FORENSICS.reset()
    t.timeline.STREAM_EVENTS.clear()
    return out


SCENARIOS = {"dossier_ring": sc_dossier_ring, "capture": sc_capture}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_forensics_module_matches_reference(both, name):
    (ref, rc), (port, pc) = both
    want = SCENARIOS[name](ref, rc)
    got = SCENARIOS[name](port, pc)
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)


# ---------------------------------------------------------------------------
# the slice

@pytest.fixture(scope="module", params=["none", "int8"])
def sampled_pair(request):
    """The port's and the reference's tiny engines with the worker-side
    forensics sample rate at 1.0, and SLO targets no CPU run breaches
    (the reference compiles on its first requests)."""
    port_mgr, ref_mgr = _managers(request.param, sample_rate=1.0,
                                  slo_ttft_target_s=60.0,
                                  slo_itl_target_s=60.0)
    yield request.param, port_mgr, ref_mgr
    asyncio.run(port_mgr.get("tiny").engine.stop())
    asyncio.run(ref_mgr.get("tiny").engine.stop())


def _kv_shape(kv_path: dict) -> dict:
    """A dossier's KV path with its queue wait reduced to present/absent
    (a timing)."""
    return dict(kv_path, queue_wait_s=kv_path["queue_wait_s"] is not None)


async def _untraced_finish(engine, Req, Stop, rid):
    """generate() with no frontend trace active: a remote worker."""
    last = None
    async for out in engine.generate(Req(
            token_ids=BURST[1], request_id=rid,
            annotations=["trace_detail"],
            stop_conditions=Stop(max_tokens=MAX_TOKENS, ignore_eos=True))):
        last = out
    return last.annotations


async def test_remote_worker_records_its_trace_and_dossier(sampled_pair):
    import dynamo_tpu.telemetry as rt
    import dynamo_tpu_torch.telemetry as pt
    from dynamo_tpu.protocols.common import PreprocessedRequest as RReq
    from dynamo_tpu.protocols.common import StopConditions as RStop
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest as PReq
    from dynamo_tpu_torch.protocols.common import StopConditions as PStop

    kv, port_mgr, ref_mgr = sampled_pair
    _clear_planes()
    pa = await _untraced_finish(port_mgr.get("tiny").engine, PReq, PStop,
                                "remote-1")
    ra = await _untraced_finish(ref_mgr.get("tiny").engine, RReq, RStop,
                                "remote-1")
    ptr, rtr = pt.TRACES.get("remote-1"), rt.TRACES.get("remote-1")
    assert ptr is not None and rtr is not None and ptr.finished
    assert span_shape(ptr.to_dict()["spans"]) == \
        span_shape(rtr.to_dict()["spans"]) == \
        span_shape(sorted(pa["trace"]["spans"],
                          key=lambda s: s["start_s"]))
    pd, rd = pt.OUTLIERS.get("remote-1"), rt.OUTLIERS.get("remote-1")
    assert pd is not None and rd is not None
    assert pd.reason == rd.reason == "sampled"
    assert pd.to_dict().keys() == rd.to_dict().keys()
    assert pd.summary().keys() == rd.summary().keys()
    assert _kv_shape(pd.kv_path) == _kv_shape(rd.kv_path)
    assert pd.timing.keys() == rd.timing.keys() == ra["timing"].keys()
    # the worker's own rings, clipped to the request's lifetime
    assert pd.rounds and pd.flight
    assert {e["kind"] for e in pd.flight} >= {"round"}
    assert pt.FORENSICS.get("dynamo_forensics_sampled_total") == 1


async def test_breach_and_sample_dossiers_through_the_frontends(
        sampled_pair, monkeypatch):
    """Both frontends at forensics_sample_rate 1.0: every request leaves a
    dossier; with a TTFT target no request meets, every one is a
    breach. /debug/outliers, a dossier, its Perfetto export and the 404
    bodies answer alike; the port's trace_export and trace_dump read
    them."""
    import dynamo_tpu.telemetry.prof as rprof
    import dynamo_tpu_torch.telemetry.prof as pprof
    from dynamo_tpu.frontend import HttpService as RService
    from dynamo_tpu_torch.frontend.service import HttpService as PService
    from dynamo_tpu_torch.tools import trace_dump, trace_export
    from tests.test_torch_frontend import _Port, _Ref

    kv, port_mgr, ref_mgr = sampled_pair
    for target, reason in ((60.0, "sampled"), (1e-6, "ttft_breach")):
        _clear_planes()
        for prof in (rprof.PROF, pprof.PROF):
            monkeypatch.setattr(prof, "ttft_target_s", target)
        port, ref = _Port(port_mgr), _Ref(ref_mgr)
        port.svc = PService(port_mgr, host="127.0.0.1", port=0,
                            forensics_sample_rate=1.0)
        from aiohttp.test_utils import TestClient, TestServer
        ref.client = TestClient(TestServer(RService(
            ref_mgr, forensics_sample_rate=1.0).app))
        async with port as p:
            got = await serve_burst(p, BURST[:2])
            pidx = await p.call("GET", "/debug/outliers")
            pone = await p.call("GET", f"/debug/outliers/{got[0][0]}")
            pperf = await p.call(
                "GET", f"/debug/outliers/{got[0][0]}?format=perfetto")
            pmiss = await p.call("GET", "/debug/outliers/never")
            ptmiss = await p.call("GET", "/debug/trace/never")
            base = f"http://127.0.0.1:{p.svc.port}"
            out = await asyncio.to_thread(trace_export.main, [
                "--base", base, "--outlier", "0", "-o", "-"])
            dumped = await asyncio.to_thread(
                trace_dump.load, f"{base}/debug/trace/{got[1][0]}")
        async with ref as r:
            want = await serve_burst(r, BURST[:2])
            ridx = await r.call("GET", "/debug/outliers")
            rone = await r.call("GET", f"/debug/outliers/{want[0][0]}")
            rmiss = await r.call("GET", "/debug/outliers/never")
            rtmiss = await r.call("GET", "/debug/trace/never")
        assert [t for _, t in got] == [t for _, t in want]
        assert pidx[0] == ridx[0] == 200
        assert pidx[2].keys() == ridx[2].keys()
        assert len(pidx[2]["outliers"]) == len(ridx[2]["outliers"]) == 2
        for ps, rs in zip(pidx[2]["outliers"], ridx[2]["outliers"]):
            assert ps.keys() == rs.keys() and ps["reason"] == reason
        assert pone[0] == rone[0] == 200
        assert pone[2].keys() == rone[2].keys()
        assert pone[2]["timing"].keys() == rone[2]["timing"].keys()
        assert _kv_shape(pone[2]["kv_path"]) == _kv_shape(rone[2]["kv_path"])
        assert span_shape(pone[2]["trace"]["spans"]) == \
            span_shape(rone[2]["trace"]["spans"])
        assert pone[2]["rounds"] and pone[2]["flight"]
        assert pperf[0] == 200
        events = pperf[2]["traceEvents"]
        assert {e["ph"] for e in events} >= {"M", "X", "i"}
        assert pmiss[0] == rmiss[0] == 404
        assert pmiss[2].keys() == rmiss[2].keys()
        assert ptmiss[0] == rtmiss[0] == 404
        assert ptmiss[2] == rtmiss[2] | {
            k: ptmiss[2][k] for k in ("oldest_retained_id", "retained")}
        assert ptmiss[2]["reason"] == "never_seen"
        assert out == 0
        assert "tokenize" in trace_dump.render_trace(dumped)
