"""TorchEngine's overload plane, as the reference has it (dynamo_tpu/
engine/engine.py: ``generate``'s deadline and budget checks, ``_admit``'s
waiting shed, ``_enqueue_waiting``, ``_enforce_bounds``,
``_maybe_preempt_running``): a request whose deadline passed gets zero
tokens and the DEADLINE finish, at intake or while it waits for a lane;
a high-priority arrival overtakes a not-started lower-priority entry;
within a priority, tenants' backlogs interleave by weighted start-time
fair queuing and one tenant stays FIFO; queue budgets bounce an arrival
with a Retry-After (global and per tenant), a HIGH-priority arrival
evicts the newest waiting entry, and running preemption migrates the
victim through the port's router. The frontend answers a bounce with
429; the wire keeps the reference's frame types.

The deadline clock is the engine's ``_wall_time``, replaced here by a
clock the test advances, so no case races a sleep against it. Every
engine has one decode lane, held by a request without a token budget
until the test cancels it, once the others are queued; so the service
order is the order in which they get the lane."""
import asyncio
from typing import Optional

import numpy as np
import pytest

from dynamo_tpu_torch.engine import engine as engine_mod
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    StopConditions,
)

T0 = 1.7e9  # the fake clock's start (unix seconds)


@pytest.fixture
def clock(monkeypatch):
    now = [T0]
    monkeypatch.setattr(engine_mod, "_wall_time", lambda: now[0])
    return now


def _engine() -> TorchEngine:
    return TorchEngine(ModelConfig.tiny(dtype="float32"), EngineConfig(
        num_pages=64, page_size=16, max_pages_per_seq=64, max_decode_slots=1,
        prefill_buckets=(32, 64), cache_dtype="float32"), device="cpu")


def _req(prompt, max_tokens: Optional[int] = 4, **kw) -> PreprocessedRequest:
    return PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=max_tokens,
                                       ignore_eos=True), **kw)


async def _drain(eng, req, order=None, name=None):
    outs = []
    async for out in eng.generate(req):
        if order is not None and not outs:
            order.append(name)
        outs.append(out)
    return outs


async def _until(cond):
    for _ in range(4000):
        if cond():
            return
        await asyncio.sleep(0.005)
    raise AssertionError("engine never reached the awaited state")


def _prompts(n, seed, length=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, length).tolist() for _ in range(n)]


async def _hog(eng):
    """A request holding the only lane (up to the context, ~1000 tokens)
    until the test cancels it."""
    hog = asyncio.ensure_future(_drain(eng, _req(_prompts(1, 9)[0], None)))
    # the engine thread takes the hog off the waiting queue just after it
    # gives it the lane: wait for both, so that only later requests wait
    await _until(lambda: any(s is not None for s in eng._slots)
                 and not eng._waiting)
    return hog


async def _release(hog):
    assert not hog.done()  # it held the lane throughout
    hog.cancel()
    await asyncio.gather(hog, return_exceptions=True)


async def _behind_a_hog(eng, queued):
    """Serve ``queued`` [(name, request)] once all of them wait behind
    the hog; returns (the order in which they got the lane, outputs)."""
    hog = await _hog(eng)
    order: list[str] = []
    tasks = [asyncio.ensure_future(_drain(eng, r, order, name))
             for name, r in queued]
    await _until(lambda: len(eng._waiting) == len(queued))
    await _release(hog)
    outs = await asyncio.gather(*tasks)
    await eng.stop()
    return order, outs


def test_deadline_past_at_intake_sheds_with_no_tokens(clock):
    eng = _engine()

    async def run():
        return await _drain(eng, _req([1, 2, 3], deadline=T0 - 1.0))

    outs = asyncio.run(run())
    assert [o.finish_reason for o in outs] == [FinishReason.DEADLINE]
    assert outs[0].token_ids == []
    assert outs[0].annotations["shed"] == {"reason": "deadline",
                                           "queued_s": 0.0}
    assert eng.sheds == 1
    assert not eng._started  # shed before the engine was needed


def test_deadline_passing_while_waiting_sheds_with_no_tokens(clock):
    """The deadline passes while the request waits behind the only lane:
    it is shed at the next admission pass, before any prefill work."""
    eng = _engine()
    p = _prompts(1, 3)[0]

    async def run():
        hog = await _hog(eng)
        doomed = asyncio.ensure_future(_drain(
            eng, _req(p, 8, deadline=T0 + 10.0)))
        await _until(lambda: len(eng._waiting) == 1)
        assert eng._waiting[0].prefill_pos < 0  # still waiting
        clock[0] = T0 + 60.0                    # its deadline passes
        outs = await doomed
        await _release(hog)
        await eng.stop()
        return outs

    outs = asyncio.run(run())
    assert [o.finish_reason for o in outs] == [FinishReason.DEADLINE]
    assert outs[0].token_ids == []
    assert outs[0].annotations["shed"]["reason"] == "deadline"
    assert eng.sheds == 1


def test_high_priority_overtakes_a_waiting_entry(clock):
    eng = _engine()
    low, high = _prompts(2, 5)
    order, outs = asyncio.run(_behind_a_hog(eng, [
        ("low", _req(low)), ("high", _req(high, priority=1))]))
    assert order == ["high", "low"]
    assert [sum(len(o.token_ids) for o in out) for out in outs] == [4, 4]


def test_tenant_backlogs_interleave_by_fair_queuing(clock):
    """Tenant a queues four requests, then tenant b two, all of one
    length n: a's stamps are 2n..5n past the hog's, b's 2n and 3n, so b
    is served between a's, not after a's backlog."""
    eng = _engine()
    ps = _prompts(6, 6)
    queued = [(f"a{i}", _req(ps[i], tenant="a")) for i in range(4)]
    queued += [(f"b{i}", _req(ps[4 + i], tenant="b")) for i in range(2)]
    order, _ = asyncio.run(_behind_a_hog(eng, queued))
    assert order == ["a0", "b0", "a1", "b1", "a2", "a3"]


def test_one_tenant_stays_fifo(clock):
    eng = _engine()
    ps = _prompts(4, 7)
    # prompt lengths differ: one tenant's stamps still only grow
    queued = [(f"r{i}", _req(p[: 8 + 4 * (3 - i)], tenant="t"))
              for i, p in enumerate(ps)]
    order, _ = asyncio.run(_behind_a_hog(eng, queued))
    assert order == ["r0", "r1", "r2", "r3"]


# ---------------------------------------------------------------------------
# the overload plane's budgets, preemption and 429s (ROADMAP item 8),
# modeled on the JAX package's tests/test_overload.py and
# tests/test_tenancy.py; each engine case runs the same scenario on
# TpuEngine and asserts the same outcome of both packages


def _budgeted(pkg="torch", **kw):
    if pkg == "torch":
        return TorchEngine(ModelConfig.tiny(dtype="float32"), EngineConfig(
            num_pages=64, page_size=16, max_pages_per_seq=64,
            max_decode_slots=1, prefill_buckets=(32, 64),
            cache_dtype="float32", **kw), device="cpu")
    from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu.models.config import ModelConfig as JConfig
    from dynamo_tpu.parallel.mesh import MeshConfig

    return TpuEngine(JConfig.tiny(dtype="float32"), JEngineConfig(
        num_pages=64, page_size=16, max_pages_per_seq=64,
        max_decode_slots=1, prefill_buckets=(32, 64),
        cache_dtype="float32", **kw), mesh_config=MeshConfig(tp=1))


def _proto(pkg):
    if pkg == "torch":
        from dynamo_tpu_torch.protocols import common
    else:
        from dynamo_tpu.protocols import common
    return common


def _registries(pkg):
    """(OVERLOAD, TENANT) of a package, reset."""
    if pkg == "torch":
        from dynamo_tpu_torch.overload.metrics import OVERLOAD
        from dynamo_tpu_torch.tenancy.metrics import TENANT
    else:
        from dynamo_tpu.overload.metrics import OVERLOAD
        from dynamo_tpu.tenancy.metrics import TENANT
    OVERLOAD.reset()
    TENANT.reset()
    return OVERLOAD, TENANT


def _preq(pkg, prompt, max_tokens=4, **kw):
    c = _proto(pkg)
    r = c.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=c.StopConditions(max_tokens=max_tokens,
                                         ignore_eos=True))
    for k, v in kw.items():
        setattr(r, k, v)
    return r


async def _outcome(eng, req):
    """('ok', tokens) or ('overloaded', retry_after_s, tenant)."""
    toks = []
    try:
        async for out in eng.generate(req):
            toks.extend(out.token_ids)
    except ConnectionError as e:
        if type(e).__name__ != "EngineOverloadedError":
            raise
        return ("overloaded", e.retry_after_s, e.tenant)
    return ("ok", toks)


async def _hold_lane(eng, pkg):
    hog = asyncio.ensure_future(_outcome(eng, _preq(pkg, _prompts(1, 9)[0],
                                                    None)))
    await _until(lambda: any(s is not None for s in eng._slots)
                 and not eng._waiting)
    return hog


def _waiting(eng):
    return (sum(1 for r in eng._waiting if r.slot < 0)
            + eng._intake.qsize())


def _both(scenario):
    """The scenario's outcome on TorchEngine, and on TpuEngine."""
    return [asyncio.run(scenario(pkg)) for pkg in ("torch", "jax")]


def test_bounded_admission_bounces_with_retry_after_and_recovers():
    """One waiting request fills a budget of 1: the next arrival bounces
    retriably with a Retry-After in [0.5, 30] s, counted once; a prompt-
    token budget bounces the same way; after the backlog drains the same
    request is admitted."""
    async def scenario(pkg):
        O, T = _registries(pkg)
        eng = _budgeted(pkg, max_waiting_requests=1,
                        max_waiting_prefill_tokens=30)
        hog = await _hold_lane(eng, pkg)
        p = _prompts(3, 2)
        waiter = asyncio.ensure_future(_outcome(eng, _preq(pkg, p[0])))
        await _until(lambda: _waiting(eng) >= 1)
        bounced = await _outcome(eng, _preq(pkg, p[1], tenant="acme"))
        m = eng.metrics().worker_stats
        stats = (m.num_requests_waiting, m.num_waiting_prefill_tokens,
                 m.max_waiting_requests, m.max_waiting_prefill_tokens)
        hog.cancel()
        await asyncio.gather(hog, return_exceptions=True)
        served = await waiter
        again = await _outcome(eng, _preq(pkg, p[1], tenant="acme"))
        await eng.stop()
        return (bounced[0], bounced[2], 0.5 <= bounced[1] <= 30.0, stats,
                served[0], len(again[1]), again[0],
                O.get("dynamo_overload_rejected_total"),
                T.get("dynamo_tenant_rejected_total", "acme"),
                T.get("dynamo_tenant_admitted_total", "acme"))

    torch_out, jax_out = _both(scenario)
    assert torch_out == jax_out
    assert torch_out == ("overloaded", "", True, (1, 20, 1, 30), "ok", 4,
                         "ok", 1.0, 1.0, 1.0)


def test_high_priority_arrival_preempts_the_newest_waiting_entry():
    async def scenario(pkg):
        O, _ = _registries(pkg)
        eng = _budgeted(pkg, max_waiting_requests=1)
        hog = await _hold_lane(eng, pkg)
        p = _prompts(2, 4)
        low = asyncio.ensure_future(_outcome(eng, _preq(pkg, p[0])))
        await _until(lambda: _waiting(eng) >= 1)
        # admitted past the budget; the loop evicts the low entry
        high = asyncio.ensure_future(_outcome(eng, _preq(pkg, p[1],
                                                         priority=1)))
        low_out = await low
        hog.cancel()
        await asyncio.gather(hog, return_exceptions=True)
        high_out = await high
        await eng.stop()
        return (low_out[0], high_out[0], len(high_out[1]),
                eng.waiting_preemptions,
                O.get("dynamo_overload_preempted_total"))

    torch_out, jax_out = _both(scenario)
    assert torch_out == jax_out == ("overloaded", "ok", 4, 1, 1.0)


def test_an_evicted_entry_has_left_the_queue_when_its_error_is_emitted(
        monkeypatch):
    """The engine thread emits the shed error to the client's loop: the
    entry must be out of the waiting queue by then, or a client that
    reads the queue on its error can still find itself in it."""
    seen = []
    emit = engine_mod._Request.emit

    def spy(self, item):
        if isinstance(item, Exception):
            seen.append(any(w is self for w in eng._waiting))
        emit(self, item)

    monkeypatch.setattr(engine_mod._Request, "emit", spy)

    async def scenario():
        hog = await _hold_lane(eng, "torch")
        p = _prompts(2, 4)
        low = asyncio.ensure_future(_outcome(eng, _preq("torch", p[0])))
        await _until(lambda: _waiting(eng) >= 1)
        high = asyncio.ensure_future(_outcome(
            eng, _preq("torch", p[1], priority=1)))
        low_out = await low
        order = [r.req.priority for r in eng._waiting if r.slot < 0]
        hog.cancel()
        await asyncio.gather(hog, return_exceptions=True)
        await high
        await eng.stop()
        return low_out[0], order

    _registries("torch")
    eng = _budgeted(max_waiting_requests=1)
    assert asyncio.run(scenario()) == ("overloaded", [1])
    assert seen == [False]


def test_tenant_budget_bounces_only_the_storming_tenant_and_confines_preemption():
    """Tenant budget 1: tenant a's second waiting request bounces with
    tenant "a" while tenant b admits; a HIGH-priority arrival of a evicts
    a's own waiting entry, never b's."""
    async def scenario(pkg):
        O, T = _registries(pkg)
        eng = _budgeted(pkg, tenant_max_waiting_requests=1)
        hog = await _hold_lane(eng, pkg)
        p = _prompts(5, 8)
        a_low = asyncio.ensure_future(_outcome(eng, _preq(pkg, p[0],
                                                          tenant="a")))
        await _until(lambda: _waiting(eng) >= 1)
        a_storm = await _outcome(eng, _preq(pkg, p[1], tenant="a"))
        b_low = asyncio.ensure_future(_outcome(eng, _preq(pkg, p[2],
                                                          tenant="b")))
        await _until(lambda: _waiting(eng) >= 2)
        a_high = asyncio.ensure_future(_outcome(eng, _preq(
            pkg, p[3], tenant="a", priority=1)))
        a_low_out = await a_low
        dbg = eng.tenant_debug()
        hog.cancel()
        await asyncio.gather(hog, return_exceptions=True)
        outs = [a_low_out[0], a_storm[0], a_storm[2],
                (await a_high)[0], (await b_low)[0]]
        await eng.stop()
        return (outs, eng.waiting_preemptions,
                O.get("dynamo_overload_preempted_total"),
                T.get("dynamo_tenant_rejected_total", "a"),
                T.get("dynamo_tenant_rejected_total", "b"),
                T.get("dynamo_tenant_shed_total", "a"),
                dbg["bounded"], sorted(dbg["tenants"]))

    torch_out, jax_out = _both(scenario)
    assert torch_out == jax_out
    assert torch_out == (["overloaded", "overloaded", "a", "ok", "ok"], 1,
                         1.0, 1.0, 0.0, 1.0, True, ["a", "b", "default"])


def test_tenant_weights_let_a_weighted_tenant_overtake():
    """Weighted fair share: tenant b at weight 4 queues two requests
    behind tenant a's four, all of one length n. The hog's service set the
    virtual clock to n: a's stamps are 2n..5n, b's n + n/4 and n + n/2,
    so both of b's are served first (at weight 1 they interleave with
    a's, test_tenant_backlogs_interleave_by_fair_queuing)."""
    eng = TorchEngine(ModelConfig.tiny(dtype="float32"), EngineConfig(
        num_pages=64, page_size=16, max_pages_per_seq=64,
        max_decode_slots=1, prefill_buckets=(32, 64), cache_dtype="float32",
        tenant_weights={"b": 4.0}), device="cpu")
    ps = _prompts(6, 6)
    queued = [(f"a{i}", _req(ps[i], tenant="a")) for i in range(4)]
    queued += [(f"b{i}", _req(ps[4 + i], tenant="b")) for i in range(2)]
    order, _ = asyncio.run(_behind_a_hog(eng, queued))
    assert order == ["b0", "b1", "a0", "a1", "a2", "a3"]


def test_running_preemption_migrates_token_identically_through_the_router():
    """A HIGH-priority arrival on a worker whose only lane streams a
    low-priority request: the victim's stream fails with PreemptedError,
    the port's KV router migrates it to the peer without a breaker
    strike, and the client's merged stream equals an unloaded run's."""
    from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
    from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.overload.metrics import OVERLOAD
    from dynamo_tpu_torch.resilience.metrics import RESILIENCE

    cfg = ModelConfig.tiny(dtype="float32")
    params = llama.init_params(cfg, 0, device="cpu")

    def mk(wid, preempt=False):
        return TorchEngine(cfg, EngineConfig(
            num_pages=128, page_size=16, max_pages_per_seq=16,
            max_decode_slots=1, prefill_buckets=(64,),
            cache_dtype="float32", worker_id=wid, preempt_running=preempt),
            params=params, device="cpu")

    victim_prompt = _prompts(1, 5, 40)[0]
    high_prompt = _prompts(1, 15, 24)[0]

    async def run():
        OVERLOAD.reset()
        ref = mk("ref")
        expected = [t for o in await _drain(ref, _req(victim_prompt, 100))
                    for t in o.token_ids]
        await ref.stop()
        eng_a, eng_b = mk("A", preempt=True), mk("B")
        push = KvPushRouter(KvRouter(16, KvRouterConfig(
            router_temperature=0.0)))
        push.retry.base_delay_s = 0.001
        push.add_worker("A", eng_a)  # the only worker: the victim lands
        migrations = RESILIENCE.get("dynamo_migration_total")
        got: list[int] = []

        async def victim():
            async for out in push.generate(_req(victim_prompt, 100)):
                got.extend(out.token_ids)

        vt = asyncio.ensure_future(victim())
        await _until(lambda: len(got) >= 8)
        push.add_worker("B", eng_b)  # the migration target
        high = asyncio.ensure_future(_drain(
            eng_a, _req(high_prompt, 6, priority=1)))
        await vt
        out_high = [t for o in await high for t in o.token_ids]
        states = push.health.states()
        await eng_a.stop()
        await eng_b.stop()
        return (expected, got, out_high, eng_a.preempt_migrations,
                OVERLOAD.get("dynamo_overload_preempt_migrations_total"),
                RESILIENCE.get("dynamo_migration_total") - migrations,
                states, "A" in push.workers)

    expected, got, high, n_pre, n_ctr, n_mig, states, kept = asyncio.run(
        run())
    assert got == expected, "merged stream must be token-identical"
    assert len(high) == 6
    assert (n_pre, n_ctr, n_mig) == (1, 1.0, 1)
    # a deliberate act of a healthy worker: no strike, not evicted
    assert states.get("A", "closed") == "closed" and kept


def test_preempted_error_crosses_the_wire_as_a_retriable_error():
    """The endpoint frame types only overload (the JAX package's wire):
    a remote PreemptedError arrives as the retriable connection error,
    and an EngineOverloadedError keeps its Retry-After and tenant, in the
    port's and in the JAX package's client alike."""
    from dynamo_tpu.runtime import endpoint as rend
    from dynamo_tpu_torch.overload.errors import (
        EngineOverloadedError,
        PreemptedError,
    )
    from dynamo_tpu_torch.runtime import endpoint as pend

    async def handler(payload):
        if payload["x"] == "overload":
            raise EngineOverloadedError("tenant over quota",
                                        retry_after_s=2.5, tenant="acme")
        raise PreemptedError("preempted by a higher-priority request")
        yield  # pragma: no cover — makes this an async generator

    async def call(mod, host, port, x):
        try:
            async for _ in mod.call_endpoint(host, port, {"x": x}):
                pass
        except ConnectionError as e:
            return (type(e).__name__, getattr(e, "retry_after_s", None),
                    getattr(e, "tenant", None))

    async def run():
        srv = pend.EndpointServer(handler)
        host, port = await srv.start()
        try:
            return [await call(mod, host, port, x)
                    for mod in (pend, rend) for x in ("overload", "pre")]
        finally:
            await srv.stop()

    assert asyncio.run(run()) == [
        ("EngineOverloadedError", 2.5, "acme"),
        ("EndpointConnectionError", None, None)] * 2


class _Overloaded:
    async def generate(self, req):
        from dynamo_tpu_torch.overload.errors import EngineOverloadedError

        raise EngineOverloadedError("engine overloaded: queue at budget",
                                    retry_after_s=3.2, tenant="acme")
        yield  # pragma: no cover


def _http(engine):
    from dynamo_tpu_torch.backend import Backend
    from dynamo_tpu_torch.frontend.model_manager import ModelChain, \
        ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor, \
        PromptFormatter
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    tok = make_test_tokenizer([f"w{i}" for i in range(30)])
    mgr = ModelManager()
    mgr.register(ModelChain(name="m", preprocessor=OpenAIPreprocessor(
        tokenizer=tok, formatter=PromptFormatter(), model_name="m"),
        engine=engine, backend=Backend(tok)))
    return HttpService(mgr, host="127.0.0.1", port=0)


@pytest.mark.parametrize("stream", [False, True])
def test_frontend_answers_429_with_retry_after(stream):
    """Unary and streamed: 429, Retry-After = ceil(3.2), the overloaded
    error body (a stream answers before its SSE is prepared), counted in
    the request counter and both 429 counters."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.overload.metrics import OVERLOAD
    from dynamo_tpu_torch.tenancy.metrics import TENANT

    svc = _http(_Overloaded())

    async def run():
        OVERLOAD.reset()
        TENANT.reset()
        await svc.start()
        try:
            async with HttpClient("127.0.0.1", svc.port) as c:
                r = await c.request("POST", "/v1/chat/completions",
                                    json_body={
                                        "model": "m", "max_tokens": 4,
                                        "stream": stream,
                                        "messages": [{"role": "user",
                                                      "content": "w1 w2"}]})
                m = await c.request("GET", "/metrics")
            return r, m.body.decode()
        finally:
            await svc.stop()

    r, text = asyncio.run(run())
    assert r.status == 429
    assert r.headers["retry-after"] == "4"
    body = r.json()
    assert body["error"]["type"] == "overloaded_error"
    assert body["error"]["code"] == 429
    assert "dynamo_overload_http_429_total 1" in text
    assert 'dynamo_tenant_http_429_total{tenant="acme"} 1' in text
    assert 'status="429"' in text


def test_a_stream_that_produced_output_keeps_the_overload_in_band():
    """n = 2: one choice streams, the other bounces: the stream is a 200
    SSE stream carrying the bounce as an in-band error event."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.protocols.common import LLMEngineOutput

    class _Half:
        calls = 0

        async def generate(self, req):
            from dynamo_tpu_torch.overload.errors import \
                EngineOverloadedError

            _Half.calls += 1
            if _Half.calls == 2:
                raise EngineOverloadedError("full", retry_after_s=1.0)
            yield LLMEngineOutput(token_ids=[5],
                                  finish_reason=FinishReason.LENGTH)

    svc = _http(_Half())

    async def run():
        await svc.start()
        try:
            async with HttpClient("127.0.0.1", svc.port) as c:
                return await c.request("POST", "/v1/completions", json_body={
                    "model": "m", "prompt": "w1", "max_tokens": 1, "n": 2,
                    "stream": True})
        finally:
            await svc.stop()

    r = asyncio.run(run())
    assert r.status == 200
    text = r.body.decode()
    assert '"error"' in text and "[DONE]" in text
