"""TorchEngine's intake rules that no knob turns on, as the reference
has them (dynamo_tpu/engine/engine.py: ``generate``'s deadline check,
``_admit``'s waiting shed, ``_enqueue_waiting``): a request whose
deadline passed gets zero tokens and the DEADLINE finish, at intake or
while it waits for a lane; a high-priority arrival overtakes a
not-started lower-priority entry; within a priority, tenants' backlogs
interleave by start-time fair queuing and one tenant stays FIFO.

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
