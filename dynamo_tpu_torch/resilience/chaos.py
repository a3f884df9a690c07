"""Fault-injection harness (a copy of the JAX package's resilience/chaos.py
on torch tensors; reference tests/fault_tolerance scenarios).

A process-global registry of named injection points, armed via:

  env   DYNAMO_CHAOS="kill_worker:p=0.5:after=3,delay:t=0.05"
  CLI   python -m dynamo_tpu_torch.launch.run ... --chaos "stall_stream:t=30"
  HTTP  POST /chaos on the worker system server
        (``python -m dynamo_tpu_torch.tools.chaos`` arms a running
        deployment without restarts)

Stream points (the remote-engine serving path, the worker side of the
push-RPC plane, where a real worker death shows):

  kill_worker    after ``after`` outputs, die mid-stream: the connection
                 drops with no done frame, the client sees transport loss
                 and the router migrates
  stall_stream   after ``after`` outputs, hang for ``t`` seconds (also the
                 disagg chunk push: a wedged link)
  drop_response  silently swallow one output (in-band loss)
  delay          sleep ``t`` seconds before each output (slow worker)
  storm          refuse the request at stream start with the retriable
                 EngineOverloadedError (``t`` is the Retry-After hint)

KV data-integrity points (kv_integrity.py plane; each corrupts a COPY of
KV bytes in flight, never a pool, so detection and recompute is the only
way back to correct tokens):

  flip_kv_bits      one random bit per fired page of a tier gather's
                    output (the G2/G3 onboard path)
  corrupt_frame     one byte of an outgoing kv_transfer payload frame, on
                    a copy: the receiver's crc verify must nack it
  truncate_g3       zero the tail half of the G3 pool before a read
  corrupt_prefetch  rot one byte of a page fetched from a peer (G4) after
                    it landed in G2 with its crc sealed

Control-plane points (runtime/store.py serving loop):

  kill_store       on the next store op, crash the store server (RST every
                   client connection): clients resync through StoreSession
  partition_store  hold every reply for ``t`` seconds

Entry grammar: comma-separated ``name[:key=value]*`` with keys ``p``
(probability, default 1), ``t`` (seconds), ``after`` (output count) and
``once``.

For one ``random.Random`` seed the hooks make the JAX package's draws in
its order, so both packages fire on the same calls and flip the same
bytes: a tensor's bytes are addressed as ``tensor.view(torch.uint8)``,
whose shape is numpy's ``ndarray.view(np.uint8)`` (a bf16 page's last
axis doubles).
"""
from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

import torch

from dynamo_tpu_torch.resilience.metrics import RESILIENCE

log = logging.getLogger(__name__)

POINT_NAMES = ("kill_worker", "stall_stream", "drop_response", "delay",
               "storm", "flip_kv_bits", "corrupt_frame", "truncate_g3",
               "corrupt_prefetch", "kill_store", "partition_store")


class ChaosInjectedError(ConnectionResetError):
    """The kill_worker fault: raised inside the worker's stream handler so
    the endpoint server drops the connection without a done frame, as a
    real worker death does."""


@dataclass
class ChaosPoint:
    name: str
    armed: bool = False
    probability: float = 1.0
    delay_s: float = 0.0
    after_outputs: int = 0
    # one-shot fuse: disarm after the first injection
    once: bool = False
    injected_total: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name, "armed": self.armed,
            "probability": self.probability, "delay_s": self.delay_s,
            "after_outputs": self.after_outputs, "once": self.once,
            "injected_total": self.injected_total,
        }


class ChaosHooks:
    """The injection-point registry and the stream wrapper applying it."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.points: dict[str, ChaosPoint] = {
            name: ChaosPoint(name) for name in POINT_NAMES
        }
        self.rng = rng or random.Random()

    # ---- arming ----

    def arm(self, name: str, *, probability: float = 1.0,
            delay_s: float = 0.0, after_outputs: int = 0,
            once: bool = False) -> ChaosPoint:
        p = self.points[name]
        p.armed = True
        p.probability = probability
        p.delay_s = delay_s
        p.after_outputs = after_outputs
        p.once = once
        log.warning("chaos point armed: %s", p.to_dict())
        return p

    def disarm(self, name: str) -> None:
        self.points[name].armed = False

    def disarm_all(self) -> None:
        for p in self.points.values():
            p.armed = False

    def reset(self) -> None:
        """Disarm everything and zero the injection counters."""
        for name in list(self.points):
            self.points[name] = ChaosPoint(name)

    def list_points(self) -> list[dict[str, Any]]:
        return [p.to_dict() for p in self.points.values()]

    def configure(self, spec: str) -> None:
        """Parse the env/CLI grammar and arm the named points."""
        for entry in (spec or "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            fields = entry.split(":")
            name = fields[0].strip()
            if name not in self.points:
                raise ValueError(
                    f"unknown chaos point {name!r} (have {POINT_NAMES})")
            kw: dict[str, Any] = {}
            for f in fields[1:]:
                k, _, v = f.partition("=")
                k = k.strip()
                if k == "p":
                    kw["probability"] = float(v)
                elif k == "t":
                    kw["delay_s"] = float(v)
                elif k == "after":
                    kw["after_outputs"] = int(v)
                elif k == "once":
                    kw["once"] = v.strip().lower() in ("1", "true", "yes", "")
                else:
                    raise ValueError(f"unknown chaos key {k!r} in {entry!r}")
            self.arm(name, **kw)

    def any_armed(self) -> bool:
        return any(p.armed for p in self.points.values())

    # ---- injection ----

    def _record(self, p: ChaosPoint) -> None:
        """Shared injection bookkeeping: counters, one-shot disarm, log."""
        p.injected_total += 1
        RESILIENCE.inc("dynamo_resilience_chaos_injections_total")
        if p.once:
            p.armed = False
        log.warning("chaos injected: %s (#%d)", p.name, p.injected_total)

    def _fire(self, p: ChaosPoint) -> bool:
        if not p.armed or self.rng.random() >= p.probability:
            return False
        self._record(p)
        return True

    def fire(self, name: str) -> bool:
        """One-roll injection check for data-path points (truncate_g3,
        corrupt_prefetch, kill_store): True when the armed point fires."""
        p = self.points.get(name)
        return p is not None and self._fire(p)

    def maybe_flip_bits(self, arr: Optional[torch.Tensor]) -> int:
        """flip_kv_bits: per page of a gathered KV batch ``[2, L, kvh, n,
        ps, hd]`` (a copy, never a pool), roll the point's probability and
        flip one random bit. Returns the pages flipped."""
        p = self.points.get("flip_kv_bits")
        if p is None or not p.armed or arr is None:
            return 0
        # a view of the caller's bytes where the last axis is dense (the
        # tiers' page-major staging permuted to page axis 3 is); else a
        # dense copy whose damage is written back
        dense = arr if arr.stride(-1) == 1 else arr.contiguous()
        u8 = dense.view(torch.uint8)
        flipped = 0
        for i in range(arr.shape[3]):
            if not p.armed or self.rng.random() >= p.probability:
                continue
            idx = tuple(
                self.rng.randrange(d) if ax != 3 else i
                for ax, d in enumerate(u8.shape)
            )
            u8[idx] ^= 1 << self.rng.randrange(8)
            self._record(p)
            flipped += 1
        if flipped and dense is not arr:
            arr.copy_(dense)
        return flipped

    def maybe_corrupt_frame(self, payload: torch.Tensor) -> torch.Tensor:
        """corrupt_frame: flip one byte of an outgoing wire payload on a
        COPY (the frame is a zero-copy view of an export buffer; chaos
        corrupts the wire, not the sender). Returns the tensor to send."""
        p = self.points.get("corrupt_frame")
        if p is None or not self._fire(p) or payload.numel() == 0:
            return payload
        dirty = payload.contiguous().clone()
        u8 = dirty.view(torch.uint8).reshape(-1)
        u8[self.rng.randrange(u8.numel())] ^= 1 << self.rng.randrange(8)
        return dirty

    async def maybe_stall(self, name: str, n_outputs: int) -> bool:
        """Injection hook for non-stream paths (the disagg chunk push, the
        store's serving loop): fire ``name`` once its after_outputs
        threshold is reached and the roll passes, sleeping the point's
        delay_s. Returns True when it fired."""
        p = self.points.get(name)
        if p is None or not p.armed or n_outputs < p.after_outputs:
            return False
        if not self._fire(p):
            return False
        await asyncio.sleep(p.delay_s)
        return True

    async def wrap_stream(
        self, stream: AsyncIterator[Any]
    ) -> AsyncIterator[Any]:
        """Apply the armed points to one response stream (worker side)."""
        storm = self.points["storm"]
        if storm.armed and self._fire(storm):
            # synthetic overload: bounce before any output, as a full
            # admission queue would (retriable, with a Retry-After hint)
            from dynamo_tpu_torch.overload.errors import EngineOverloadedError

            raise EngineOverloadedError(
                "chaos: storm (synthetic overload)",
                retry_after_s=storm.delay_s or 1.0)
        n = 0
        kill = self.points["kill_worker"]
        stall = self.points["stall_stream"]
        drop = self.points["drop_response"]
        delay = self.points["delay"]
        # per-stream triggers are rolled once at stream start, so a p=0.5
        # kill does not re-roll on every output
        do_kill = kill.armed and self.rng.random() < kill.probability
        do_stall = stall.armed and self.rng.random() < stall.probability
        async for item in stream:
            # armed is re-checked at injection time: a once-fused point
            # disarmed by a concurrent stream's injection must not fire
            if do_kill and kill.armed and n >= kill.after_outputs:
                self._record(kill)
                raise ChaosInjectedError("chaos: worker killed mid-stream")
            if do_stall and stall.armed and n >= stall.after_outputs:
                self._record(stall)
                do_stall = False  # stall once per stream
                await asyncio.sleep(stall.delay_s)
            if delay.armed and self._fire(delay):
                await asyncio.sleep(delay.delay_s)
            n += 1
            if drop.armed and self._fire(drop):
                continue
            yield item


# process-wide hooks: the worker serving path consults this instance; the
# system server's /chaos control and the env/CLI config mutate it
CHAOS = ChaosHooks()
