"""Fleet flight simulator: time-compressed fleet-scale runs through the
real control plane (the port's copy of the JAX package's fleetsim/).

The package has three layers (ROADMAP "million-user flight simulator"):

  clock.py   — injectable clock abstraction. ``REAL_CLOCK`` (the default
               everywhere) is plain ``time.monotonic``/``time.time``/
               ``asyncio.sleep``; ``VirtualClock(rate=N)`` compresses
               time N× so an hour of traffic replays in a minute.
  traces.py  — seeded workload generation: diurnal and bursty (Markov-
               modulated Poisson) arrival processes over a shared-prefix
               prompt population, with JSONL record/replay.
  sim.py     — ``SimFleet``/``SimConnector``: hundreds to thousands of
               in-process mocker workers registered against a LIVE store
               (real leases, real watches, real metrics plane), driven
               through the real watcher/router/overload/planner planes.

Only ``clock`` is imported eagerly — mocker/planner import it for their
clock defaults, and pulling ``sim`` in here would create an import cycle.
"""
from dynamo_tpu_torch.fleetsim.clock import REAL_CLOCK, Clock, VirtualClock

__all__ = ["Clock", "REAL_CLOCK", "VirtualClock"]
