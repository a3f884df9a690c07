"""Load-based planner v0: observe worker load, scale the fleet (the port's
copy of the JAX package's planner.py).

Parity: reference components/planner load-based mode
(utils/planner_core.py:51,131-168): a control loop that every
``adjustment_interval_s`` observes aggregated worker metrics, decides a
replica count against KV-usage and queue-depth thresholds, and asks a
connector to realize it — LocalConnector spawns/retires ``in=endpoint``
worker subprocesses (the circus-watcher equivalent,
local_connector.py:310); a k8s connector would patch replicas instead.

Scale-up when (avg KV usage > kv_usage_scale_up) OR (total waiting >
waiting_scale_up); scale-down when BOTH avg usage < kv_usage_scale_down
AND waiting == 0. One step per interval, clamped to [min, max]; downscale
requires ``stable_intervals`` consecutive low observations so transient
dips don't flap the fleet.
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Protocol

from dynamo_tpu_torch.kv_router.metrics_aggregator import MetricsAggregator
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.runtime.client import KvClient
from dynamo_tpu_torch.runtime.publisher import METRICS_TOPIC

log = logging.getLogger(__name__)


@dataclass
class PlannerConfig:
    adjustment_interval_s: float = 10.0
    kv_usage_scale_up: float = 0.8
    kv_usage_scale_down: float = 0.3
    waiting_scale_up: int = 4
    min_replicas: int = 1
    max_replicas: int = 8
    stable_intervals: int = 2    # consecutive low loads before downscale
    metrics_stale_after_s: float = 15.0
    # load predictor filtering the observed series before decide() — one of
    # predictors.make_predictor: "constant" (reactive, reference default),
    # "moving_average", "ar"/"arima" (trend-following forecast;
    # reference load_predictor.py:159)
    predictor: str = "constant"
    # predictive mode (fleetsim tentpole): additionally forecast the
    # next-interval concurrent-stream count with the configured predictor
    # and size the fleet for the FORECAST — with a trend-following
    # predictor ("ar") the planner scales ahead of a rising wave instead
    # of after the queue already built. ``streams_per_replica`` is the
    # per-replica capacity the forecast divides by (from a profile sweep
    # or the mocker's decode-slot count); predictive mode is inert at 0.
    predictive: bool = False
    streams_per_replica: float = 0.0
    # live queue-wait scale-up trigger: when a WorkerLoadView is wired
    # and any worker's estimated admission wait exceeds this, scale up
    # even if KV usage and queue depth look fine (0 = disabled)
    queue_wait_scale_up_s: float = 0.0
    # fleet-merged latency triggers (telemetry/fleet_feed.py): the
    # planner keeps its own FleetLatencyFeed over the same metrics
    # subscription and reads interval-delta p99s each decide. Stream
    # counts miss a latency wave that arrives without queue growth
    # (slow rounds, deep prefixes falling off cache); the merged TTFT /
    # queue-wait distribution sees it directly. 0 = disabled.
    fleet_ttft_scale_up_s: float = 0.0
    fleet_queue_scale_up_s: float = 0.0


class Connector(Protocol):
    """Realizes a replica count (LocalConnector / KubernetesConnector)."""

    def current_replicas(self) -> int: ...

    async def set_replicas(self, n: int) -> None: ...


class LocalConnector:
    """Worker pool as local subprocesses of the port's CLI (circus-
    arbiter equivalent). Retirement is newest-first GRACEFUL DRAIN:
    SIGTERM asks the worker to stop admitting, finish its in-flight
    requests and exit (launch/run.py installs the drain handler) — the
    warm KV and live streams survive scale-down. SIGKILL only lands
    after ``drain_grace_s`` as the unresponsive-worker backstop."""

    def __init__(self, worker_cmd: list[str], drain_grace_s: float = 30.0,
                 clock: Optional[Any] = None,
                 log_dir: Optional[str] = None):
        from dynamo_tpu_torch.fleetsim.clock import REAL_CLOCK

        # e.g. [sys.executable, "-m", "dynamo_tpu_torch.cli", "run",
        #       "in=endpoint", "out=mocker", "--control-plane", addr, ...]
        self.worker_cmd = list(worker_cmd)
        self.drain_grace_s = drain_grace_s
        # each spawned worker's stdout and stderr go to
        # ``{log_dir}/worker-{n}.log`` (None: discarded, the reference's)
        self.log_dir = log_dir
        self.spawned = 0
        # drain-grace deadlines are sim-visible: under a compressed clock
        # the grace window must compress too (real clock default)
        self.clock = clock or REAL_CLOCK
        self.procs: list[subprocess.Popen] = []
        self.drains_started = 0
        # retiring workers: drained out of self.procs but possibly still
        # finishing requests; reaped by their grace tasks. The procs are
        # tracked separately so shutdown() can SIGKILL a retiree whose
        # grace task it cancels (a SIGTERM-ignoring worker must never
        # outlive the planner as an orphan).
        self._retiring: list[asyncio.Task] = []
        self._retiring_procs: list[subprocess.Popen] = []

    def current_replicas(self) -> int:
        self.procs = [p for p in self.procs if p.poll() is None]
        return len(self.procs)

    async def _retire(self, proc: subprocess.Popen) -> None:
        """SIGTERM -> wait out the drain grace -> SIGKILL backstop."""
        try:
            proc.terminate()
            deadline = self.clock.monotonic() + self.drain_grace_s
            while proc.poll() is None and self.clock.monotonic() < deadline:
                await self.clock.sleep(0.1)
            if proc.poll() is None:
                log.warning(
                    "planner: worker pid %d ignored drain for %.0fs; "
                    "killing", proc.pid, self.drain_grace_s,
                )
                proc.kill()
        finally:
            if proc in self._retiring_procs:
                self._retiring_procs.remove(proc)

    async def set_replicas(self, n: int) -> None:
        self.current_replicas()  # reap exited
        self._retiring = [t for t in self._retiring if not t.done()]
        while len(self.procs) < n:
            out: Any = subprocess.DEVNULL
            if self.log_dir is not None:
                out = open(os.path.join(self.log_dir,
                                        f"worker-{self.spawned}.log"), "wb")
            try:
                proc = subprocess.Popen(
                    self.worker_cmd, stdout=out, stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
            finally:
                if out is not subprocess.DEVNULL:
                    out.close()   # the child holds its own descriptor
            self.spawned += 1
            self.procs.append(proc)
            log.info("planner: spawned worker pid %d", proc.pid)
        while len(self.procs) > n:
            proc = self.procs.pop()
            log.info("planner: draining worker pid %d (grace %.0fs)",
                     proc.pid, self.drain_grace_s)
            self.drains_started += 1
            self._retiring_procs.append(proc)
            self._retiring.append(
                asyncio.get_running_loop().create_task(self._retire(proc))
            )

    async def shutdown(self) -> None:
        procs = list(self.procs)  # set_replicas(0) empties self.procs
        await self.set_replicas(0)
        for t in self._retiring:
            t.cancel()
        # cancelled grace tasks lose their SIGKILL backstop: kill every
        # still-alive proc, INCLUDING mid-retirement ones
        for p in procs + list(self._retiring_procs):
            if p.poll() is None:
                p.kill()  # shutdown is immediate, not graceful
        self._retiring_procs.clear()


class MultihostLocalConnector:
    """DP replicas of a cross-host engine (the reference's
    MultihostLocalConnector, planner.py:166): each replica a group of
    ``num_nodes`` processes. The port has no multi-host engine yet, so it
    is refused by name until ROADMAP item 13 brings one."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "MultihostLocalConnector: multi-host engine groups are not "
            "served by the PyTorch port yet (ROADMAP item 13)")


class Planner:
    """The observe -> decide -> scale loop (planner_core.py:131-168)."""

    def __init__(
        self,
        kv: KvClient,
        connector: Connector,
        config: Optional[PlannerConfig] = None,
        sla: Optional[Any] = None,  # profiler.SlaCapacity -> SLA mode
        *,
        clock: Optional[Any] = None,       # fleetsim Clock (real default)
        load_view: Optional[Any] = None,   # overload.WorkerLoadView tap
    ):
        from dynamo_tpu_torch.fleetsim.clock import REAL_CLOCK

        self.kv = kv
        self.connector = connector
        self.config = config or PlannerConfig()
        self.sla = sla
        self.clock = clock or REAL_CLOCK
        # live queue-wait view (overload plane): when wired, decide()
        # reads estimated admission waits as an extra scale-up signal
        self.load_view = load_view
        self.aggregator = MetricsAggregator(
            stale_after_s=self.config.metrics_stale_after_s,
            clock=self.clock.monotonic,
        )
        # fleet-merged latency feed (telemetry/fleet_feed.py): a private
        # instance (not the process-global FLEET_FEED) so the planner's
        # advance() interval-delta baseline is its own, and fleetsim's
        # VirtualClock governs staleness
        from dynamo_tpu_torch.telemetry.fleet_feed import FleetLatencyFeed

        self.fleet_feed = FleetLatencyFeed(
            stale_after_s=self.config.metrics_stale_after_s,
            clock=self.clock.monotonic,
        )
        self.decisions: list[tuple[float, int]] = []  # (ts, target) history
        self._low_streak = 0
        self._task: Optional[asyncio.Task] = None
        self._sub_task: Optional[asyncio.Task] = None
        from dynamo_tpu_torch.predictors import make_predictor

        # one predictor per observed series (independent windows)
        self._pred_usage = make_predictor(self.config.predictor)
        self._pred_waiting = make_predictor(self.config.predictor)
        self._pred_streams = make_predictor(self.config.predictor)

    async def start(self) -> "Planner":
        from dynamo_tpu_torch.runtime.tasks import CriticalTask

        sub = await self.kv.subscribe(f"{METRICS_TOPIC}.>")
        # supervised: a dead metrics follower or decide loop must restart,
        # not silently stop autoscaling (reference utils/task.rs:42)
        self._sub_task = CriticalTask(
            lambda: self._follow(sub), "planner-metrics-follow"
        ).start()
        self._task = CriticalTask(self._loop, "planner-adjust-loop").start()
        return self

    async def stop(self) -> None:
        for t in (self._task, self._sub_task):
            if t is not None:
                await t.stop()
        self._task = self._sub_task = None

    async def _follow(self, sub) -> None:
        async for ev in sub:
            try:
                m = ForwardPassMetrics.from_dict(json.loads(ev["value"]))
            except (KeyError, ValueError, TypeError):
                continue
            self.aggregator.update(m)
            self.fleet_feed.observe(m)

    async def _loop(self) -> None:
        while True:
            await self.clock.sleep(self.config.adjustment_interval_s)
            try:
                await self.adjust()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("planner adjustment failed")

    def _streams(self, snap) -> int:
        """Concurrent streams across the fleet (active + queued)."""
        return sum(
            m.worker_stats.request_active_slots
            + m.worker_stats.num_requests_waiting
            for m in snap.metrics.values()
        )

    def _predictive_target(self, snap, current: int) -> int:
        """Forecast next-interval stream count; size the fleet for the
        forecast. With a trend-following predictor the target rises
        BEFORE the wave peaks — the point of predictive mode."""
        import math

        from dynamo_tpu_torch.planner_metrics import PLANNER

        c = self.config
        self._pred_streams.add_data_point(self._streams(snap))
        forecast = self._pred_streams.predict_next()
        PLANNER.set("dynamo_planner_predicted_load", forecast)
        if c.streams_per_replica <= 0:
            return current
        return max(c.min_replicas, min(
            c.max_replicas,
            math.ceil(forecast / c.streams_per_replica),
        ))

    def _fleet_latency_high(self) -> bool:
        """Fleet-merged latency trigger: p99 TTFT / queue wait over the
        LAST DECIDE INTERVAL (advance() deltas, not the cumulative
        distribution) beyond the configured bounds. Runs every decide —
        even with both bounds disabled the gauges still publish, so
        dashboards see what the planner sees."""
        from dynamo_tpu_torch.planner_metrics import PLANNER

        deltas = self.fleet_feed.advance()
        from dynamo_tpu_torch.telemetry.metrics import percentile_from_snapshot

        ttft_p99 = percentile_from_snapshot(
            deltas.get("dynamo_fleet_request_ttft_seconds") or {}, 0.99)
        queue_p99 = percentile_from_snapshot(
            deltas.get("dynamo_fleet_request_queue_seconds") or {}, 0.99)
        PLANNER.set("dynamo_planner_fleet_ttft_p99_seconds",
                    round(ttft_p99 or 0.0, 6))
        PLANNER.set("dynamo_planner_fleet_queue_p99_seconds",
                    round(queue_p99 or 0.0, 6))
        c = self.config
        if (c.fleet_ttft_scale_up_s > 0 and ttft_p99 is not None
                and ttft_p99 > c.fleet_ttft_scale_up_s):
            return True
        return (c.fleet_queue_scale_up_s > 0 and queue_p99 is not None
                and queue_p99 > c.fleet_queue_scale_up_s)

    def _queue_wait_high(self, snap) -> bool:
        """Live overload-plane trigger: any worker's estimated admission
        wait beyond the configured bound."""
        c = self.config
        if self.load_view is None or c.queue_wait_scale_up_s <= 0:
            return False
        for wid in snap.metrics:
            est = self.load_view.est_wait_s(wid)
            if est is not None and est > c.queue_wait_scale_up_s:
                return True
        return False

    def decide(self) -> int:
        """Pure decision from the current snapshot (unit-testable)."""
        c = self.config
        snap = self.aggregator.snapshot()
        current = self.connector.current_replicas()
        if self.sla is not None:
            # SLA mode (reference planner_sla.py): size the fleet so the
            # observed stream count fits within profiled SLA capacity.
            # Scale-up is immediate (SLA protection); scale-down steps one
            # replica per stable_intervals of consistently-lower targets so
            # a stale/empty metrics snapshot can't collapse the fleet.
            from dynamo_tpu_torch.planner_metrics import PLANNER

            self._pred_streams.add_data_point(self._streams(snap))
            streams = self._pred_streams.predict_next()
            PLANNER.set("dynamo_planner_predicted_load", streams)
            target = min(c.max_replicas,
                         self.sla.replicas_for(streams, c.min_replicas))
            if target >= current:
                self._low_streak = 0
                return target
            self._low_streak += 1
            if self._low_streak >= c.stable_intervals:
                self._low_streak = 0
                return current - 1
            return current
        self._pred_usage.add_data_point(snap.load_avg())
        self._pred_waiting.add_data_point(sum(
            m.worker_stats.num_requests_waiting
            for m in snap.metrics.values()
        ))
        usage = self._pred_usage.predict_next()
        waiting = self._pred_waiting.predict_next()
        # evaluated unconditionally (not short-circuited inside the
        # ``or``): advance() must step its interval baseline and publish
        # the fleet p99 gauges exactly once per decide
        fleet_high = self._fleet_latency_high()
        target = current
        if (usage > c.kv_usage_scale_up or waiting > c.waiting_scale_up
                or self._queue_wait_high(snap) or fleet_high):
            target = current + 1
            self._low_streak = 0
        elif usage < c.kv_usage_scale_down and waiting < 0.5:
            self._low_streak += 1
            if self._low_streak >= c.stable_intervals:
                target = current - 1
                self._low_streak = 0
        else:
            self._low_streak = 0
        if not c.predictive:
            from dynamo_tpu_torch.planner_metrics import PLANNER

            PLANNER.set("dynamo_planner_predicted_load", usage)
        else:
            # predictive floor: never below what the forecast needs, and
            # a forecast above current load cancels a pending downscale
            pred = self._predictive_target(snap, current)
            if pred > target:
                target = pred
                self._low_streak = 0
        return max(c.min_replicas, min(c.max_replicas, target))

    async def adjust(self) -> int:
        from dynamo_tpu_torch.planner_metrics import PLANNER

        target = self.decide()
        current = self.connector.current_replicas()
        PLANNER.inc("dynamo_planner_decisions_total")
        PLANNER.set("dynamo_planner_replicas", target)
        if target != current:
            log.info("planner: scaling %d -> %d", current, target)
            PLANNER.inc("dynamo_planner_scale_ups_total"
                        if target > current
                        else "dynamo_planner_scale_downs_total")
            await self.connector.set_replicas(target)
        self.decisions.append((self.clock.monotonic(), target))
        return target


async def run_planner(args) -> None:
    """CLI entry: planner over a local worker pool, or over a k8s worker
    Deployment (``--connector kubernetes --k8s-deployment NAME``). SLA
    and connector flags validate BEFORE connecting so misconfiguration
    fails fast. SIGTERM stops the planner and its workers (a clean exit,
    code 0)."""
    from dynamo_tpu_torch.launch.run import sigterm_event

    sla = _build_sla(args)
    kubernetes = getattr(args, "connector", "local") == "kubernetes"
    if kubernetes and not args.k8s_deployment:
        raise SystemExit("--connector kubernetes needs --k8s-deployment")
    host, _, port = args.control_plane.partition(":")
    kv = await KvClient(host or "127.0.0.1", int(port or 7111)).connect()
    if kubernetes:
        # scale the worker Deployment through the k8s API (reference
        # kubernetes_connector.py; in-cluster credentials by default)
        from dynamo_tpu_torch.k8s import KubernetesConnector

        try:
            connector = await KubernetesConnector(
                args.k8s_deployment, args.k8s_namespace).start()
        except BaseException:
            await kv.close()
            raise
    else:
        worker_cmd = [sys.executable, "-m", "dynamo_tpu_torch.cli", "run",
                      "in=endpoint", f"out={args.engine}",
                      "--control-plane", args.control_plane,
                      "--model-name", args.model_name,
                      "--namespace", args.namespace]
        connector = LocalConnector(worker_cmd)
    cfg = PlannerConfig(
        adjustment_interval_s=args.adjustment_interval,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        predictor=getattr(args, "predictor", "constant"),
        predictive=getattr(args, "predictive", False),
        streams_per_replica=getattr(args, "streams_per_replica", 0.0),
        fleet_ttft_scale_up_s=getattr(args, "fleet_ttft_scale_up", 0.0),
        fleet_queue_scale_up_s=getattr(
            args, "fleet_queue_scale_up", 0.0),
    )
    if connector.current_replicas() < cfg.min_replicas:
        await connector.set_replicas(cfg.min_replicas)
    planner = await Planner(kv, connector, cfg, sla=sla).start()
    stop = sigterm_event()
    mode = "sla" if sla else "load"
    print(f"planner ({mode}) managing '{args.model_name}' workers "
          f"[{cfg.min_replicas}, {cfg.max_replicas}]", flush=True)
    try:
        await stop.wait()
    finally:
        await planner.stop()
        await connector.shutdown()
        await kv.close()


def _build_sla(args):
    sla = None
    if getattr(args, "sla_profile", None):
        from dynamo_tpu_torch.profiler import SlaCapacity

        if args.ttft_sla is None and args.itl_sla is None:
            raise SystemExit(
                "--sla-profile requires --ttft-sla and/or --itl-sla "
                "(otherwise no SLA would be enforced)"
            )
        with open(args.sla_profile) as f:
            profile = json.load(f)
        names = [c.get("name") for c in profile.get("configs", [])]
        config_name = getattr(args, "sla_config", None)
        if config_name is None:
            if len(names) != 1:
                raise SystemExit(
                    f"profile has configs {names}; pass --sla-config to "
                    "pick the one your deployed workers actually run"
                )
            config_name = names[0]
        elif config_name not in names:
            raise SystemExit(
                f"--sla-config {config_name!r} not in profile ({names})"
            )
        sla = SlaCapacity(
            profile=profile,
            ttft_sla_s=args.ttft_sla,
            itl_sla_s=args.itl_sla,
            config_name=config_name,
        )
        if sla.max_concurrency() <= 0:
            raise SystemExit(
                f"SLA unmeetable: no profiled point of {config_name!r} "
                f"satisfies ttft<={args.ttft_sla} itl<={args.itl_sla} — "
                "re-profile or relax the targets"
            )
    elif args.ttft_sla is not None or args.itl_sla is not None:
        raise SystemExit("--ttft-sla/--itl-sla need --sla-profile")
    return sla
