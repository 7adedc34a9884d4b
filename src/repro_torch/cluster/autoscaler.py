"""Reactive autoscaler (paper §3: "run-time infrastructure scaling";
Spark's dynamic allocation, re-read onto replica pools), copied from
``repro.cluster.autoscaler``.

Watches two signals and resizes the replica pool between configured bounds:

  * queue pressure — cluster-wide outstanding cost per alive replica above
    ``scale_up_depth`` adds a replica; sustained idleness below
    ``scale_down_depth`` drains one (graceful: it finishes its inbox).
  * fall-behind    — the stream runtime's "processing time exceeds the
    micro-batch period" signal (``StreamRuntime.falling_behind``) forces a
    scale-up even when queues look shallow, because ingest is about to pile
    up (paper Fig. 6b's saturation point).

A new replica is whatever ``backend_factory`` returns: a live backend on a
thread, or a ``BackendSpec`` rebuilt in a spawned worker (``transport=
"process"`` or ``"socket"``), each worker an engine with its own CUDA
context, weights and KV.  The JAX module's weight re-placement over a
device mesh (``elastic=``, ``make_mesh=``) needs ``ElasticRunner``, which
the port does not have yet (ROADMAP.md, Queue 1, item 8): passing either
raises instead of scaling without it.

``tick()`` is deliberately pull-based and side-effect-explicit so tests can
drive it with a fake clock; ``start()`` runs it on a daemon thread.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

from repro_torch.cluster.backends import BackendSpec
from repro_torch.cluster.metrics import MetricsRegistry, null_registry
from repro_torch.cluster.replica import ReplicaConfig
from repro_torch.cluster.router import Router


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_depth: float = 8.0       # outstanding cost per replica
    scale_down_depth: float = 1.0
    cooldown_s: float = 1.0           # min gap between scale actions
    idle_ticks_to_drain: int = 3      # consecutive calm ticks before drain
    replica_cfg: ReplicaConfig = ReplicaConfig()


@dataclasses.dataclass
class ScaleEvent:
    t: float
    action: str                       # "up" | "down"
    n_replicas: int                   # pool size after the action
    reason: str


class Autoscaler:
    def __init__(self, router: Router, backend_factory: Callable[[], object],
                 cfg: AutoscalerConfig = AutoscalerConfig(),
                 fall_behind: Optional[Callable[[], bool]] = None,
                 elastic=None, make_mesh: Optional[Callable[[int], object]] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 transport: str = "thread"):
        # ``backend_factory`` may return a live backend (placed on a thread)
        # or a serializable ``BackendSpec`` — required when ``transport`` is
        # "process", where the new replica is a spawned worker.
        if elastic is not None or make_mesh is not None:
            raise NotImplementedError(
                "Autoscaler(elastic=, make_mesh=) re-places weights over a "
                "device mesh with ElasticRunner, which is not in the port "
                "yet: ROADMAP.md, Queue 1, item 8 (the multi-device paths)")
        self.router = router
        self.backend_factory = backend_factory
        self.transport = transport
        self.cfg = cfg
        self.fall_behind = fall_behind
        self.metrics = metrics if metrics is not None else null_registry()
        self.clock = clock
        self.events: List[ScaleEvent] = []
        self._last_action_t = float("-inf")
        self._idle_ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------- policy
    def tick(self, now: Optional[float] = None) -> Optional[ScaleEvent]:
        now = self.clock() if now is None else now
        n = self.router.n_alive()
        depth = self.router.queue_depth()
        per_replica = depth / max(n, 1)
        self.metrics.gauge("autoscaler.depth_per_replica").set(per_replica)
        if now - self._last_action_t < self.cfg.cooldown_s:
            return None

        behind = bool(self.fall_behind()) if self.fall_behind else False
        if (per_replica > self.cfg.scale_up_depth or behind) \
                and n < self.cfg.max_replicas:
            self._idle_ticks = 0
            return self._scale_up(now, "fall_behind" if behind
                                  else f"depth/replica={per_replica:.1f}")

        if per_replica < self.cfg.scale_down_depth and n > self.cfg.min_replicas:
            self._idle_ticks += 1
            if self._idle_ticks >= self.cfg.idle_ticks_to_drain:
                self._idle_ticks = 0
                return self._scale_down(now, f"idle x{self.cfg.idle_ticks_to_drain}")
        else:
            self._idle_ticks = 0
        return None

    def _scale_up(self, now: float, reason: str) -> ScaleEvent:
        # NB: with transport="process" this blocks the tick for the worker
        # spawn (interpreter + backend build; bounded by
        # replica_cfg.spawn_timeout_s) and can fail — a failed spawn must
        # not kill the autoscaler loop, so it becomes an "up_failed" event
        # and the cooldown backs the retry off.
        try:
            made = self.backend_factory()
            if isinstance(made, BackendSpec):
                self.router.add_replica(spec=made, cfg=self.cfg.replica_cfg,
                                        transport=self.transport)
            else:
                self.router.add_replica(made, self.cfg.replica_cfg)
        except Exception as e:          # noqa: BLE001 - spawn/build failure
            self._last_action_t = now
            self.metrics.counter("autoscaler.scale_up_failures").inc()
            ev = ScaleEvent(now, "up_failed", self.router.n_alive(), repr(e))
            self.events.append(ev)
            return ev
        n = self.router.n_alive()
        self._last_action_t = now
        ev = ScaleEvent(now, "up", n, reason)
        self.events.append(ev)
        self.metrics.counter("autoscaler.scale_ups").inc()
        return ev

    def _scale_down(self, now: float, reason: str) -> ScaleEvent:
        # drain the least-loaded replica (cheapest to finish)
        victim = min(self.router.alive_replicas(),
                     key=lambda w: (w.outstanding_cost(), -w.rid))
        self.router.remove_replica(victim.rid, drain=True)
        n = self.router.n_alive()
        self._last_action_t = now
        ev = ScaleEvent(now, "down", n, reason)
        self.events.append(ev)
        self.metrics.counter("autoscaler.scale_downs").inc()
        return ev

    # -------------------------------------------------- background mode
    def start(self, period_s: float = 0.1) -> "Autoscaler":
        def loop():
            while not self._stop.wait(period_s):
                self.tick()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
