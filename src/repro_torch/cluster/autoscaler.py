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
context, weights and KV.

Weight placement: when a pool resize coincides with a device-mesh change,
pass an ``ElasticRunner`` (``core.fault``) and a ``make_mesh(n)``
factory, and each resize re-places the parameters with
``elastic.rescale(make_mesh(n))`` (``autoscaler.py:106-108``).  JAX has
one controller for every device; under ``torch.distributed`` each rank
runs its own, and building a mesh and rescaling are collective.  So the
protocol is:

  * rank 0 runs the ``Autoscaler``; every other rank runs
    :func:`follow_rescales` with the same ``make_mesh``;
  * at each resize rank 0 sends the new size n to every rank
    (``dist.broadcast`` of one int64 over the world), then every rank,
    rank 0 included, calls ``make_mesh(n)`` and ``elastic.rescale`` on
    it together (ranks outside the new mesh drop their weights);
  * :meth:`Autoscaler.release_followers` sends 0, on which the followers
    return.  Without an initialised process group, or on a world of one
    rank, nothing is sent;
  * ``tick()`` then issues collectives, so on a world of several ranks
    it runs on the thread that issues rank 0's other collectives, never
    beside them: ``start()`` refuses ``elastic=`` with ``make_mesh=``
    there, since its thread would interleave the ranks' collectives in
    another order and hang them.

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
        self.router = router
        self.backend_factory = backend_factory
        self.transport = transport
        self.cfg = cfg
        self.fall_behind = fall_behind
        self.elastic = elastic
        self.make_mesh = make_mesh
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

    def _replace_weights(self, n: int):
        if self.elastic is not None and self.make_mesh is not None:
            _send_size(n)
            self.elastic.rescale(self.make_mesh(n))

    def release_followers(self):
        """Tell the ranks in :func:`follow_rescales` to return."""
        if self.elastic is not None and self.make_mesh is not None:
            _send_size(0)

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
        self._replace_weights(n)
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
        self._replace_weights(n)
        self._last_action_t = now
        ev = ScaleEvent(now, "down", n, reason)
        self.events.append(ev)
        self.metrics.counter("autoscaler.scale_downs").inc()
        return ev

    # -------------------------------------------------- background mode
    def start(self, period_s: float = 0.1) -> "Autoscaler":
        if self.elastic is not None and self.make_mesh is not None and \
                _world_size() > 1:
            raise RuntimeError(
                "with elastic= and make_mesh= on several ranks, tick() "
                "issues collectives: call it on rank 0's collective thread, "
                "not on start()'s own (the protocol in the module docstring)")

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


# ----------------------------------------------------------------------
def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _send_size(n: int) -> int:
    """Rank 0's ``n`` on every rank of the world (the resize protocol in
    the module docstring); ``n`` itself without a world to send to."""
    import torch
    import torch.distributed as dist
    if _world_size() == 1:
        return n
    from repro_torch.core.collectives import rank_device
    t = torch.tensor([n], dtype=torch.int64, device=rank_device())
    dist.broadcast(t, src=0)
    return int(t.item())


def follow_rescales(elastic, make_mesh: Callable[[int], object]) -> int:
    """The loop of every rank but 0: wait for rank 0's next pool size,
    build its mesh and rescale ``elastic`` onto it, until rank 0 sends 0
    (:meth:`Autoscaler.release_followers`).  Returns the number of
    rescales taken part in."""
    done = 0
    while True:
        n = _send_size(-1)
        if n == 0:
            return done
        elastic.rescale(make_mesh(n))
        done += 1
