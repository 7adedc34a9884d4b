"""Request router: fan user requests out over a pool of replica transports.

The paper distributes the *pipeline* over Spark workers; this module
distributes the *service* — the missing piece between one `Engine`/stream
runtime and "heavy traffic from millions of users".  Pluggable dispatch
policies:

  * ``round_robin``      — uniform rotation over alive replicas.
  * ``least_loaded``     — lowest outstanding cost (requests or token/row
                           weights), the classic join-shortest-queue policy.
  * ``session_affinity`` — rendezvous (highest-random-weight) hashing of the
                           session key, so a session sticks to one replica
                           (warm caches / per-user state) and only the keys
                           of a *removed* replica ever remap.

The router sees replicas only through the
:class:`~repro_torch.cluster.transport.Transport` surface — it neither
knows nor cares whether a replica is a thread in this process
(``transport="thread"``) or a worker subprocess behind an RPC inbox
(``transport="process"``, built from a serializable
:class:`~repro_torch.cluster.backends.BackendSpec`).

Fault path: a replica crash spills its unacknowledged requests back here;
they are requeued on survivors (bounded retries, `core/fault.py` semantics).
Admission control (`cluster/admission.py`) runs at `submit`, so overload is
an explicit `Rejected` result instead of unbounded queueing; when replicas
carry a backend *kind* ("lm", "svm", ...) the deadline test uses that
backend's own cost model and queue depth.

Copied from ``repro.cluster.router``; the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import hashlib
import itertools
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)

from repro_torch.cluster.admission import AdmissionController, Rejected
from repro_torch.cluster.backends import BackendSpec
from collections import OrderedDict

from repro_torch.cluster.metrics import (MetricsRegistry, merge_snapshots,
                                         null_registry, terminal_snapshot_view)
from repro_torch.cluster.overload import BrownoutController, CircuitBreaker
from repro_torch.cluster.replica import (KV_IMPORT_TAG, ClusterRequest,
                                         ReplicaConfig, Status, WaitTimeout)
from repro_torch.cluster.tracing import current_recorder, current_tracer
from repro_torch.cluster.transport import Transport, make_transport

POLICIES = ("round_robin", "least_loaded", "session_affinity")


def _rendezvous_weight(session_key: str, rid: int) -> int:
    h = hashlib.md5(f"{session_key}|{rid}".encode()).digest()
    return int.from_bytes(h[:8], "little")


class Router:
    """Front door over N replica :class:`Transport` s."""

    def __init__(self, policy: str = "round_robin",
                 admission: Optional[AdmissionController] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 max_retries: int = 2,
                 requeue_timeout_s: float = 5.0,
                 retry_backoff_base_s: float = 0.05,
                 retry_backoff_max_s: float = 1.0,
                 poison_threshold: int = 2,
                 breaker: Optional[CircuitBreaker] = None,
                 brownout: Optional[BrownoutController] = None):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.policy = policy
        self.metrics = metrics if metrics is not None else null_registry()
        self.admission = admission
        self.max_retries = max_retries
        self.requeue_timeout_s = requeue_timeout_s
        # retry budget: each respill waits base * 2^(attempt-1) (capped)
        # before re-offering — a crash's burst spreads instead of slamming
        # survivors in lockstep
        self.retry_backoff_base_s = retry_backoff_base_s
        self.retry_backoff_max_s = retry_backoff_max_s
        # poison detection: a request whose dispatch has now killed this
        # many *distinct* replicas terminates with finish_reason="poison"
        # instead of cascading through the rest of the fleet
        self.poison_threshold = poison_threshold
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.brownout = brownout
        self._replicas: Dict[int, Transport] = {}
        self._lock = threading.Lock()
        self._rr = itertools.count()
        self._rids = itertools.count(1)
        # session placement ledger: session_key -> replica rid of the last
        # successful dispatch.  A drain reads it twice: to *report* which
        # sessions remap (last_remapped_sessions) and to *migrate* the
        # drained backend's exported KV state to those sessions' new
        # rendezvous homes (_migrate_kv).  Bounded: old entries evict
        # LRU-ish rather than growing with total sessions ever served —
        # an evicted key only loses the warm hand-off, never correctness.
        self._session_homes: Dict[str, int] = {}
        self.session_ledger_cap = 65536
        self.last_remapped_sessions: Dict[int, List[str]] = {}
        self._latency = self.metrics.histogram("router.latency_s")
        self._completed = self.metrics.counter("router.completed")
        self._failed = self.metrics.counter("router.failed")
        self._requeued = self.metrics.counter("router.requeued")
        self._submitted = self.metrics.counter("router.submitted")
        # optional SLO engine (wired by serve/telemetry setup): a firing
        # burn alert feeds extra pressure into the brownout ladder
        self.slo: Optional[Any] = None
        # terminal snapshots of departed replicas: a removed/dead worker's
        # last-merged counters stay in cluster_snapshot() so cluster-wide
        # counters (and .le<i> histogram counts) never regress when a
        # worker leaves.  Bounded FIFO by rid; gauges/percentiles are
        # filtered out at capture (terminal_snapshot_view).
        self._departed: "OrderedDict[int, Dict[str, float]]" = OrderedDict()
        self.departed_cap = 32

    # -------------------------------------------------- replica pool
    def add_replica(self, backend=None, cfg: ReplicaConfig = ReplicaConfig(),
                    rid: Optional[int] = None, *,
                    spec: Optional[BackendSpec] = None,
                    transport: str = "thread",
                    kind: Optional[str] = None,
                    **transport_kwargs) -> Transport:
        """Add one replica.  ``backend`` (a live object) keeps the first
        signature and runs on a thread; ``spec=`` + ``transport="process"``
        places the same replica in a spawned worker process instead.
        Extra keyword arguments pass through to ``make_transport`` — e.g.
        ``transport="socket"`` accepts ``artifacts=`` (the weight store
        fetches resolve against), ``listener=``, ``token=``, and
        ``spawn=False`` for operator-run remote workers."""
        worker = make_transport(transport, backend=backend, spec=spec,
                                cfg=cfg, rid=rid, metrics=self.metrics,
                                on_spill=self._on_spill, kind=kind,
                                **transport_kwargs)
        worker.start()
        with self._lock:
            self._replicas[worker.rid] = worker
        self._set_pool_gauge()
        return worker

    def remove_replica(self, rid: int, drain: bool = True,
                       migrate: bool = True) -> None:
        """Take a replica out of rotation; by default let it finish its
        inbox first (graceful drain).

        Removing a replica remaps its rendezvous-hashed sessions — and
        *only* its sessions: every key homed on a surviving replica keeps
        its placement (the rendezvous property,
        ``tests/test_cluster.py::test_drain_remaps_only_drained_sessions``).
        With ``migrate=True`` (the default) the drained backend's exported
        KV state — published by the replica driver just before the drained
        signal — is shipped to each remapped session's new rendezvous
        home, so those sessions resume *warm* (block-exact prefix reuse)
        instead of restarting cold.  Backends that publish nothing (echo
        workers, dense engines) keep the old log-and-forget behavior via
        ``last_remapped_sessions`` / ``router.sessions_remapped``."""
        with self._lock:
            worker = self._replicas.pop(rid, None)
        remapped = self._note_remapped_sessions(rid)
        self._set_pool_gauge()
        self.breaker.forget(rid)
        if worker is not None and drain:
            worker.drain()
            if migrate:
                self._migrate_kv(worker, remapped)
        if worker is not None:
            # after the drain: the final heartbeat's snapshot is the
            # freshest view of the worker's lifetime counters
            self._retain_departed(worker)

    def _migrate_kv(self, worker: Transport,
                    remapped: List[str]) -> None:
        """Warm session migration: ship the drained worker's KV export to
        each remapped session's new rendezvous home as a
        ``(KV_IMPORT_TAG, state)`` payload, offered directly (admission
        was already paid by the original requests).  One frame per
        distinct target replica; imports are idempotent on the far side,
        so at-least-once delivery — and a later retry landing the same
        sessions' requests next to the import in one batch — is safe."""
        state = getattr(worker, "kv_state", None)
        if state is None or not remapped:
            return
        same_kind = [w for w in self.alive_replicas()
                     if w.kind == worker.kind]
        if not same_kind:
            return
        targets: Dict[int, Transport] = {}
        for key in remapped:
            home = max(same_kind,
                       key=lambda w: _rendezvous_weight(key, w.rid))
            targets[home.rid] = home
        shipped = 0
        for home in targets.values():
            req = ClusterRequest((KV_IMPORT_TAG, state), kind=worker.kind,
                                 rid=next(self._rids),
                                 submitted_s=time.monotonic())
            if home.offer(req):
                shipped += 1
            else:
                self.metrics.counter("router.kv_migrate_failed").inc()
        if shipped:
            self.metrics.counter("router.sessions_migrated") \
                .inc(len(remapped))
            self.metrics.counter("router.kv_migrations").inc(shipped)
            current_recorder().record("session_migrated",
                                      replica=worker.rid,
                                      sessions=len(remapped),
                                      targets=shipped)

    def _note_remapped_sessions(self, rid: int) -> List[str]:
        with self._lock:
            remapped = sorted(k for k, home in self._session_homes.items()
                              if home == rid)
            for k in remapped:
                del self._session_homes[k]
            if not remapped and rid in self.last_remapped_sessions:
                # second notification for the same replica (e.g. a drain
                # followed by its death spill): don't clobber the export
                return []
            self.last_remapped_sessions[rid] = remapped
            while len(self.last_remapped_sessions) > 64:  # bounded history
                self.last_remapped_sessions.pop(
                    next(iter(self.last_remapped_sessions)))
        if remapped:
            self.metrics.counter("router.sessions_remapped") \
                .inc(len(remapped))
            log.info("replica %d removed: %d session(s) remap: %s", rid,
                     len(remapped),
                     ", ".join(remapped[:16]) +
                     (" …" if len(remapped) > 16 else ""))
        return remapped

    def _retain_departed(self, worker: Transport) -> None:
        """Keep a departed replica's monotone counters in the cluster
        merge (bounded; see ``cluster_snapshot``).  Thread replicas share
        the router registry and ship an empty snapshot — nothing to do."""
        snap = terminal_snapshot_view(worker.metrics_snapshot())
        if not snap:
            return
        with self._lock:
            self._departed[worker.rid] = snap
            while len(self._departed) > self.departed_cap:
                self._departed.popitem(last=False)

    def alive_replicas(self) -> List[Transport]:
        with self._lock:
            return [w for w in self._replicas.values() if w.alive]

    def n_alive(self) -> int:
        return len(self.alive_replicas())

    def queue_depth(self, kind: Optional[str] = None) -> int:
        """Outstanding cost (inbox + in-flight) over alive replicas —
        cluster-wide, or restricted to one backend kind."""
        return sum(w.outstanding_cost() for w in self.alive_replicas()
                   if kind is None or w.kind == kind)

    def _set_pool_gauge(self):
        self.metrics.gauge("router.replicas").set(self.n_alive())

    # -------------------------------------------------- dispatch policies
    def _ranked(self, req: ClusterRequest) -> List[Transport]:
        """Alive replicas in dispatch-preference order for this request.
        Dead transports are never candidates (see
        ``tests/test_transport.py`` for the property test)."""
        alive = sorted((w for w in self.alive_replicas()
                        if self.breaker.allow(w.rid)),
                       key=lambda w: w.rid)
        if req.kind is not None:
            # strict: a kind with no live replica sheds explicitly rather
            # than falling back to wrong-kind backends (whose process()
            # would raise on the foreign payload and cascade-kill the pool)
            alive = [w for w in alive if w.kind == req.kind]
        if not alive:
            return []
        if self.policy == "least_loaded":
            return sorted(alive, key=lambda w: (w.outstanding_cost(), w.rid))
        if self.policy == "session_affinity" and req.session_key is not None:
            return sorted(alive, key=lambda w: _rendezvous_weight(
                req.session_key, w.rid), reverse=True)
        k = next(self._rr) % len(alive)
        return alive[k:] + alive[:k]

    # -------------------------------------------------- submission
    def submit(self, payload: Any, *, cost: int = 1,
               session_key: Optional[str] = None,
               kind: Optional[str] = None,
               timeout_s: float = 30.0,
               on_partial: Optional[Callable[[Any], None]] = None,
               ) -> ClusterRequest:
        """``on_partial(frame)`` streams partial results (e.g. per-K-step
        token slices from an LM engine) while the request is in flight;
        the final result still arrives through :meth:`wait`."""
        now = time.monotonic()
        req = ClusterRequest(payload, cost=cost, session_key=session_key,
                             kind=kind, deadline_s=now + timeout_s,
                             rid=next(self._rids), submitted_s=now,
                             on_partial=on_partial, metrics=self.metrics)
        self._submitted.inc()
        # trace root: the sampling decision for this request's entire
        # cross-host span tree is made here, once
        root = current_tracer().span("request", rid=req.rid, cost=cost,
                                     kind=kind)
        if root.recording:
            req.trace_span = root
            req.trace_ctx = root.context()
        current_recorder().record("submit", rid=req.rid, cost=cost,
                                  backend=kind)
        self._tick_brownout()
        if self.admission is not None:
            with current_tracer().span("admission.decide",
                                       parent=root) as asp:
                kv_frac = None
                if self.admission.cfg.min_kv_headroom_frac > 0:
                    kv_frac = self.kv_free_fraction()
                scale = self.brownout.admission_scale() \
                    if self.brownout is not None else 1.0
                shed = self.admission.decide(self.queue_depth(kind), cost,
                                             req.deadline_s, now, kind=kind,
                                             kv_free_frac=kv_frac,
                                             scale=scale)
                asp.tag(shed=shed is not None)
            if shed is not None:
                current_recorder().record("shed", rid=req.rid,
                                          reason=shed.reason)
                req.reject(shed)
                return req
        with current_tracer().span("router.dispatch", parent=root) as dsp:
            self._dispatch(req)
            if req.replica_rid is None and not req.done.is_set():
                dsp.tag(replica="pending")
        return req

    def _tick_brownout(self) -> int:
        """Advance the brownout ladder from the live overload signals
        (queue occupancy vs the admission bound, KV-pool occupancy) and
        broadcast the level to every replica on a transition."""
        bo = self.brownout
        if bo is None:
            return 0
        qmax = self.admission.cfg.max_queue_cost \
            if self.admission is not None else 0
        qfrac = self.queue_depth() / qmax if qmax else 0.0
        kv = self.kv_free_fraction()
        slo_pressure = self.slo.pressure() if self.slo is not None else 0.0
        lvl = bo.tick(qfrac, 1.0 - kv if kv is not None else 0.0,
                      extra=slo_pressure)
        self.metrics.gauge("router.brownout_level").set(lvl)
        if bo.changed:
            current_recorder().record("brownout_level", level=lvl,
                                      queue_frac=round(qfrac, 3))
            self.metrics.counter("router.brownout_transitions").inc()
            for w in self.alive_replicas():
                fn = getattr(w, "set_brownout", None)
                if fn is not None:
                    fn(lvl)
        return lvl

    def kv_free_fraction(self) -> Optional[float]:
        """Cluster-wide paged-KV headroom: free / total blocks summed over
        the router registry (thread replicas write it directly) and every
        alive worker's last heartbeat snapshot.  Reads just the two
        ``engine.kv_blocks_*`` gauges — this runs on every admission
        decision, so it must not pay ``cluster_snapshot``'s full
        merge-and-recompute-percentiles cost.  None when no replica
        reports a pool (dense engines, non-LM backends)."""
        total = self.metrics.gauge("engine.kv_blocks_total").value
        free = self.metrics.gauge("engine.kv_blocks_free").value
        for w in self.alive_replicas():
            snap = w.metrics_snapshot()
            total += snap.get("engine.kv_blocks_total", 0.0)
            free += snap.get("engine.kv_blocks_free", 0.0)
        if total <= 0:
            return None
        return free / total

    def _note_session_home(self, key: str, rid: int) -> None:
        with self._lock:
            self._session_homes.pop(key, None)    # refresh insertion order
            self._session_homes[key] = rid
            while len(self._session_homes) > self.session_ledger_cap:
                self._session_homes.pop(next(iter(self._session_homes)))

    def _dispatch(self, req: ClusterRequest) -> None:
        if req.cancelled:
            # a cancel can only precede dispatch on the respill path, but
            # the guard is cheap and makes "never re-dispatched" local
            req.finish_cancelled()
            return
        for worker in self._ranked(req):
            attempts_before = req.attempts
            if worker.offer(req):
                # offer() may report True because a concurrent spill took
                # ownership (the fault path requeues it elsewhere and bumps
                # req.attempts); only an undisturbed accept makes this
                # worker the session's home
                self.breaker.note_dispatch(worker.rid)
                if req.session_key is not None and \
                        req.attempts == attempts_before:
                    self._note_session_home(req.session_key, worker.rid)
                self.metrics.gauge("router.queue_depth").set(self.queue_depth())
                return
        # every alive inbox full (or pool empty): explicit backpressure
        self.metrics.counter("router.shed_backpressure").inc()
        req.reject(Rejected("queue_full", "all replica inboxes full"))

    def wait(self, req: ClusterRequest,
             timeout: Optional[float] = None) -> Any:
        """Block for the result.  On timeout the request is *still in
        flight* and a typed :class:`WaitTimeout` comes back instead of a
        leaked falsy result — the documented follow-up is
        ``router.cancel(req)`` (a later wait can still observe the
        terminal state the cancel produces)."""
        out = req.wait(timeout)
        if not req.done.is_set():
            self.metrics.counter("router.wait_timeout").inc()
            return WaitTimeout(rid=req.rid,
                               waited_s=timeout if timeout is not None
                               else 0.0)
        if req.status is Status.OK:
            self._completed.inc()
            self._latency.observe(req.finished_s - req.submitted_s)
            if req.replica_rid is not None:
                # a clean completion resolves that replica's half-open
                # probe (if this request happened to be it)
                self.breaker.record_ack(req.replica_rid)
        return out

    def cancel(self, req: ClusterRequest) -> None:
        """Cancel an in-flight request: flag it so no router path ever
        moves it again (dispatch, spill, requeue), then fan a best-effort
        ``("cancel", rid)`` to every alive replica — rids are globally
        unique and never reused, so broadcasting is race-free even while
        the request migrates between replicas.  The terminal state arrives
        either as the replica's ``Terminal("cancelled")`` ack (with any
        partial tokens) or, if the request is currently between homes,
        from the requeue loop observing the flag.  A cancel that loses the
        race with a genuine completion is a no-op: the first terminal
        state wins."""
        if req.done.is_set():
            return
        req.cancelled = True
        self.metrics.counter("router.cancelled").inc()
        current_recorder().record("cancelled", rid=req.rid, where="router")
        for w in self.alive_replicas():
            fn = getattr(w, "cancel", None)
            if fn is not None:
                fn(req.rid)

    # -------------------------------------------------- fault path
    def _on_spill(self, spilled: List[ClusterRequest],
                  dead: Transport) -> None:
        """Requeue a spilling replica's unacknowledged requests.

        Two spill sources share this path: a *dead* transport (crash,
        heartbeat timeout) is removed from the pool and its requests go to
        survivors only; a transport that is merely *disconnected* (socket
        drop inside its reconnect window, ``dead.alive`` still True) stays
        in the pool and may even re-accept its own spilled requests once
        the worker reconnects.  At-least-once either way: a request whose
        batch finished compute but was never acknowledged is re-executed;
        none are lost."""
        if not dead.alive:
            with self._lock:
                self._replicas.pop(dead.rid, None)
            self._retain_departed(dead)
            self._note_remapped_sessions(dead.rid)
            self._set_pool_gauge()
            # a dead transport leaves the pool for good (rids are never
            # reused) — drop its breaker state instead of growing the map
            self.breaker.forget(dead.rid)
        # circuit breaker: a spill from a transport that *stays* in the
        # pool (socket flap inside its reconnect window) is a strike — a
        # crash-looping replica trips into quarantine instead of being
        # ranked first on the very next dispatch
        elif self.breaker.record_crash(dead.rid):
            self.metrics.counter("router.quarantined").inc()
            current_recorder().record("quarantine", replica=dead.rid,
                                      state=self.breaker.state(dead.rid))
        exclude = dead.rid if not dead.alive else None
        for req in spilled:
            req.attempts += 1
            if not dead.alive:
                req.killed_replicas.add(dead.rid)
            # the replacement replica re-runs from scratch and re-streams
            # every token: reset the partial-frame view so incremental
            # consumers don't render the first attempt's prefix twice
            req.reset_partials()
            # refresh the dispatched context's attempt number so spans
            # from the dead attempt stay tagged apart from the retry's
            if req.trace_span is not None:
                req.trace_ctx = req.trace_span.context(
                    attempt=req.attempts)
            current_recorder().record("spill", rid=req.rid,
                                      replica=dead.rid,
                                      attempt=req.attempts)
            if req.cancelled:
                # never re-dispatch a cancelled rid — terminal right here
                req.finish_cancelled()
                self.metrics.counter("router.cancelled_on_spill").inc()
                continue
            if len(req.killed_replicas) >= self.poison_threshold:
                # this request has now taken down N distinct replicas:
                # stop feeding it to the fleet
                req.finish_reason = "poison"
                self.metrics.counter("router.poisoned").inc()
                current_recorder().record(
                    "poison", rid=req.rid,
                    replicas=sorted(req.killed_replicas))
                req.fail(RuntimeError(
                    f"request {req.rid}: poison — killed "
                    f"{len(req.killed_replicas)} replicas "
                    f"{sorted(req.killed_replicas)}"))
                self._failed.inc()
                continue
            if req.attempts > self.max_retries:
                req.fail(RuntimeError(
                    f"request {req.rid}: retries exhausted after replica "
                    f"{dead.rid} crash"))
                self._failed.inc()
                continue
            # bounded exponential backoff before the re-offer: a crash
            # dumps a burst — attempt 1 waits base, attempt 2 waits 2x,
            # ... capped, so survivors absorb the wave instead of a
            # synchronized stampede
            delay = min(self.retry_backoff_base_s * (2 ** (req.attempts - 1)),
                        self.retry_backoff_max_s)
            if delay > 0:
                self.metrics.counter("router.retry_backoff").inc()
                current_recorder().record("retry_backoff", rid=req.rid,
                                          attempt=req.attempts,
                                          delay_s=round(delay, 4))
                time.sleep(delay)
            if not self._requeue_blocking(req, exclude=exclude):
                req.fail(RuntimeError(
                    f"request {req.rid}: no surviving replica accepted it"))
                self._failed.inc()
            elif not req.done.is_set():
                self._requeued.inc()

    def _requeue_blocking(self, req: ClusterRequest,
                          exclude: Optional[int]) -> bool:
        """Offer to survivors, waiting out transient inbox fullness (a crash
        dumps a burst on the pool) up to ``requeue_timeout_s``.  Returns
        True when the request was *handled* — accepted by a survivor, or
        terminally finished here because it was cancelled / expired while
        waiting (re-dispatching either would waste a survivor's slot on
        work nobody wants)."""
        t_end = time.monotonic() + self.requeue_timeout_s
        while True:
            if req.cancelled or req.done.is_set():
                req.finish_cancelled()      # no-op if already terminal
                return True
            now = time.monotonic()
            if now > req.deadline_s:
                current_recorder().record("deadline_expired", rid=req.rid,
                                          where="requeue")
                self.metrics.counter("router.expired_on_requeue").inc()
                req.finish_expired()
                return True
            if now >= t_end:
                return False
            ranked = [w for w in self._ranked(req) if w.rid != exclude]
            if not ranked:
                return False
            for worker in ranked:
                attempts_before = req.attempts
                if worker.offer(req):
                    self.breaker.note_dispatch(worker.rid)
                    if req.session_key is not None and \
                            req.attempts == attempts_before:
                        self._note_session_home(req.session_key, worker.rid)
                    return True
            time.sleep(0.002)

    # -------------------------------------------------- service bridge
    def process_batch(self, payloads: List[Any],
                      timeout_s: float = 30.0,
                      cost_fn: Optional[Callable[[Any], int]] = None,
                      session_fn: Optional[Callable[[Any], Optional[str]]] = None,
                      ) -> List[Any]:
        """Fan a batch out over the pool and wait for every result — the
        ``step_fn`` contract, so an ``MLaaSService`` front can target a
        cluster exactly like a local step (see ``as_step_fn``).

        Per-payload outcomes: the backend result, a :class:`Rejected`, or
        ``None`` for a failed request (retries exhausted)."""
        reqs = [self.submit(p,
                            cost=cost_fn(p) if cost_fn else 1,
                            session_key=session_fn(p) if session_fn else None,
                            timeout_s=timeout_s)
                for p in payloads]
        return [self.wait(r, timeout=timeout_s + self.requeue_timeout_s)
                for r in reqs]

    def as_step_fn(self, **kwargs) -> Callable[[List[Any]], List[Any]]:
        return lambda payloads: self.process_batch(payloads, **kwargs)

    # -------------------------------------------------- telemetry
    def cluster_snapshot(self) -> Dict[str, float]:
        """One flat view of the whole service: the router-side registry
        merged with each alive worker's last shipped snapshot (process
        replicas report their counters over the heartbeat channel; thread
        replicas already share the registry) plus the retained terminal
        snapshots of departed replicas — cluster counters and histogram
        bucket counts stay monotone when a worker dies or is removed."""
        with self._lock:
            departed = list(self._departed.values())
        return merge_snapshots(self.metrics.snapshot(),
                               [w.metrics_snapshot()
                                for w in self.alive_replicas()] + departed)

    # -------------------------------------------------- lifecycle
    def stop(self, drain: bool = True) -> None:
        with self._lock:
            workers = list(self._replicas.values())
            self._replicas.clear()
        for w in workers:
            if drain:
                w.drain()
            else:
                w.inject_crash()
                w.join()
            self._retain_departed(w)
        self._set_pool_gauge()
