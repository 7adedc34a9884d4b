"""Replica transports: where a replica runs and how requests reach it,
copied from ``repro.cluster.transport``.

The router, autoscaler and metrics speak to replicas only through the
:class:`Transport` surface (submit/ack/spill/heartbeat over a bounded
inbox), so worker *placement* is pluggable:

  * :class:`LocalTransport`  — the replica driver on a host thread over a
    ``queue.Queue`` inbox.  Threads share one process and its CUDA
    context: weights are zero-copy, but the host work of all replicas
    shares one interpreter.
  * :class:`ProcessTransport` — a spawned worker subprocess with an RPC
    inbox over a duplex pipe; crash detection is by process liveness.
    Each worker owns an independent Python interpreter and CUDA context,
    with its own weights and KV.  Workers are spawned, never forked: a
    CUDA context does not survive a fork.
  * :class:`SocketTransport`  — the same worker behind a framed TCP
    connection (``cluster/wire.py``), so the worker may live on *any*
    host: the paper's worker nodes, finally network-transparent.  The
    worker dials the parent's :class:`~repro_torch.cluster.wire.WorkerListener`
    and completes a versioned (re)connect handshake (token, kind,
    ``BackendSpec`` fingerprint); weights resolve through a
    content-addressed artifact store (``cluster/artifacts.py``).  Crash
    detection is by *heartbeat timeout*, not process liveness — the
    parent may not own the worker's process.  A dropped connection spills
    every unacknowledged request immediately (zero lost) while the
    transport stays in the pool for a reconnect window, so a network blip
    costs a requeue, not a replica.

All transports implement the same at-least-once contract: every request
is either acknowledged exactly once or spilled back to ``on_spill`` for
redispatch; none are lost.  The in-replica loop is shared
(:func:`repro_torch.cluster.replica.run_replica_loop`) and the parent-side
bookkeeping for both remote transports is shared too
(:class:`RemoteTransport`): the outstanding-request table, ack/heartbeat
dispatch, and the die/spill path are one implementation, with the process
and socket classes supplying only their carrier (pipe vs. TCP channel)
and their death detector (liveness vs. heartbeat timeout).

Remote workers are rebuilt from a :class:`~repro_torch.cluster.backends.
BackendSpec` (config + weights path or ``artifact:<sha256>`` reference),
never from live objects — the only things that cross a process or host
boundary are picklable.
"""
from __future__ import annotations

import itertools
import json
import multiprocessing as mp
import os
import queue
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.artifacts import ArtifactStore, spec_fingerprint
from repro_torch.cluster.backends import BackendSpec
from repro_torch.cluster.framing import (decode_frame,  # noqa: F401
                                         encode_frame)
# (re-exported: the framed wire protocol predates cluster/framing.py)
from repro_torch.cluster.metrics import MetricsRegistry, null_registry
from repro_torch.cluster.replica import (ClusterRequest, ReplicaConfig,
                                         ReplicaCrash, run_replica_loop)
from repro_torch.cluster.tracing import (FlightRecorder, TraceContext, Tracer,
                                         current_recorder, current_tracer,
                                         set_recorder, set_tracer)
from repro_torch.cluster.wire import (Channel, ChannelClosed, PipeChannel,
                                      WorkerListener)

TRANSPORTS = ("thread", "process", "socket")

OnSpill = Callable[[List[ClusterRequest], "Transport"], None]


# ----------------------------------------------------------------------
# Flight-recorder dumps land in an artifact store so a chaos postmortem
# can pull them by digest after the process that crashed is gone.  The
# default store is process-wide (shared tempdir root); tests and serve
# wiring may install their own.

_flight_store: Optional[ArtifactStore] = None
_flight_store_lock = threading.Lock()


def set_flight_store(store: Optional[ArtifactStore]) -> None:
    global _flight_store
    with _flight_store_lock:
        _flight_store = store


def default_flight_store() -> ArtifactStore:
    global _flight_store
    with _flight_store_lock:
        if _flight_store is None:
            _flight_store = ArtifactStore()
        return _flight_store


# ----------------------------------------------------------------------
class Transport:
    """What the router/autoscaler may assume about a replica.

    Lifecycle: ``start()`` -> ``offer()`` x N -> ``drain()`` (graceful) or
    ``inject_crash()`` (fault).  A dead transport spills every
    unacknowledged request to ``on_spill`` exactly once.
    """

    _ids = itertools.count()

    def __init__(self, cfg: ReplicaConfig, rid: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 on_spill: Optional[OnSpill] = None, kind: str = "fn"):
        self.rid = next(Transport._ids) if rid is None else rid
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else null_registry()
        self.on_spill = on_spill
        self.kind = kind
        self.alive = False
        self.heartbeat_s = 0.0
        self.started_s = 0.0
        self.busy_s = 0.0
        self.processed = 0
        # tracing: live "transport.inflight" spans keyed by request rid
        # (offer -> ack/spill), and digests of flight-recorder dumps this
        # transport wrote to the artifact store on death
        self._inflight_spans: Dict[int, Any] = {}
        self.flight_dumps: List[str] = []
        # warm KV migration: the backend's drain-time export, published
        # by the replica driver just before the drained signal.  The
        # router reads this after drain() returns and ships it to the
        # drained sessions' new homes; None = nothing to migrate.
        self.kv_state: Any = None

    # -- control surface -------------------------------------------------
    def start(self) -> "Transport":
        raise NotImplementedError

    def offer(self, req: ClusterRequest) -> bool:
        """Enqueue; False == backpressure (inbox full / replica down)."""
        raise NotImplementedError

    def outstanding_cost(self) -> int:
        raise NotImplementedError

    def inject_crash(self) -> None:
        raise NotImplementedError

    def drain(self, timeout: float = 10.0) -> None:
        raise NotImplementedError

    def join(self, timeout: float = 10.0) -> None:
        raise NotImplementedError

    # -- health / telemetry ----------------------------------------------
    def healthy(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return self.alive and \
            now - self.heartbeat_s < self.cfg.heartbeat_timeout_s

    def busy_fraction(self) -> float:
        wall = time.monotonic() - self.started_s
        return self.busy_s / wall if wall > 0 else 0.0

    def metrics_snapshot(self) -> Dict[str, float]:
        """Worker-side metrics.  Local replicas write into the shared
        registry directly, so their snapshot is empty; remote replicas
        return the last heartbeat's registry snapshot."""
        return {}

    def _record_crash(self, n_spilled: int) -> None:
        self.metrics.counter("replica.crashes").inc()
        self.metrics.counter("replica.spilled_requests").inc(n_spilled)

    # -- tracing helpers --------------------------------------------------
    def _span_inflight(self, req: ClusterRequest) -> None:
        """Open a transport.inflight span (offer -> ack/spill) when the
        request carries a trace context.  Callers hold ``self._lock`` —
        the tracer lock is a leaf, so nesting is safe."""
        if req.trace_ctx is None:
            return
        self._inflight_spans[req.rid] = current_tracer().span(
            "transport.inflight", parent=req.trace_ctx,
            replica=self.rid, transport=type(self).__name__,
            kind=self.kind)

    def _end_inflight(self, rid: int, **tags) -> None:
        sp = self._inflight_spans.pop(rid, None)
        if sp is not None:
            if tags:
                sp.tag(**tags)
            sp.end()

    def _dump_flight(self, reason: str,
                     worker_events: Sequence = ()) -> Optional[str]:
        """Postmortem: write the merged flight-recorder event log (parent
        ring + the worker increments mirrored off heartbeats) to the
        artifact store.  Must never raise — it runs on fault paths."""
        try:
            store = getattr(self, "artifacts", None) or default_flight_store()
            doc = {"rid": self.rid, "kind": self.kind, "reason": reason,
                   "wall": time.time(),
                   "parent_events": current_recorder().events(),
                   "worker_events": list(worker_events)}
            digest = store.put_bytes(
                json.dumps(doc, sort_keys=True, default=str).encode())
            self.flight_dumps.append(digest)
            self.metrics.counter("replica.flight_dumps").inc()
            return digest
        except Exception:               # noqa: BLE001 - telemetry must not
            return None                 # take down the fault path itself


# ----------------------------------------------------------------------
class LocalTransport(Transport):
    """The replica driver on a host thread with a ``queue.Queue`` inbox.

    The first replica of the cluster layer, ``ReplicaWorker`` (which
    remains as an alias): same offer/crash/drain races, same straggler
    handling.
    """

    def __init__(self, backend, cfg: ReplicaConfig = ReplicaConfig(),
                 rid: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 on_spill: Optional[OnSpill] = None, kind: str = "fn"):
        super().__init__(cfg, rid=rid, metrics=metrics, on_spill=on_spill,
                         kind=kind)
        self.backend = backend
        self.inbox: "queue.Queue[ClusterRequest]" = \
            queue.Queue(maxsize=cfg.inbox_capacity)
        self._lock = threading.Lock()
        self._outstanding_cost = 0
        self._crash = threading.Event()
        self._closing = threading.Event()
        self._brownout_level = 0
        self._hist = self.metrics.histogram("replica.batch_s")
        self._thread = threading.Thread(
            target=run_replica_loop, args=(backend, cfg, self),
            daemon=True, name=f"replica-{self.rid}")

    # -- control surface -------------------------------------------------
    def start(self) -> "LocalTransport":
        self.alive = True
        self.started_s = self.heartbeat_s = time.monotonic()
        self._thread.start()
        return self

    def offer(self, req: ClusterRequest) -> bool:
        if not self.alive or self._closing.is_set():
            return False
        try:
            self.inbox.put_nowait(req)
        except queue.Full:
            return False
        with self._lock:
            self._outstanding_cost += req.cost
            self._span_inflight(req)
        if not self.alive:
            # Raced with a concurrent crash: the dying thread may already
            # have drained the inbox, so reclaim whatever is left ourselves
            # and report failure — the caller re-dispatches elsewhere.
            leftovers: List[ClusterRequest] = []
            while True:
                try:
                    leftovers.append(self.inbox.get_nowait())
                except queue.Empty:
                    break
            with self._lock:
                self._outstanding_cost -= sum(r.cost for r in leftovers)
                for r in leftovers:
                    self._end_inflight(r.rid, aborted=True)
            others = [r for r in leftovers if r is not req]
            if others and self.on_spill is not None:
                self.on_spill(others, self)
            return False
        return True

    def outstanding_cost(self) -> int:
        with self._lock:
            return self._outstanding_cost

    def inject_crash(self) -> None:
        """Fault injection: the worker dies at its next loop checkpoint and
        spills all unacknowledged requests."""
        self._crash.set()

    def drain(self, timeout: float = 10.0) -> None:
        """Graceful: stop accepting, finish the inbox, exit."""
        self._closing.set()
        self._thread.join(timeout)

    def join(self, timeout: float = 10.0) -> None:
        self._thread.join(timeout)

    # -- driver inbox IO (run_replica_loop callbacks) --------------------
    def heartbeat(self) -> None:
        self.heartbeat_s = time.monotonic()

    def crash_requested(self) -> bool:
        return self._crash.is_set()

    def closing(self) -> bool:
        return self._closing.is_set()

    def get(self, timeout: float) -> ClusterRequest:
        return self.inbox.get(timeout=timeout)

    def get_nowait(self) -> ClusterRequest:
        return self.inbox.get_nowait()

    @staticmethod
    def payload(req: ClusterRequest) -> Any:
        return req.payload

    @staticmethod
    def trace_ctx(req: ClusterRequest) -> Any:
        """Same process: the driver reads the context straight off the
        request (remote transports rehydrate it from the wire frame)."""
        return req.trace_ctx

    @staticmethod
    def deadline(req: ClusterRequest) -> Any:
        """Same process, same monotonic clock: the absolute deadline is
        readable straight off the request (None when unbounded)."""
        dl = req.deadline_s
        return dl if dl != float("inf") else None

    @staticmethod
    def is_cancelled(req: ClusterRequest) -> bool:
        """Shared object: ``Router.cancel`` already flipped the flag."""
        return req.cancelled

    def cancel(self, rid: int) -> None:
        """No frame needed — cancellation travels through the shared
        ``ClusterRequest.cancelled`` flag the loop polls."""

    def brownout(self) -> int:
        return self._brownout_level

    def set_brownout(self, level: int) -> None:
        self._brownout_level = int(level)

    def begin(self, batch: List[ClusterRequest]) -> None:
        pass            # the driver hands the in-flight batch to spill()

    def publish_kv_state(self, state: Any) -> None:
        """Drain-time KV hand-off — same process, direct hand-over."""
        self.kv_state = state

    @staticmethod
    def emit(req: ClusterRequest, frame: Any) -> None:
        """Streaming: a partial-result frame for an in-flight request —
        same process, so it goes straight to the request."""
        req.emit_partial(frame)

    def ack(self, batch: List[ClusterRequest], results: List[Any],
            busy_s: float) -> None:
        self.busy_s += busy_s
        self._hist.observe(busy_s)
        done_cost = 0
        for r, res in zip(batch, results):
            with self._lock:
                self._end_inflight(r.rid)
            r.complete(res, self.rid)
            done_cost += r.cost
            self.processed += 1
        with self._lock:
            self._outstanding_cost -= done_cost

    def spill(self, batch: List[ClusterRequest], error: BaseException) -> None:
        """Crash path: mark dead, spill in-flight + inbox to the router."""
        self.alive = False
        spilled = list(batch)
        # Two drain passes with a grace gap: an `offer` that read `alive`
        # just before we flipped it may still land a request (offer's own
        # post-put check is the second line of defence).
        for _ in range(2):
            while True:
                try:
                    spilled.append(self.inbox.get_nowait())
                except queue.Empty:
                    break
            time.sleep(0.005)
        with self._lock:
            self._outstanding_cost = 0
            for r in spilled:
                self._end_inflight(r.rid, spilled=True)
        self._record_crash(len(spilled))
        current_recorder().record("replica_death", replica=self.rid,
                                  spilled=len(spilled), error=repr(error))
        if spilled:
            current_recorder().record("spill", replica=self.rid,
                                      rids=[r.rid for r in spilled])
        self._dump_flight(repr(error))
        if self.on_spill is not None:
            self.on_spill(spilled, self)
        else:
            for r in spilled:
                r.fail(error)

    def close(self) -> None:
        # Graceful exit: refuse new offers first, then finish any request
        # that raced into the inbox between the final empty poll and the
        # flip (offer's post-put aliveness re-check closes the rest of the
        # window by reclaiming and re-dispatching).
        self.alive = False
        time.sleep(self.cfg.poll_s)
        stragglers: List[ClusterRequest] = []
        while True:
            try:
                stragglers.append(self.inbox.get_nowait())
            except queue.Empty:
                break
        if stragglers:
            try:
                results = self.backend.process([r.payload for r in stragglers])
                for r, res in zip(stragglers, results):
                    r.complete(res, self.rid)
                    self.processed += 1
            except BaseException as e:
                if self.on_spill is not None:
                    self.on_spill(stragglers, self)
                else:
                    for r in stragglers:
                        r.fail(e)
        with self._lock:
            self._outstanding_cost = 0
            for rid in list(self._inflight_spans):
                self._end_inflight(rid)


# ----------------------------------------------------------------------
# Worker side, shared by the process and socket transports.

class WorkerIO:
    """Driver inbox IO inside a remote worker: work items are
    ``(rid, cost, payload, trace_ctx)`` tuples received over the channel;
    acks, heartbeats, metrics snapshots, trace spans and flight-recorder
    increments are shipped back.

    A dedicated reader thread pumps the channel into ``pending``
    continuously, so the parent's sends never back up behind a long
    ``backend.process`` call — ``offer()`` on the parent side stays
    non-blocking even when payloads exceed the OS transport buffer.

    With ``heartbeat_thread=True`` (socket workers) a second thread sends
    heartbeats on the wire every ``heartbeat_interval_s`` even while the
    replica loop is deep inside a long batch — the parent's only death
    signal is heartbeat staleness, so the worker must stay audibly alive
    through a minutes-long compile."""

    def __init__(self, chan: Channel, cfg: ReplicaConfig, rid: int,
                 registry: MetricsRegistry, heartbeat_thread: bool = False,
                 backlog: Optional[List[Any]] = None):
        self.chan = chan
        self.cfg = cfg
        self.rid = rid
        self.registry = registry
        self._hist = registry.histogram("replica.batch_s")
        self.pending: "queue.Queue[Tuple[int, int, Any, Any]]" = queue.Queue()
        self.cancelled: set = set()     # rids cancelled by the parent
        self._brownout = 0              # parent's current degradation level
        self._evt_seq = 0       # last flight-recorder seq shipped on a hb
        self.disconnected = False
        self.crashed = False
        self._crash = False
        self._closing = False
        self._last_hb = 0.0
        self.processed = 0
        self.busy_s = 0.0
        self._stop_hb = threading.Event()
        # frames read off the channel before this IO existed (e.g. control
        # frames that arrived while the artifact fetch loop owned the
        # connection) are replayed first, in arrival order
        for msg in (backlog or []):
            self._ingest(msg)
        self._reader = threading.Thread(target=self._pump_loop, daemon=True,
                                        name=f"replica-{rid}-pump")
        self._reader.start()
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat_thread:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True, name=f"replica-{rid}-hb")
            self._hb_thread.start()

    def _send(self, msg: Any, pickle_only: bool = False) -> None:
        try:
            self.chan.send(msg, pickle_only)
        except ChannelClosed:
            self._on_lost()

    def _on_lost(self) -> None:
        """The parent is unreachable: wind down.  Everything still queued
        here is parent-owned state the parent has already spilled, so drop
        it rather than burning compute on work that was re-dispatched."""
        self.disconnected = True
        self._closing = True
        while True:
            try:
                self.pending.get_nowait()
            except queue.Empty:
                break

    def _ingest(self, msg) -> None:
        tag = msg[0]
        if tag == "req":
            # trailing elements are optional: trace context, then
            # the deadline *budget* in seconds (older parents send 4- or
            # 5-element frames; tolerate all).  The budget is relative —
            # time.monotonic() does not cross hosts — and pinned to this
            # worker's clock at ingest.
            tctx = TraceContext.from_wire(msg[4]) if len(msg) > 4 else None
            budget = msg[5] if len(msg) > 5 else None
            deadline = time.monotonic() + budget if budget is not None \
                else None
            self.pending.put((msg[1], msg[2], msg[3], tctx, deadline))
        elif tag == "cancel":
            # monotonic rid space, never reused: a cancel can never name
            # future work, so a plain grow-only set is race-free
            self.cancelled.add(msg[1])
        elif tag == "brownout":
            self._brownout = int(msg[1])
        elif tag == "drain":
            self._closing = True
        elif tag == "crash":
            self._crash = True

    def _pump_loop(self) -> None:
        """Reader thread: keep the parent->worker channel drained."""
        while not self.disconnected:
            try:
                msg = self.chan.recv(0.05)
            except ChannelClosed:
                self._on_lost()
                return
            if msg is None:
                continue
            self._ingest(msg)

    def _hb_frame(self) -> tuple:
        """Heartbeat payload: liveness + metrics snapshot + the tracer's
        finished spans + flight-recorder increments since the last ship.
        Telemetry on heartbeats is best-effort by design — a frame lost to
        a dropped connection costs spans, never correctness."""
        spans = current_tracer().drain()
        events = current_recorder().since(self._evt_seq)
        if events:
            self._evt_seq = events[-1]["seq"]
        return ("hb", self.processed, self.busy_s,
                self.registry.snapshot(), spans, events)

    def _hb_loop(self) -> None:
        while not self._stop_hb.wait(self.cfg.heartbeat_interval_s):
            if self.disconnected:
                return
            self._last_hb = time.monotonic()
            self._send(self._hb_frame())

    def send_ready(self) -> None:
        self._send(("ready",))

    def stop(self) -> None:
        self._stop_hb.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)

    # -- driver callbacks ------------------------------------------------
    def heartbeat(self) -> None:
        now = time.monotonic()
        if now - self._last_hb >= self.cfg.heartbeat_interval_s:
            self._last_hb = now
            self._send(self._hb_frame())

    def crash_requested(self) -> bool:
        return self._crash

    def closing(self) -> bool:
        return self._closing

    def get(self, timeout: float):
        return self.pending.get(timeout=timeout)

    def get_nowait(self):
        return self.pending.get_nowait()

    @staticmethod
    def payload(item) -> Any:
        return item[2]

    @staticmethod
    def trace_ctx(item) -> Any:
        """The rehydrated :class:`TraceContext` riding the work item."""
        return item[3] if len(item) > 3 else None

    @staticmethod
    def deadline(item) -> Any:
        """Absolute worker-clock deadline riding the item (or None)."""
        return item[4] if len(item) > 4 else None

    def is_cancelled(self, item) -> bool:
        return item[0] in self.cancelled

    def brownout(self) -> int:
        return self._brownout

    def begin(self, batch) -> None:
        pass                            # the parent tracks in-flight state

    def emit(self, item, frame) -> None:
        """Streaming: ship a partial-result frame for in-flight item
        ``(rid, cost, payload, tctx)``; the parent routes it to the
        request's ``on_partial``.  Best-effort — a lost frame only
        degrades streaming granularity, the ack still carries the full
        result."""
        self._send(("partial", item[0], frame), pickle_only=True)

    def ack(self, batch, results, busy_s: float) -> None:
        self.busy_s += busy_s
        self.processed += len(batch)
        self._hist.observe(busy_s)
        self._send(("ack", [(item[0], res)
                            for item, res in zip(batch, results)], busy_s),
                   pickle_only=True)    # results must round-trip type-exact

    def spill(self, batch, error: BaseException) -> None:
        # The parent owns every unacknowledged request; telling it why we
        # died is all that is needed — it spills from its own table.  The
        # dying breath also carries the final spans + flight events: the
        # heartbeat that would have shipped them will never fire.
        self.crashed = True
        events = current_recorder().since(self._evt_seq)
        if events:
            self._evt_seq = events[-1]["seq"]
        self._send(("dead", repr(error), current_tracer().drain(), events))

    def publish_kv_state(self, state: Any) -> None:
        """Drain-time KV hand-off: ship the backend's export on the wire.
        Sent before close()'s ("drained",) frame, so FIFO ordering
        guarantees the parent stores it before drain() returns."""
        self._send(("kv_state", state), pickle_only=True)

    def close(self) -> None:
        if self.disconnected:
            return                      # the parent already spilled our work
        # FIFO channel order guarantees every request sent before the drain
        # control message has already been pumped into `pending`, and the
        # driver only reaches here once `pending` is empty.
        self._send(self._hb_frame())
        self._send(("drained",))


def _worker_entry(conn, spec: BackendSpec, cfg: ReplicaConfig,
                  rid: int) -> None:
    """Entry point of a spawned pipe-replica worker process."""
    from repro_torch.cluster.metrics import set_worker_registry
    registry = MetricsRegistry()
    set_worker_registry(registry)   # builders adopt the heartbeat registry
    # follower-mode tracer: sample_rate=0 means the worker never roots a
    # trace of its own, but spans parented on an incoming (sampled)
    # TraceContext always record — the parent's sampling decision rules
    set_tracer(Tracer(enabled=True, sample_rate=0.0, replica=str(rid)))
    set_recorder(FlightRecorder(replica=str(rid)))
    io = WorkerIO(PipeChannel(conn), cfg, rid, registry)
    try:
        backend = spec.build()
    except BaseException as e:          # noqa: BLE001 - report, don't raise
        io.spill([], e)
        return
    io.send_ready()
    run_replica_loop(backend, cfg, io)


# ----------------------------------------------------------------------
class RemoteTransport(Transport):
    """Parent-side half shared by :class:`ProcessTransport` and
    :class:`SocketTransport`.

    Owns the table of unacknowledged requests — the worker only ever sees
    ``(rid, cost, payload)`` triples — plus the ack/heartbeat/fetch frame
    dispatch and the die/spill path.  Subclasses supply the carrier
    (pipe/TCP), death detection (process liveness/heartbeat timeout) and
    carrier teardown.
    """

    def __init__(self, spec: BackendSpec, cfg: ReplicaConfig = ReplicaConfig(),
                 rid: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 on_spill: Optional[OnSpill] = None,
                 kind: Optional[str] = None):
        super().__init__(cfg, rid=rid, metrics=metrics, on_spill=on_spill,
                         kind=kind if kind is not None else spec.kind)
        self.spec = spec
        self._lock = threading.Lock()
        self._chan: Optional[Channel] = None
        self._outstanding: Dict[int, ClusterRequest] = {}
        self._dispatch_t: Dict[int, float] = {}   # rid -> offer() time
        self._outstanding_cost = 0
        self._closing = threading.Event()
        self._ready = threading.Event()
        self._drained = threading.Event()
        self._worker_snapshot: Dict[str, float] = {}
        # mirror of the worker's flight-recorder events (shipped as
        # heartbeat increments) so a postmortem dump has the worker's
        # side of the story even after the worker process is gone
        self._flight_mirror: deque = deque(maxlen=1024)
        # fault injection: inbound "hb" frames are dropped (one-way
        # partition) until this monotonic deadline
        self._hb_drop_until = 0.0

    # -- control surface -------------------------------------------------
    def offer(self, req: ClusterRequest) -> bool:
        if not self.alive or self._closing.is_set():
            return False
        try:
            # serialize before registering: payloads must round-trip
            # type-exact (tuples stay tuples), and an unpicklable payload
            # must neither kill the replica nor leak an outstanding entry —
            # refusing here lets the router shed it explicitly
            tctx = req.trace_ctx
            # deadline rides as a *relative* budget (monotonic clocks do
            # not cross hosts); workers that predate it ignore the extra
            # element, exactly like the trace-context rollout
            budget = req.deadline_s - time.monotonic() \
                if req.deadline_s != float("inf") else None
            frame = encode_frame(
                ("req", req.rid, req.cost, req.payload,
                 tctx.to_wire() if tctx is not None else None, budget),
                pickle_only=True)
        except Exception:               # noqa: BLE001 - unserializable
            return False
        with self._lock:
            chan = self._chan
            if not self.alive or chan is None or \
                    len(self._outstanding) >= self.cfg.inbox_capacity:
                return False
            self._outstanding[req.rid] = req
            self._dispatch_t[req.rid] = time.monotonic()
            self._outstanding_cost += req.cost
            self._span_inflight(req)
        try:
            chan.send_bytes(frame)
        except ChannelClosed:
            with self._lock:
                owned = self._outstanding.pop(req.rid, None) is not None
                self._dispatch_t.pop(req.rid, None)
                if owned:
                    self._outstanding_cost -= req.cost
                    self._end_inflight(req.rid, aborted=True)
            self._channel_broken(chan, "send failed")
            # if the fault path already took the request it is being
            # requeued over there — claim success so the caller does not
            # dispatch a second copy
            return not owned
        if not self.alive or self._chan is not chan:
            # Raced with a concurrent death/disconnect.  If the spill
            # already took this request, the fault path owns it (it is
            # being requeued); otherwise reclaim it and report failure.
            with self._lock:
                if self._outstanding.pop(req.rid, None) is not None:
                    self._dispatch_t.pop(req.rid, None)
                    self._outstanding_cost -= req.cost
                    self._end_inflight(req.rid, aborted=True)
                    return False
        return True

    def outstanding_cost(self) -> int:
        with self._lock:
            return self._outstanding_cost

    def cancel(self, rid: int) -> None:
        """Best-effort ``("cancel", rid)`` control frame.  Safe to send
        for rids this worker never saw (the worker's cancelled-set is
        keyed by globally-unique rids) and safe to lose (the parent-side
        terminal state already refuses late acks and re-dispatch)."""
        chan = self._chan
        if chan is None or not self.alive:
            return
        try:
            chan.send(("cancel", rid))
        except ChannelClosed:
            pass                        # dying replica: spill handles it

    def set_brownout(self, level: int) -> None:
        """Ship the router's degradation level; old workers drop the
        unknown frame on the floor (graceful non-degradation)."""
        chan = self._chan
        if chan is None or not self.alive:
            return
        try:
            chan.send(("brownout", int(level)))
        except ChannelClosed:
            pass

    def drain(self, timeout: float = 10.0) -> None:
        self._closing.set()
        chan = self._chan
        if chan is not None:
            try:
                chan.send(("drain",))
            except ChannelClosed:
                pass
        self._drained.wait(timeout)
        self.join(timeout)

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        return self._ready.wait(
            self.cfg.spawn_timeout_s if timeout is None else timeout)

    def metrics_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._worker_snapshot)

    def _await_ready(self) -> None:
        if not self._ready.wait(self.cfg.spawn_timeout_s):
            err = ReplicaCrash(
                f"replica {self.rid}: worker not ready within "
                f"{self.cfg.spawn_timeout_s}s")
            self._die(err)
            raise err
        if not self.alive:              # died during startup (build failed)
            raise ReplicaCrash(
                f"replica {self.rid}: worker died during startup")

    # -- receive path ----------------------------------------------------
    def _recv_loop(self, chan: Channel) -> None:
        while True:
            if not self.alive or self._chan is not chan:
                return
            try:
                msg = chan.recv(0.05)
            except ChannelClosed:
                self._channel_broken(chan, "connection lost")
                return
            if msg is None:
                if not self._idle_tick(chan):
                    return
                continue
            if not self._handle(chan, msg):
                return

    def _handle(self, chan: Channel, msg) -> bool:
        tag = msg[0]
        if tag == "hb" and time.monotonic() < self._hb_drop_until:
            # injected one-way partition: the worker's heartbeats vanish
            # on the way in (acks and data frames still flow, so the
            # zero-lost invariants hold); a worker that sends nothing
            # else goes heartbeat-stale and dies exactly like a real
            # asymmetric partition would make it
            self.metrics.counter("replica.hb_dropped").inc()
            return True
        self.heartbeat_s = time.monotonic()
        if tag == "ack":
            self.busy_s += msg[2]
            for rid, res in msg[1]:
                with self._lock:
                    req = self._outstanding.pop(rid, None)
                    self._dispatch_t.pop(rid, None)
                    if req is not None:
                        self._outstanding_cost -= req.cost
                        self._end_inflight(rid)
                if req is not None:
                    req.complete(res, self.rid)
                    self.processed += 1
        elif tag == "hb":
            with self._lock:
                self._worker_snapshot = dict(msg[3])
            self._ingest_telemetry(
                msg[4] if len(msg) > 4 else None,
                msg[5] if len(msg) > 5 else None)
            # the stall check cannot live only on recv timeouts: a worker
            # heartbeating faster than the recv poll would keep the channel
            # busy enough that _idle_tick never fires — the exact loris
            # this guard exists to catch
            return not self._check_ack_stall()
        elif tag == "partial":
            # streaming frame for an in-flight request; don't pop — the
            # ack is still the completion signal (late frames after a
            # spill hit an empty table and drop harmlessly)
            with self._lock:
                req = self._outstanding.get(msg[1])
            if req is not None:
                req.emit_partial(msg[2])
        elif tag == "ready":
            self._ready.set()
        elif tag == "kv_state":
            # the drained worker's KV export; FIFO framing puts it ahead
            # of ("drained",), so it is in place before drain() returns
            self.kv_state = msg[1]
        elif tag == "drained":
            self._drained.set()
        elif tag == "dead":
            # the dying breath carries the worker's final spans + flight
            # events (the next heartbeat would have, but never fires)
            self._ingest_telemetry(
                msg[2] if len(msg) > 2 else None,
                msg[3] if len(msg) > 3 else None)
            self._die(ReplicaCrash(
                f"replica {self.rid}: worker died: {msg[1]}"))
            return False
        else:
            return self._handle_extra(chan, msg)
        return True

    def _ingest_telemetry(self, spans, events) -> None:
        """Adopt worker-shipped spans into the parent tracer and mirror
        worker flight events (for the postmortem dump)."""
        if spans:
            current_tracer().ingest(spans, replica=self.rid)
        if events:
            with self._lock:
                self._flight_mirror.extend(
                    e for e in events if isinstance(e, dict))

    def inject_hb_partition(self, duration_s: float) -> None:
        """Fault injection: a one-way network partition — inbound
        heartbeats are dropped for ``duration_s`` while every other frame
        (acks, partials) still flows.  An idle worker goes
        heartbeat-stale and dies with a spill; a busy worker survives on
        its data frames, exactly like a real asymmetric partition."""
        self._hb_drop_until = time.monotonic() + float(duration_s)
        self.metrics.counter("replica.hb_partitions").inc()
        current_recorder().record("partition", replica=self.rid,
                                  direction="worker->parent",
                                  duration_s=float(duration_s))

    def _handle_extra(self, chan: Channel, msg) -> bool:
        return True

    def _idle_tick(self, chan: Channel) -> bool:
        """Called on every recv timeout; False stops the loop."""
        return not self._check_ack_stall()

    def _check_ack_stall(self) -> bool:
        """Slow-loris detector: the replica looks alive (its carrier-level
        liveness signal is green) but its oldest dispatched request has
        gone unacknowledged past ``cfg.ack_timeout_s``.  Declares the
        transport dead — spilling every unacknowledged request for
        redispatch on survivors — and returns True.  Late acks from the
        zombie worker pop an empty outstanding table, so nothing is ever
        double-completed."""
        if self.cfg.ack_timeout_s <= 0:
            return False
        now = time.monotonic()
        with self._lock:
            if not self.alive or not self._outstanding:
                return False
            oldest = min(self._dispatch_t.get(rid, now)
                         for rid in self._outstanding)
        age = now - oldest
        if age <= self.cfg.ack_timeout_s:
            return False
        self.metrics.counter("replica.ack_timeouts").inc()
        self._die(ReplicaCrash(
            f"replica {self.rid}: ack timeout — oldest request "
            f"unacknowledged for {age:.2f}s > {self.cfg.ack_timeout_s}s "
            f"while the worker still looked alive (slow loris)"))
        return True

    def _channel_broken(self, chan: Channel, why: str) -> None:
        raise NotImplementedError

    # -- death / teardown ------------------------------------------------
    def _take_outstanding(self) -> List[ClusterRequest]:
        spilled = sorted(self._outstanding.values(), key=lambda r: r.rid)
        self._outstanding.clear()
        self._dispatch_t.clear()
        self._outstanding_cost = 0
        for rid in list(self._inflight_spans):
            self._end_inflight(rid, spilled=True)
        return spilled

    def _die(self, error: BaseException) -> None:
        with self._lock:
            if not self.alive:
                return
            self.alive = False
            spilled = self._take_outstanding()
            chan, self._chan = self._chan, None
        self._ready.set()               # unblock any start()/wait_ready()
        self._drained.set()
        self._kill_carrier(chan)
        self._record_crash(len(spilled))
        current_recorder().record("replica_death", replica=self.rid,
                                  spilled=len(spilled), error=repr(error))
        if spilled:
            # the spilled batch must be IN the dump (the router's
            # per-request respill events fire after it is written)
            current_recorder().record("spill", replica=self.rid,
                                      rids=[r.rid for r in spilled])
        with self._lock:
            mirror = list(self._flight_mirror)
        self._dump_flight(repr(error), worker_events=mirror)
        self._spill_out(spilled, error)

    def _drain_clean(self) -> None:
        with self._lock:
            self.alive = False
            leftovers = self._take_outstanding()
            chan, self._chan = self._chan, None
        if chan is not None:
            chan.close()
        # a clean drain should leave nothing behind; spill defensively
        if leftovers:
            self._spill_out(leftovers, ReplicaCrash(
                f"replica {self.rid}: drained with leftovers"))

    def _kill_carrier(self, chan: Optional[Channel]) -> None:
        if chan is not None:
            chan.close()

    def _spill_out(self, spilled: List[ClusterRequest],
                   error: BaseException) -> None:
        if self.on_spill is not None:
            # called even when nothing spilled: the router uses the empty
            # spill as the death notification (pool removal, session-remap
            # export) for workers that died idle
            self.on_spill(spilled, self)
        else:
            for r in spilled:
                r.fail(error)


# ----------------------------------------------------------------------
class ProcessTransport(RemoteTransport):
    """A replica in its own worker process behind an RPC inbox.

    If the process dies — a backend exception, an injected ``SIGKILL``, an
    OOM kill — the pipe breaks, the receiver notices within one poll
    interval, and every unacknowledged request spills to ``on_spill``: the
    same zero-lost contract as the thread transport, now robust to
    interpreter death.
    """

    def __init__(self, spec: BackendSpec, cfg: ReplicaConfig = ReplicaConfig(),
                 rid: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 on_spill: Optional[OnSpill] = None,
                 kind: Optional[str] = None, start_method: str = "spawn"):
        super().__init__(spec, cfg, rid=rid, metrics=metrics,
                         on_spill=on_spill, kind=kind)
        self._ctx = mp.get_context(start_method)
        self._conn, self._child_conn = self._ctx.Pipe(duplex=True)
        self._proc = None
        self._recv_thread: Optional[threading.Thread] = None

    # -- control surface -------------------------------------------------
    def start(self, wait_ready: bool = True) -> "ProcessTransport":
        self._proc = self._ctx.Process(
            target=_worker_entry,
            args=(self._child_conn, self.spec, self.cfg, self.rid),
            daemon=True, name=f"replica-{self.rid}")
        self._proc.start()
        self._child_conn.close()        # the child holds its own handle now
        self.alive = True
        self.started_s = self.heartbeat_s = time.monotonic()
        self._chan = PipeChannel(self._conn)
        self._recv_thread = threading.Thread(
            target=self._recv_loop, args=(self._chan,), daemon=True,
            name=f"replica-{self.rid}-recv")
        self._recv_thread.start()
        if wait_ready:
            self._await_ready()
        return self

    def inject_crash(self, soft: bool = False) -> None:
        """Fault injection.  Hard (default) == real process death: SIGKILL
        the worker; the receiver detects the broken pipe and spills every
        unacknowledged request, exactly as an OOM-killed production worker
        would.  Soft sends a ``("crash",)`` control frame instead: the
        worker raises at its next loop checkpoint (crash-*before*-ack if a
        batch is in flight) and reports back over the pipe."""
        if self._proc is None or not self._proc.is_alive():
            self._die(ReplicaCrash(f"replica {self.rid}: injected crash"))
            return
        if soft:
            chan = self._chan
            try:
                if chan is None:
                    raise ChannelClosed("no channel")
                chan.send(("crash",))
            except ChannelClosed:
                self._die(ReplicaCrash(
                    f"replica {self.rid}: pipe closed on soft crash"))
        else:
            self._proc.kill()

    def join(self, timeout: float = 10.0) -> None:
        if self._proc is not None:
            self._proc.join(timeout)
        if self._recv_thread is not None and \
                self._recv_thread is not threading.current_thread():
            self._recv_thread.join(timeout)

    # -- death detection: process liveness -------------------------------
    def _idle_tick(self, chan: Channel) -> bool:
        if self._proc is not None and not self._proc.is_alive():
            # exited without a frame on the wire (e.g. killed between
            # messages, or a clean post-drain exit)
            self._channel_broken(chan, "worker exited")
            return False
        return super()._idle_tick(chan)

    def _channel_broken(self, chan: Channel, why: str) -> None:
        if self._closing.is_set() and self._drained.is_set():
            self._drain_clean()
        else:
            self._die(ReplicaCrash(
                f"replica {self.rid}: worker process died ({why})"))

    def _kill_carrier(self, chan: Optional[Channel]) -> None:
        super()._kill_carrier(chan)
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()


# ----------------------------------------------------------------------
class SocketTransport(RemoteTransport):
    """A replica on the far side of a framed TCP connection.

    The worker dials the parent's :class:`~repro_torch.cluster.wire.
    WorkerListener` and opens with a versioned hello (token, kind, spec
    fingerprint); the parent answers ``("welcome", rid, spec, cfg)`` and
    the worker builds its backend from the shipped spec, pulling any
    ``artifact:<sha256>`` weights reference from the parent's
    :class:`~repro_torch.cluster.artifacts.ArtifactStore` over the same
    connection.  By default ``start()`` also spawns a local
    ``worker_main`` process that dials back over loopback, so the socket
    path is exercised end-to-end on one host; with ``spawn=False`` the
    parent only listens, and the operator runs
    ``python -m repro_torch.cluster.worker_main --connect HOST:PORT --token T``
    on any machine.

    Failure model (vs. :class:`ProcessTransport`): the parent cannot see
    the worker's process, so

      * a *dropped connection* (RST, severed cable, SIGKILL'd worker)
        spills every unacknowledged request immediately — zero lost — but
        leaves the transport in the pool for a reconnect window;
      * a worker that reconnects within ``heartbeat_timeout_s`` (same
        token, same spec fingerprint) resumes service on the same rid, so
        session-affinity placement is undisturbed;
      * *heartbeat staleness* past ``heartbeat_timeout_s`` — never process
        liveness — declares the transport dead.
    """

    def __init__(self, spec: BackendSpec, cfg: ReplicaConfig = ReplicaConfig(),
                 rid: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 on_spill: Optional[OnSpill] = None,
                 kind: Optional[str] = None,
                 listener: Optional[WorkerListener] = None,
                 spawn: bool = True, token: Optional[str] = None,
                 artifacts: Optional[ArtifactStore] = None,
                 start_method: str = "spawn"):
        super().__init__(spec, cfg, rid=rid, metrics=metrics,
                         on_spill=on_spill, kind=kind)
        self.listener = listener if listener is not None \
            else default_listener()
        self.token = token if token is not None \
            else f"w{self.rid}-{uuid.uuid4().hex[:10]}"
        self.spawn = spawn
        self.artifacts = artifacts
        self._spec_hash = spec_fingerprint(spec)
        self._ctx = mp.get_context(start_method)
        self._proc = None
        self._recv_threads: List[threading.Thread] = []
        self._monitor: Optional[threading.Thread] = None
        self._ever_connected = False

    # -- control surface -------------------------------------------------
    def start(self, wait_ready: bool = True) -> "SocketTransport":
        self.alive = True
        self.started_s = self.heartbeat_s = time.monotonic()
        self.listener.register(self.token, self._adopt)
        if self.spawn:
            from repro_torch.cluster import worker_main
            self._proc = self._ctx.Process(
                target=worker_main.run_worker,
                args=(tuple(self.listener.address), self.token),
                daemon=True, name=f"replica-{self.rid}-sock")
            self._proc.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name=f"replica-{self.rid}-monitor")
        self._monitor.start()
        if wait_ready:
            self._await_ready()
        return self

    def inject_crash(self, soft: bool = False) -> None:
        """Hard (default): SIGKILL the spawned worker — the connection
        drops, unacknowledged requests spill at once, and the heartbeat
        monitor declares the transport dead when no reconnect arrives.
        For a non-spawned (remote) worker there is no process to kill, so
        hard crash degrades to immediate transport death.  Soft asks the
        worker to raise at its next loop checkpoint, as on a pipe."""
        if soft:
            chan = self._chan
            if chan is not None:
                try:
                    chan.send(("crash",))
                    return
                except ChannelClosed:
                    pass
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()
            if not soft:
                return              # disconnect spill + hb timeout follow
        self._die(ReplicaCrash(f"replica {self.rid}: injected crash"))

    def sever_connection(self) -> None:
        """Fault injection: cut the TCP connection without touching the
        worker — a network partition.  Unacknowledged requests spill
        immediately; the worker notices EOF and re-runs the handshake."""
        chan = self._chan
        if chan is not None:
            current_recorder().record("partition", replica=self.rid,
                                      direction="both", cause="sever")
            chan.close()            # recv loops on both sides see EOF

    def connected(self) -> bool:
        return self._chan is not None

    def drain(self, timeout: float = 10.0) -> None:
        self._closing.set()
        chan = self._chan
        if chan is not None:
            try:
                chan.send(("drain",))
            except ChannelClosed:
                pass
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            if self._drained.wait(0.05):
                break
            if not self.alive:
                break
            if self._chan is None:
                break               # disconnected mid-drain: nothing to wait
        if self.alive and not self._drained.is_set():
            self._retire()          # worker unreachable; close the slot
        self.join(min(timeout, 5.0))

    def _retire(self) -> None:
        """Take the transport out of service without the crash metric —
        used when a drain cannot complete because no worker is connected
        (its outstanding table is already empty in that case)."""
        with self._lock:
            if not self.alive:
                return
            self.alive = False
            spilled = self._take_outstanding()
            chan, self._chan = self._chan, None
        self._ready.set()
        self._drained.set()
        self._kill_carrier(chan)
        if spilled:
            self._record_crash(len(spilled))
            self._spill_out(spilled, ReplicaCrash(
                f"replica {self.rid}: retired with outstanding requests"))

    def join(self, timeout: float = 10.0) -> None:
        if self._proc is not None:
            self._proc.join(timeout)
        me = threading.current_thread()
        for t in list(self._recv_threads):
            if t is not me:
                t.join(timeout)

    # -- handshake (listener callback) -----------------------------------
    def _adopt(self, chan: Channel, hello: tuple) -> None:
        """Version was already checked by the listener; this half verifies
        the spec fingerprint and swaps the live channel (first contact and
        reconnect are the same path)."""
        _tag, _ver, _token, _w_kind, w_hash = hello[:5]
        if not self.alive:
            try:
                chan.send(("reject", f"replica {self.rid} is dead"))
            except ChannelClosed:
                pass
            chan.close()
            return
        if w_hash is not None and w_hash != self._spec_hash:
            # a stale worker (old deployment / different weights) must be
            # refused at the door, not allowed to serve wrong results
            # (count first: the peer acts on the reject the moment it lands)
            self.metrics.counter("replica.handshake_rejects").inc()
            try:
                chan.send(("reject", "backend spec fingerprint mismatch"))
            except ChannelClosed:
                pass
            chan.close()
            return
        # welcome must hit the wire BEFORE the channel is published: once
        # self._chan is set, a concurrent offer() may send ("req", ...)
        # frames, and the worker treats anything-but-welcome as a reject
        try:
            chan.send(("welcome", self.rid, self.spec, self.cfg),
                      pickle_only=True)
            if self._closing.is_set():
                chan.send(("drain",))   # drain started while disconnected
        except ChannelClosed:
            chan.close()
            return                      # worker will redial (or is gone)
        with self._lock:
            if not self.alive:
                chan.close()
                return
            old, self._chan = self._chan, chan
            # the worker may redial before *we* notice the old connection
            # died (NAT drop, racing poll): anything still outstanding was
            # sent down the old pipe and the new incarnation never saw it,
            # so it must spill now — the stale recv loop will see the swap
            # and stand down without spilling
            stale = self._take_outstanding() if old is not None else []
        if old is not None:
            old.close()
        reconnect = self._ever_connected
        self._ever_connected = True
        self.heartbeat_s = time.monotonic()
        if reconnect:
            self.metrics.counter("replica.reconnects").inc()
            current_recorder().record("reconnect", replica=self.rid,
                                      stale_spilled=len(stale))
        if stale:
            self.metrics.counter("replica.disconnect_spills").inc(len(stale))
            self._spill_out(stale, ReplicaCrash(
                f"replica {self.rid}: reconnect superseded the previous "
                f"connection"))
        t = threading.Thread(target=self._recv_loop, args=(chan,),
                             daemon=True, name=f"replica-{self.rid}-recv")
        # prune loops whose channels are gone: a flaky link reconnecting
        # for days must not accumulate dead Thread objects
        self._recv_threads = [r for r in self._recv_threads if r.is_alive()]
        self._recv_threads.append(t)
        t.start()

    # -- death detection: heartbeat timeout ------------------------------
    def _monitor_loop(self) -> None:
        period = min(0.05, self.cfg.heartbeat_timeout_s / 4)
        while self.alive:
            time.sleep(period)
            if not self.alive:
                return
            if not self._ready.is_set():
                continue            # startup is governed by spawn_timeout_s
            stale = time.monotonic() - self.heartbeat_s
            if stale > self.cfg.heartbeat_timeout_s:
                self._die(ReplicaCrash(
                    f"replica {self.rid}: heartbeat timeout "
                    f"({stale:.2f}s > {self.cfg.heartbeat_timeout_s}s)"))
                return

    def _channel_broken(self, chan: Channel, why: str) -> None:
        with self._lock:
            if self._chan is not chan:
                return              # stale loop; a newer channel took over
            self._chan = None
            spilled = self._take_outstanding()
        chan.close()
        if self._closing.is_set() and self._drained.is_set():
            self.alive = False
            self.listener.unregister(self.token)
            if spilled:             # clean drain leaves nothing; defensive
                self._spill_out(spilled, ReplicaCrash(
                    f"replica {self.rid}: drained with leftovers"))
            return
        # Mid-flight disconnect: the zero-lost contract pays out *now* —
        # every unacknowledged request spills for redispatch — but the
        # transport stays in the pool for the reconnect window (the
        # monitor declares death if no worker returns in time).
        self.metrics.counter("replica.disconnects").inc()
        current_recorder().record("disconnect", replica=self.rid,
                                  why=why, spilled=len(spilled))
        if spilled:
            self.metrics.counter("replica.disconnect_spills") \
                .inc(len(spilled))
            self._spill_out(spilled, ReplicaCrash(
                f"replica {self.rid}: connection lost ({why})"))

    #: one-frame fetch replies cap the shippable artifact (chunked
    #: transfer is a ROADMAP item); past this the reply is an explicit
    #: miss, not a dead recv thread
    MAX_ARTIFACT_BYTES = 1 << 30

    def _handle_extra(self, chan: Channel, msg) -> bool:
        if msg[0] == "fetch":
            # served off-thread: a gigabyte read + sendall on the recv
            # thread would starve heartbeat processing for the whole
            # transfer and let the monitor kill a healthy worker mid-fetch
            threading.Thread(target=self._serve_fetch, args=(chan, msg[1]),
                             daemon=True,
                             name=f"replica-{self.rid}-fetch").start()
        return True

    def _serve_fetch(self, chan: Channel, digest) -> None:
        data = None
        try:
            if self.artifacts is not None and self.artifacts.has(digest):
                path = self.artifacts.get_path(digest)
                if os.path.getsize(path) <= self.MAX_ARTIFACT_BYTES:
                    data = self.artifacts.read_bytes(digest)
        except (ValueError, OSError, KeyError):
            data = None         # malformed digest / store hiccup: a miss,
            # never an exception that would kill a transport thread
        try:
            chan.send(("artifact", digest, data))
        except ChannelClosed:
            pass                # the recv loop notices the break itself

    def _kill_carrier(self, chan: Optional[Channel]) -> None:
        self.listener.unregister(self.token)
        super()._kill_carrier(chan)
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()


# ----------------------------------------------------------------------
_default_listener: Optional[WorkerListener] = None
_default_listener_lock = threading.Lock()


def default_listener() -> WorkerListener:
    """Process-wide listener shared by socket transports that were not
    given one explicitly (lazily bound to an ephemeral loopback port)."""
    global _default_listener
    with _default_listener_lock:
        if _default_listener is None:
            _default_listener = WorkerListener()
        return _default_listener


def make_transport(transport: str, *, backend=None,
                   spec: Optional[BackendSpec] = None,
                   cfg: ReplicaConfig = ReplicaConfig(),
                   rid: Optional[int] = None,
                   metrics: Optional[MetricsRegistry] = None,
                   on_spill: Optional[OnSpill] = None,
                   kind: Optional[str] = None,
                   listener: Optional[WorkerListener] = None,
                   artifacts: Optional[ArtifactStore] = None,
                   spawn: bool = True,
                   token: Optional[str] = None) -> Transport:
    """Build (but do not start) a transport.

    ``thread`` accepts a live backend object or a spec (built in-process);
    ``process`` and ``socket`` require a :class:`BackendSpec` — live
    backends cannot cross a process or host boundary.
    """
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r} not in {TRANSPORTS}")
    if transport == "process":
        if spec is None:
            raise ValueError("ProcessTransport needs a BackendSpec "
                             "(a live backend cannot cross the process "
                             "boundary)")
        return ProcessTransport(spec, cfg, rid=rid, metrics=metrics,
                                on_spill=on_spill, kind=kind)
    if transport == "socket":
        if spec is None:
            raise ValueError("SocketTransport needs a BackendSpec "
                             "(a live backend cannot cross the host "
                             "boundary)")
        return SocketTransport(spec, cfg, rid=rid, metrics=metrics,
                               on_spill=on_spill, kind=kind,
                               listener=listener, artifacts=artifacts,
                               spawn=spawn, token=token)
    if backend is None:
        if spec is None:
            raise ValueError("LocalTransport needs a backend or a spec")
        backend = spec.build()
    resolved_kind = kind if kind is not None else \
        (spec.kind if spec is not None
         else getattr(backend, "kind", "fn") or "fn")
    return LocalTransport(backend, cfg, rid=rid, metrics=metrics,
                          on_spill=on_spill, kind=resolved_kind)


# Back-compat: the thread replica by its old name.
ReplicaWorker = LocalTransport
