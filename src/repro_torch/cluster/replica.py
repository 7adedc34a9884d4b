"""Replica requests, backends, and the transport-agnostic worker driver,
copied from ``repro.cluster.replica``.

The cluster's unit of scale — the paper's "worker node" — is a *replica*:
one backend (LM engine, SVM stream runtime, or any batched step function)
behind a bounded inbox.  A replica:

  * pulls up to ``max_batch`` requests from its inbox and runs them through
    the backend as one batch (the mapPartitions amortization);
  * reports liveness via a heartbeat timestamp and a busy fraction;
  * on a crash (injected fault or backend exception) *spills* every
    unacknowledged request — the batch that was in flight plus the whole
    inbox — so the router can requeue them on survivors.  Semantics are
    at-least-once (a crash between backend completion and acknowledgement
    reprocesses the batch elsewhere), which is the Spark
    lineage-recomputation contract; zero requests are lost.

*Where* the replica runs is a transport concern (``cluster/transport.py``):
``LocalTransport`` runs this driver on a host thread over a ``queue.Queue``
inbox; ``ProcessTransport`` runs the same driver inside a spawned worker
process over an RPC inbox fed by a pipe.  The loop itself —
:func:`run_replica_loop` — is shared, so batching, crash-before-ack, and
graceful-drain semantics are identical on both sides of the process
boundary.

Every result a backend hands the driver is a host object (Python ints,
numpy arrays), never a CUDA tensor: the port's engine emits Python ints
and its stream runtime returns numpy, so a result pickles across a pipe
or socket without touching the card.

The port's paged engine has the JAX engine's KV lifecycle, so a replica
of it behaves as a JAX replica does:

  * brownout L1 turns speculative decode off through
    :meth:`EngineBackend.set_brownout` (the engine's ``speculative``
    attribute), and a lower level turns it back on;
  * on a graceful drain :func:`run_replica_loop` exports the engine's
    published KV blocks (``Engine.export_kv_state``), and the router ships
    them to the drained sessions' new homes as ``KV_IMPORT_TAG`` payloads,
    so ``Router.remove_replica(..., migrate=True)`` moves sessions warm.
"""
from __future__ import annotations

import dataclasses
import enum
import queue
import threading
import time
from typing import Any, Callable, List, Optional

from repro_torch.cluster.admission import Rejected
from repro_torch.cluster.tracing import current_recorder, current_tracer


class Status(enum.Enum):
    PENDING = "pending"
    OK = "ok"
    REJECTED = "rejected"       # shed by admission control -> Rejected result
    FAILED = "failed"           # retries exhausted / no survivors / shutdown
    CANCELLED = "cancelled"     # Router.cancel() -> work dropped everywhere
    EXPIRED = "expired"         # deadline passed before a useful completion


class Terminal:
    """Picklable terminal-result wrapper a replica acks for work it ended
    early instead of running to completion: deadline expiry (dropped from
    the worker queue, or finished mid-decode by the engine) and
    cancellation.  ``tokens`` carries whatever partial output existed at
    the cut, so a cancelled stream still returns what it produced.
    ``ClusterRequest.complete`` unwraps it into the matching terminal
    status rather than ``Status.OK``."""

    __slots__ = ("reason", "tokens")

    def __init__(self, reason: str, tokens: Any = None):
        self.reason = reason
        self.tokens = tokens if tokens is not None else []

    def __repr__(self) -> str:
        return f"Terminal({self.reason!r}, n_tokens={len(self.tokens)})"


@dataclasses.dataclass(frozen=True)
class WaitTimeout:
    """Typed sentinel returned by ``Router.wait(timeout=)`` when the
    request is still in flight at the timeout — instead of leaking the
    request's (unset) result.  The documented follow-up is
    ``router.cancel(req)``; the request itself is untouched and a later
    ``wait`` can still observe its terminal state."""
    rid: int
    waited_s: float


@dataclasses.dataclass
class ClusterRequest:
    """One end-user request travelling through the cluster."""
    payload: Any
    cost: int = 1                         # load units (e.g. tokens, rows)
    session_key: Optional[str] = None     # affinity key (user/session id)
    kind: Optional[str] = None            # backend kind (admission cost model)
    deadline_s: float = float("inf")      # absolute time.monotonic deadline
    rid: int = -1
    submitted_s: float = 0.0
    attempts: int = 0
    status: Status = Status.PENDING
    result: Any = None
    error: Optional[BaseException] = None
    replica_rid: Optional[int] = None     # replica that completed it
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    finished_s: float = 0.0
    # resilience: ``cancelled`` is set by ``Router.cancel`` before the
    # cancel frames fan out, so every router-side path (spill, requeue,
    # dispatch) refuses to move the request again; ``finish_reason``
    # mirrors the engine's taxonomy ("deadline", "cancelled", "poison",
    # "" for plain OK/FAILED); ``killed_replicas`` tallies the distinct
    # replicas whose death spilled this request (poison detection).
    cancelled: bool = False
    finish_reason: str = ""
    killed_replicas: set = dataclasses.field(default_factory=set)
    # streaming: partial-result frames forwarded by the replica while the
    # request is still in flight (e.g. per-K-step token slices from an LM
    # engine).  ``on_partial(frame)`` fires on the transport's receive
    # thread; ``partials`` keeps every frame for non-callback consumers.
    on_partial: Optional[Callable[[Any], None]] = None
    partials: List[Any] = dataclasses.field(default_factory=list)
    # tracing: the router-side root span (ended at the terminal state) and
    # the context dispatched with every attempt — the router refreshes
    # ``trace_ctx``'s attempt number on each respill so spans from a dead
    # attempt stay tagged apart from the retry's.
    trace_span: Any = None
    trace_ctx: Any = None
    # telemetry: the router attaches its registry so the single terminal
    # transition below can count every outcome by finish reason
    # (``router.finish.total`` / ``router.finish.<reason>``) — the SLO
    # engine's availability objective is computed from exactly these.
    # Never pickled: only payloads cross the transport boundary.
    metrics: Any = None

    def emit_partial(self, frame: Any) -> None:
        self.partials.append(frame)
        if self.on_partial is not None:
            try:
                self.on_partial(frame)
            except Exception:        # noqa: BLE001 - consumer's bug
                pass                 # streaming must never kill transport IO

    #: sentinel frame sent through ``on_partial`` when a spilled request
    #: is re-dispatched: the replacement replica re-runs from scratch and
    #: will re-stream every token, so incremental consumers must discard
    #: what they rendered for the previous attempt.
    RETRY_FRAME = ("__retry__",)

    def reset_partials(self) -> None:
        """At-least-once streaming: called by the router before a spilled
        request is requeued.  Clears the frame buffer (the authoritative
        ``partials`` view restarts with the new attempt) and signals
        ``on_partial`` consumers with :data:`RETRY_FRAME`."""
        if not self.partials:
            return
        self.partials.clear()
        if self.on_partial is not None:
            try:
                self.on_partial(self.RETRY_FRAME)
            except Exception:        # noqa: BLE001 - consumer's bug
                pass

    def _finish(self, status: Status):
        self.status = status
        self.finished_s = time.monotonic()
        if self.metrics is not None:
            reason = self.finish_reason or status.value
            self.metrics.counter("router.finish.total").inc()
            self.metrics.counter(f"router.finish.{reason}").inc()
        if self.trace_span is not None:
            self.trace_span.tag(status=status.value, attempts=self.attempts)
            self.trace_span.end()
        self.done.set()

    def complete(self, result: Any, replica_rid: int):
        if self.done.is_set():
            # late ack racing a local terminal (cancel after wait-timeout,
            # deadline downgrade): the first terminal state wins; dropping
            # the ack here is what keeps "never double-completed" true
            # without coordinating with every in-flight replica
            return
        self.replica_rid = replica_rid
        if isinstance(result, Terminal):
            # the replica ended this early (queue drop or mid-decode
            # finish) and shipped the partial output with the reason
            self.result = result.tokens
            self.finish_reason = result.reason
            self._finish(Status.CANCELLED if result.reason == "cancelled"
                         else Status.EXPIRED)
            return
        self.result = result
        if time.monotonic() > self.deadline_s:
            # a full result that arrived past the deadline is not a
            # success: nobody is waiting for it any more.  Downgrading at
            # the single completion point makes "nothing expired ever
            # completes ok" hold even for workers that predate deadline
            # propagation (old-build interop) and for acks already in
            # flight when the deadline passed.
            self.finish_reason = "deadline"
            self._finish(Status.EXPIRED)
            return
        self._finish(Status.OK)

    def reject(self, rejected: Rejected):
        self.result = rejected
        self._finish(Status.REJECTED)

    def fail(self, error: BaseException):
        self.error = error
        self._finish(Status.FAILED)

    def finish_cancelled(self):
        """Router-side terminal for a cancel that cannot expect an ack —
        the replica is dead, the request is between dispatches, or it was
        sitting in the requeue loop.  Idempotent against a racing ack."""
        if self.done.is_set():
            return
        self.cancelled = True
        self.finish_reason = "cancelled"
        self.result = None
        self._finish(Status.CANCELLED)

    def finish_expired(self):
        """Router-side terminal for work whose deadline passed while it
        had no live home (spilled, waiting for a survivor): re-dispatching
        it would burn a replica slot on an answer nobody reads."""
        if self.done.is_set():
            return
        self.finish_reason = "deadline"
        self.result = None
        self._finish(Status.EXPIRED)

    @property
    def missed_deadline(self) -> bool:
        return self.done.is_set() and self.finished_s > self.deadline_s

    def wait(self, timeout: Optional[float] = None) -> Any:
        self.done.wait(timeout)
        return self.result


class ReplicaCrash(RuntimeError):
    """Raised inside a worker loop by fault injection (or raised on the
    parent side of a process transport when the worker process dies)."""


# ----------------------------------------------------------------------
# Backends: anything with process(list_of_payloads) -> list_of_results.

class FnBackend:
    """Wrap a batched ``step_fn(payloads) -> results`` (tests, services)."""

    kind = "fn"                     # backend kind (admission cost model,
                                    # per-kind telemetry attribution)

    def __init__(self, step_fn: Callable[[List[Any]], List[Any]]):
        self.step_fn = step_fn

    def process(self, payloads: List[Any]) -> List[Any]:
        return self.step_fn(payloads)


class StreamBackend:
    """One SVM two-phase stream runtime per replica.

    Payloads are micro-batches ``(X, keys, ts)``.  ``fetch`` is the ingest
    stage (the paper's HDFS/storage document read + parse) applied per
    micro-batch before device compute; it blocks the host thread, which is
    exactly what overlapping replicas hide.
    """

    kind = "stream"

    def __init__(self, runtime, fetch: Optional[Callable[[Any], Any]] = None):
        self.runtime = runtime
        self.fetch = fetch

    def process(self, payloads: List[Any]) -> List[Any]:
        out = []
        for payload in payloads:
            if self.fetch is not None:
                payload = self.fetch(payload)
            X, keys, ts = payload
            sc, ok = self.runtime.process_microbatch(X, keys, ts)
            out.append((sc, ok))
        return out


#: payload sentinel tag for warm KV migration: a payload of
#: ``(KV_IMPORT_TAG, state)`` carries a drained replica's exported KV
#: blocks to its sessions' new home, where the engine adopts them before
#: the batch's real requests run (imports are idempotent, so the router's
#: at-least-once delivery is safe).
KV_IMPORT_TAG = "__kv_import__"


class EngineBackend:
    """One continuous-batching LM engine per replica.

    Payloads are ``(prompt_tokens, max_new)``; results are the generated
    token lists.  The whole pulled batch shares the engine's decode slots.
    A ``(KV_IMPORT_TAG, state)`` payload instead adopts a migrated
    replica's KV blocks (see :data:`KV_IMPORT_TAG`) and acks with
    ``("kv_imported", n_blocks)``.

    Streaming: when the driver binds an emitter (:meth:`bind_emitter`),
    each engine host sync forwards a ``(new_tokens, done)`` frame for the
    payload that produced it — partial tokens reach the submitter at
    K-step granularity instead of whole-request acks.
    """

    kind = "engine"

    def __init__(self, engine):
        self.engine = engine
        self._emit = None
        self._trace_ctxs = None
        self._deadlines = None
        self._cancel_poll = None
        self._brownout = 0
        self._spec0 = None     # engine's own speculative setting, lazily

    def bind_emitter(self, emit) -> None:
        """``emit(payload_index, frame)`` forwards a partial-result frame
        for the current batch; rebound by the driver per batch."""
        self._emit = emit

    def bind_trace(self, ctxs) -> None:
        """Per-payload :class:`~repro_torch.cluster.tracing.TraceContext` list
        for the current batch (rebound by the driver, like the emitter),
        so engine-side spans parent into the cluster request's trace."""
        self._trace_ctxs = ctxs

    def bind_deadlines(self, deadlines) -> None:
        """Per-payload absolute ``time.monotonic`` deadlines (or None) for
        the current batch — the engine finishes a session mid-decode with
        ``finish_reason="deadline"`` once its entry passes."""
        self._deadlines = deadlines

    def bind_cancel(self, poll) -> None:
        """``poll(payload_index) -> bool`` checked by the engine each host
        sync; True finishes that session with
        ``finish_reason="cancelled"`` and frees its KV within the sync."""
        self._cancel_poll = poll

    #: brownout ladder, applied per level (cumulative): L1 disables
    #: speculative decode (frees draft+verify compute), L2 additionally
    #: halves the effective ``max_new`` (every admitted stream finishes in
    #: half the decode budget), L3 adds router-side admission tightening.
    def set_brownout(self, level: int) -> None:
        self._brownout = level
        eng = self.engine
        if self._spec0 is None:
            self._spec0 = bool(getattr(eng, "speculative", False))
        if hasattr(eng, "speculative"):
            eng.speculative = self._spec0 and level < 1

    @staticmethod
    def _is_kv_import(payload) -> bool:
        return isinstance(payload, tuple) and len(payload) == 2 and \
            isinstance(payload[0], str) and payload[0] == KV_IMPORT_TAG

    def process(self, payloads: List[Any]) -> List[Any]:
        emit = self._emit
        ctxs = self._trace_ctxs
        if ctxs is None or len(ctxs) != len(payloads):
            ctxs = [None] * len(payloads)
        dls = self._deadlines
        if dls is None or len(dls) != len(payloads):
            dls = [None] * len(payloads)
        poll = self._cancel_poll

        def on_tokens(i):
            if emit is None:
                return None
            return lambda req, toks, done: emit(i, (toks, done))

        def cancel_cb(i):
            if poll is None:
                return None
            return lambda: poll(i)

        results: List[Any] = [None] * len(payloads)
        # adopt migrated KV blocks FIRST so this very batch's requests
        # (the migrated sessions, rerouted here) hit the warm prefixes
        for i, payload in enumerate(payloads):
            if self._is_kv_import(payload):
                imp = getattr(self.engine, "import_kv_state", None)
                results[i] = ("kv_imported",
                              imp(payload[1]) if imp is not None else 0)
        live = [(i, p) for i, p in enumerate(payloads)
                if results[i] is None]
        # brownout L2+: shrink the decode budget so every admitted stream
        # completes inside its deadline at degraded length, instead of a
        # few streams completing full-length while the rest expire
        shrink = self._brownout >= 2
        reqs = [(i, self.engine.submit(
                    prompt,
                    max_new=max(1, max_new // 2) if shrink else max_new,
                    on_tokens=on_tokens(i),
                    trace_ctx=ctxs[i],
                    deadline_s=dls[i],
                    cancel_cb=cancel_cb(i)))
                for i, (prompt, max_new) in live]
        self.engine.run_until_drained()
        for i, r in reqs:
            # expired/cancelled sessions ack a Terminal so the parent can
            # land them in the matching status instead of OK; whatever
            # tokens existed at the cut ride along
            if r.finish_reason in ("deadline", "cancelled"):
                results[i] = Terminal(r.finish_reason, r.out_tokens)
            else:
                results[i] = r.out_tokens
        return results

    def export_kv_state(self):
        """Drain-time hand-off: the engine's migratable KV state (or None
        when there is nothing to ship)."""
        fn = getattr(self.engine, "export_kv_state", None)
        return fn() if fn is not None else None


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReplicaConfig:
    inbox_capacity: int = 64
    max_batch: int = 8
    poll_s: float = 0.002
    heartbeat_timeout_s: float = 5.0
    # Slow-loris guard (remote transports): a replica whose liveness signal
    # stays green (process alive / heartbeats flowing) but that has not
    # acknowledged its oldest dispatched request for this long is declared
    # dead, so its work reroutes to survivors.  0 disables the guard (the
    # default: legitimate deep inboxes over slow backends would trip a
    # short universal bound — size it to the deployment's batch SLO).
    ack_timeout_s: float = 0.0
    # process transports only: how often the worker ships a heartbeat +
    # metrics snapshot back to the parent, and how long the parent waits
    # for the spawned interpreter to import + build its backend.
    heartbeat_interval_s: float = 0.25
    spawn_timeout_s: float = 120.0


# ----------------------------------------------------------------------
# The transport-agnostic driver.  A transport hands it an "inbox IO" object:
#
#   rid                      replica id (for error messages)
#   heartbeat()              refresh the liveness signal
#   crash_requested() -> bool   fault injection checkpoint
#   closing() -> bool        graceful drain requested
#   get(timeout) / get_nowait()   next work item (raise queue.Empty)
#   payload(item)            the backend payload carried by an item
#   begin(batch)             batch is now in flight (unacknowledged)
#   emit(item, frame)        [optional] forward a partial-result frame for
#                            an in-flight item (streaming backends)
#   ack(batch, results, busy_s)   acknowledge a completed batch
#   spill(batch, error)      crash path: `batch` was in flight; the
#                            transport must also spill everything still
#                            queued and mark itself dead
#   close()                  graceful-exit path after the loop breaks
#
# Items are opaque to the driver: ``ClusterRequest`` objects on a local
# transport, ``(rid, cost, payload)`` triples inside a worker process.

def run_replica_loop(backend, cfg: ReplicaConfig, io) -> None:
    """Pull -> process -> acknowledge, with crash-before-ack spill
    semantics.  Shared by ``LocalTransport``'s thread and the
    ``ProcessTransport`` worker process."""
    while True:
        io.heartbeat()
        if io.crash_requested():
            io.spill([], ReplicaCrash(f"replica {io.rid}: injected crash"))
            return
        batch: List[Any] = []
        try:
            batch.append(io.get(cfg.poll_s))
            while len(batch) < cfg.max_batch:
                batch.append(io.get_nowait())
        except queue.Empty:
            pass
        if not batch:
            if io.closing():
                break
            continue
        # resilience pre-pass: work that is already pointless — past its
        # deadline while queued, or cancelled by the submitter — is acked
        # as a Terminal immediately, WITHOUT touching the backend, so an
        # overloaded replica burns zero compute on tokens nobody reads
        dl_fn = getattr(io, "deadline", None)
        cx_fn = getattr(io, "is_cancelled", None)
        if dl_fn is not None or cx_fn is not None:
            now = time.monotonic()
            live: List[Any] = []
            dropped: List[Any] = []
            terms: List[Terminal] = []
            for r in batch:
                if cx_fn is not None and cx_fn(r):
                    dropped.append(r)
                    terms.append(Terminal("cancelled"))
                    current_recorder().record("cancelled", replica=io.rid,
                                              where="queue")
                elif dl_fn is not None and (dl_fn(r) or float("inf")) < now:
                    dropped.append(r)
                    terms.append(Terminal("deadline"))
                    current_recorder().record("deadline_expired",
                                              replica=io.rid, where="queue")
                else:
                    live.append(r)
            if dropped:
                io.begin(dropped)
                io.ack(dropped, terms, 0.0)
            batch = live
            if not batch:
                continue
        io.begin(batch)
        # mid-flight resilience: a deadline/cancel-aware backend (the LM
        # engine) gets per-item deadlines and a cancel poll so sessions
        # end mid-decode instead of only at queue boundaries
        if dl_fn is not None and hasattr(backend, "bind_deadlines"):
            backend.bind_deadlines([dl_fn(r) for r in batch])
        if cx_fn is not None and hasattr(backend, "bind_cancel"):
            backend.bind_cancel(lambda i, _b=batch: cx_fn(_b[i]))
        # brownout: apply the router's current degradation level before
        # the batch runs (disable speculation / shrink effective max_new)
        bl_fn = getattr(io, "brownout", None)
        if bl_fn is not None and hasattr(backend, "set_brownout"):
            backend.set_brownout(bl_fn())
        # streaming bridge: a backend that accepts an emitter gets partial
        # frames forwarded through the transport (LocalTransport fires the
        # request's callback directly; remote workers ship ("partial", ...)
        # frames the parent dispatches) — tokens stream at the backend's
        # sync cadence instead of quantizing to whole-request acks
        emit_fn = getattr(io, "emit", None)
        if emit_fn is not None and hasattr(backend, "bind_emitter"):
            backend.bind_emitter(
                lambda i, frame, _b=batch: emit_fn(_b[i], frame))
        # tracing bridge: rehydrated contexts ride the work items; the
        # batch span parents on the first traced item (one batch serves
        # many requests — sibling items are listed in the tags) and a
        # trace-aware backend gets the per-item contexts for its own spans
        ctx_fn = getattr(io, "trace_ctx", None)
        ctxs = [ctx_fn(r) for r in batch] if ctx_fn is not None \
            else [None] * len(batch)
        if hasattr(backend, "bind_trace"):
            backend.bind_trace(ctxs)
        bsp = current_tracer().span(
            "replica.batch",
            parent=next((c for c in ctxs if c is not None), None),
            replica=io.rid, n=len(batch))
        t0 = time.monotonic()
        try:
            results = backend.process([io.payload(r) for r in batch])
            if io.crash_requested():
                # crash before acknowledgement: the whole batch spills
                raise ReplicaCrash(f"replica {io.rid}: crashed before ack")
        except BaseException as e:
            bsp.tag(spilled=True, error=repr(e))
            bsp.end()
            current_recorder().record("batch_spill", replica=io.rid,
                                      n=len(batch), error=repr(e))
            io.spill(batch, e)
            return
        bsp.end()
        io.ack(batch, results, time.monotonic() - t0)
    # graceful drain: a backend holding migratable session state (the LM
    # engine's published KV blocks) exports it now — after the last batch,
    # before the drained frame — and the transport publishes it to the
    # parent, where the router ships it to the sessions' new homes
    export = getattr(backend, "export_kv_state", None)
    publish = getattr(io, "publish_kv_state", None)
    if export is not None and publish is not None:
        try:
            state = export()
        except Exception:       # noqa: BLE001 - hand-off is best-effort
            state = None
        if state is not None:
            publish(state)
    io.close()
