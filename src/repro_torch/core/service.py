"""MLaaS service front (the paper's "service offered to a wide public"):
a thread-safe request queue with deadline-aware batching in front of either

  * a local batched ``step_fn(list_of_payloads) -> list_of_results``
    (single-replica: the two-phase pipeline or one serving engine), or
  * a :class:`repro_torch.cluster.Router`, which fans the batch out over a
    pool of replica workers (multi-replica cluster).

Batching policy = the mapPartitions trade-off, live: requests are grouped
until either the batch capacity is reached or the oldest request's slack
(deadline - now - estimated_step_time) runs out, using the partitioner's
fitted cost model to estimate step time per batch size.  The slack test
itself lives in ``repro_torch.cluster.admission.deadline_slack`` and is shared
with the cluster's admission controller.

Shutdown contract: ``stop()`` never abandons requests.  By default it
*flushes* — everything already queued is processed before the loop exits;
with ``drain=False`` waiting requests complete immediately with an explicit
``Rejected("shutdown")`` result.  Either way, no caller blocks forever on
``req.done.wait()``.

Copied from ``repro.core.service``; the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, List, Optional

from repro_torch.cluster.admission import Rejected, deadline_slack
from repro_torch.cluster.metrics import MetricsRegistry
from repro_torch.core.partitioner import CostModel


@dataclasses.dataclass
class ServiceRequest:
    payload: Any
    deadline_s: float                  # absolute time.monotonic deadline
    submitted_s: float = 0.0
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Any = None
    missed_deadline: bool = False

    @property
    def rejected(self) -> bool:
        return isinstance(self.result, Rejected)


class MLaaSService:
    """Deadline-batching front over a local step_fn or a cluster Router."""

    #: longest single block on the inbox queue: bounds both how stale the
    #: deadline-slack estimate can get while waiting and how long stop()
    #: can trail behind its wakeup sentinel
    IDLE_WAIT_CAP_S = 0.25

    def __init__(self, step_fn: Optional[Callable[[List[Any]], List[Any]]] = None,
                 capacity: int = 8, cost_model: Optional[CostModel] = None,
                 poll_s: float = 0.002, router=None,
                 metrics: Optional[MetricsRegistry] = None):
        if (step_fn is None) == (router is None):
            raise ValueError("provide exactly one of step_fn / router")
        self.router = router
        self.step_fn = step_fn if step_fn is not None else router.as_step_fn()
        self.capacity = capacity
        self.cost_model = cost_model
        self.poll_s = poll_s
        self.q: "queue.Queue[ServiceRequest]" = queue.Queue()
        self._stop = threading.Event()
        self._accept_lock = threading.Lock()   # submit vs shutdown-drain
        self._closed = False                   # loop has begun final drain
        self._drain_on_stop = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_batches = self.metrics.counter("service.batches")
        self._c_requests = self.metrics.counter("service.requests")
        self._c_missed = self.metrics.counter("service.missed")
        self._c_sum_batch = self.metrics.counter("service.sum_batch")
        self._h_latency = self.metrics.histogram("service.latency_s")

    def start(self):
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout_s: float = 10.0):
        """Shut down without stranding requests: flush the backlog
        (``drain=True``) or fail it fast with ``Rejected("shutdown")``."""
        self._drain_on_stop = drain
        self._stop.set()
        self.q.put(None)                   # sentinel: wake a blocked q.get
        self._thread.join(timeout=timeout_s)

    # ------------------------------------------------------------------
    def submit(self, payload, timeout_s: float = 10.0) -> ServiceRequest:
        req = ServiceRequest(payload, deadline_s=time.monotonic() + timeout_s,
                             submitted_s=time.monotonic())
        # The lock makes check+enqueue atomic w.r.t. the loop's final drain:
        # once `_closed` is observed, no request can slip in behind the
        # drain and block its caller forever.
        with self._accept_lock:
            if self._closed or self._stop.is_set():   # fail-fast after stop()
                req.result = Rejected("shutdown", "service stopped")
                req.done.set()
                return req
            self.q.put(req)
        self.metrics.gauge("service.queue_depth").set(self.q.qsize())
        return req

    def _estimate(self, m: int) -> float:
        return self.cost_model.time(m) if self.cost_model else 0.0

    # ------------------------------------------------------------------
    def _run_batch(self, batch: List[ServiceRequest]):
        try:
            results = self.step_fn([r.payload for r in batch])
        except Exception as e:
            # a backend failure must not kill the loop (stranding every
            # later request) nor strand this batch: fail it explicitly
            self.metrics.counter("service.step_errors").inc()
            err = Rejected("step_error", repr(e))
            for r in batch:
                r.result = err
                r.done.set()
            return
        t_done = time.monotonic()
        self._c_batches.inc()
        self._c_requests.inc(len(batch))
        self._c_sum_batch.inc(len(batch))
        for r, res in zip(batch, results):
            r.result = res
            r.missed_deadline = t_done > r.deadline_s
            self._c_missed.inc(int(r.missed_deadline))
            self._h_latency.observe(t_done - r.submitted_s)
            r.done.set()

    def _wait_timeout(self, pending: List[ServiceRequest]) -> float:
        """How long the loop may block on the inbox before it must act.

        Idle (nothing pending): nothing can become urgent except via the
        queue itself, so block up to the cap instead of spinning at
        ``poll_s`` — idle CPU burn drops from ~1/poll_s wakeups/s to
        ~1/IDLE_WAIT_CAP_S.  With pending requests: sleep exactly the
        oldest request's deadline slack (minus the estimated step time),
        clamped to [poll_s, cap] — a new arrival interrupts the wait via
        ``q.get`` either way."""
        if not pending:
            return self.IDLE_WAIT_CAP_S
        slack = deadline_slack(min(r.deadline_s for r in pending),
                               time.monotonic(),
                               self._estimate(len(pending)))
        # wake 2*poll_s ahead of the slack expiry (the dispatch threshold
        # below): sleeping the full slack would dispatch *at* the deadline
        # minus the step estimate, turning any get() overshoot into a miss
        return min(max(slack - 2 * self.poll_s, self.poll_s),
                   self.IDLE_WAIT_CAP_S)

    def _loop(self):
        pending: List[ServiceRequest] = []
        while not self._stop.is_set():
            # drain the queue: one deadline-aware blocking get, then a
            # non-blocking sweep (None = the stop() wakeup sentinel)
            self.metrics.counter("service.loop_wakeups").inc()
            try:
                got = self.q.get(timeout=self._wait_timeout(pending))
                if got is not None:
                    pending.append(got)
                while len(pending) < self.capacity:
                    got = self.q.get_nowait()
                    if got is not None:
                        pending.append(got)
            except queue.Empty:
                pass
            if not pending:
                continue
            now = time.monotonic()
            full = len(pending) >= self.capacity
            oldest_slack = deadline_slack(min(r.deadline_s for r in pending),
                                          now, self._estimate(len(pending)))
            if full or oldest_slack <= self.poll_s * 2:
                batch, pending = pending[:self.capacity], pending[self.capacity:]
                self._run_batch(batch)
        # ---- shutdown: nothing may be left behind -----------------------
        with self._accept_lock:
            self._closed = True            # later submits fail fast
            try:
                while True:
                    got = self.q.get_nowait()
                    if got is not None:    # drop wakeup sentinels
                        pending.append(got)
            except queue.Empty:
                pass
        if self._drain_on_stop:
            while pending:
                batch, pending = pending[:self.capacity], pending[self.capacity:]
                self._run_batch(batch)
        else:
            shutdown = Rejected("shutdown", "service stopped before dispatch")
            for r in pending:
                r.result = shutdown
                r.done.set()

    # ------------------------------------------------------------------
    @property
    def stats(self) -> dict:
        """Legacy counter view (kept for existing callers/tests)."""
        return {"batches": self._c_batches.value,
                "requests": self._c_requests.value,
                "missed": self._c_missed.value,
                "sum_batch": self._c_sum_batch.value}

    def mean_batch(self) -> float:
        b = self._c_batches.value
        return self._c_sum_batch.value / b if b else 0.0
