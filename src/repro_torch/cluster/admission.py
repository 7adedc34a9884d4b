"""Admission control and backpressure for the serving cluster.

The paper's service must stay responsive for "evergrowing user bases"; when
offered load exceeds capacity the failure mode must be an *explicit, cheap
rejection* at the front door — not silent deadline misses deep in the queue
(the pathology the stream runtime calls "falling behind").

Two shedding rules, both O(1) per request:

  * queue-full   — a bounded global queue (count or cost units); requests
                   beyond it are shed immediately.
  * deadline     — the ``CostModel`` slack test that used to live inline in
                   ``MLaaSService._loop``: if the fitted service-time estimate
                   for the work already queued ahead says the deadline cannot
                   be met, reject now instead of missing later.

Rejected requests complete with an explicit :class:`Rejected` result so
callers can distinguish "shed by policy" from "failed".

Copied from ``repro.cluster.admission``; the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional

from repro_torch.core.partitioner import CostModel
from repro_torch.cluster.metrics import MetricsRegistry, null_registry


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Explicit overload result: the request was shed, not processed."""
    reason: str                       # "queue_full" | "deadline" | "shutdown"
    detail: str = ""


def deadline_slack(deadline_s: float, now: float, est_service_s: float) -> float:
    """Slack = time to deadline minus the estimated service time.

    This is the batching/shedding criterion shared by the service front
    (flush when the oldest request's slack runs out) and the admission
    controller (reject when slack is negative on arrival).
    """
    return deadline_s - now - est_service_s


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    max_queue_cost: int = 1024        # bound on queued cost units (≈ requests)
    cost_model: Optional[CostModel] = None
    min_slack_s: float = 0.0          # extra safety margin on the deadline test
    # Per-backend cost models, keyed by backend kind ("lm", "svm", ...):
    # an LM token and an SVM row cost very different service time, so one
    # global model either over-sheds the cheap backend or under-sheds the
    # expensive one.  Falls back to ``cost_model`` for unknown kinds.
    cost_models: Optional[Mapping[str, CostModel]] = None
    # KV-pool headroom gate (paged LM engines): shed when the cluster's
    # free-block fraction (engine.kv_blocks_free / engine.kv_blocks_total,
    # shipped through replica heartbeats) drops below this.  Queue depth
    # alone cannot see memory pressure — a paged replica with short queues
    # can still be out of blocks for *long* sequences, and admitting into
    # a starved pool turns into in-engine deferral (or mid-decode pool
    # exhaustion) instead of a cheap front-door rejection.  0 disables.
    min_kv_headroom_frac: float = 0.0


class AdmissionController:
    """Front-door policy: decide admit/shed from global queue state."""

    def __init__(self, cfg: AdmissionConfig = AdmissionConfig(),
                 metrics: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else null_registry()
        self._admitted = self.metrics.counter("admission.admitted")
        self._shed_full = self.metrics.counter("admission.shed_queue_full")
        self._shed_deadline = self.metrics.counter("admission.shed_deadline")
        self._shed_kv = self.metrics.counter("admission.shed_kv_pressure")

    def _model_for(self, kind: Optional[str]) -> Optional[CostModel]:
        if kind is not None and self.cfg.cost_models:
            cm = self.cfg.cost_models.get(kind)
            if cm is not None:
                return cm
        return self.cfg.cost_model

    def _estimate(self, queued_cost: int, kind: Optional[str] = None) -> float:
        cm = self._model_for(kind)
        return cm.time(max(queued_cost, 1)) if cm else 0.0

    def decide(self, queued_cost: int, cost: int, deadline_s: float,
               now: Optional[float] = None,
               kind: Optional[str] = None,
               kv_free_frac: Optional[float] = None,
               scale: float = 1.0) -> Optional[Rejected]:
        """Returns None to admit, or a :class:`Rejected` describing the shed.

        ``queued_cost`` is the outstanding cost ahead of this request (the
        router passes the per-kind queue depth when ``kind`` is given, else
        cluster-wide); ``cost`` the new request's own cost units; ``kind``
        selects a per-backend cost model for the deadline test;
        ``kv_free_frac`` is the backend pool's free-KV-block fraction when
        known (paged LM engines export it via ``engine.kv_blocks_*``);
        ``scale`` tightens the queue bound under brownout (the router
        passes the overload controller's admission scale — level 3 halves
        the effective front-door budget so load sheds cheaply here instead
        of expiring deep in replica queues).
        """
        bound = self.cfg.max_queue_cost * scale
        if queued_cost + cost > bound:
            self._shed_full.inc()
            return Rejected("queue_full",
                            f"queued={queued_cost} + {cost} > "
                            f"{bound:g}"
                            + (f" (brownout scale {scale:g})"
                               if scale != 1.0 else ""))
        if self.cfg.min_kv_headroom_frac > 0 and kv_free_frac is not None \
                and kv_free_frac < self.cfg.min_kv_headroom_frac:
            self._shed_kv.inc()
            return Rejected("kv_pressure",
                            f"free kv blocks {kv_free_frac:.3f} < "
                            f"{self.cfg.min_kv_headroom_frac} headroom "
                            f"(kind={kind or 'global'})")
        now = time.monotonic() if now is None else now
        est = self._estimate(queued_cost + cost, kind)
        slack = deadline_slack(deadline_s, now, est)
        if slack < self.cfg.min_slack_s:
            self._shed_deadline.inc()
            return Rejected("deadline",
                            f"slack={slack:.4f}s < {self.cfg.min_slack_s}s "
                            f"(est={est:.4f}s, kind={kind or 'global'})")
        self._admitted.inc()
        return None
