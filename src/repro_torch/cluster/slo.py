"""SLO objectives, error-budget accounting and multi-window burn-rate
alerts over the Router's finish-reason taxonomy, copied from
``repro.cluster.slo``.

An :class:`SLOObjective` states what "good" means for a backend kind:

* **latency** — a threshold and a target fraction ("99% of requests
  finish under 1s"), evaluated from the windowed bucket deltas of a
  latency histogram stem (:class:`~repro_torch.cluster.timeseries
  .TimeSeriesStore`), so the burn rate reflects *recent* requests, not
  lifetime averages;
* **availability** — the fraction of terminal requests that did not burn
  budget.  ``deadline`` misses, ``poison`` quarantines and
  ``kv_pool_exhausted`` victims burn; ``cancelled`` is the caller's
  choice and does not (it is excluded from the denominator too).

Alerting follows the SRE multi-window burn-rate pattern: a (fast, slow)
window pair fires only when BOTH exceed the pair's burn threshold — the
fast window gives low detection latency, the slow window keeps a blip
from paging — and clears after ``clear_after`` consecutive quiet ticks
(hysteresis against flapping).  Transitions emit FlightRecorder events
(``slo_burn_fired`` / ``slo_burn_cleared``) and every evaluation
publishes ``slo.*`` gauges into the registry, which the stats endpoint
and dashboard read back out of the snapshot.  A firing alert can
optionally be fed into :class:`~repro_torch.cluster.overload
.BrownoutController` as extra pressure via :meth:`SLOEngine.pressure`.

Window lengths here default to production-ish scales; tests use
:func:`test_scaled_objective` to shrink them to the chaos-harness
timescale (sub-second windows) without changing any of the logic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.metrics import HIST_BUCKET_BOUNDS, MetricsRegistry
from repro_torch.cluster.timeseries import TimeSeriesStore

__all__ = ["BurnWindow", "SLOObjective", "SLOEngine",
           "test_scaled_objective", "BAD_FINISH_REASONS",
           "NEUTRAL_FINISH_REASONS"]

# The Router's finish-reason taxonomy, split by budget impact.  ``deadline``:
# the service missed the caller's deadline; ``poison``: quarantined
# after repeatedly killing replicas; ``kv_pool_exhausted``: victimized
# for capacity.  ``cancelled`` is caller-initiated and neutral.
BAD_FINISH_REASONS: Tuple[str, ...] = ("deadline", "poison",
                                       "kv_pool_exhausted")
NEUTRAL_FINISH_REASONS: Tuple[str, ...] = ("cancelled",)


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One (fast, slow) window pair with its burn-rate threshold: the
    alert condition is ``burn(fast) > threshold AND burn(slow) >
    threshold``."""
    fast_s: float
    slow_s: float
    threshold: float


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    kind: str = "any"                      # backend kind this SLO covers
    latency_stem: str = "router.latency_s"
    latency_threshold_s: float = 1.0
    latency_target: float = 0.99           # fraction under the threshold
    availability_target: float = 0.99
    # classic page/ticket pairs (fractions of a 30-day budget)
    windows: Tuple[BurnWindow, ...] = (
        BurnWindow(fast_s=300.0, slow_s=3600.0, threshold=14.4),
        BurnWindow(fast_s=1800.0, slow_s=21600.0, threshold=6.0),
    )
    bad_reasons: Tuple[str, ...] = BAD_FINISH_REASONS
    neutral_reasons: Tuple[str, ...] = NEUTRAL_FINISH_REASONS
    clear_after: int = 2                   # quiet ticks before clearing

    @property
    def latency_budget(self) -> float:
        return max(1.0 - self.latency_target, 1e-9)

    @property
    def availability_budget(self) -> float:
        return max(1.0 - self.availability_target, 1e-9)


def test_scaled_objective(kind: str = "any",
                          fast_s: float = 0.4, slow_s: float = 1.2,
                          threshold: float = 2.0,
                          **overrides: Any) -> SLOObjective:
    """The same objective shrunk to chaos-harness timescales: one window
    pair of sub-second fast/slow windows and a low burn threshold, so an
    injected fault burst trips the alert within a few sampler ticks."""
    kw: Dict[str, Any] = dict(
        kind=kind,
        windows=(BurnWindow(fast_s=fast_s, slow_s=slow_s,
                            threshold=threshold),),
        clear_after=1,
    )
    kw.update(overrides)
    return SLOObjective(**kw)


class _Alert:
    """Firing/clearing state machine for one (objective, sub-objective)."""

    __slots__ = ("state", "quiet_ticks", "fired_count", "cleared_count",
                 "last_burns")

    def __init__(self):
        self.state = "ok"
        self.quiet_ticks = 0
        self.fired_count = 0
        self.cleared_count = 0
        self.last_burns: List[Tuple[float, float, float]] = []

    def step(self, exceeding: bool, clear_after: int) -> Optional[str]:
        """Advance one tick; returns 'fired'/'cleared' on a transition."""
        if exceeding:
            self.quiet_ticks = 0
            if self.state == "ok":
                self.state = "firing"
                self.fired_count += 1
                return "fired"
            return None
        if self.state == "firing":
            self.quiet_ticks += 1
            if self.quiet_ticks >= clear_after:
                self.state = "ok"
                self.quiet_ticks = 0
                self.cleared_count += 1
                return "cleared"
        return None


class SLOEngine:
    """Evaluate objectives against a :class:`TimeSeriesStore` each tick;
    publish gauges, emit FlightRecorder events on transitions, account
    the lifetime error budget, and expose brownout pressure."""

    def __init__(self, objectives: Sequence[SLOObjective],
                 registry: MetricsRegistry,
                 recorder: Optional[Any] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.objectives = list(objectives)
        self.registry = registry
        self.recorder = recorder
        self._clock = clock
        self._alerts: Dict[Tuple[str, str], _Alert] = {}
        # lifetime budget accounting, accumulated from per-tick deltas
        self._cum: Dict[Tuple[str, str], List[float]] = {}
        self._last_tick_t: Optional[float] = None
        self.ticks = 0

    # -- burn-rate math -------------------------------------------------
    @staticmethod
    def _latency_bad_fraction(store: TimeSeriesStore, stem: str,
                              threshold_s: float, window_s: float,
                              now: float) -> Tuple[float, float]:
        """(bad_fraction, total) of windowed observations over the latency
        threshold, with linear partial credit inside the bucket that
        straddles the threshold (bucket-resolution exactness)."""
        counts = store.window_bucket_counts(stem, window_s, now=now)
        total = sum(counts)
        if total <= 0:
            return 0.0, 0.0
        good = 0.0
        for i, c in enumerate(counts):
            if c <= 0:
                continue
            if i >= len(HIST_BUCKET_BOUNDS):
                continue                       # overflow: all bad
            lo = HIST_BUCKET_BOUNDS[i - 1] if i else 0.0
            hi = HIST_BUCKET_BOUNDS[i]
            if hi <= threshold_s:
                good += c
            elif lo < threshold_s:
                good += c * (threshold_s - lo) / (hi - lo)
        return max(1.0 - good / total, 0.0), total

    @staticmethod
    def _availability_bad_fraction(store: TimeSeriesStore,
                                   obj: SLOObjective, window_s: float,
                                   now: float) -> Tuple[float, float]:
        bad = sum(store.increase(f"router.finish.{r}", window_s, now=now)
                  for r in obj.bad_reasons)
        total = store.increase("router.finish.total", window_s, now=now)
        total -= sum(store.increase(f"router.finish.{r}", window_s,
                                    now=now) for r in obj.neutral_reasons)
        if total <= 0:
            return 0.0, 0.0
        return min(bad / total, 1.0), total

    def _burn(self, store: TimeSeriesStore, obj: SLOObjective, sub: str,
              window_s: float, now: float) -> float:
        if sub == "latency":
            frac, _ = self._latency_bad_fraction(
                store, obj.latency_stem, obj.latency_threshold_s,
                window_s, now)
            return frac / obj.latency_budget
        frac, _ = self._availability_bad_fraction(store, obj, window_s,
                                                  now)
        return frac / obj.availability_budget

    # -- tick -----------------------------------------------------------
    def tick(self, store: TimeSeriesStore,
             now: Optional[float] = None) -> None:
        t = self._clock() if now is None else float(now)
        tick_span = (t - self._last_tick_t
                     if self._last_tick_t is not None else 0.0)
        for obj in self.objectives:
            for sub in ("latency", "availability"):
                key = (obj.kind, sub)
                alert = self._alerts.get(key)
                if alert is None:
                    alert = self._alerts[key] = _Alert()
                burns: List[Tuple[float, float, float]] = []
                exceeding = False
                for w in obj.windows:
                    bf = self._burn(store, obj, sub, w.fast_s, t)
                    bs = self._burn(store, obj, sub, w.slow_s, t)
                    burns.append((bf, bs, w.threshold))
                    if bf > w.threshold and bs > w.threshold:
                        exceeding = True
                alert.last_burns = burns
                transition = alert.step(exceeding, obj.clear_after)
                self._account(store, obj, sub, tick_span, t)
                self._publish(obj, sub, alert, burns)
                if transition and self.recorder is not None:
                    bf, bs, thr = burns[0]
                    self.recorder.record(
                        f"slo_burn_{transition}", objective=obj.kind,
                        slo=sub, burn_fast=round(bf, 3),
                        burn_slow=round(bs, 3), threshold=thr,
                        fast_window_s=obj.windows[0].fast_s,
                        slow_window_s=obj.windows[0].slow_s)
        self._last_tick_t = t
        self.ticks += 1

    def _account(self, store: TimeSeriesStore, obj: SLOObjective,
                 sub: str, tick_span: float, now: float) -> None:
        """Accumulate lifetime (bad, total) from this tick's delta."""
        key = (obj.kind, sub)
        cum = self._cum.get(key)
        if cum is None:
            cum = self._cum[key] = [0.0, 0.0]
        if tick_span <= 0:
            return
        if sub == "latency":
            frac, total = self._latency_bad_fraction(
                store, obj.latency_stem, obj.latency_threshold_s,
                tick_span, now)
        else:
            frac, total = self._availability_bad_fraction(
                store, obj, tick_span, now)
        cum[0] += frac * total
        cum[1] += total

    def _publish(self, obj: SLOObjective, sub: str, alert: _Alert,
                 burns: List[Tuple[float, float, float]]) -> None:
        base = f"slo.{obj.kind}.{sub}"
        bf, bs, _thr = burns[0]
        g = self.registry.gauge
        g(f"{base}.burn_fast").set(bf)
        g(f"{base}.burn_slow").set(bs)
        g(f"{base}.firing").set(1.0 if alert.state == "firing" else 0.0)
        g(f"{base}.fired_total").set(float(alert.fired_count))
        g(f"{base}.budget_remaining").set(
            self.budget_remaining(obj.kind, sub))

    # -- read side ------------------------------------------------------
    def budget_remaining(self, kind: str, sub: str) -> float:
        """Lifetime error budget left, as a fraction of the allowance
        (1.0 = untouched, 0.0 = exhausted, negative = overspent)."""
        obj = next((o for o in self.objectives if o.kind == kind), None)
        cum = self._cum.get((kind, sub))
        if obj is None or cum is None or cum[1] <= 0:
            return 1.0
        budget = (obj.latency_budget if sub == "latency"
                  else obj.availability_budget)
        return 1.0 - (cum[0] / cum[1]) / budget

    def firing(self) -> List[Tuple[str, str]]:
        return [k for k, a in self._alerts.items() if a.state == "firing"]

    def pressure(self) -> float:
        """Extra brownout pressure in [0, 1]: zero while healthy; a
        firing alert contributes its fast-burn overshoot (burn at 2x the
        threshold saturates to 1.0).  Feed into
        ``BrownoutController.tick`` alongside queue/KV pressure."""
        worst = 0.0
        for alert in self._alerts.values():
            if alert.state != "firing":
                continue
            for bf, _bs, thr in alert.last_burns:
                if thr > 0:
                    worst = max(worst, min(bf / thr - 1.0, 1.0))
        return max(worst, 0.0)

    def status(self) -> Dict[str, Any]:
        """Schema served at ``/slo.json`` and rendered on the dash."""
        out: Dict[str, Any] = {"objectives": [], "ticks": self.ticks,
                               "pressure": self.pressure()}
        for obj in self.objectives:
            entry: Dict[str, Any] = {
                "kind": obj.kind,
                "latency_threshold_s": obj.latency_threshold_s,
                "latency_target": obj.latency_target,
                "availability_target": obj.availability_target,
                "alerts": {},
            }
            for sub in ("latency", "availability"):
                alert = self._alerts.get((obj.kind, sub))
                if alert is None:
                    continue
                entry["alerts"][sub] = {
                    "state": alert.state,
                    "fired_count": alert.fired_count,
                    "cleared_count": alert.cleared_count,
                    "burns": [
                        {"fast": bf, "slow": bs, "threshold": thr}
                        for bf, bs, thr in alert.last_burns],
                    "budget_remaining": self.budget_remaining(obj.kind,
                                                              sub),
                }
            out["objectives"].append(entry)
        return out
