"""Time-series telemetry over the flat cluster snapshot (paper §6: the
evaluation is about rates, latency and fall-behind over *time*), copied
from ``repro.cluster.timeseries``.

``cluster_snapshot()`` answers point-in-time questions only — lifetime
counters and lifetime-reservoir percentiles never recover after a spike
and cannot express "what is the p99 *right now*".  This module samples
the merged snapshot at heartbeat cadence into a fixed-memory ring buffer
(:class:`TimeSeriesStore`) and types every stem:

* **counter** → reset-safe windowed :meth:`TimeSeriesStore.rate` (sum of
  positive consecutive increments — a restarted worker's residual reset
  clamps to zero instead of emitting a negative rate);
* **gauge** (``is_gauge_key``) → last value / EWMA;
* **histogram** → **windowed percentiles from bucket-count deltas**:
  the ``.le<i>`` keys are themselves monotone counters against
  :data:`~repro_torch.cluster.metrics.HIST_BUCKET_BOUNDS`, so the per-bucket
  increment over a trailing window is an exact histogram of the window's
  observations, and ``bucket_percentile`` over those deltas is a true
  10-second p99, exact up to bucket resolution (10^(1/4)x).

On top ride the EWMA arrival-rate / service-rate estimators (published
as ``timeseries.*`` gauges for the predictive autoscaler), per-stage
latency attribution from the tracer's span tree (:class:`StageAttributor`),
and the :class:`TelemetrySampler` thread that drives all of it plus the
optional SLO engine.

Memory is strictly bounded: at most ``max_stems`` tracked keys, each a
ring of ``capacity`` ``(t, value)`` pairs — ``max_points`` is the hard
ceiling, asserted in tests.
"""
from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.metrics import (_BUCKET_KEY_RE, _N_BUCKETS,
                                         MetricsRegistry, bucket_percentile,
                                         is_gauge_key)

__all__ = [
    "TimeSeriesStore", "EwmaRate", "StageAttributor", "TelemetrySampler",
]


class TimeSeriesStore:
    """Fixed-memory ring buffer of sampled snapshot values, typed per stem.

    ``sample()`` appends every numeric key of a flat snapshot dict with a
    timestamp; readers derive windowed rates, EWMAs and bucket-delta
    percentiles.  All methods are thread-safe; reads take a snapshot of
    the relevant ring under the lock and compute outside critical
    sections where possible (rings are small — ``capacity`` defaults to
    240 samples ≈ one minute at heartbeat cadence).
    """

    def __init__(self, capacity: int = 240, max_stems: int = 1024,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self.capacity = int(capacity)
        self.max_stems = int(max_stems)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}
        self._ticks: deque = deque(maxlen=self.capacity)
        self.dropped_keys = 0          # keys refused by the max_stems bound

    # -- bounds ---------------------------------------------------------
    @property
    def max_points(self) -> int:
        """Hard memory ceiling: ring capacity x stem bound."""
        return self.capacity * self.max_stems

    @property
    def n_points(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._series.values())

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._series)

    # -- writing --------------------------------------------------------
    def sample(self, snap: Dict[str, float],
               now: Optional[float] = None) -> None:
        """Record one snapshot.  Non-numeric values are skipped; keys
        beyond ``max_stems`` are counted in ``dropped_keys`` rather than
        grown unboundedly."""
        t = self._clock() if now is None else float(now)
        with self._lock:
            self._ticks.append(t)
            for k, v in snap.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                d = self._series.get(k)
                if d is None:
                    if len(self._series) >= self.max_stems:
                        self.dropped_keys += 1
                        continue
                    d = self._series[k] = deque(maxlen=self.capacity)
                d.append((t, float(v)))

    # -- typing ---------------------------------------------------------
    @staticmethod
    def key_type(key: str) -> str:
        """'bucket' | 'counter' | 'gauge' for a flat snapshot key."""
        if _BUCKET_KEY_RE.match(key):
            return "bucket"              # .le<i>: monotone counter series
        if key.endswith(".count"):
            return "counter"
        if is_gauge_key(key):
            return "gauge"
        return "counter"

    def histogram_stems(self) -> List[str]:
        """Stems that ship bucketed counts (``<stem>.le<i>`` keys)."""
        with self._lock:
            stems = {m.group("stem") for k in self._series
                     if (m := _BUCKET_KEY_RE.match(k))}
        return sorted(stems)

    # -- reading: points ------------------------------------------------
    def last(self, key: str) -> Optional[float]:
        with self._lock:
            d = self._series.get(key)
            return d[-1][1] if d else None

    def points(self, key: str,
               window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        with self._lock:
            d = self._series.get(key)
            pts = list(d) if d else []
        if window_s is not None:
            t = (self._clock() if now is None else now) - window_s
            pts = [p for p in pts if p[0] >= t]
        return pts

    def ewma(self, key: str, halflife_s: float = 5.0,
             now: Optional[float] = None) -> float:
        """Exponentially-weighted last value over the stored ring
        (irregular sampling handled via per-step decay)."""
        pts = self.points(key)
        if not pts:
            return 0.0
        est, t_prev = pts[0][1], pts[0][0]
        for t, v in pts[1:]:
            dt = max(t - t_prev, 0.0)
            alpha = 1.0 - math.exp(-dt * math.log(2.0) / max(halflife_s,
                                                             1e-9))
            est += alpha * (v - est)
            t_prev = t
        return est

    # -- reading: windowed counter math ---------------------------------
    def _window_increase(self, key: str, window_s: float,
                         now: float) -> Tuple[float, float]:
        """(total positive increase, seconds covered) for a counter key
        over the trailing window.

        Counter resets (a restarted worker shrinking the merged total)
        clamp each negative consecutive delta to zero — the increase is
        the sum of positive steps, never negative.  A key first seen
        mid-window counts its full first value as an increase *only* if
        the store was already ticking before it appeared (absent key ==
        zero); a store attaching to a long-running source must not credit
        lifetime totals as fresh traffic.
        """
        cutoff = now - window_s
        with self._lock:
            d = self._series.get(key)
            pts = list(d) if d else []
            ticks = list(self._ticks)
        if not pts:
            return 0.0, 0.0
        # baseline: last sample at or before the cutoff, else a synthetic
        # zero at the last pre-appearance store tick inside the window
        base: Optional[Tuple[float, float]] = None
        in_win: List[Tuple[float, float]] = []
        for p in pts:
            if p[0] <= cutoff:
                base = p
            else:
                in_win.append(p)
        if not in_win:
            return 0.0, 0.0
        if base is None:
            first_t = in_win[0][0]
            prev_ticks = [t for t in ticks if cutoff <= t < first_t]
            if prev_ticks:
                base = (prev_ticks[-1], 0.0)
        seq = ([base] if base is not None else []) + in_win
        inc = 0.0
        for (t0, v0), (t1, v1) in zip(seq, seq[1:]):
            inc += max(v1 - v0, 0.0)
        covered = now - (seq[0][0] if base is not None else in_win[0][0])
        return inc, max(covered, 0.0)

    def increase(self, key: str, window_s: float,
                 now: Optional[float] = None) -> float:
        """Reset-clamped total increase of a counter over the window."""
        t = self._clock() if now is None else float(now)
        inc, _ = self._window_increase(key, window_s, t)
        return inc

    def rate(self, key: str, window_s: float,
             now: Optional[float] = None) -> float:
        """Windowed per-second rate of a counter key; >= 0 always (resets
        clamp to zero rather than going negative)."""
        t = self._clock() if now is None else float(now)
        inc, covered = self._window_increase(key, window_s, t)
        if covered <= 0.0:
            return 0.0
        return inc / covered

    # -- reading: windowed histogram math -------------------------------
    def window_bucket_counts(self, stem: str, window_s: float,
                             now: Optional[float] = None) -> List[float]:
        """Per-bucket observation counts for the trailing window, from
        ``.le<i>`` counter deltas."""
        t = self._clock() if now is None else float(now)
        return [self.increase(f"{stem}.le{i}", window_s, now=t)
                for i in range(_N_BUCKETS)]

    def window_count(self, stem: str, window_s: float,
                     now: Optional[float] = None) -> float:
        return self.increase(f"{stem}.count", window_s, now=now)

    def window_percentile(self, stem: str, p: float, window_s: float,
                          now: Optional[float] = None) -> float:
        """Percentile of the observations that fell inside the trailing
        window — exact up to bucket resolution.  0.0 on an empty window;
        ``inf`` when the percentile lands in the overflow bucket."""
        counts = self.window_bucket_counts(stem, window_s, now=now)
        if sum(counts) <= 0:
            return 0.0
        return bucket_percentile(counts, p)

    def window_mean(self, stem: str, window_s: float,
                    now: Optional[float] = None) -> float:
        """Approximate windowed mean from bucket midpoints (the flat
        snapshot has no windowed sum; good to bucket resolution)."""
        from repro_torch.cluster.metrics import HIST_BUCKET_BOUNDS
        counts = self.window_bucket_counts(stem, window_s, now=now)
        total = sum(counts)
        if total <= 0:
            return 0.0
        acc = 0.0
        for i, c in enumerate(counts):
            if c <= 0:
                continue
            if i >= len(HIST_BUCKET_BOUNDS):
                mid = HIST_BUCKET_BOUNDS[-1]       # overflow: floor at top
            else:
                lo = HIST_BUCKET_BOUNDS[i - 1] if i else 0.0
                mid = 0.5 * (lo + HIST_BUCKET_BOUNDS[i])
            acc += c * mid
        return acc / total

    # -- series views (for sparklines) ----------------------------------
    def rate_series(self, key: str, window_s: float,
                    now: Optional[float] = None,
                    max_points: int = 60) -> List[Tuple[float, float]]:
        """Windowed rate evaluated at each stored tick (trailing)."""
        t_now = self._clock() if now is None else float(now)
        with self._lock:
            ticks = list(self._ticks)
        ticks = [t for t in ticks if t <= t_now][-max_points:]
        return [(t, self.rate(key, window_s, now=t)) for t in ticks]

    def percentile_series(self, stem: str, p: float, window_s: float,
                          now: Optional[float] = None,
                          max_points: int = 60) -> List[Tuple[float, float]]:
        t_now = self._clock() if now is None else float(now)
        with self._lock:
            ticks = list(self._ticks)
        ticks = [t for t in ticks if t <= t_now][-max_points:]
        return [(t, self.window_percentile(stem, p, window_s, now=t))
                for t in ticks]

    # -- export ---------------------------------------------------------
    def to_json(self, windows: Sequence[float] = (10.0, 60.0),
                now: Optional[float] = None) -> Dict[str, Any]:
        """Schema served at ``/timeseries.json`` — windowed views only,
        no raw rings (bounded payload regardless of capacity)."""
        t = self._clock() if now is None else float(now)
        hist_stems = set(self.histogram_stems())
        hist_members = set()
        for s in hist_stems:
            hist_members.add(f"{s}.count")
            hist_members.add(f"{s}.mean")
            for p in (50, 95, 99):
                hist_members.add(f"{s}.p{p}")
            for i in range(_N_BUCKETS):
                hist_members.add(f"{s}.le{i}")
        counters: Dict[str, Any] = {}
        gauges: Dict[str, Any] = {}
        for k in self.keys():
            if k in hist_members:
                continue
            if self.key_type(k) == "gauge":
                gauges[k] = {"last": self.last(k), "ewma": self.ewma(k)}
            else:
                counters[k] = {
                    "last": self.last(k),
                    "rate": {f"{w:g}s": self.rate(k, w, now=t)
                             for w in windows},
                }
        hists: Dict[str, Any] = {}
        for s in sorted(hist_stems):
            hists[s] = {
                "count_rate": {f"{w:g}s": (self.window_count(s, w, now=t)
                                           / w) for w in windows},
                **{f"p{p}": {f"{w:g}s": _finite(
                    self.window_percentile(s, p, w, now=t))
                    for w in windows} for p in (50, 95, 99)},
                "mean": {f"{w:g}s": self.window_mean(s, w, now=t)
                         for w in windows},
                "lifetime_p99": self.last(f"{s}.p99"),
            }
        return {
            "now": t,
            "windows": [float(w) for w in windows],
            "n_keys": len(self.keys()),
            "n_points": self.n_points,
            "max_points": self.max_points,
            "dropped_keys": self.dropped_keys,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        }


def _finite(v: float) -> float:
    """JSON has no inf: clamp overflow-bucket percentiles to a sentinel
    (the top histogram bound is ~1e3 s; 1e9 is unambiguous)."""
    return v if math.isfinite(v) else 1e9


class EwmaRate:
    """EWMA per-second rate from a monotone counter, robust to irregular
    update intervals and counter resets (negative deltas clamp to 0)."""

    def __init__(self, halflife_s: float = 5.0):
        self.halflife_s = float(halflife_s)
        self._rate = 0.0
        self._last_v: Optional[float] = None
        self._last_t: Optional[float] = None

    def update(self, value: float, now: float) -> float:
        if self._last_t is None:
            self._last_v, self._last_t = float(value), float(now)
            return self._rate
        dt = now - self._last_t
        if dt <= 0:
            return self._rate
        inst = max(float(value) - self._last_v, 0.0) / dt
        alpha = 1.0 - math.exp(-dt * math.log(2.0) /
                               max(self.halflife_s, 1e-9))
        self._rate += alpha * (inst - self._rate)
        self._last_v, self._last_t = float(value), float(now)
        return self._rate

    @property
    def rate(self) -> float:
        return self._rate


# ----------------------------------------------------------------------
# Per-stage latency attribution from the span tree.

# span name -> dashboard segment (spans whose wall time IS the segment)
_SEGMENT_SPANS = {
    "admission.decide": "admission",
    "router.dispatch": "dispatch",
    "engine.prefill": "prefill",
    "engine.decode_sync": "decode",
    "engine.stream_emit": "stream",
}
# spans that mark the start of replica-side execution: queue time is the
# gap between the transport handing the request off (transport.inflight
# t0) and the first of these
_EXEC_START_SPANS = ("replica.batch", "engine.request", "engine.admit")


class StageAttributor:
    """Derive ``stage.<kind>.<segment>_s`` histograms from the existing
    span tree, so the dashboard shows *where* p99 lives.

    Spans are polled non-destructively (``Tracer.spans()``) so the
    Chrome-trace exporter still sees everything; a bounded seen-set
    dedups across polls.  Segments buffer per trace until the root
    ``request`` span arrives with the backend-kind tag, then flush into
    per-kind and aggregate (``stage.any.*``) histograms; traces whose
    root never shows (dropped from the ring) flush as ``any`` on
    eviction.
    """

    def __init__(self, registry: MetricsRegistry,
                 max_pending: int = 1024, max_seen: int = 65536):
        self.registry = registry
        self._pending: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._max_pending = max_pending
        self._seen: "OrderedDict[Tuple[str, str], None]" = OrderedDict()
        self._max_seen = max_seen
        self._lock = threading.Lock()

    def _entry(self, trace: str) -> Dict[str, Any]:
        e = self._pending.get(trace)
        if e is None:
            e = self._pending[trace] = {
                "segments": [], "inflight_t0": None, "exec_t0": None,
                "kind": None,
            }
            while len(self._pending) > self._max_pending:
                old_trace, old = self._pending.popitem(last=False)
                self._flush(old)
        return e

    def consume(self, spans: Sequence[Dict[str, Any]]) -> None:
        with self._lock:
            for s in spans:
                sid = (s.get("trace"), s.get("span"))
                if sid in self._seen:
                    continue
                self._seen[sid] = None
                while len(self._seen) > self._max_seen:
                    self._seen.popitem(last=False)
                self._ingest(s)

    def _ingest(self, s: Dict[str, Any]) -> None:
        trace = s.get("trace")
        if not trace:
            return
        name = s.get("name", "")
        tags = s.get("tags") or {}
        e = self._entry(trace)
        if name in _SEGMENT_SPANS:
            e["segments"].append((_SEGMENT_SPANS[name],
                                  float(s.get("wall", 0.0))))
        elif name == "transport.inflight":
            t0 = s.get("t0")
            if t0 is not None and (e["inflight_t0"] is None
                                   or t0 < e["inflight_t0"]):
                e["inflight_t0"] = t0
            if tags.get("kind"):
                e["kind"] = str(tags["kind"])
        elif name in _EXEC_START_SPANS:
            t0 = s.get("t0")
            if t0 is not None and (e["exec_t0"] is None
                                   or t0 < e["exec_t0"]):
                e["exec_t0"] = t0
        if name == "request":
            if tags.get("kind"):
                e["kind"] = str(tags["kind"])
            self._pending.pop(trace, None)
            self._flush(e)

    def _flush(self, e: Dict[str, Any]) -> None:
        kind = e.get("kind") or "any"
        segs = list(e["segments"])
        if e["inflight_t0"] is not None and e["exec_t0"] is not None:
            segs.append(("queue",
                         max(e["exec_t0"] - e["inflight_t0"], 0.0)))
        for seg, dur in segs:
            self.registry.histogram(f"stage.any.{seg}_s").observe(dur)
            if kind != "any":
                self.registry.histogram(
                    f"stage.{kind}.{seg}_s").observe(dur)


class TelemetrySampler:
    """Background thread driving the telemetry loop at heartbeat cadence:
    sample ``snapshot_fn()`` into the store, update the EWMA arrival /
    service rate gauges, attribute stage latency from the tracer, and
    tick the SLO engine.  ``tick()`` is public so tests (and the
    ``--watch`` renderer) can drive it deterministically without the
    thread."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, float]],
                 store: TimeSeriesStore,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Any] = None,
                 slo: Optional[Any] = None,
                 period_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        self.snapshot_fn = snapshot_fn
        self.store = store
        self.registry = registry
        self.period_s = float(period_s)
        self.tracer = tracer
        self.slo = slo
        self._clock = clock
        self.arrival = EwmaRate(halflife_s=max(4 * self.period_s, 1.0))
        self.service = EwmaRate(halflife_s=max(4 * self.period_s, 1.0))
        self.attributor = (StageAttributor(registry)
                           if registry is not None else None)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0

    # -- one step (deterministic entry point) ---------------------------
    def tick(self, now: Optional[float] = None) -> Dict[str, float]:
        t = self._clock() if now is None else float(now)
        if self.attributor is not None and self.tracer is not None:
            # attribute first so stage.* stems appear in this snapshot
            self.attributor.consume(self.tracer.spans())
        snap = self.snapshot_fn()
        arrival = self.arrival.update(snap.get("router.submitted", 0.0), t)
        service = self.service.update(
            snap.get("router.finish.total", 0.0), t)
        if self.registry is not None:
            self.registry.gauge("timeseries.arrival_rate_hz").set(arrival)
            self.registry.gauge("timeseries.service_rate_hz").set(service)
            snap = dict(snap)
            snap["timeseries.arrival_rate_hz"] = arrival
            snap["timeseries.service_rate_hz"] = service
        self.store.sample(snap, now=t)
        if self.slo is not None:
            self.slo.tick(self.store, now=t)
        self.ticks += 1
        return snap

    # -- thread ---------------------------------------------------------
    def start(self) -> "TelemetrySampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="telemetry-sampler", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:               # telemetry must never take
                pass                        # the service down with it
            self._stop.wait(self.period_s)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
