"""Unified service metrics, copied from ``repro.cluster.metrics`` (paper
§6: the evaluation reports rates, latency and fall-behind — production
MLaaS needs the same signals live).

One thread-safe :class:`MetricsRegistry` replaces the ad-hoc ``stats`` dicts
that ``MLaaSService``, ``Engine`` and ``StreamRuntime`` each grew on their
own: counters (monotonic), gauges (last value), and histograms (bounded
reservoir, exact percentiles over the sample).  Every cluster component
(router, replicas, admission controller, autoscaler) reports into the same
registry so a single ``snapshot()`` describes the whole service.
"""
from __future__ import annotations

import bisect
import re
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# Shared log-spaced histogram bucket upper bounds (seconds): 1e-4 .. 1e3 at
# four buckets per decade (resolution factor 10^(1/4) ~ 1.78x), plus an
# implicit overflow bucket — the top must clear a worker's first batch
# (minutes: interpreter start, weights, kernel builds).  Fixed module-wide
# so worker-side snapshots and the router-side registry always agree on
# bucket meaning — that is what makes cluster-wide percentile *merging*
# exact up to bucket resolution (``merge_snapshots``), instead of the old
# max-across-workers upper bound.
HIST_BUCKET_BOUNDS: Sequence[float] = tuple(
    float(10.0 ** (e / 4.0)) for e in range(-16, 13))
_N_BUCKETS = len(HIST_BUCKET_BOUNDS) + 1          # + overflow
_BUCKET_KEY_RE = re.compile(r"^(?P<stem>.+)\.le(?P<i>\d+)$")

# ----------------------------------------------------------------------
# Flat snapshots erase metric types — every consumer that needs to treat
# a key as "level" rather than "monotone count" (departed-replica
# retention in Router.cluster_snapshot, TimeSeriesStore windowing) has to
# re-derive them, so the classification lives here, next to the metrics
# themselves.  Histogram-derived keys are recognized structurally; gauges
# by name.  Everything else is a counter.
GAUGE_KEYS = frozenset({
    "engine.kv_blocks_total", "engine.kv_blocks_free",
    "engine.kv_blocks_cached",
    "router.replicas", "router.queue_depth", "router.brownout_level",
    "service.queue_depth", "stream.falling_behind",
    "autoscaler.depth_per_replica",
})
GAUGE_PREFIXES = ("slo.", "timeseries.")
_HIST_DERIVED_SUFFIXES = (".mean", ".p50", ".p95", ".p99")


def is_gauge_key(key: str) -> bool:
    """True for keys that carry a *level* (last-value semantics): named
    gauges and the histogram-derived mean/percentile keys.  Histogram
    ``.count``/``.le<i>`` keys and plain counters are monotone and return
    False."""
    if key in GAUGE_KEYS or key.startswith(GAUGE_PREFIXES):
        return True
    return key.endswith(_HIST_DERIVED_SUFFIXES)


def terminal_snapshot_view(snap: Dict[str, float]) -> Dict[str, float]:
    """What of a departed replica's final snapshot stays in the cluster
    merge: monotone counters, histogram ``.count``/``.le<i>`` buckets and
    ``.mean`` s (the count-weighted mean merge stays correct).  Levels
    drop — a dead replica holds no queue depth or KV blocks, and
    retaining its gauges would inflate cluster capacity forever — and so
    do lifetime percentiles, whose max-merge would otherwise pin the
    cluster tail to a corpse's worst sample."""
    return {k: v for k, v in snap.items()
            if k.endswith(".mean") or not is_gauge_key(k)}


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._value += dv

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bounded reservoir of observations with exact percentiles over the
    retained sample (uniform reservoir replacement once full), plus fixed
    log-spaced bucket counts (:data:`HIST_BUCKET_BOUNDS`) so snapshots can
    be *merged* across workers with bucket-resolution percentiles."""

    __slots__ = ("_samples", "_count", "_sum", "_cap", "_rng", "_lock",
                 "_buckets")

    def __init__(self, cap: int = 4096):
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._cap = cap
        self._rng = np.random.RandomState(0)
        self._lock = threading.Lock()
        self._buckets = [0] * _N_BUCKETS

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            self._buckets[bisect.bisect_left(HIST_BUCKET_BOUNDS,
                                             float(v))] += 1
            if len(self._samples) < self._cap:
                self._samples.append(float(v))
            else:                     # reservoir: keep each obs w.p. cap/count
                j = self._rng.randint(self._count)
                if j < self._cap:
                    self._samples[j] = float(v)

    def bucket_counts(self) -> List[int]:
        with self._lock:
            return list(self._buckets)

    # count/sum/mean take the lock: `observe` mutates ``_count`` and
    # ``_sum`` as two separate writes, so lock-free reads could pair a
    # post-observe count with a pre-observe sum (a torn read that shows
    # up as a wrong mean under concurrent load).
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            return float(np.percentile(np.asarray(self._samples), p))

    def stats(self) -> Dict[str, Any]:
        """Every derived figure read under ONE lock acquisition, so a
        snapshot's count/mean/percentiles/buckets describe the same set of
        observations (separate property reads interleave with writers)."""
        with self._lock:
            count, total = self._count, self._sum
            if self._samples:
                pct = np.percentile(np.asarray(self._samples), (50, 95, 99))
                pct = {50: float(pct[0]), 95: float(pct[1]),
                       99: float(pct[2])}
            else:
                pct = {50: 0.0, 95: 0.0, 99: 0.0}
            return {"count": count, "sum": total,
                    "mean": total / count if count else 0.0,
                    "percentiles": pct, "buckets": list(self._buckets)}


class MetricsRegistry:
    """Create-or-get named metrics; ``snapshot()`` flattens everything."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def _key(self, name: str) -> str:
        return f"{self.prefix}{name}" if self.prefix else name

    # get-or-create without eagerly constructing the default:
    # ``setdefault(k, Histogram())`` would build (and discard) a fresh
    # metric on every hot-path lookup — Histogram.__init__ alone seeds a
    # RandomState, ~0.1ms per call inside the serving engine's finish path
    def counter(self, name: str) -> Counter:
        k = self._key(name)
        with self._lock:
            c = self._counters.get(k)
            if c is None:
                c = self._counters[k] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        k = self._key(name)
        with self._lock:
            g = self._gauges.get(k)
            if g is None:
                g = self._gauges[k] = Gauge()
            return g

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        k = self._key(name)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Histogram(cap)
            return h

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.histogram(name).observe(time.perf_counter() - t0)

    def snapshot(self) -> Dict[str, float]:
        """Flat view: counters/gauges by name, histograms expanded to
        count/mean/p50/p95/p99 plus their non-empty bucket counts
        (``<name>.le<i>`` against :data:`HIST_BUCKET_BOUNDS`), which is
        what lets ``merge_snapshots`` combine percentiles exactly."""
        out: Dict[str, float] = {}
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        for k, c in counters.items():
            out[k] = c.value
        for k, g in gauges.items():
            out[k] = g.value
        for k, h in hists.items():
            st = h.stats()              # one lock: a consistent view
            out[f"{k}.count"] = st["count"]
            out[f"{k}.mean"] = st["mean"]
            for p in (50, 95, 99):
                out[f"{k}.p{p}"] = st["percentiles"][p]
            for i, n in enumerate(st["buckets"]):
                if n:
                    out[f"{k}.le{i}"] = float(n)
        return out

    def report(self) -> str:
        snap = self.snapshot()
        return "\n".join(f"{k}={snap[k]:.6g}" for k in sorted(snap))


def bucket_percentile(counts: Sequence[float], p: float) -> float:
    """Percentile estimate from :data:`HIST_BUCKET_BOUNDS` bucket counts,
    linearly interpolated within the containing bucket (exact up to the
    10^(1/4)x bucket resolution).  A percentile landing in the overflow
    bucket returns ``inf`` — the buckets cannot bound it, and the caller
    falls back to a conservative estimate rather than under-reporting the
    tail."""
    total = float(sum(counts))
    if total <= 0:
        return 0.0
    target = (p / 100.0) * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            if i >= len(HIST_BUCKET_BOUNDS):      # overflow bucket
                return float("inf")
            lo = HIST_BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
            hi = HIST_BUCKET_BOUNDS[i]
            return float(lo + (hi - lo) * max(target - cum, 0.0) / c)
        cum += c
    return float("inf")


def merge_snapshots(base: Dict[str, float],
                    worker_snaps: List[Dict[str, float]]) -> Dict[str, float]:
    """Aggregate worker-side snapshots into one cluster view.

    Remote replicas cannot write into the parent's registry, so they ship
    ``snapshot()`` dicts over the heartbeat channel and the parent merges:
    counters/gauges, histogram ``.count`` s and bucket ``.le<i>`` counts
    sum; histogram ``.mean`` s combine count-weighted.

    Percentile merging is decided *per stem*, deterministically, from the
    full contributor set (base + every worker) before anything merges: a
    stem whose every non-empty contributor ships bucket counts gets its
    percentiles recomputed from the summed buckets — a true cluster-wide
    percentile up to bucket resolution — while a stem with even one
    legacy contributor (observations but no ``.le<i>`` keys) keeps the
    conservative max-across-contributors upper bound for ALL of its
    contributors.  Recomputing such a stem from its partial bucket sums
    would ignore the legacy workers' observations entirely and could
    report a percentile *below* data the merge has already seen.
    """
    out = dict(base)
    # classify stems over every contributor first (order-independent):
    # bucketed = ships .le<i> keys; legacy = has observations but no
    # buckets.  An empty histogram (count 0) ships no buckets by design
    # and must not demote its stem to legacy.
    bucketed_stems: set = set()
    legacy_stems: set = set()
    for snap in [base] + list(worker_snaps):
        with_buckets = {m.group("stem") for k in snap
                        if (m := _BUCKET_KEY_RE.match(k))}
        bucketed_stems |= with_buckets
        for k, v in snap.items():
            if k.endswith(".count") and v > 0 and \
                    k[:-len(".count")] not in with_buckets:
                legacy_stems.add(k[:-len(".count")])
    recompute_stems = bucketed_stems - legacy_stems
    for snap in worker_snaps:
        # counts *before* this worker is merged, for mean re-weighting
        pre = {k: out.get(k, 0.0) for k in snap if k.endswith(".count")}
        for k, v in snap.items():
            if k not in out:
                out[k] = v
            elif k.endswith((".p50", ".p95", ".p99")):
                out[k] = max(out[k], v)
            elif k.endswith(".mean"):
                stem = k[:-len(".mean")]
                n_out = pre.get(f"{stem}.count", 0.0)
                n_new = snap.get(f"{stem}.count", 0.0)
                total = n_out + n_new
                out[k] = (out[k] * n_out + v * n_new) / total if total \
                    else 0.0
            else:
                out[k] = out[k] + v
    for stem in recompute_stems:
        counts = [out.get(f"{stem}.le{i}", 0.0) for i in range(_N_BUCKETS)]
        if sum(counts) <= 0:
            continue
        for p in (50, 95, 99):
            est = bucket_percentile(counts, p)
            if est != float("inf"):
                out[f"{stem}.p{p}"] = est
            # overflow: keep the max-merged value already in `out` — an
            # observation beyond the last bound (e.g. a first-batch
            # compile) must not be *under*-reported as the bound itself
    return out


_NULL: Optional[MetricsRegistry] = None


def null_registry() -> MetricsRegistry:
    """Shared sink for components constructed without an explicit registry."""
    global _NULL
    if _NULL is None:
        _NULL = MetricsRegistry()
    return _NULL


# ----------------------------------------------------------------------
# The registry a remote worker ships over its heartbeat channel.  Workers
# rebuild their backend from a BackendSpec, which cannot carry a live
# registry — so the worker entry points publish theirs here before
# ``spec.build()`` and builders adopt it.  Without this, backend-level
# metrics (``engine.*`` counters, the paged-KV ``engine.kv_blocks_*``
# gauges the admission headroom gate reads) would sit in a private
# registry no heartbeat ever sees.
_WORKER_REGISTRY: Optional[MetricsRegistry] = None


def set_worker_registry(registry: Optional[MetricsRegistry]) -> None:
    global _WORKER_REGISTRY
    _WORKER_REGISTRY = registry


def worker_registry() -> Optional[MetricsRegistry]:
    """The heartbeat-shipped registry of this worker process, if any."""
    return _WORKER_REGISTRY
