"""Service metrics for the port's engine, copied from
``repro.cluster.metrics``: a thread-safe :class:`MetricsRegistry` of
counters (monotonic), gauges (last value) and histograms (bounded
reservoir with exact percentiles over the sample, plus fixed log-spaced
bucket counts).  ``snapshot()`` flattens everything under the same key
names as the JAX package, so the two engines report alike.

The cluster-side helpers of the JAX module (snapshot merging, gauge-key
classification, the worker registry) wait for the port of the cluster
builders (ROADMAP.md, Queue 1, item 4).
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Sequence

import numpy as np

# log-spaced bucket upper bounds (seconds): 1e-4 .. 1e3 at four buckets per
# decade, plus an implicit overflow bucket — the same bounds as the JAX
# package, so snapshots of both engines mean the same thing
HIST_BUCKET_BOUNDS: Sequence[float] = tuple(
    float(10.0 ** (e / 4.0)) for e in range(-16, 13))
_N_BUCKETS = len(HIST_BUCKET_BOUNDS) + 1          # + overflow


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

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bounded reservoir of observations with exact percentiles over the
    retained sample (uniform reservoir replacement once full), plus fixed
    log-spaced bucket counts (:data:`HIST_BUCKET_BOUNDS`)."""

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

    def stats(self) -> Dict[str, Any]:
        """Every derived figure read under ONE lock acquisition."""
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

    # get-or-create without constructing a discarded default per lookup
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

    def snapshot(self) -> Dict[str, float]:
        """Flat view: counters/gauges by name, histograms expanded to
        count/mean/p50/p95/p99 plus their non-empty bucket counts
        (``<name>.le<i>``)."""
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
            st = h.stats()
            out[f"{k}.count"] = st["count"]
            out[f"{k}.mean"] = st["mean"]
            for p in (50, 95, 99):
                out[f"{k}.p{p}"] = st["percentiles"][p]
            for i, n in enumerate(st["buckets"]):
                if n:
                    out[f"{k}.le{i}"] = float(n)
        return out
