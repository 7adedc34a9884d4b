"""mapPartitions analogue (paper §3.1 challenge #3, §3.2 trade-off), copied
from ``repro.core.partitioner``.

On Spark the knob is partition size: model loading is paid once per
partition, but oversized partitions lose parallelism.  On the card the
per-call cost is kernel launches + weight streaming from HBM, amortized
by micro-batch size; oversized micro-batches lose latency and (for
streams) fall behind the period.  The autotuner measures the step at a few sizes, fits the linear
cost model  t(m) = overhead + per_item * m,  and picks the smallest size
whose efficiency (per-item share of the call) exceeds a target while meeting
a latency budget — the quantitative form of the paper's recommendation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class CostModel:
    overhead_s: float        # fixed per-call cost ("model load")
    per_item_s: float        # marginal per-instance cost
    r2: float                # fit quality

    def time(self, m: int) -> float:
        return self.overhead_s + self.per_item_s * m

    def efficiency(self, m: int) -> float:
        t = self.time(m)
        return (self.per_item_s * m) / t if t > 0 else 0.0

    def throughput(self, m: int) -> float:
        return m / self.time(m)


def fit_cost_model(sizes: Sequence[int], times: Sequence[float]) -> CostModel:
    x = np.asarray(sizes, np.float64)
    y = np.asarray(times, np.float64)
    A = np.stack([np.ones_like(x), x], axis=1)
    (b, c), *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = A @ np.array([b, c])
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1.0
    return CostModel(max(b, 0.0), max(c, 1e-12), 1.0 - ss_res / ss_tot)


def measure_step(step_fn: Callable[[int], None], sizes: Sequence[int],
                 warmup: int = 1, repeats: int = 3) -> CostModel:
    """step_fn(m) runs (and blocks on) one call with micro-batch size m:
    on the card it must synchronize before it returns."""
    times: List[float] = []
    for m in sizes:
        for _ in range(warmup):
            step_fn(m)
        t0 = time.perf_counter()
        for _ in range(repeats):
            step_fn(m)
        times.append((time.perf_counter() - t0) / repeats)
    return fit_cost_model(sizes, times)


def choose_partition_size(model: CostModel, *, latency_budget_s: float,
                          target_efficiency: float = 0.8,
                          max_size: int = 1 << 16) -> int:
    """Smallest m with efficiency >= target, subject to t(m) <= budget;
    falls back to the largest m inside the budget."""
    m = 1
    while m <= max_size:
        if model.efficiency(m) >= target_efficiency and \
                model.time(m) <= latency_budget_s:
            return m
        m *= 2
    # budget-bound fallback
    m_budget = int((latency_budget_s - model.overhead_s) / model.per_item_s)
    return max(1, min(m_budget, max_size))
