"""The port's service front and partition autotuner against the JAX
package: ``core/service.py`` (``MLaaSService``, deadline-slack batching)
and ``core/partitioner.py`` (the mapPartitions cost model).

Both modules are plain Python and numpy in both packages, so every case
of ``tests/test_service.py`` and ``tests/test_optim_partitioner.py`` (and
the service cases of ``tests/test_cluster.py``) runs once over
``repro`` and once over ``repro_torch``, and the outcomes must be the
same.  The deadline-flush case is host-speed-proof: its cost model
overestimates the step tenfold, so the flush leaves ample room before the
deadline however loaded the host is.
"""
import importlib
import time

import numpy as np
import pytest

pytest.importorskip("torch")

PKGS = ("repro", "repro_torch")


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.service = importlib.import_module(f"{name}.core.service")
        self.partitioner = importlib.import_module(
            f"{name}.core.partitioner")
        self.cluster = importlib.import_module(f"{name}.cluster")


@pytest.fixture(params=PKGS)
def pkg(request):
    return _Pkg(request.param)


def _echo(cluster, delay=0.0):
    def step(payloads):
        if delay:
            time.sleep(delay)
        return [p * 2 for p in payloads]
    return cluster.FnBackend(step)


# ----------------------------------------------------------------------
# tests/test_service.py

def test_service_batches_and_completes(pkg):
    calls = []

    def step(payloads):
        calls.append(len(payloads))
        return [p * 2 for p in payloads]

    svc = pkg.service.MLaaSService(step, capacity=4).start()
    reqs = [svc.submit(i, timeout_s=2.0) for i in range(10)]
    for r in reqs:
        assert r.done.wait(5.0)
    svc.stop()
    assert [r.result for r in reqs] == [2 * i for i in range(10)]
    assert svc.stats["requests"] == 10
    assert max(calls) <= 4


def test_idle_service_does_not_busy_poll(pkg):
    MLaaSService = pkg.service.MLaaSService
    svc = MLaaSService(lambda ps: ps, capacity=4).start()
    time.sleep(0.3)
    wakeups_idle = svc.metrics.counter("service.loop_wakeups").value
    assert wakeups_idle <= 25, \
        f"idle loop woke {wakeups_idle}x in 0.3s — still busy-polling"
    r = svc.submit("late", timeout_s=2.0)
    assert r.done.wait(3.0) and r.result == "late"
    t0 = time.monotonic()
    svc.stop()
    assert time.monotonic() - t0 < MLaaSService.IDLE_WAIT_CAP_S + 1.0


def test_service_flushes_on_deadline_slack(pkg):
    """A lone request in a service of capacity 64 is dispatched by the
    deadline policy, alone, after the policy waited, and well inside its
    deadline.  The cost model says 0.5 s for a step that takes 0.05 s, so
    the policy dispatches ~0.5 s before the deadline: a host that is slow
    by hundreds of milliseconds still meets it."""
    dispatched = []

    def step(payloads):
        dispatched.append((time.monotonic(), len(payloads)))
        time.sleep(0.05)
        return payloads

    model = pkg.partitioner.fit_cost_model([1, 4], [0.5, 0.5])
    assert model.time(1) == pytest.approx(0.5)
    svc = pkg.service.MLaaSService(step, capacity=64,
                                   cost_model=model).start()
    r = svc.submit("only-one", timeout_s=2.0)
    assert r.done.wait(5.0), "lone request must flush before its deadline"
    svc.stop()
    assert r.result == "only-one" and not r.missed_deadline
    (t_dispatch, n), = dispatched
    assert n == 1 and svc.mean_batch() == 1
    waited = t_dispatch - r.submitted_s
    assert waited >= 0.75, f"dispatched after {waited:.3f}s: no wait"
    assert r.deadline_s - t_dispatch >= 0.25, \
        f"dispatched {r.deadline_s - t_dispatch:.3f}s before the deadline"


# ----------------------------------------------------------------------
# the service cases of tests/test_cluster.py

def test_service_front_targets_router(pkg):
    r = pkg.cluster.Router(policy="round_robin")
    for _ in range(2):
        r.add_replica(_echo(pkg.cluster))
    svc = pkg.service.MLaaSService(router=r, capacity=4).start()
    reqs = [svc.submit(i, timeout_s=5.0) for i in range(12)]
    for q in reqs:
        assert q.done.wait(5.0)
    svc.stop()
    r.stop()
    assert [q.result for q in reqs] == [2 * i for i in range(12)]
    assert svc.stats["requests"] == 12


def test_service_needs_exactly_one_backend(pkg):
    MLaaSService = pkg.service.MLaaSService
    with pytest.raises(ValueError):
        MLaaSService()
    with pytest.raises(ValueError):
        MLaaSService(lambda ps: ps, router=pkg.cluster.Router())


def test_service_stop_drains_pending(pkg):
    slow = lambda ps: (time.sleep(0.05), [p * 2 for p in ps])[1]  # noqa
    svc = pkg.service.MLaaSService(slow, capacity=2).start()
    reqs = [svc.submit(i, timeout_s=30.0) for i in range(8)]
    svc.stop(drain=True)
    for q in reqs:
        assert q.done.wait(1.0), "stop() stranded a pending request"
    assert [q.result for q in reqs] == [2 * i for i in range(8)]


def test_service_stop_failfast_rejects_pending(pkg):
    slow = lambda ps: (time.sleep(0.2), [p for p in ps])[1]  # noqa
    svc = pkg.service.MLaaSService(slow, capacity=1).start()
    reqs = [svc.submit(i, timeout_s=30.0) for i in range(6)]
    time.sleep(0.05)
    svc.stop(drain=False)
    for q in reqs:
        assert q.done.wait(1.0), "stop(drain=False) stranded a request"
    rejected = [q for q in reqs if q.rejected]
    assert rejected, "pending requests must be failed fast on shutdown"
    assert all(q.result.reason == "shutdown" for q in rejected)
    late = svc.submit(99)
    assert late.done.is_set() and late.rejected


def test_service_step_error_fails_batch_but_not_the_loop(pkg):
    def flaky(ps):
        if any(p < 0 for p in ps):
            raise RuntimeError("backend OOM")
        return [p * 2 for p in ps]

    svc = pkg.service.MLaaSService(flaky, capacity=4).start()
    bad = [svc.submit(-i - 1, timeout_s=2.0) for i in range(4)]
    for q in bad:
        assert q.done.wait(5.0), "failed batch must not strand callers"
    assert all(q.rejected and q.result.reason == "step_error" for q in bad)
    ok = svc.submit(21, timeout_s=2.0)
    assert ok.done.wait(5.0) and ok.result == 42
    svc.stop()


# ----------------------------------------------------------------------
# tests/test_optim_partitioner.py (the autotuner half)

@pytest.mark.parametrize("o, c", [(1e-4, 1e-6), (3e-3, 2e-4), (0.1, 1e-3)])
def test_cost_model_recovers_synthetic(pkg, o, c):
    sizes = [1, 2, 4, 8, 16, 32]
    times = [o + c * m for m in sizes]
    model = pkg.partitioner.fit_cost_model(sizes, times)
    assert abs(model.overhead_s - o) / o < 0.05
    assert abs(model.per_item_s - c) / c < 0.05
    assert model.r2 > 0.999


def test_choose_partition_size_tradeoff(pkg):
    part = pkg.partitioner
    model = part.fit_cost_model([1, 16], [0.1 + 1e-3, 0.1 + 16e-3])
    m = part.choose_partition_size(model, latency_budget_s=1.0,
                                   target_efficiency=0.8)
    assert model.efficiency(m) >= 0.8
    assert model.time(m) <= 1.0
    m_tight = part.choose_partition_size(model, latency_budget_s=0.2,
                                         target_efficiency=0.8)
    assert m_tight <= m


def test_measure_step_runs(pkg):
    def fake_step(m):
        time.sleep(0.001 + m * 1e-5)

    model = pkg.partitioner.measure_step(fake_step, [1, 8, 32], warmup=0,
                                         repeats=1)
    assert model.per_item_s > 0


def test_partitioner_equals_the_jax_package():
    """Same noisy measurements, same fit and the same chosen sizes."""
    from repro.core import partitioner as jp
    from repro_torch.core import partitioner as tp
    rng = np.random.RandomState(0)
    sizes = [3, 6, 12, 24, 48]
    times = [2e-3 + 1.5e-4 * m + rng.uniform(0, 2e-4) for m in sizes]
    a, b = jp.fit_cost_model(sizes, times), tp.fit_cost_model(sizes, times)
    assert (a.overhead_s, a.per_item_s, a.r2) == \
        (b.overhead_s, b.per_item_s, b.r2)
    for budget in (0.005, 0.01, 0.25):
        for eff in (0.5, 0.8, 0.95):
            assert jp.choose_partition_size(
                a, latency_budget_s=budget, target_efficiency=eff) == \
                tp.choose_partition_size(
                    b, latency_budget_s=budget, target_efficiency=eff)
