"""The port's telemetry against the JAX package's: the time-series store,
the SLO burn-rate engine, the dashboard and stats server, the autoscaler
and the serve driver's stats flags.

These modules are plain Python over the cluster snapshot, copied from
``repro.cluster``.  So the parity checks feed the same seeded snapshot
sequences (numpy) and the same fake clock into both packages and require
equal outputs: windowed rates, increases, percentiles, EWMAs, the
``/timeseries.json`` and ``/slo.json`` payloads, alert transitions,
brownout pressure, ``render_watch``'s text and the autoscalers'
``ScaleEvent`` sequences.  Then the cases of tests/test_timeseries.py and
the autoscaler cases of tests/test_cluster.py and tests/test_transport.py
run on the port.  Every thread, server and replica a test starts is
stopped in a ``finally``; timed behaviour is driven by ``tick()`` on a fake
clock, never asserted after a sleep.
"""
import importlib
import io
import json
import threading
import time
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.cluster import (Autoscaler, AutoscalerConfig,  # noqa: E402
                                 FnBackend, MetricsRegistry, ReplicaConfig,
                                 Router, Status, echo_spec, prometheus_text)
from repro_torch.cluster.metrics import is_gauge_key  # noqa: E402
from repro_torch.cluster.slo import SLOEngine  # noqa: E402
from repro_torch.cluster.slo import \
    test_scaled_objective as scaled_objective  # noqa: E402
from repro_torch.cluster.timeseries import (EwmaRate,  # noqa: E402
                                            TelemetrySampler,
                                            TimeSeriesStore)
from repro_torch.cluster.tracing import FlightRecorder  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

#: one 10^(1/4)x histogram bucket — the documented resolution bound
BUCKET_FACTOR = 10.0 ** 0.25
PROC_CFG = ReplicaConfig(inbox_capacity=256, max_batch=4)
PKGS = ("repro", "repro_torch")
WINDOWS = (0.5, 2.0, 10.0)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class _Pkg:
    """One package's telemetry modules, by name."""

    def __init__(self, name):
        self.name = name
        self.cluster = importlib.import_module(f"{name}.cluster")
        for mod in ("timeseries", "slo", "dashboard", "tracing"):
            setattr(self, mod, importlib.import_module(f"{name}.cluster.{mod}"))


def _pkgs():
    return [_Pkg(n) for n in PKGS]


def gated(event: threading.Event, cls=FnBackend):
    def step(payloads):
        assert event.wait(10.0), "gate never opened"
        return [p * 2 for p in payloads]
    return cls(step)


# ----------------------------------------------------------------------
# parity: the same snapshots and clock through both packages

def _snapshots(n_ticks=60, seed=0):
    """A seeded sequence of (t, flat snapshot): counters that grow, one
    that resets (a restarted worker), a key that appears mid-stream, a
    latency histogram with a slow burst, gauges, and non-numeric values
    the store must skip.  Snapshots come from a ``MetricsRegistry``, as
    ``cluster_snapshot()`` builds them."""
    rng = np.random.RandomState(seed)
    reg = MetricsRegistry()
    lat = reg.histogram("router.latency_s")
    ttft = reg.histogram("engine.ttft_s")
    counters = {k: reg.counter(k) for k in (
        "router.submitted", "router.finish.total", "router.finish.deadline",
        "router.finish.cancelled", "engine.tokens")}
    t, restarted, out = 0.0, 0.0, []
    for i in range(n_ticks):
        t += float(rng.uniform(0.05, 0.3))
        n = int(rng.randint(0, 12))
        slow = 20 <= i < 30
        for _ in range(n):
            lat.observe(float(np.exp(rng.uniform(np.log(1e-3),
                                                 np.log(8.0 if slow
                                                        else 0.5)))))
            ttft.observe(float(rng.uniform(0.001, 0.2)))
        counters["router.submitted"].inc(n + int(rng.randint(0, 3)))
        counters["router.finish.total"].inc(n)
        counters["router.finish.deadline"].inc(
            int(rng.randint(0, n + 1)) if 35 <= i < 42 else 0)
        counters["router.finish.cancelled"].inc(int(rng.randint(0, 2)))
        counters["engine.tokens"].inc(32 * n)
        reg.gauge("router.replicas").set(float(1 + (i // 15) % 3))
        reg.gauge("router.queue_depth").set(float(rng.randint(0, 40)))
        snap = reg.snapshot()
        restarted = 0.0 if i == 40 else restarted + n   # reset at tick 40
        snap["worker.restarted"] = restarted
        if i >= 25:
            snap["late.counter"] = float(3 * (i - 24))
        snap["flag"] = True
        snap["label"] = "replica-1"
        out.append((t, snap))
    return out


def _store_reading(ts, store, t):
    """Every read the store offers, at time ``t``."""
    keys = sorted(store.keys())
    stems = store.histogram_stems()
    out = {
        "keys": keys, "stems": stems, "n_points": store.n_points,
        "types": {k: ts.TimeSeriesStore.key_type(k) for k in keys},
        "json": store.to_json(windows=WINDOWS, now=t),
    }
    for k in keys:
        out[k] = ([store.rate(k, w, now=t) for w in WINDOWS] +
                  [store.increase(k, w, now=t) for w in WINDOWS] +
                  [store.ewma(k, 2.0, now=t), store.last(k)])
    for s in stems:
        out[s] = ([store.window_percentile(s, p, w, now=t)
                   for p in (50, 90, 99) for w in WINDOWS] +
                  [store.window_mean(s, w, now=t) for w in WINDOWS] +
                  [store.window_count(s, w, now=t) for w in WINDOWS])
    out["series"] = (store.rate_series("router.submitted", 1.0, now=t) +
                     store.percentile_series("router.latency_s", 99, 1.0,
                                             now=t))
    return out


def test_store_equals_jax_on_seeded_snapshots():
    """rate, increase, window_percentile, window_mean, ewma, the series
    views and ``to_json`` are equal, every tick, through a counter reset,
    a key appearing mid-stream, and the ring wrapping (capacity 32)."""
    pk = _pkgs()
    clocks = [FakeClock() for _ in pk]
    stores = [p.timeseries.TimeSeriesStore(capacity=32, max_stems=36,
                                           clock=c)
              for p, c in zip(pk, clocks)]
    for i, (t, snap) in enumerate(_snapshots()):
        for c, store in zip(clocks, stores):
            c.t = t
            store.sample(dict(snap))
        if i % 5 == 4:
            readings = [_store_reading(p.timeseries, s, t)
                        for p, s in zip(pk, stores)]
            assert readings[1] == readings[0], i
    assert stores[1].dropped_keys == stores[0].dropped_keys > 0
    assert stores[1].n_points <= stores[1].max_points


def _slo_pair(objectives):
    pk = _pkgs()
    clock = FakeClock()
    rigs = []
    for p in pk:
        reg = p.cluster.MetricsRegistry()
        rec = p.tracing.FlightRecorder()
        store = p.timeseries.TimeSeriesStore(clock=clock)
        slo = p.slo.SLOEngine([o(p) for o in objectives], reg, recorder=rec,
                              clock=clock)
        rigs.append((p, reg, rec, store, slo))
    return clock, rigs


def _events(rec):
    return [{k: v for k, v in e.items() if k not in ("seq", "t", "wall")}
            for e in rec.events()]


def test_slo_engine_equals_jax_on_seeded_snapshots():
    """``status()``, ``pressure()``, ``firing()``, the ``slo.*`` gauges and
    the fired / cleared transitions (FlightRecorder events) are equal
    every tick, for the scaled objective and the default one, through a
    latency burst and a deadline-miss burst."""
    clock, rigs = _slo_pair([
        lambda p: p.slo.test_scaled_objective(),
        lambda p: p.slo.test_scaled_objective(
            kind="lm", fast_s=0.6, slow_s=2.0, threshold=3.0,
            latency_threshold_s=0.25),
        lambda p: p.slo.SLOObjective(kind="default")])
    transitions = 0
    for t, snap in _snapshots(n_ticks=90, seed=3):
        clock.t = t
        got = []
        for p, reg, rec, store, slo in rigs:
            store.sample(dict(snap))
            slo.tick(store)
            gauges = {k: v for k, v in reg.snapshot().items()
                      if k.startswith("slo.")}
            got.append((slo.status(), slo.pressure(), sorted(slo.firing()),
                        gauges, _events(rec)))
        assert got[1] == got[0], t
        transitions = len(got[0][4])
    assert transitions >= 2          # the bursts fired and cleared alerts
    kinds = {e["kind"] for e in _events(rigs[1][2])}
    assert kinds == {"slo_burn_fired", "slo_burn_cleared"}


def test_render_watch_and_dash_equal_jax():
    """The terminal screen and the ``/dash`` page are the same text from
    the same store and SLO status."""
    clock, rigs = _slo_pair([lambda p: p.slo.test_scaled_objective()])
    texts = []
    for t, snap in _snapshots(n_ticks=40, seed=5):
        clock.t = t
        for p, reg, rec, store, slo in rigs:
            snap = dict(snap, **{"timeseries.arrival_rate_hz": t,
                                 "timeseries.service_rate_hz": 0.5 * t})
            store.sample(snap)
            slo.tick(store)
    for p, reg, rec, store, slo in rigs:
        texts.append((p.dashboard.render_watch(store, slo.status()),
                      p.dashboard.render_watch(store, None, window_s=2.0),
                      p.dashboard.render_dash(store, slo.status(),
                                              window_s=2.0)))
    assert texts[1] == texts[0]
    assert "FIRING" in texts[1][0] or " ok " in texts[1][0]
    assert "router.latency_s" in texts[1][0]


def _spans(seed=2):
    """Finished spans of 12 traces as the tracer records them: the root
    ``request`` span with a backend kind, the transport hand-off, replica
    execution and engine stages, in an order that splits some traces over
    two polls."""
    rng = np.random.RandomState(seed)
    spans = []
    for i in range(12):
        trace, t = f"t{i}", float(i)
        kind = ("lm", "svm", None)[i % 3]
        seq = [("admission.decide", {}), ("router.dispatch", {}),
               ("transport.inflight", {"kind": kind} if kind else {}),
               ("replica.batch", {}), ("engine.prefill", {}),
               ("engine.decode_sync", {}), ("engine.decode_sync", {}),
               ("request", {"kind": kind} if kind else {})]
        if i == 7:
            seq.pop()                      # a root that never arrives
        for j, (name, tags) in enumerate(seq):
            d = float(rng.uniform(1e-4, 0.3))
            spans.append({"trace": trace, "span": f"{i}.{j}",
                          "parent": None, "name": name, "t0": t,
                          "t1": t + d, "wall": d, "replica": "parent",
                          "tags": dict(tags)})
            t += d
    return spans


def test_sampler_and_stage_attribution_equal_jax():
    """``TelemetrySampler.tick`` over the same snapshots and spans: the
    EWMA arrival / service gauges, the ``stage.*`` histograms attributed
    from the span tree (spans re-polled, a trace split over polls, one
    root missing) and the store are equal."""
    spans = _spans()
    snaps = _snapshots(n_ticks=12, seed=7)

    class Tracer:                          # the tracer's ring, polled
        def __init__(self):
            self.n = 0

        def spans(self):
            return spans[:self.n]

    rigs = []
    for p in _pkgs():
        clock = FakeClock()
        reg = p.cluster.MetricsRegistry()
        store = p.timeseries.TimeSeriesStore(clock=clock)
        tracer = Tracer()
        it = iter(snaps)
        sampler = p.timeseries.TelemetrySampler(
            lambda it=it: dict(next(it)[1]), store, registry=reg,
            tracer=tracer, period_s=0.25, clock=clock)
        rigs.append((clock, reg, store, tracer, sampler))
    for i, (t, _) in enumerate(snaps):
        for clock, reg, store, tracer, sampler in rigs:
            clock.t = t
            tracer.n = min(len(spans), 9 * (i + 1))
            sampler.tick()
    readings = [(sorted(reg.snapshot().items()),
                 store.to_json(windows=WINDOWS), sampler.ticks)
                for clock, reg, store, tracer, sampler in rigs]
    assert readings[1] == readings[0]
    snap = dict(readings[1][0])
    assert snap["timeseries.arrival_rate_hz"] > 0
    assert snap["stage.lm.decode_s.count"] == 8        # 4 traces x 2
    assert snap["stage.any.queue_s.count"] > 0


def _scale_run(p, clock, replica_cls):
    """tests/test_cluster.py's up-on-pressure, down-when-idle case on
    package ``p``: the ScaleEvents it gives."""
    gate = threading.Event()
    r = p.cluster.Router(policy="least_loaded")
    cfg = p.cluster.AutoscalerConfig(
        min_replicas=1, max_replicas=3, scale_up_depth=4.0,
        scale_down_depth=0.5, cooldown_s=1.0, idle_ticks_to_drain=2,
        replica_cfg=p.cluster.ReplicaConfig(inbox_capacity=256))
    try:
        r.add_replica(gated(gate, replica_cls), cfg.replica_cfg)
        sc = p.cluster.Autoscaler(r, lambda: gated(gate, replica_cls), cfg,
                                  clock=clock)
        reqs = [r.submit(i) for i in range(20)]
        sc.tick()
        sc.tick()
        clock.t += 2.0
        sc.tick()
        clock.t += 2.0
        sc.tick()
        gate.set()
        for q in reqs:
            assert q.done.wait(10.0)
        for _ in range(6):
            clock.t += 2.0
            sc.tick()
        return [(e.t, e.action, e.n_replicas, e.reason) for e in sc.events]
    finally:
        gate.set()
        r.stop()


def test_autoscaler_events_equal_jax():
    runs = [_scale_run(p, FakeClock(), p.cluster.FnBackend) for p in _pkgs()]
    assert runs[1] == runs[0]
    assert [e[1] for e in runs[1]] == ["up", "up", "down", "down"]


def test_fall_behind_events_equal_jax():
    runs = []
    for p in _pkgs():
        r = p.cluster.Router()
        try:
            r.add_replica(gated(threading.Event(), p.cluster.FnBackend))
            clock = FakeClock()
            behind = iter([True, False, True, True])
            sc = p.cluster.Autoscaler(
                r, lambda: p.cluster.FnBackend(lambda ps: ps),
                p.cluster.AutoscalerConfig(max_replicas=3, cooldown_s=0.5),
                fall_behind=lambda: next(behind), clock=clock)
            for _ in range(4):
                sc.tick()
                clock.t += 0.6
            runs.append([(e.t, e.action, e.n_replicas, e.reason)
                         for e in sc.events])
        finally:
            r.stop()
    assert runs[1] == runs[0]
    assert [e[3] for e in runs[1]] == ["fall_behind", "fall_behind"]


@pytest.mark.parametrize("name", PKGS)
def test_autoscaler_process_events_equal_jax(name):
    """tests/test_transport.py's process-transport case: the factory
    returns an echo ``BackendSpec``, so the new replica is a spawned
    worker; both packages give the same single "up" event."""
    p = _Pkg(name)
    r = p.cluster.Router(policy="least_loaded")
    cfg = p.cluster.ReplicaConfig(inbox_capacity=256, max_batch=4)
    try:
        r.add_replica(spec=p.cluster.echo_spec(delay_s=0.05), cfg=cfg,
                      transport="process")
        sc = p.cluster.Autoscaler(
            r, lambda: p.cluster.echo_spec(delay_s=0.05),
            p.cluster.AutoscalerConfig(max_replicas=2, cooldown_s=0.0,
                                       scale_up_depth=4.0, replica_cfg=cfg),
            transport="process", clock=FakeClock(1.0))
        reqs = [r.submit(i) for i in range(30)]
        ev = sc.tick()
        assert (ev.t, ev.action, ev.n_replicas, ev.reason) == \
            (1.0, "up", 2, "depth/replica=30.0")
        assert all(isinstance(w, p.cluster.ProcessTransport)
                   for w in r.alive_replicas())
        assert [r.wait(q, 30.0) for q in reqs] == [2 * i for i in range(30)]
    finally:
        r.stop()


@pytest.mark.parametrize("kw", [dict(elastic=object()),
                                dict(make_mesh=lambda n: n)],
                         ids=["elastic", "make_mesh"])
def test_elastic_rescale_raises_naming_item_8(kw):
    """The ``elastic=`` / ``make_mesh=`` wiring (the name kept from when
    either raised): with one of them alone a resize re-places nothing, as
    in JAX; with both, every scale-up and scale-down calls
    ``elastic.rescale(make_mesh(n))`` at the new pool size, and, in a
    process without a process group, sends the size to no one.
    ``tests/test_torch_dist_pipeline.py`` runs the protocol on 4 ranks."""
    from torch_dist_ranks import FakeRouter
    calls = []

    class Runner:
        def rescale(self, mesh):
            calls.append(mesh)

    full = dict(elastic=Runner(), make_mesh=lambda n: ("mesh", n))
    cfg = AutoscalerConfig(min_replicas=1, max_replicas=4, scale_up_depth=1.0,
                           scale_down_depth=1.0, cooldown_s=0.0,
                           idle_ticks_to_drain=1)
    for given in (kw, full):
        calls.clear()
        r = FakeRouter(2)
        sc = Autoscaler(r, lambda: object(), cfg,
                        **{k: full[k] if k in kw else v
                           for k, v in given.items()})
        r.depth = 100.0
        assert sc.tick(1.0).action == "up"
        r.depth = 0.0
        assert sc.tick(2.0).action == "down"
        sc.release_followers()
        assert calls == ([] if given is kw else [("mesh", 3), ("mesh", 2)])


def test_stats_server_routes_parse_and_equal_jax():
    """A ``StatsServer`` on port 0 over each package's store: all four
    routes answer over HTTP and parse; ``/timeseries.json`` and
    ``/slo.json`` are the same documents from both packages."""
    clock, rigs = _slo_pair([lambda p: p.slo.test_scaled_objective()])
    for t, snap in _snapshots(n_ticks=30, seed=11):
        clock.t = t
        for p, reg, rec, store, slo in rigs:
            store.sample(dict(snap))
            slo.tick(store)
    bodies = []
    for p, reg, rec, store, slo in rigs:
        snap = dict(reg.snapshot(), **{"kernels.launches.flash_attention": 7})
        server = p.dashboard.StatsServer(lambda s=snap: s, store, slo=slo,
                                         port=0).start()
        try:
            assert server.host == "127.0.0.1" and server.port > 0
            got = {}
            for route in ("/metrics", "/timeseries.json", "/slo.json",
                          "/dash", "/nope"):
                try:
                    with urllib.request.urlopen(server.url + route,
                                                timeout=10.0) as resp:
                        got[route] = (resp.status, resp.read().decode())
                except urllib.error.HTTPError as e:
                    got[route] = (e.code, "")
        finally:
            server.stop()
        bodies.append(got)
    for got in bodies:
        assert {r: s for r, (s, _) in got.items()} == {
            "/metrics": 200, "/timeseries.json": 200, "/slo.json": 200,
            "/dash": 200, "/nope": 404}
        prom = got["/metrics"][1].splitlines()
        samples = [ln for ln in prom if ln and not ln.startswith("#")]
        assert samples and all(len(ln.split()) == 2 for ln in samples)
        assert "repro_kernels_launches_flash_attention 7" in samples
        assert got["/dash"][1].startswith("<!DOCTYPE html>")
    for route in ("/timeseries.json", "/slo.json"):
        docs = [json.loads(got[route][1]) for got in bodies]
        assert docs[1] == docs[0]
    assert docs[1]["objectives"][0]["kind"] == "any"


def _brownout_levels(p):
    """Brownout levels at three submits into a Router whose ``slo`` is a
    firing SLO engine (the queues stay empty)."""
    clock = FakeClock()
    reg = p.cluster.MetricsRegistry()
    store = p.timeseries.TimeSeriesStore(clock=clock)
    slo = p.slo.SLOEngine([p.slo.test_scaled_objective()], reg, clock=clock)
    h = reg.histogram("router.latency_s")
    store.sample(reg.snapshot())
    for _ in range(6):
        for _ in range(5):
            h.observe(5.0)
        clock.t += 0.1
        store.sample(reg.snapshot())
        slo.tick(store)
    assert slo.pressure() > 0.5
    r = p.cluster.Router(brownout=p.cluster.BrownoutController())
    try:
        r.add_replica(p.cluster.FnBackend(lambda ps: ps))
        r.slo = slo
        levels = []
        for i in range(3):
            assert r.wait(r.submit(i), 10.0) == i
            levels.append(r.brownout.level)
    finally:
        r.stop()
    return levels


def test_firing_slo_feeds_the_router_brownout():
    """``router.slo`` set to a firing SLO engine raises the brownout ladder
    at each submit though the queues are empty; both packages climb the
    same levels."""
    levels = [_brownout_levels(p) for p in _pkgs()]
    assert levels[1] == levels[0]
    assert levels[1][-1] >= 1 and levels[1] == sorted(levels[1])


# ----------------------------------------------------------------------
# tests/test_timeseries.py on the port: windowed percentiles


def test_window_percentile_matches_bruteforce_oracle():
    """p50/p90/p99 over the trailing window agree with numpy over the
    exact same observations, up to one bucket of resolution."""
    rng = np.random.RandomState(7)
    reg = MetricsRegistry()
    h = reg.histogram("lat_s")
    clk = FakeClock()
    store = TimeSeriesStore(clock=clk)
    store.sample(reg.snapshot())               # baseline tick at t=0
    obs = []
    for _ in range(10):
        clk.t += 1.0
        vals = np.exp(rng.uniform(np.log(1e-3), np.log(5.0), size=60))
        for v in vals:
            h.observe(float(v))
        obs.extend(float(v) for v in vals)
        store.sample(reg.snapshot())
    for p in (50, 90, 99):
        est = store.window_percentile("lat_s", p, window_s=10.5)
        oracle = float(np.percentile(obs, p))
        assert oracle / BUCKET_FACTOR <= est <= oracle * BUCKET_FACTOR, \
            (p, est, oracle)
    assert store.window_count("lat_s", 10.5) == len(obs)


def test_window_percentile_sees_only_the_window():
    reg = MetricsRegistry()
    h = reg.histogram("lat_s")
    clk = FakeClock()
    store = TimeSeriesStore(clock=clk)
    store.sample(reg.snapshot())
    for _ in range(5):                         # fast phase: t=1..5
        clk.t += 1.0
        for _ in range(20):
            h.observe(0.002)
        store.sample(reg.snapshot())
    for _ in range(3):                         # slow phase: t=6..8
        clk.t += 1.0
        for _ in range(20):
            h.observe(3.0)
        store.sample(reg.snapshot())
    est = store.window_percentile("lat_s", 50, window_s=3.0)
    assert est > 1.0, est                      # fast phase fully aged out


def test_spike_recovers_within_one_window_reservoir_does_not():
    reg = MetricsRegistry()
    h = reg.histogram("lat_s")
    clk = FakeClock()
    store = TimeSeriesStore(clock=clk)
    store.sample(reg.snapshot())
    window_s = 5.0

    def drive(n_ticks, value, per_tick=20):
        for _ in range(n_ticks):
            clk.t += 1.0
            for _ in range(per_tick):
                h.observe(value)
            store.sample(reg.snapshot())

    drive(6, 0.002)                            # steady fast traffic
    assert store.window_percentile("lat_s", 99, window_s) < 0.01
    drive(2, 3.0)                              # spike
    assert store.window_percentile("lat_s", 99, window_s) > 1.0
    drive(6, 0.002)                            # one full window of fast
    recovered = store.window_percentile("lat_s", 99, window_s)
    assert recovered < 0.01, recovered
    lifetime = store.last("lat_s.p99")
    assert lifetime is not None and lifetime > 1.0, lifetime


def test_empty_window_and_unknown_keys_read_zero():
    reg = MetricsRegistry()
    h = reg.histogram("lat_s")
    clk = FakeClock()
    store = TimeSeriesStore(clock=clk)
    assert store.window_percentile("nope", 99, 10.0) == 0.0
    assert store.rate("nope", 10.0) == 0.0
    assert store.increase("nope", 10.0) == 0.0
    clk.t = 1.0
    h.observe(0.5)
    store.sample(reg.snapshot())
    clk.t = 100.0                              # stem known, window empty
    store.sample(reg.snapshot())
    assert store.window_percentile("lat_s", 99, 5.0) == 0.0
    assert store.rate("lat_s.count", 5.0) == 0.0


# reset-safe counter windowing

def test_counter_reset_clamps_and_attach_is_not_credited():
    clk = FakeClock()
    store = TimeSeriesStore(clock=clk)
    clk.t = 1.0
    store.sample({"reqs": 100.0})              # attach to a running source
    clk.t = 2.0
    store.sample({"reqs": 150.0})
    clk.t = 3.0
    store.sample({"reqs": 20.0})               # worker restart: reset
    clk.t = 4.0
    store.sample({"reqs": 30.0})
    assert store.increase("reqs", 10.0) == pytest.approx(60.0)
    assert store.rate("reqs", 10.0) >= 0.0
    clk.t = 5.0
    store.sample({"reqs": 30.0, "late": 7.0})
    assert store.increase("late", 10.0) == pytest.approx(7.0)


def test_ewma_rate_clamps_resets():
    e = EwmaRate(halflife_s=1.0)
    e.update(100.0, 0.0)
    r1 = e.update(200.0, 1.0)
    assert r1 > 0.0
    r2 = e.update(0.0, 2.0)                    # reset: decays, never < 0
    assert 0.0 <= r2 < r1


# memory bounds + concurrency

def test_memory_bound_and_stem_cap():
    clk = FakeClock()
    store = TimeSeriesStore(capacity=8, max_stems=16, clock=clk)
    for i in range(50):
        clk.t += 1.0
        store.sample({f"k{j}": float(i) for j in range(40)})
    assert store.max_points == 8 * 16
    assert store.n_points <= store.max_points
    assert len(store.keys()) == 16
    assert store.dropped_keys > 0
    assert len(store.points("k0")) <= 8
    j = store.to_json()
    assert j["n_points"] <= j["max_points"]
    assert j["dropped_keys"] == store.dropped_keys


def test_concurrent_writers_and_readers():
    store = TimeSeriesStore(capacity=32, max_stems=64)
    reg = MetricsRegistry()
    h = reg.histogram("lat_s")
    errors = []
    stop = threading.Event()

    def writer(i):
        try:
            while not stop.is_set():
                h.observe(0.01 * (i + 1))
                reg.counter("reqs").inc()
                store.sample(reg.snapshot())
        except Exception as exc:               # noqa: BLE001
            errors.append(exc)

    def reader():
        try:
            while not stop.is_set():
                store.to_json()
                store.window_percentile("lat_s", 99, 1.0)
                store.rate("reqs", 1.0)
                store.ewma("lat_s.p99")
        except Exception as exc:               # noqa: BLE001
            errors.append(exc)

    threads = ([threading.Thread(target=writer, args=(i,))
                for i in range(3)]
               + [threading.Thread(target=reader) for _ in range(2)])
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(5.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert store.n_points <= store.max_points


# SLO burn-rate engine (fake clock)

def _slo_rig():
    reg = MetricsRegistry()
    clk = FakeClock()
    store = TimeSeriesStore(clock=clk)
    rec = FlightRecorder()
    slo = SLOEngine([scaled_objective()], reg, recorder=rec, clock=clk)
    return reg, clk, store, rec, slo


def _tick(clk, store, slo, reg, dt=0.1):
    clk.t += dt
    store.sample(reg.snapshot())
    slo.tick(store, now=clk.t)


def test_slo_latency_burn_fires_and_clears_with_hysteresis():
    reg, clk, store, rec, slo = _slo_rig()
    h = reg.histogram("router.latency_s")
    store.sample(reg.snapshot())
    for _ in range(4):                         # healthy: under threshold
        for _ in range(5):
            h.observe(0.01)
        _tick(clk, store, slo, reg)
    assert slo.firing() == []
    assert slo.pressure() == 0.0
    for _ in range(6):                         # burst: every request slow
        for _ in range(5):
            h.observe(5.0)
        _tick(clk, store, slo, reg)
    assert ("any", "latency") in slo.firing()
    assert slo.pressure() > 0.0
    snap = reg.snapshot()
    assert snap["slo.any.latency.firing"] == 1.0
    assert snap["slo.any.latency.burn_fast"] > 2.0
    fired = [e for e in rec.events() if e["kind"] == "slo_burn_fired"]
    assert any(e["slo"] == "latency" and e["objective"] == "any"
               for e in fired)
    assert "repro_slo_any_latency_firing 1" in prometheus_text(snap)
    for _ in range(25):                        # recovery: > slow window
        for _ in range(5):
            h.observe(0.01)
        _tick(clk, store, slo, reg)
    assert slo.firing() == []
    assert slo.pressure() == 0.0
    snap = reg.snapshot()
    assert snap["slo.any.latency.firing"] == 0.0
    assert any(e["kind"] == "slo_burn_cleared" and e["slo"] == "latency"
               for e in rec.events())
    assert snap["slo.any.latency.budget_remaining"] < 1.0


def test_slo_availability_deadline_burns_cancelled_is_neutral():
    reg, clk, store, rec, slo = _slo_rig()
    total = reg.counter("router.finish.total")
    dead = reg.counter("router.finish.deadline")
    canc = reg.counter("router.finish.cancelled")
    store.sample(reg.snapshot())
    for _ in range(6):
        total.inc(5)
        canc.inc(5)
        _tick(clk, store, slo, reg)
    assert slo.firing() == []
    for _ in range(6):                         # deadline-miss burst
        total.inc(5)
        dead.inc(4)
        _tick(clk, store, slo, reg)
    assert ("any", "availability") in slo.firing()
    assert any(e["kind"] == "slo_burn_fired"
               and e["slo"] == "availability" for e in rec.events())
    for _ in range(25):                        # clean traffic drains it
        total.inc(5)
        _tick(clk, store, slo, reg)
    assert ("any", "availability") not in slo.firing()
    assert any(e["kind"] == "slo_burn_cleared"
               and e["slo"] == "availability" for e in rec.events())


# end-to-end: live Router harnesses

def test_slo_fires_in_overload_deadline_burst_harness():
    """A wedged replica makes a burst of requests expire in its queue; the
    sampler feeds the real ``cluster_snapshot`` counters into the store
    and the fast-window availability alert fires, then clears once
    traffic is healthy."""
    reg = MetricsRegistry()
    rec = FlightRecorder()
    r = Router(metrics=reg)
    gate = threading.Event()
    clk = FakeClock()
    store = TimeSeriesStore(clock=clk)
    slo = SLOEngine([scaled_objective()], reg, recorder=rec, clock=clk)
    sampler = TelemetrySampler(r.cluster_snapshot, store, registry=reg,
                               slo=slo, clock=clk)
    try:
        r.add_replica(gated(gate), ReplicaConfig(max_batch=1))
        sampler.tick()                         # baseline before the burst
        blocker = r.submit(1, timeout_s=30.0)
        victims = [r.submit(i, timeout_s=0.05) for i in range(8)]
        time.sleep(0.15)                       # deadlines pass while queued
        gate.set()
        assert r.wait(blocker, timeout=10.0) == 2
        for q in victims:
            assert q.done.wait(10.0)
        assert all(q.status is Status.EXPIRED for q in victims)
        for _ in range(4):
            clk.t += 0.1
            sampler.tick()
        assert ("any", "availability") in slo.firing()
        snap = reg.snapshot()
        assert snap["slo.any.availability.firing"] == 1.0
        assert any(e["kind"] == "slo_burn_fired" for e in rec.events())
        for i in range(8):                     # healthy traffic again
            assert r.wait(r.submit(10 + i, timeout_s=10.0),
                          timeout=10.0) == 2 * (10 + i)
        for _ in range(25):
            clk.t += 0.1
            sampler.tick()
        assert slo.firing() == []
        assert any(e["kind"] == "slo_burn_cleared"
                   for e in rec.events())
    finally:
        gate.set()
        r.stop()


def _monotone_keys(snap):
    return [k for k in snap
            if not is_gauge_key(k)
            and TimeSeriesStore.key_type(k) in ("counter", "bucket")]


def _assert_monotone(before, after, label):
    for k in _monotone_keys(before):
        assert after.get(k, 0.0) >= before[k] - 1e-9, \
            (label, k, before[k], after.get(k))


def test_cluster_counters_monotone_across_replica_kill_and_removal():
    """Departed-replica retention: removing a worker gracefully and
    losing one to a crash must not regress any cluster-wide counter or
    histogram bucket count in ``cluster_snapshot()``."""
    reg = MetricsRegistry()
    r = Router(policy="round_robin", metrics=reg)
    try:
        workers = [r.add_replica(spec=echo_spec(delay_s=0.001),
                                 cfg=PROC_CFG, transport="process")
                   for _ in range(3)]
        reqs = [r.submit(i) for i in range(18)]
        assert [r.wait(q, 30.0) for q in reqs] == [2 * i for i in range(18)]
        # worker-side counters ship over the heartbeats: wait for them
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            a = r.cluster_snapshot()
            if a.get("replica.batch_s.count", 0.0) > 0:
                break
            time.sleep(0.05)
        assert a.get("replica.batch_s.count", 0.0) > 0, \
            "worker counters never arrived over heartbeats"
        r.remove_replica(workers[0].rid)       # graceful removal
        b = r.cluster_snapshot()
        _assert_monotone(a, b, "after graceful removal")
        workers[1].inject_crash(soft=True)     # abrupt death
        more = [r.submit(100 + i) for i in range(6)]
        assert [r.wait(q, 30.0) for q in more] == \
            [2 * (100 + i) for i in range(6)]
        c = r.cluster_snapshot()
    finally:
        r.stop()
    _assert_monotone(b, c, "after crash")
    assert c["router.finish.total"] > b.get("router.finish.total", 0.0)


# ----------------------------------------------------------------------
# tests/test_cluster.py's autoscaler case (its fall-behind case and
# tests/test_transport.py's process case are the parity tests above)


def test_autoscaler_up_on_pressure_down_when_idle():
    t = [0.0]
    gate = threading.Event()
    r = Router(policy="least_loaded")
    cfg = AutoscalerConfig(min_replicas=1, max_replicas=3, scale_up_depth=4.0,
                           scale_down_depth=0.5, cooldown_s=1.0,
                           idle_ticks_to_drain=2,
                           replica_cfg=ReplicaConfig(inbox_capacity=256))
    try:
        r.add_replica(gated(gate), cfg.replica_cfg)
        sc = Autoscaler(r, lambda: gated(gate), cfg, clock=lambda: t[0])
        reqs = [r.submit(i) for i in range(20)]
        ev = sc.tick()
        assert ev and ev.action == "up" and r.n_alive() == 2
        assert sc.tick() is None, "cooldown must gate consecutive actions"
        t[0] += 2.0
        ev = sc.tick()
        assert ev and ev.action == "up" and r.n_alive() == 3
        t[0] += 2.0
        assert sc.tick() is None, "max_replicas must cap the pool"
        gate.set()
        for q in reqs:
            assert q.done.wait(10.0)
        for expect_n in (2, 1):
            t[0] += 2.0
            assert sc.tick() is None        # first idle tick: observe only
            t[0] += 2.0
            ev = sc.tick()                  # second idle tick: drain one
            assert ev and ev.action == "down" and r.n_alive() == expect_n
        t[0] += 2.0
        sc.tick()
        t[0] += 2.0
        assert sc.tick() is None, "min_replicas must floor the pool"
        assert [e.action for e in sc.events] == ["up", "up", "down", "down"]
    finally:
        gate.set()
        r.stop()


def test_failed_spawn_is_an_event_and_backs_off():
    """A factory that raises gives an ``up_failed`` event and the cooldown
    gates the retry; the pool keeps serving."""
    clock = FakeClock()
    r = Router()

    def broken():
        raise RuntimeError("no card")

    try:
        r.add_replica(FnBackend(lambda ps: ps))
        sc = Autoscaler(r, broken, AutoscalerConfig(cooldown_s=1.0),
                        fall_behind=lambda: True, clock=clock)
        ev = sc.tick()
        assert ev.action == "up_failed" and "no card" in ev.reason
        assert sc.tick() is None
        clock.t += 1.5
        assert sc.tick().action == "up_failed"
        assert r.wait(r.submit(3), 10.0) == 3 and r.n_alive() == 1
    finally:
        r.stop()


# ----------------------------------------------------------------------
# the serve driver's stats flags


@pytest.mark.parametrize("extra", [
    ["--arch", "internlm2-1.8b"],
    ["--arch", "starcoder2-3b", "--paged", "--block-size", "8"],
    ["--replicas", "2", "--transport", "thread", "--brownout", "--trace",
     "--trace-sample-rate", "0.5", "--kv-headroom", "0.05"],
], ids=["single", "starcoder2", "cluster"])
def test_serve_stats_dump_writes_the_four_routes(tmp_path, extra):
    prefix = str(tmp_path / "stats")
    out = io.StringIO()
    with redirect_stdout(out):
        serve.main(["--device", "cpu", "--reduce", "--requests", "3",
                    "--max-new", "4", "--slots", "2", "--max-len", "32",
                    "--stats-dump", prefix, "--stats-period", "0.05",
                    *extra])
    lines = out.getvalue().strip().splitlines()
    assert lines[-1].startswith("[serve]") and "tokens=15" in lines[-1]
    assert any(ln.startswith("[stats] dumped 4 routes") for ln in lines)
    text = (tmp_path / "stats.metrics.txt").read_text()
    assert "repro_engine_tokens" in text
    ts = json.loads((tmp_path / "stats.timeseries.json").read_text())
    assert ts["n_points"] <= ts["max_points"] and ts["counters"]
    slo = json.loads((tmp_path / "stats.slo.json").read_text())
    assert slo["objectives"][0]["kind"] == "any" and slo["ticks"] >= 1
    dash = (tmp_path / "stats.dash.html").read_text()
    assert dash.startswith("<!DOCTYPE html>")
    if "--replicas" in extra:
        assert "repro_router_completed 3" in text


def test_serve_profile_dir_and_no_fused(tmp_path):
    """``--profile-dir`` writes a torch.profiler Chrome trace; ``--no-fused``
    serves the reference engine (as many tokens as the fused one)."""
    outs = []
    for extra in ([], ["--no-fused", "--profile-dir", str(tmp_path)]):
        out = io.StringIO()
        with redirect_stdout(out):
            serve.main(["--device", "cpu", "--reduce", "--requests", "2",
                        "--max-new", "3", "--slots", "2", "--max-len", "32",
                        "--prom-out", str(tmp_path / f"m{len(outs)}.txt"),
                        *extra])
        outs.append(out.getvalue())
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())
    assert "[profile] torch.profiler trace" in outs[1]
    tokens = [ln for o in outs for ln in o.splitlines()
              if ln.startswith("[serve]")]
    assert all("tokens=8" in ln for ln in tokens)


def test_background_threads_tick_and_stop():
    """``TelemetrySampler.start`` and ``Autoscaler.start`` run ``tick`` on
    daemon threads; ``stop`` ends them.  Each waits on an event its tick
    sets, never on a sleep."""
    sampled, polled = threading.Event(), threading.Event()
    store = TimeSeriesStore()
    sampler = TelemetrySampler(lambda: (sampled.set(), {"n": 1.0})[1], store,
                               period_s=0.01)
    r = Router()
    sc = Autoscaler(r, lambda: FnBackend(lambda ps: ps),
                    AutoscalerConfig(max_replicas=1),
                    fall_behind=lambda: (polled.set(), False)[1])
    try:
        r.add_replica(FnBackend(lambda ps: ps))
        sampler.start()
        sc.start(period_s=0.01)
        assert sampled.wait(10.0) and polled.wait(10.0)
    finally:
        sampler.stop()
        sc.stop()
        r.stop()
    assert sampler._thread is None and not sc._thread.is_alive()
    assert sampler.ticks >= 1 and store.last("n") == 1.0
    assert sc.events == []
