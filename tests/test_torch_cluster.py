"""The port's cluster layer against the JAX package's.

Router policies, admission shedding, spill on a crashed replica and the
brownout ladder run once over ``repro.cluster`` and once over
``repro_torch.cluster`` on echo backends (plain Python), with the same
outcomes.  Then a Router over the port's ``EngineBackend`` on the CPU
(``reduced()`` internlm2-1.8b, fp32, dense and paged) must give the JAX
``Engine``'s greedy tokens exactly: on a thread replica whose weights are
carried over with ``params_from_numpy``, and on a process replica built
from ``engine_spec(weights_path=..., device="cpu")`` that reads the
``Checkpointer`` directory the JAX side wrote.
"""
import importlib
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.checkpointer import (Checkpointer,  # noqa: E402
                                           _flatten_with_paths)
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.cluster import (EngineBackend, MetricsRegistry,  # noqa: E402
                                 ReplicaConfig, Router, Status, engine_spec)
from repro_torch.cluster.backends import make_engine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.service import MLaaSService  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

PKGS = ("repro", "repro_torch")


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.cluster = importlib.import_module(f"{name}.cluster")
        self.router = importlib.import_module(f"{name}.cluster.router")
        self.partitioner = importlib.import_module(
            f"{name}.core.partitioner")


@pytest.fixture(params=PKGS)
def pkg(request):
    return _Pkg(request.param)


def _echo(pkg, delay=0.0):
    def step(payloads):
        if delay:
            time.sleep(delay)
        return [p * 2 for p in payloads]
    return pkg.cluster.FnBackend(step)


def _gated(pkg, event):
    def step(payloads):
        assert event.wait(10.0), "gate never opened"
        return [p * 2 for p in payloads]
    return pkg.cluster.FnBackend(step)


# ----------------------------------------------------------------------
# policies

def test_round_robin_distributes_evenly(pkg):
    r = pkg.cluster.Router(policy="round_robin")
    workers = [r.add_replica(_echo(pkg, 0.001)) for _ in range(3)]
    reqs = [r.submit(i) for i in range(30)]
    assert [r.wait(q, 5.0) for q in reqs] == [2 * i for i in range(30)]
    assert [w.processed for w in workers] == [10, 10, 10]
    r.stop()


def test_session_affinity_is_sticky(pkg):
    r = pkg.cluster.Router(policy="session_affinity")
    for _ in range(3):
        r.add_replica(_echo(pkg, 0.001))
    reqs = [r.submit(i, session_key="user-42") for i in range(20)]
    for q in reqs:
        r.wait(q, 5.0)
    assert len({q.replica_rid for q in reqs}) == 1
    reqs = [r.submit(i, session_key=f"user-{i}") for i in range(40)]
    for q in reqs:
        r.wait(q, 5.0)
    assert len({q.replica_rid for q in reqs}) >= 2
    r.stop()


def test_rendezvous_homes_equal_the_jax_package():
    """Both routers hash a session to the same replica, so a session's
    home does not depend on which package serves it."""
    from repro.cluster.router import _rendezvous_weight as jw
    from repro_torch.cluster.router import _rendezvous_weight as tw
    for key in [f"user-{i}" for i in range(100)]:
        for pool in ([1, 2, 3], [4, 7], [1, 3, 5, 8, 13]):
            assert max(pool, key=lambda rid: jw(key, rid)) == \
                max(pool, key=lambda rid: tw(key, rid))


def test_least_loaded_routes_around_a_busy_replica(pkg):
    """Join-shortest-queue: while one replica holds work behind a closed
    gate, every new request goes to the other."""
    gate = threading.Event()
    r = pkg.cluster.Router(policy="least_loaded")
    busy = r.add_replica(_gated(pkg, gate),
                         pkg.cluster.ReplicaConfig(max_batch=1))
    free = r.add_replica(_echo(pkg), pkg.cluster.ReplicaConfig(max_batch=1))
    held = r.submit(0, cost=5)          # a tie goes to the lower rid
    reqs = []
    for i in range(1, 9):
        reqs.append(r.submit(i, cost=1))
        assert r.wait(reqs[-1], 5.0) == 2 * i
    assert {q.replica_rid for q in reqs} == {free.rid}
    gate.set()
    assert r.wait(held, 5.0) == 0 and held.replica_rid == busy.rid
    r.stop()


# ----------------------------------------------------------------------
# admission

def test_admission_sheds_on_queue_full_and_nothing_hangs(pkg):
    c = pkg.cluster
    m = c.MetricsRegistry()
    r = c.Router(policy="round_robin", metrics=m,
                 admission=c.AdmissionController(
                     c.AdmissionConfig(max_queue_cost=5), m))
    r.add_replica(_echo(pkg, 0.01),
                  c.ReplicaConfig(max_batch=1, inbox_capacity=256))
    reqs = [r.submit(i) for i in range(50)]
    for q in reqs:
        assert q.done.wait(10.0), "request neither completed nor rejected"
    shed = [q for q in reqs if q.status is c.Status.REJECTED]
    ok = [q for q in reqs if q.status is c.Status.OK]
    assert len(ok) + len(shed) == 50 and shed
    assert all(isinstance(q.result, c.Rejected) and
               q.result.reason == "queue_full" for q in shed)
    assert m.snapshot()["admission.shed_queue_full"] == len(shed)
    r.stop()


def test_admission_sheds_infeasible_deadline(pkg):
    c = pkg.cluster
    cm = pkg.partitioner.CostModel(overhead_s=0.0, per_item_s=1.0, r2=1.0)
    r = c.Router(admission=c.AdmissionController(
        c.AdmissionConfig(max_queue_cost=100, cost_model=cm)))
    r.add_replica(_echo(pkg))
    q = r.submit("x", timeout_s=0.05)
    assert q.status is c.Status.REJECTED and q.result.reason == "deadline"
    ok = r.submit("y", timeout_s=10.0)
    assert r.wait(ok, 5.0) == "yy"
    r.stop()


def test_backpressure_when_every_inbox_is_full(pkg):
    c = pkg.cluster
    gate = threading.Event()
    r = c.Router()
    r.add_replica(_gated(pkg, gate),
                  c.ReplicaConfig(inbox_capacity=1, max_batch=1))
    reqs = [r.submit(i) for i in range(20)]
    gate.set()
    for q in reqs:
        assert q.done.wait(10.0)
    shed = [q for q in reqs if q.status is c.Status.REJECTED]
    assert shed and all(q.result.reason == "queue_full" for q in shed)
    r.stop()


# ----------------------------------------------------------------------
# spill on a crashed replica

def test_crash_spills_to_survivors_with_zero_lost(pkg):
    c = pkg.cluster
    m = c.MetricsRegistry()
    r = c.Router(policy="round_robin", metrics=m, max_retries=3)
    cfg = c.ReplicaConfig(max_batch=2, inbox_capacity=256)
    workers = [r.add_replica(spec=c.echo_spec(delay_s=0.005), cfg=cfg,
                             transport="thread") for _ in range(3)]
    reqs = [r.submit(i) for i in range(60)]
    time.sleep(0.02)
    workers[0].inject_crash()
    assert [r.wait(q, 20.0) for q in reqs] == [2 * i for i in range(60)]
    assert all(q.status is c.Status.OK for q in reqs)
    assert r.n_alive() == 2 and not workers[0].alive
    snap = m.snapshot()
    assert snap["replica.crashes"] == 1 and snap["router.failed"] == 0
    r.stop()


def test_crash_with_no_survivors_fails_explicitly(pkg):
    c = pkg.cluster
    gate = threading.Event()
    r = c.Router()
    w = r.add_replica(_gated(pkg, gate), c.ReplicaConfig(inbox_capacity=64))
    reqs = [r.submit(i) for i in range(4)]
    w.inject_crash()
    gate.set()
    for q in reqs:
        assert q.done.wait(10.0), "must fail explicitly, not hang"
    assert all(q.status is c.Status.FAILED for q in reqs)
    r.stop()


# ----------------------------------------------------------------------
# brownout

def test_router_brownout_ladder_under_queue_pressure(pkg):
    c = pkg.cluster
    gate = threading.Event()
    m = c.MetricsRegistry()
    r = c.Router(metrics=m,
                 admission=c.AdmissionController(
                     c.AdmissionConfig(max_queue_cost=10), m),
                 brownout=c.BrownoutController())
    w = r.add_replica(_gated(pkg, gate), c.ReplicaConfig(max_batch=1))
    held = [r.submit(0, cost=8, timeout_s=30.0),
            r.submit(1, cost=1, timeout_s=30.0),
            r.submit(2, cost=1, timeout_s=30.0)]
    assert m.gauge("router.brownout_level").value == 2
    shed = r.submit(3, cost=1, timeout_s=30.0)
    assert shed.status is c.Status.REJECTED
    assert "brownout" in shed.result.detail
    assert w.brownout() == 3
    assert m.counter("router.brownout_transitions").value == 3
    gate.set()
    for q in held:
        assert r.wait(q, timeout=10.0) == 2 * q.payload
    for i in range(4):
        r.wait(r.submit(10 + i, cost=1, timeout_s=10.0), timeout=10.0)
    assert m.gauge("router.brownout_level").value == 0
    r.stop()


def test_engine_backend_brownout_on_the_port_engine():
    """L1 turns the port engine's speculative decode off and L0 back on;
    L2 also halves ``max_new``, and the spec counters stand still while
    speculation is off.  An engine without the attribute is left alone
    (the ``hasattr`` guard), and one built without speculation stays
    without."""
    eng = types.SimpleNamespace()
    EngineBackend(eng).set_brownout(1)
    assert not hasattr(eng, "speculative")
    port = make_engine(device="cpu", max_len=32, slots=2, sync_every=4,
                       paged=True, block_size=8, speculative=True)
    be = EngineBackend(port)
    assert port.speculative
    be.set_brownout(1)
    assert not port.speculative
    be.set_brownout(0)
    assert port.speculative
    be.set_brownout(2)
    assert not port.speculative
    (toks,) = be.process([(np.arange(5, dtype=np.int32), 8)])
    assert len(toks) == 4 + 1, "L2 serves max_new // 2 after the first"
    assert port.metrics.counter("engine.spec_proposed").value == 0
    be.set_brownout(0)
    be.process([(np.arange(7, dtype=np.int32), 8)])
    assert port.metrics.counter("engine.spec_proposed").value > 0
    plain = make_engine(device="cpu", max_len=32, slots=2, sync_every=4)
    be = EngineBackend(plain)
    be.set_brownout(1)
    be.set_brownout(0)
    assert not plain.speculative


def _scenario(pkg):
    """A scripted run with every outcome the two routers must agree on:
    dispatch, shedding at the front door, a crash spilled to the
    survivor, and the counters that record them."""
    c = pkg.cluster
    m = c.MetricsRegistry()
    gate_a, gate_b = threading.Event(), threading.Event()
    r = c.Router(policy="round_robin", metrics=m, max_retries=3,
                 admission=c.AdmissionController(
                     c.AdmissionConfig(max_queue_cost=6), m))
    cfg = c.ReplicaConfig(max_batch=1, inbox_capacity=64)
    a = r.add_replica(_gated(pkg, gate_a), cfg)
    b = r.add_replica(_gated(pkg, gate_b), cfg)
    first = [r.submit(i) for i in range(10)]     # 6 admitted, 4 shed
    a.inject_crash()
    gate_a.set()
    gate_b.set()
    for q in first:
        assert q.done.wait(10.0)
    second = [r.submit(100 + i) for i in range(4)]
    for q in second:
        r.wait(q, 5.0)
    rids = {a.rid: "a", b.rid: "b", None: None}
    out = [(q.payload, q.status.value, q.result if q.status is c.Status.OK
            else getattr(q.result, "reason", None), rids[q.replica_rid])
           for q in first + second]
    snap = m.snapshot()
    keys = ("router.completed", "router.failed", "router.submitted",
            "admission.shed_queue_full", "replica.crashes")
    r.stop()
    return out, {k: snap.get(k, 0) for k in keys}


def test_same_outcomes_from_both_packages():
    jax_out, jax_counts = _scenario(_Pkg("repro"))
    port_out, port_counts = _scenario(_Pkg("repro_torch"))
    assert port_out == jax_out
    assert port_counts == jax_counts
    assert jax_counts["replica.crashes"] == 1
    assert any(s == "rejected" for _, s, _, _ in jax_out)


# ----------------------------------------------------------------------
# the port's engines behind a Router, token-exact against the JAX engine

SCFG = dict(max_len=64, slots=2, sync_every=4, block_size=8)
MAX_NEW = 6


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """JAX reduced internlm2-1.8b weights in a Checkpointer directory, the
    prompts, and the JAX engine's greedy tokens, dense and paged."""
    jcfg = jax_reduced(jax_get_config("internlm2-1.8b"))
    jparams = jax.jit(lambda k: api.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    ckpt = tmp_path_factory.mktemp("ckpt")
    Checkpointer(str(ckpt)).save(1, jparams)
    flat = {k: np.asarray(v)
            for k, v in _flatten_with_paths(jparams)[0].items()}
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, jcfg.vocab, size=n).astype(np.int32)
               for n in (5, 9, 7, 12, 6, 3)]
    want = {}
    for paged in (False, True):
        eng = JEngine(jparams, jcfg, JServeConfig(paged=paged, **SCFG))
        reqs = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
        eng.run_until_drained()
        want[paged] = [r.out_tokens for r in reqs]
    return dict(ckpt=str(ckpt), flat=flat, prompts=prompts, want=want)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_thread_replicas_token_exact_with_jax(lm, paged):
    cfg = reduced(get_config("internlm2-1.8b"))
    params = weights.params_from_numpy(lm["flat"], cfg, device="cpu")
    scfg = ServeConfig(paged=paged, **SCFG)
    r = Router(policy="round_robin")
    for _ in range(2):
        r.add_replica(EngineBackend(Engine(params, cfg, scfg, device="cpu")),
                      ReplicaConfig(max_batch=4))
    reqs = [r.submit((p, MAX_NEW), cost=MAX_NEW) for p in lm["prompts"]]
    got = [r.wait(q, 60.0) for q in reqs]
    r.stop()
    assert all(q.status is Status.OK for q in reqs)
    assert got == lm["want"][paged]
    assert len({q.replica_rid for q in reqs}) == 2


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_process_replica_from_jax_checkpoint_token_exact(lm, paged):
    """One worker process builds its engine from the JAX Checkpointer
    directory; the service front over the Router gets the JAX tokens, and
    the worker's engine counters arrive over its heartbeats."""
    m = MetricsRegistry()
    r = Router(policy="round_robin", metrics=m)
    spec = engine_spec(weights_path=lm["ckpt"], device="cpu", paged=paged,
                       **SCFG)
    w = r.add_replica(spec=spec, cfg=ReplicaConfig(max_batch=8),
                      transport="process")
    svc = MLaaSService(router=r, capacity=len(lm["prompts"])).start()
    reqs = [svc.submit((p, MAX_NEW), timeout_s=60.0) for p in lm["prompts"]]
    for q in reqs:
        assert q.done.wait(90.0)
    svc.stop()
    assert [q.result for q in reqs] == lm["want"][paged]
    r.stop()
    snap = r.cluster_snapshot()
    assert w.processed == len(reqs)
    assert snap["engine.requests"] == len(reqs)
    assert snap["engine.tokens"] == len(reqs) * MAX_NEW


def test_serve_driver_replicated_on_threads(tmp_path, capsys):
    """``launch/serve.py --replicas 2`` prints the JAX driver's
    ``[cluster]`` line and writes the Chrome trace and the Prometheus
    exposition of the run."""
    from repro_torch.cluster import set_tracer
    from repro_torch.launch import serve
    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.txt"
    try:
        serve.main(["--device", "cpu", "--reduce", "--replicas", "2",
                    "--requests", "4", "--max-new", "3", "--slots", "2",
                    "--max-len", "32", "--brownout", "--router-policy",
                    "least_loaded", "--trace-out", str(trace),
                    "--prom-out", str(prom)])
    finally:
        set_tracer(None)
    out = capsys.readouterr().out
    assert "[cluster] replicas=2 transport=thread policy=least_loaded " \
        "completed=4 shed=0" in out
    assert "kv=dense reqs=4 tokens=16 " in out
    assert '"traceEvents"' in trace.read_text()
    assert "repro_router_completed 4" in prom.read_text()


def test_profiling_hooks_write_a_torch_trace(tmp_path):
    """``start_profiling`` / ``stop_profiling`` run ``torch.profiler``
    where the JAX package runs ``jax.profiler``; ``annotate`` names a
    stage in the trace."""
    from repro_torch.cluster import tracing
    tracing.start_profiling(str(tmp_path))
    with tracing.annotate("engine.decode_sync"):
        torch.ones(8) @ torch.ones(8)
    path = tracing.stop_profiling()
    assert path is not None and tracing.stop_profiling() is None
    assert "engine.decode_sync" in open(path).read()


# ----------------------------------------------------------------------
# drain-time warm migration through the Router
# (tests/test_kv_lifecycle.py:225-306, on the port's engines)
WARM = ServeConfig(max_len=48, slots=2, sync_every=4, paged=True,
                   block_size=8, kv_blocks=24, prefix_cache=True)


@pytest.mark.parametrize("migrate", [True, False], ids=["warm", "cold"])
def test_drained_session_moves_to_its_new_home(lm, migrate):
    """``remove_replica(home, drain=True, migrate=...)`` over 3 thread
    replicas with session affinity: with ``migrate`` the drained
    replica's prefix blocks ship to the session's new home, which decodes
    the continuation warm (prefix hits > 0); without it the new home
    decodes cold.  Either way the tokens are an uninterrupted engine's."""
    cfg = reduced(get_config("internlm2-1.8b"))
    params = weights.params_from_numpy(lm["flat"], cfg, device="cpu")
    r = Router(policy="session_affinity", metrics=MetricsRegistry())
    workers = [r.add_replica(
        EngineBackend(Engine(params, cfg, WARM, device="cpu")),
        ReplicaConfig(max_batch=2), kind="lm") for _ in range(3)]
    prompt = np.random.RandomState(17).randint(
        0, cfg.vocab, size=17).astype(np.int32)
    q = r.submit((prompt.copy(), 8), session_key="sess-1", kind="lm",
                 timeout_s=60.0)
    toks = r.wait(q, 60.0)
    home = q.replica_rid
    cont = np.concatenate([prompt, np.asarray(toks, np.int32)])
    oracle = Engine(params, cfg, WARM, device="cpu")
    want = oracle.submit(cont.copy(), max_new=6)
    oracle.run_until_drained()
    r.remove_replica(home, drain=True, migrate=migrate)
    snap = r.metrics.snapshot()
    assert (snap.get("router.sessions_migrated", 0) >= 1) == migrate, snap
    assert (snap.get("router.kv_migrations", 0) >= 1) == migrate, snap
    q2 = r.submit((cont.copy(), 6), session_key="sess-1", kind="lm",
                  timeout_s=60.0)
    toks2 = r.wait(q2, 60.0)
    assert q2.replica_rid != home, "session not remapped off the drain"
    new_home = next(w for w in workers if w.rid == q2.replica_rid)
    got = new_home.backend.engine.metrics.snapshot()
    assert (got.get("engine.prefix_hit_blocks", 0) > 0) == migrate
    assert (got.get("engine.kv_import_blocks", 0) > 0) == migrate
    assert toks2 == list(want.out_tokens)
    r.stop()
