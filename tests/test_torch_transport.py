"""The port's transports and wire: the versioned socket handshake (a bad
protocol version, an unknown token and a stale spec fingerprint are
refused at the door), the standalone ``worker_main --connect`` worker, a
SIGKILLed process replica spilling with nothing lost, one randomized
thread-pool chaos episode (never lose, never double), the control plane
without msgpack (the card's machine has none), and wire compatibility
with the JAX package's frames, and the drain-time KV hand-off between two
process replicas of the paged engine.

Workers here run echo backends, so a spawned worker imports no torch,
except the KV hand-off's, which run the port's engine on the CPU.
The chaos pieces are copied from ``tests/chaos.py``, which imports the
JAX package.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.cluster import framing as jframing  # noqa: E402
from repro.cluster import wire as jwire  # noqa: E402
from repro_torch.cluster import (MetricsRegistry, ReplicaConfig,  # noqa: E402
                                 Router, Status, echo_spec, engine_spec,
                                 framing, spec_fingerprint, wire)
from repro_torch.cluster.backends import make_engine  # noqa: E402
from repro_torch.cluster.replica import ClusterRequest  # noqa: E402
from repro_torch.cluster.transport import SocketTransport  # noqa: E402
from repro_torch.cluster.wire import (PROTOCOL_VERSION,  # noqa: E402
                                      WorkerListener, connect_channel)

ROOT = Path(__file__).resolve().parents[1]
CFG = ReplicaConfig(inbox_capacity=256, max_batch=4, heartbeat_timeout_s=2.0)


def _wait_until(pred, timeout_s=10.0, period=0.02):
    t_end = time.monotonic() + timeout_s
    while time.monotonic() < t_end:
        if pred():
            return True
        time.sleep(period)
    return pred()


def _recv_frame(chan, timeout_s=5.0):
    t_end = time.monotonic() + timeout_s
    while time.monotonic() < t_end:
        msg = chan.recv(0.1)
        if msg is not None:
            return msg
    return None


# ----------------------------------------------------------------------
# frames and handshake

@pytest.mark.parametrize("obj, pickle_only", [
    (["req", 7, 3, {"a": [1, 2, 3], "b": "x"}], False),
    (("hb", 3, 0.5, {"engine.tokens": 12.0}, [], []), False),
    (("ack", [(1, [5, 6, 7])], 0.01), True),
    (("req", 1, 1, (np.arange(6, dtype=np.float32), np.ones(2, bool))),
     True)])
def test_frames_cross_between_the_packages(obj, pickle_only):
    """A port worker and a JAX parent (or the reverse) read each other's
    frames, byte for byte, under one protocol version."""
    assert PROTOCOL_VERSION == jwire.PROTOCOL_VERSION
    buf = framing.encode_frame(obj, pickle_only)
    assert buf == jframing.encode_frame(obj, pickle_only)
    out = jframing.decode_frame(buf)
    if pickle_only:
        assert type(out) is type(obj)
        np.testing.assert_equal(out, obj)
    else:
        assert out == list(obj) if isinstance(obj, tuple) else out == obj


def test_wrong_protocol_version_rejected():
    listener = WorkerListener()
    try:
        chan = connect_channel(listener.address)
        chan.send(("hello", PROTOCOL_VERSION + 1, "any-token", None, None))
        msg = _recv_frame(chan)
        assert msg is not None and msg[0] == "reject"
        assert "version" in msg[1]
        with pytest.raises(wire.ChannelClosed):
            for _ in range(100):
                if chan.recv(0.1) is None:
                    continue
        chan.close()
    finally:
        listener.close()


def test_unknown_token_rejected():
    listener = WorkerListener()
    try:
        chan = connect_channel(listener.address)
        chan.send(("hello", PROTOCOL_VERSION, "nobody-registered-me",
                   None, None))
        msg = _recv_frame(chan)
        assert msg is not None and msg[0] == "reject"
        assert "token" in msg[1]
        chan.close()
    finally:
        listener.close()


def test_welcome_carries_spec_and_stale_fingerprint_rejected():
    listener = WorkerListener()
    spec = echo_spec(delay_s=0.0, scale=5)
    t = SocketTransport(spec, CFG, metrics=MetricsRegistry(),
                        listener=listener, spawn=False)
    try:
        t.start(wait_ready=False)
        chan = connect_channel(listener.address)
        chan.send(("hello", PROTOCOL_VERSION, t.token, None, None))
        msg = _recv_frame(chan)
        assert msg is not None and msg[0] == "welcome"
        _tag, rid, shipped, cfg = msg[:4]
        assert rid == t.rid and cfg == CFG and shipped == spec
        chan.close()
        chan2 = connect_channel(listener.address)
        chan2.send(("hello", PROTOCOL_VERSION, t.token, "fn",
                    spec_fingerprint(echo_spec(scale=999))))
        msg2 = _recv_frame(chan2)
        assert msg2 is not None and msg2[0] == "reject"
        assert "fingerprint" in msg2[1]
        chan2.close()
        assert t.metrics.snapshot()["replica.handshake_rejects"] == 1
    finally:
        t._die(RuntimeError("test teardown"))
        listener.close()


# ----------------------------------------------------------------------
# the standalone worker, with and without msgpack

_NO_MSGPACK = ("import repro_torch.cluster.framing as f, "
               "repro_torch.cluster.wire as w; f.msgpack = w.msgpack = None; ")


def _serve_through_worker_main(no_msgpack: bool):
    """A SocketTransport that spawns nothing; the worker is
    ``repro_torch.cluster.worker_main`` run as its own program, dialing
    the listener with the transport's token."""
    r = Router(policy="round_robin")
    listener, token = WorkerListener(), "worker-main-test"
    added = []
    adder = threading.Thread(target=lambda: added.append(r.add_replica(
        spec=echo_spec(scale=3), cfg=CFG, transport="socket", spawn=False,
        listener=listener, token=token)))
    adder.start()
    assert _wait_until(lambda: token in listener._handlers)
    host, port = listener.address
    code = ((_NO_MSGPACK if no_msgpack else "") +
            "from repro_torch.cluster import worker_main; "
            f"worker_main.main(['--connect', '{host}:{port}', "
            f"'--token', '{token}'])")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    try:
        adder.join(60.0)
        assert added and added[0].alive, "worker never became ready"
        t = added[0]
        reqs = [r.submit(i) for i in range(12)]
        tup = r.submit((1, 2))
        assert [r.wait(q, 30.0) for q in reqs] == [3 * i for i in range(12)]
        out = r.wait(tup, 30.0)
        assert out == (1, 2) * 3 and isinstance(out, tuple)
        assert _wait_until(
            lambda: t.metrics_snapshot().get("replica.batch_s.count", 0) > 0)
        r.stop()
        assert proc.wait(30.0) == 0, "a drained worker exits cleanly"
    finally:
        if proc.poll() is None:
            proc.kill()
        listener.close()


def test_worker_main_connect_serves_and_drains():
    _serve_through_worker_main(no_msgpack=False)


def test_control_plane_without_msgpack(monkeypatch):
    """Both ends without msgpack, as on the card's machine: every frame,
    the hello included, goes pickled, and the listener accepts it."""
    monkeypatch.setattr(framing, "msgpack", None)
    monkeypatch.setattr(wire, "msgpack", None)
    assert framing.encode_frame(("hb", 1, 0.0, {}, [], []))[:1] == b"P"
    _serve_through_worker_main(no_msgpack=True)


# ----------------------------------------------------------------------
# process death

def test_sigkilled_process_replica_spills_zero_lost():
    m = MetricsRegistry()
    r = Router(policy="round_robin", metrics=m, max_retries=5)
    workers = [r.add_replica(spec=echo_spec(delay_s=0.005), cfg=CFG,
                             transport="process") for _ in range(2)]
    reqs = [r.submit(i) for i in range(40)]
    time.sleep(0.02)
    workers[0].inject_crash()                       # SIGKILL
    assert [r.wait(q, 30.0) for q in reqs] == [2 * i for i in range(40)]
    assert all(q.status is Status.OK for q in reqs)
    assert _wait_until(lambda: not workers[0].alive)
    assert r.n_alive() == 1
    assert _wait_until(lambda: m.snapshot().get("replica.crashes", 0) == 1)
    assert m.snapshot().get("router.failed", 0) == 0
    r.stop()


def test_replica_kill_dumps_flight_events_to_artifact_store():
    """A SIGKILLed worker leaves a crash dump of the parent's flight
    events in the artifact store.  The receive thread writes it when it
    sees the death, which may come after every request has completed
    elsewhere, so the test waits for the dump."""
    from repro_torch.cluster import default_flight_store
    r = Router(policy="round_robin", metrics=MetricsRegistry(),
               max_retries=3)
    workers = [r.add_replica(spec=echo_spec(delay_s=0.01), cfg=CFG,
                             transport="process") for _ in range(2)]
    reqs = [r.submit(i) for i in range(20)]
    time.sleep(0.03)
    workers[0].inject_crash()
    assert [r.wait(q, 30.0) for q in reqs] == [2 * i for i in range(20)]
    assert _wait_until(lambda: workers[0].flight_dumps), "no crash dump"
    doc = json.loads(default_flight_store().read_bytes(
        workers[0].flight_dumps[-1]))
    assert doc["rid"] == workers[0].rid
    kinds = [e["kind"] for e in doc["parent_events"]]
    assert "submit" in kinds and "replica_death" in kinds
    for e in doc["parent_events"]:      # the recorder is process-wide
        if e["kind"] == "spill" and e.get("replica") == workers[0].rid:
            assert set(e["rids"]) <= {q.rid for q in reqs}
    r.stop()


# ----------------------------------------------------------------------
# the drain-time KV hand-off over a real process boundary
# (tests/test_kv_lifecycle.py:309-340)

def test_process_drain_publishes_kv_state_and_migrates():
    """A drained process replica of the paged engine publishes its prefix
    blocks before it leaves, and the router ships them to the session's
    new home: that worker adopts them (its counters arrive over the
    heartbeats) and serves the continuation warm, with the tokens of an
    in-process engine on the same seeded weights."""
    kw = dict(max_len=48, slots=2, sync_every=4, paged=True, block_size=8,
              kv_blocks=24, prefix_cache=True)
    r = Router(policy="session_affinity", metrics=MetricsRegistry())
    cfg = ReplicaConfig(max_batch=2, spawn_timeout_s=120.0)
    workers = [r.add_replica(spec=engine_spec(device="cpu", **kw), cfg=cfg,
                             transport="process", kind="lm")
               for _ in range(2)]
    prompt = np.random.RandomState(23).randint(0, 256, size=17).astype(
        np.int32)
    q = r.submit((prompt.copy(), 8), session_key="sess-3", kind="lm",
                 timeout_s=120.0)
    toks = r.wait(q, 120.0)
    assert isinstance(toks, list)
    home = q.replica_rid
    r.remove_replica(home, drain=True, migrate=True)
    assert r.metrics.snapshot().get("router.sessions_migrated", 0) >= 1
    cont = np.concatenate([prompt, np.asarray(toks, np.int32)])
    q2 = r.submit((cont.copy(), 6), session_key="sess-3", kind="lm",
                  timeout_s=120.0)
    toks2 = r.wait(q2, 120.0)
    assert isinstance(toks2, list) and q2.replica_rid != home
    assert _wait_until(
        lambda: r.cluster_snapshot().get("engine.kv_import_blocks", 0) > 0
        and r.cluster_snapshot().get("engine.prefix_hit_blocks", 0) > 0)
    r.stop()
    eng = make_engine(device="cpu", **kw)
    want = eng.submit(cont.copy(), max_new=6)
    eng.run_until_drained()
    assert toks2 == want.out_tokens
    assert not any(w.alive for w in workers)


# ----------------------------------------------------------------------
# one chaos episode (pieces of tests/chaos.py)

ACTIONS = ("kill", "crash", "drop", "delay")


@dataclasses.dataclass(frozen=True)
class Fault:
    at_s: float
    action: str
    target: int
    duration_s: float = 0.05


def random_schedule(seed: int, n_faults: int, horizon_s: float,
                    n_replicas: int) -> List[Fault]:
    rng = np.random.RandomState(seed)
    faults = [Fault(at_s=float(rng.uniform(0.0, horizon_s)),
                    action=str(rng.choice(list(ACTIONS))),
                    target=int(rng.randint(n_replicas)),
                    duration_s=float(rng.uniform(0.02, 0.15)))
              for _ in range(n_faults)]
    return sorted(faults, key=lambda f: f.at_s)


class _CompletionCounter:
    """Counts ``ClusterRequest.complete`` calls per request, so a request
    completed twice cannot hide behind the last writer's result."""

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._orig = None

    def __enter__(self):
        self._orig = ClusterRequest.complete
        counter = self

        def counting_complete(req, result, replica_rid):
            with counter._lock:
                counter.counts[id(req)] = counter.counts.get(id(req), 0) + 1
            return counter._orig(req, result, replica_rid)

        ClusterRequest.complete = counting_complete
        return self

    def __exit__(self, *exc):
        ClusterRequest.complete = self._orig
        return False


def _apply_fault(fault: Fault, workers, gate: threading.Event) -> None:
    if fault.action == "delay":
        gate.clear()
        time.sleep(fault.duration_s)
        gate.set()
        return
    workers[fault.target % len(workers)].inject_crash()


@pytest.mark.parametrize("seed", [3, 1234])
def test_chaos_thread_episode_never_loses_or_doubles(seed):
    n_requests, horizon_s, timeout_s = 90, 0.5, 60.0
    faults = random_schedule(seed, n_faults=3, horizon_s=horizon_s,
                             n_replicas=3)
    metrics = MetricsRegistry()
    router = Router(policy="round_robin", metrics=metrics, max_retries=8,
                    requeue_timeout_s=3.0)
    cfg = ReplicaConfig(inbox_capacity=512, max_batch=4,
                        heartbeat_timeout_s=1.5)
    workers = [router.add_replica(spec=echo_spec(delay_s=0.002), cfg=cfg,
                                  transport="thread") for _ in range(3)]
    gate = threading.Event()
    gate.set()
    reqs: List[ClusterRequest] = []
    with _CompletionCounter() as counter:
        start = time.monotonic()
        stop_faults = threading.Event()

        def fault_loop():
            for f in faults:
                wait = start + f.at_s - time.monotonic()
                if wait > 0 and stop_faults.wait(wait):
                    return
                _apply_fault(f, workers, gate)

        injector = threading.Thread(target=fault_loop, daemon=True)
        injector.start()
        try:
            for i in range(n_requests):
                gate.wait(1.0)
                reqs.append(router.submit(i, session_key=f"s{i % 7}",
                                          timeout_s=timeout_s))
                time.sleep(horizon_s / n_requests)
            t_end = time.monotonic() + timeout_s
            for q in reqs:
                q.done.wait(max(t_end - time.monotonic(), 0.1))
        finally:
            stop_faults.set()
            injector.join(timeout=5.0)
            router.stop(drain=True)
        lost = [q.payload for q in reqs if not q.done.is_set()]
        double = [q.payload for q in reqs
                  if counter.counts.get(id(q), 0) > 1]
    assert not lost, f"lost: {lost[:10]}"
    assert not double, f"double-completed: {double[:10]}"
    assert not [q.payload for q in reqs
                if q.status is Status.OK and q.result != 2 * q.payload]
    terminal = (Status.OK, Status.REJECTED, Status.FAILED, Status.CANCELLED,
                Status.EXPIRED)
    assert all(q.status in terminal for q in reqs)
