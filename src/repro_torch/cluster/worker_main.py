"""Standalone socket-replica worker: the remote half of
:class:`~repro_torch.cluster.transport.SocketTransport`.

Run on any host that can reach the parent's
:class:`~repro_torch.cluster.wire.WorkerListener`::

    PYTHONPATH=src python -m repro_torch.cluster.worker_main \
        --connect HOST:PORT --token TOKEN [--artifacts DIR]

Life of a worker:

  1. dial the listener and send the versioned hello
     ``("hello", PROTOCOL_VERSION, token, kind|None, spec_hash|None)`` —
     kind/hash are ``None`` on first contact (the spec has not been
     shipped yet) and the announced fingerprint thereafter;
  2. receive ``("welcome", rid, spec, cfg)``; on first contact resolve any
     ``artifact:<sha256>`` kwarg through the local content-addressed
     store, fetching missing blobs from the parent over this connection,
     then ``spec.build()`` the backend (the expensive step: torch import,
     CUDA context, weights);
  3. run :func:`~repro_torch.cluster.replica.run_replica_loop` over the
     connection until it ends, then decide:
       * crashed (injected fault / backend exception) -> exit; the parent
         spills from its table;
       * drained (parent sent ``("drain",)``) -> clean exit;
       * disconnected (EOF / reset)           -> go to 1 and *reconnect*,
         reusing the already-built backend — a network blip costs a
         handshake, not a rebuild.

A ``("reject", reason)`` at step 1/2 — version mismatch, unknown token,
spec-fingerprint mismatch, dead transport — ends the worker: the parent
has decided this worker must not serve.

Copied from ``repro.cluster.worker_main``; the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Optional, Tuple

from repro_torch.cluster.artifacts import (ArtifactStore, resolve_spec,
                                           spec_fingerprint)
from repro_torch.cluster.metrics import MetricsRegistry
from repro_torch.cluster.replica import run_replica_loop
from repro_torch.cluster.transport import WorkerIO
from repro_torch.cluster.wire import (PROTOCOL_VERSION, ChannelClosed,
                                      SocketChannel, connect_channel)


def _dial(address: Tuple[str, int], window_s: float,
          retry_s: float = 0.1) -> Optional[SocketChannel]:
    """Retry-connect until the window closes (the listener may not be up
    yet, or a partition may still be healing)."""
    t_end = time.monotonic() + window_s
    while True:
        try:
            return connect_channel(address, timeout=max(retry_s, 1.0))
        except OSError:
            if time.monotonic() >= t_end:
                return None
            time.sleep(retry_s)


def _recv_blocking(chan: SocketChannel, timeout_s: float):
    t_end = time.monotonic() + timeout_s
    while time.monotonic() < t_end:
        msg = chan.recv(0.2)
        if msg is not None:
            return msg
    return None


def _fetch_over(chan: SocketChannel, digest: str, backlog: list,
                timeout_s: float = 15.0) -> Optional[bytes]:
    """Pull one artifact blob from the parent's store by content hash.

    One *attempt*: one ``("fetch", digest)`` frame, one bounded wait.
    ``resolve_spec`` wraps this in ``fetch_with_retry``, so a ``None``
    here (parent busy, frame lost) is retried with jittered backoff and
    each retry re-sends the request frame — the per-attempt timeout is
    deliberately short so retries happen while the build window is still
    open.  A late answer to a timed-out attempt is matched by digest on
    the next attempt; any non-artifact frame read while waiting (a drain
    or crash control frame racing the build) goes into ``backlog`` for
    the WorkerIO to replay — never silently dropped."""
    chan.send(("fetch", digest))
    t_end = time.monotonic() + timeout_s
    while time.monotonic() < t_end:
        msg = chan.recv(0.2)
        if msg is None:
            continue
        if msg[0] == "artifact" and msg[1] == digest:
            return msg[2]
        backlog.append(msg)
    return None


def run_worker(address: Tuple[str, int], token: str,
               artifacts_dir: Optional[str] = None,
               connect_window_s: float = 30.0,
               protocol_version: int = PROTOCOL_VERSION) -> None:
    """Connect-serve-reconnect until crashed, drained, or rejected."""
    address = (str(address[0]), int(address[1]))
    store = ArtifactStore(artifacts_dir)
    registry = MetricsRegistry()
    from repro_torch.cluster.metrics import set_worker_registry
    set_worker_registry(registry)   # builders adopt the heartbeat registry
    # follower-mode tracer (sample_rate=0: never roots a trace, always
    # honors an incoming sampled context) + flight recorder; both are
    # re-labeled with the real rid once the welcome assigns it
    from repro_torch.cluster.tracing import (FlightRecorder, Tracer,
                                             set_recorder, set_tracer)
    tracer = Tracer(enabled=True, sample_rate=0.0, replica="worker")
    set_tracer(tracer)
    recorder = FlightRecorder(replica="worker")
    set_recorder(recorder)
    backend = None
    announce_kind: Optional[str] = None
    announce_hash: Optional[str] = None
    window = connect_window_s
    while True:
        chan = _dial(address, window)
        if chan is None:
            return                      # listener unreachable: give up
        try:
            chan.send(("hello", protocol_version, token,
                       announce_kind, announce_hash))
            msg = _recv_blocking(chan, timeout_s=10.0)
        except ChannelClosed:
            chan.close()
            continue                    # races with listener churn: redial
        if msg is None or not isinstance(msg, (tuple, list)) \
                or msg[0] != "welcome":
            chan.close()
            return                      # rejected (or garbled): stand down
        _tag, rid, spec, cfg = msg[:4]
        tracer.replica = str(rid)
        recorder.replica = str(rid)
        backlog: list = []
        if backend is None:
            announce_kind = spec.kind
            announce_hash = spec_fingerprint(spec)
            # keepalive during the build: a *replacement* worker (same
            # token, parent already past first-ready) is under the
            # parent's heartbeat-timeout regime, and spec.build() can be a
            # minutes-long torch import + weight build with no other traffic
            stop_keepalive = threading.Event()

            def _keepalive():
                while not stop_keepalive.wait(cfg.heartbeat_interval_s):
                    try:
                        chan.send(("hb", 0, 0.0, {}))
                    except ChannelClosed:
                        return

            ka = threading.Thread(target=_keepalive, daemon=True,
                                  name="build-keepalive")
            ka.start()
            try:
                resolved = resolve_spec(
                    spec, store,
                    fetch=lambda d: _fetch_over(chan, d, backlog))
                backend = resolved.build()
            except ChannelClosed:
                # network blip mid-fetch: the contract says a disconnect
                # costs a handshake, not the worker — redial and retry
                stop_keepalive.set()
                chan.close()
                backend = None
                window = max(cfg.heartbeat_timeout_s, 1.0)
                continue
            except BaseException as e:  # noqa: BLE001 - report, don't raise
                try:
                    chan.send(("dead", repr(e)))
                except ChannelClosed:
                    pass
                chan.close()
                return
            finally:
                stop_keepalive.set()
                ka.join(timeout=2.0)
        io = WorkerIO(chan, cfg, rid, registry, heartbeat_thread=True,
                      backlog=backlog)
        io.send_ready()
        try:
            run_replica_loop(backend, cfg, io)
        finally:
            io.stop()
        if io.crashed or not io.disconnected:
            chan.close()
            return                      # crash or clean drain: done
        chan.close()
        # disconnected mid-service: the parent spilled our unacked work;
        # reconnect within its heartbeat window and resume on the same rid
        window = max(cfg.heartbeat_timeout_s, 1.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="standalone socket replica worker")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="the parent WorkerListener address")
    ap.add_argument("--token", required=True,
                    help="worker token registered by the parent transport")
    ap.add_argument("--artifacts", default=None,
                    help="local content-addressed artifact cache dir "
                         "(default: a shared tempdir)")
    ap.add_argument("--connect-window", type=float, default=30.0,
                    help="seconds to keep retrying the first connect")
    args = ap.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    run_worker((host or "127.0.0.1", int(port)), args.token,
               artifacts_dir=args.artifacts,
               connect_window_s=args.connect_window)


if __name__ == "__main__":
    main()
