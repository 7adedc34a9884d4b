"""Cross-host request tracing, flight recorder, and trace exporters,
copied from ``repro.cluster.tracing``.

The paper's evaluation (§6) reasons from end-to-end timings; a request in
this repo now crosses five stages (admission -> router -> transport ->
replica loop -> engine prefill / K-step decode), so "where did this
request spend its time" needs per-stage spans, not one wall-clock delta.

Three pieces, all cheap enough to leave compiled in:

  * :class:`Tracer` — thread-safe span factory writing finished spans
    (plain dicts) into a bounded per-process ring buffer.  Disabled
    tracers return a shared no-op span (one branch per call site);
    enabled tracers sample *per root* (``sample_rate``), and every child
    inherits the root's decision through its :class:`TraceContext`, so a
    request is traced everywhere or nowhere.
  * :class:`TraceContext` — the four scalars that cross the process /
    socket boundary (trace id, parent span id, sampled flag, attempt
    number).  It rides as an optional trailing element on ``("req", ...)``
    frames; worker-side spans ship back on the existing heartbeat channel
    exactly like metrics snapshots, and the parent's
    :meth:`Tracer.ingest` re-homes them so one buffer holds the complete
    cross-host timeline.  The at-least-once machinery bumps ``attempt``
    on every respill, so spans from a dead attempt stay distinguishable
    from the retry's instead of silently merging.
  * :class:`FlightRecorder` — an always-on ring buffer of the last N
    structured events (admits, dispatches, spills, COW copies, KV
    evictions, reconnects, partitions).  Remote workers ship increments
    over heartbeats; on replica death / ack timeout the transport dumps
    the merged event log to the artifact store (``transport.py``) so a
    chaos postmortem starts from evidence, not print statements.

Exporters: :func:`to_chrome_trace` (Chrome trace-event JSON, loadable in
Perfetto / ``chrome://tracing``, one track per replica and per stage) and
:func:`prometheus_text` (text exposition of a merged registry snapshot).
Opt-in ``torch.profiler`` hooks (:func:`start_profiling` /
:func:`stop_profiling`) put device time in a Chrome trace, and
:func:`annotate` names engine stages there.

Leaf module: imports nothing from the cluster package except
``metrics`` (itself a leaf), so every layer — wire, transport, replica,
router, engine — may import it freely.

Clock note: span times are ``time.monotonic()`` with a wall-clock anchor
recorded per span.  CLOCK_MONOTONIC is shared by every process on one
Linux host, so same-host spans (thread / process / loopback-socket
replicas) land on one comparable axis; truly remote hosts are aligned
only as well as their wall clocks (the ``wall`` anchor) — good enough
for ms-scale serving stages, and explicitly not NTP-grade.
"""
from __future__ import annotations

import itertools
import json
import os
import random
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.cluster.metrics import HIST_BUCKET_BOUNDS

_N_BUCKETS = len(HIST_BUCKET_BOUNDS) + 1


def _scalar(v: Any) -> Any:
    """Coerce a tag value to something msgpack/json-safe."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_scalar(x) for x in v]
    item = getattr(v, "item", None)         # numpy scalars
    if callable(item):
        try:
            return item()
        except Exception:                   # noqa: BLE001 - best-effort tag
            pass
    return str(v)


class TraceContext:
    """What propagates across the process/socket boundary: enough to
    parent a remote span and to honor the root's sampling decision."""

    __slots__ = ("trace_id", "span_id", "sampled", "attempt")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True,
                 attempt: int = 0):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.attempt = attempt

    def to_wire(self) -> list:
        return [self.trace_id, self.span_id,
                1 if self.sampled else 0, self.attempt]

    @staticmethod
    def from_wire(w) -> Optional["TraceContext"]:
        if not w:
            return None
        try:
            return TraceContext(str(w[0]), str(w[1]), bool(w[2]), int(w[3]))
        except (IndexError, TypeError, ValueError):
            return None                     # malformed ctx: drop, don't die

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
                f"sampled={self.sampled}, attempt={self.attempt})")


class Span:
    """One in-progress span.  ``end()`` (or ``with``-exit) freezes it into
    a plain dict in the tracer's buffer; after that it is inert."""

    __slots__ = ("_tracer", "trace_id", "span_id", "parent_id", "name",
                 "tags", "_t0", "_done")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.tags: Dict[str, Any] = {}
        self._t0 = time.monotonic()
        self._done = False

    @property
    def recording(self) -> bool:
        return True

    def context(self, attempt: int = 0) -> TraceContext:
        """Context for children of this span (carried over the wire)."""
        return TraceContext(self.trace_id, self.span_id, True, attempt)

    @property
    def ctx(self) -> TraceContext:
        return self.context()

    def tag(self, **kv) -> "Span":
        for k, v in kv.items():
            self.tags[k] = _scalar(v)
        return self

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        self._tracer._record({
            "trace": self.trace_id, "span": self.span_id,
            "parent": self.parent_id, "name": self.name,
            "t0": self._t0, "t1": time.monotonic(),
            # wall derived from the tracer's one-time base: a span start
            # costs one clock read, not two (this is the decode hot path)
            "wall": self._t0 + self._tracer._wall_base,
            "replica": self._tracer.replica, "tags": self.tags,
        })

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        if exc is not None:
            self.tag(error=repr(exc))
        self.end()
        return False


class _NullSpan:
    """Shared no-op span: the entire cost of disabled/unsampled tracing is
    returning this singleton.  Its ``ctx`` is None, so nothing propagates
    and downstream stages also no-op."""

    __slots__ = ()
    recording = False
    ctx = None

    def context(self, attempt: int = 0) -> None:
        return None

    def tag(self, **kv) -> "_NullSpan":
        return self

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span factory over a bounded per-process buffer.

    ``span(name)`` with no parent is a *root*: it makes the sampling
    decision.  ``span(name, parent=ctx_or_span)`` is a child: it inherits
    the root's decision (an unsampled root handed out a ``None`` ctx, so
    its children never reach this tracer at all).
    """

    def __init__(self, enabled: bool = True, sample_rate: float = 1.0,
                 capacity: int = 8192, replica: str = "parent"):
        self.enabled = enabled
        self.sample_rate = float(sample_rate)
        self.replica = str(replica)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._ids = itertools.count(1)
        self._prefix = f"{random.getrandbits(32):08x}"
        self._rng = random.Random(os.getpid() ^ random.getrandbits(30))
        self._wall_base = time.time() - time.monotonic()

    # -- span creation ---------------------------------------------------
    def _new_id(self) -> str:
        return f"{self._prefix}-{next(self._ids):x}"

    def span(self, name: str, parent: Any = None, **tags) -> Any:
        """Start a span.  ``parent`` may be None (root), a
        :class:`TraceContext`, or another :class:`Span`."""
        if not self.enabled:
            return NULL_SPAN
        if parent is None:
            if self.sample_rate < 1.0 and \
                    self._rng.random() >= self.sample_rate:
                return NULL_SPAN
            sp = Span(self, self._new_id(), self._new_id(), None, name)
        else:
            if isinstance(parent, (Span, _NullSpan)):
                parent = parent.ctx
            if parent is None or not parent.sampled:
                return NULL_SPAN
            sp = Span(self, parent.trace_id, self._new_id(),
                      parent.span_id, name)
            if parent.attempt:
                sp.tags["attempt"] = parent.attempt
        if tags:
            sp.tag(**tags)
        return sp

    # -- buffer ----------------------------------------------------------
    def _record(self, span_dict: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span_dict)

    def ingest(self, spans: Sequence[Dict[str, Any]],
               replica: Any = None) -> None:
        """Adopt spans shipped from a remote worker (heartbeat payload).
        ``replica`` re-homes spans the worker recorded under its own
        default label."""
        if not spans:
            return
        with self._lock:
            for s in spans:
                if not isinstance(s, dict) or "span" not in s:
                    continue                # malformed: drop, don't die
                if replica is not None and \
                        s.get("replica") in (None, "", "worker"):
                    s = dict(s)
                    s["replica"] = str(replica)
                if len(self._spans) == self._spans.maxlen:
                    self.dropped += 1
                self._spans.append(s)

    def drain(self) -> List[Dict[str, Any]]:
        """Take-and-clear: how a worker ships its spans over heartbeats."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def spans(self) -> List[Dict[str, Any]]:
        """Non-destructive snapshot (export / assertions)."""
        with self._lock:
            return list(self._spans)


#: shared disabled tracer: the default for every component that was not
#: handed (or globally given) a real one.
NULL_TRACER = Tracer(enabled=False, capacity=1)


_TRACER: Tracer = NULL_TRACER
_TRACER_LOCK = threading.Lock()


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Install the process-wide tracer (mirrors
    ``metrics.set_worker_registry``): worker entry points install theirs
    before ``spec.build()`` so backends adopt it; the parent installs one
    before constructing the router.  ``None`` restores the no-op."""
    global _TRACER
    with _TRACER_LOCK:
        _TRACER = tracer if tracer is not None else NULL_TRACER


def current_tracer() -> Tracer:
    return _TRACER


# ----------------------------------------------------------------------
# Flight recorder: the last N structured events, always on.

class FlightRecorder:
    """Bounded ring of ``{"seq", "t", "wall", "kind", ...fields}`` events.

    ``seq`` is monotonic per recorder, so remote workers can ship
    *increments* over heartbeats (:meth:`since`) and the parent-side
    mirror never double-counts.  Recording is one lock + dict build —
    cheap enough for per-request cluster events and per-sync engine
    events, which is the point: the buffer must already be populated when
    the crash happens."""

    def __init__(self, capacity: int = 512, replica: str = ""):
        self.capacity = capacity
        self.replica = str(replica)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._seq = 0

    def record(self, kind: str, **fields) -> None:
        with self._lock:
            self._seq += 1
            evt = {"seq": self._seq, "t": time.monotonic(),
                   "wall": time.time(), "kind": kind}
            if self.replica:
                evt["replica"] = self.replica
            for k, v in fields.items():
                evt[k] = _scalar(v)
            self._events.append(evt)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def since(self, seq: int) -> List[Dict[str, Any]]:
        """Events with ``seq`` strictly greater than ``seq`` (heartbeat
        increments)."""
        with self._lock:
            return [e for e in self._events if e["seq"] > seq]

    @property
    def last_seq(self) -> int:
        return self._seq

    def dump_json(self, **extra) -> bytes:
        doc = dict(extra)
        doc["events"] = self.events()
        return json.dumps(doc, sort_keys=True, default=str).encode()


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def set_recorder(recorder: Optional[FlightRecorder]) -> None:
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = recorder


def current_recorder() -> FlightRecorder:
    """Process-wide flight recorder, lazily created (always on: the ring
    must be full of history *before* anything goes wrong)."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


# ----------------------------------------------------------------------
# Exporter 1: Chrome trace-event JSON (Perfetto / chrome://tracing).

def to_chrome_trace(spans: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Complete ("X") events on one track per (replica, stage).

    ``pid`` maps replicas, ``tid`` maps stage names within a replica, and
    metadata events give both human names, so Perfetto renders one lane
    per replica with its stages stacked.  ``ts`` is the span's monotonic
    start in µs (same-host comparable; see module docstring), ``args``
    carries ids + tags so a span's tree is reconstructible from the file.
    """
    events: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    for s in spans:
        replica = str(s.get("replica", "parent"))
        if replica not in pids:
            pids[replica] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[replica], "tid": 0,
                           "args": {"name": f"replica:{replica}"}})
        key = (replica, s["name"])
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == replica]) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pids[replica], "tid": tids[key],
                           "args": {"name": s["name"]}})
        args = {"trace_id": s.get("trace"), "span_id": s.get("span"),
                "parent_id": s.get("parent")}
        args.update(s.get("tags") or {})
        events.append({
            "ph": "X", "cat": "repro", "name": s["name"],
            "pid": pids[replica], "tid": tids[(replica, s["name"])],
            "ts": float(s["t0"]) * 1e6,
            "dur": max(float(s["t1"]) - float(s["t0"]), 0.0) * 1e6,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ----------------------------------------------------------------------
# Exporter 2: Prometheus text exposition of a (merged) registry snapshot.

_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    out = _PROM_SANITIZE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return f"{prefix}_{out}" if prefix else out


def prometheus_text(snapshot: Dict[str, float],
                    prefix: str = "repro") -> str:
    """Render a flat ``snapshot()`` / ``cluster_snapshot()`` dict as
    Prometheus text exposition.

    Histogram stems (keys shipping ``.count`` + ``.p50``) become native
    histograms — cumulative ``_bucket{le=...}`` series rebuilt from the
    ``.le<i>`` counts against :data:`~repro_torch.cluster.metrics.
    HIST_BUCKET_BOUNDS`, plus ``_sum`` (mean x count) and ``_count`` —
    with the snapshot's percentile estimates exported alongside as
    ``<stem>_p50`` etc. gauges.  Everything else exports as a gauge.

    Conformance hardening (all repairs, never assertions — the exporter
    runs on telemetry paths and must not raise on a weird merge):

    * ``_bucket`` series are monotone non-decreasing by construction —
      negative per-bucket increments (a torn merge) clamp to zero;
    * ``le="+Inf"`` always equals ``_count``, including for legacy
      bucket-less stems, and both are raised to the bucket total when
      the buckets have seen more than ``.count`` reports;
    * every metric gets a ``# HELP`` line before its ``# TYPE``;
    * two source keys sanitizing to the same metric name do not
      interleave: the later (sorted) key is emitted under a
      deterministic ``_dup<n>`` suffix instead.
    """
    lines: List[str] = []
    consumed = set()
    used_names: Dict[str, str] = {}     # emitted base name -> source key

    def unique(name: str, source: str, *derived: str) -> str:
        """Claim ``name`` (and histogram-derived series names) for
        ``source``; on a collision pick the first free ``_dup<n>``."""
        base, n = name, 1
        while any(d in used_names for d in (name, *[f"{name}{s}"
                                                    for s in derived])):
            n += 1
            name = f"{base}_dup{n}"
        used_names[name] = source
        for s in derived:
            used_names[f"{name}{s}"] = source
        return name

    stems = sorted(k[:-len(".count")] for k in snapshot
                   if k.endswith(".count")
                   and f"{k[:-len('.count')]}.p50" in snapshot)
    for stem in stems:
        name = unique(_prom_name(stem, prefix), stem,
                      "_bucket", "_sum", "_count")
        count = snapshot[f"{stem}.count"]
        mean = snapshot.get(f"{stem}.mean", 0.0)
        consumed.update({f"{stem}.count", f"{stem}.mean"})
        lines.append(f"# HELP {name} histogram of {stem} "
                     f"(merged cluster snapshot)")
        lines.append(f"# TYPE {name} histogram")
        cum = 0.0
        for i, bound in enumerate(HIST_BUCKET_BOUNDS):
            cum += max(snapshot.get(f"{stem}.le{i}", 0.0), 0.0)
            consumed.add(f"{stem}.le{i}")
            lines.append(f'{name}_bucket{{le="{bound:.6g}"}} {cum:.6g}')
        overflow_key = f"{stem}.le{len(HIST_BUCKET_BOUNDS)}"
        consumed.add(overflow_key)
        # +Inf must equal _count even for legacy snapshots with no
        # buckets, and must not dip below the finite-bucket cumulative
        total = max(count, cum + max(snapshot.get(overflow_key, 0.0), 0.0))
        lines.append(f'{name}_bucket{{le="+Inf"}} {total:.6g}')
        lines.append(f"{name}_sum {mean * count:.6g}")
        lines.append(f"{name}_count {total:.6g}")
        for p in (50, 95, 99):
            key = f"{stem}.p{p}"
            if key in snapshot:
                consumed.add(key)
                pname = unique(f"{name}_p{p}", key)
                lines.append(f"# HELP {pname} p{p} estimate of {stem}")
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {snapshot[key]:.6g}")
    for k in sorted(snapshot):
        if k in consumed:
            continue
        name = unique(_prom_name(k, prefix), k)
        lines.append(f"# HELP {name} value of {k}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {snapshot[k]:.6g}")
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# Opt-in torch.profiler hooks: device time in a Chrome trace.

_PROFILER = None
_PROFILE_DIR = ""


def start_profiling(log_dir: str) -> None:
    """Start a ``torch.profiler`` trace of the host and, where there is
    one, the card; :func:`stop_profiling` writes it into ``log_dir``."""
    global _PROFILER, _PROFILE_DIR
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _PROFILER, _PROFILE_DIR = prof, log_dir


def stop_profiling() -> Optional[str]:
    """Stop the trace :func:`start_profiling` began and write it as
    ``trace_<pid>.json`` into its directory; returns that path."""
    global _PROFILER
    prof, _PROFILER = _PROFILER, None
    if prof is None:
        return None
    prof.stop()
    path = os.path.join(_PROFILE_DIR, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


def annotate(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` around an
    engine stage, so host-side stage names land in a profiler trace next
    to the kernels; it costs next to nothing while no profiler runs.
    torch is imported here, not at module import, so a worker process of
    a pure-Python backend never loads it."""
    import torch
    return torch.profiler.record_function(name)
