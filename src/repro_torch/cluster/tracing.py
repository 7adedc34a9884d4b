"""Request tracing and the crash flight recorder, copied from
``repro.cluster.tracing`` (the part the engine uses).

  * :class:`Tracer` — thread-safe span factory over a bounded ring buffer.
    Disabled tracers return the shared no-op :data:`NULL_SPAN`; enabled
    ones sample per root and children inherit the root's decision through
    their :class:`TraceContext`.
  * :class:`FlightRecorder` — an always-on ring of the last N structured
    events (admits, COW copies, KV evictions, ...).
  * :func:`annotate` — a ``torch.profiler.record_function`` range around
    an engine stage, so host-side stage names land in a PyTorch profiler
    trace next to the kernels.

The exporters (Chrome trace, Prometheus text) wait for the port of the
cluster layer (ROADMAP.md, Queue 1, item 4).
"""
from __future__ import annotations

import itertools
import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch


def _scalar(v: Any) -> Any:
    """Coerce a tag value to something msgpack/json-safe."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_scalar(x) for x in v]
    item = getattr(v, "item", None)         # numpy / torch scalars
    if callable(item):
        try:
            return item()
        except Exception:                   # noqa: BLE001 - best-effort tag
            pass
    return str(v)


class TraceContext:
    """What propagates across a process boundary: enough to parent a
    remote span and to honor the root's sampling decision."""

    __slots__ = ("trace_id", "span_id", "sampled", "attempt")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True,
                 attempt: int = 0):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.attempt = attempt

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
    """Shared no-op span: the whole cost of disabled tracing."""

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
    ``span(name)`` with no parent is a root and makes the sampling
    decision; ``span(name, parent=ctx_or_span)`` inherits it."""

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

    def _record(self, span_dict: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span_dict)

    def spans(self) -> List[Dict[str, Any]]:
        """Non-destructive snapshot (export / assertions)."""
        with self._lock:
            return list(self._spans)


#: shared disabled tracer: the default for every component not given one
NULL_TRACER = Tracer(enabled=False, capacity=1)

_TRACER: Tracer = NULL_TRACER
_TRACER_LOCK = threading.Lock()


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Install the process-wide tracer; ``None`` restores the no-op."""
    global _TRACER
    with _TRACER_LOCK:
        _TRACER = tracer if tracer is not None else NULL_TRACER


def current_tracer() -> Tracer:
    return _TRACER


class FlightRecorder:
    """Bounded ring of ``{"seq", "t", "wall", "kind", ...fields}`` events
    with a monotonic ``seq`` per recorder."""

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

    @property
    def last_seq(self) -> int:
        return self._seq


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def set_recorder(recorder: Optional[FlightRecorder]) -> None:
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = recorder


def current_recorder() -> FlightRecorder:
    """Process-wide flight recorder, lazily created (always on)."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


def annotate(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` around an
    engine stage; it costs next to nothing while no profiler runs."""
    return torch.profiler.record_function(name)
