"""Process-wide tracing state (``repro.core.flags``): the dry run's count
route and the counter it reports to.

JAX's module holds ``COST_MODE``, which its cost pass sets so that the
models unroll their scans: XLA's ``cost_analysis`` counts a while/scan body
once whatever its trip count.  The port counts at the Python level, where
every trip of a loop is an op of its own, so it has no such flag.

:func:`counted` says whether a tensor takes the count route: a fake tensor
(``torch._subclasses.fake_tensor``; tested before the device, since a fake
tensor may report any device).  A ``meta`` tensor is not one: it has no
route and raises.  A kernel op or collective on the count route launches
and builds nothing, calls no group, and returns an empty result of its
real shape and dtype.

:func:`add` and :func:`add_collective` hand one call's work to the active
counter (:func:`set_counter`; ``launch/dryrun_lib.Counter``).  The counter
is process-wide, since the autograd engine runs a CUDA backward on threads
of its own; with none active a report costs one test.  A kernel's launch
count (``kernels.LAUNCHES``) is the card's alone: the count route reports
to the counter and leaves it be.
"""
from __future__ import annotations

from torch._subclasses.fake_tensor import is_fake

_COUNTER = None


def counted(t) -> bool:
    """A fake tensor: the call is counted, not launched."""
    return is_fake(t)


def set_counter(counter):
    """Make ``counter`` (or None) the one that :func:`add` and
    :func:`add_collective` report to, and return the one it replaces.  It
    has ``kernel(name, work)`` and ``collective(op, buf_bytes, group,
    wire_bytes)``."""
    global _COUNTER
    prev, _COUNTER = _COUNTER, counter
    return prev


def add(name: str, work_fn, *args, **kwargs) -> None:
    """Report one call of kernel ``name`` with ``work_fn(*args,
    **kwargs)``'s work (``kernels.work``), where a counter is active."""
    if _COUNTER is not None:
        _COUNTER.kernel(name, work_fn(*args, **kwargs))


def add_collective(op: str, buf_bytes: int, group: int) -> None:
    """Report one collective (an HLO op name) over ``group`` ranks of a
    ``buf_bytes`` buffer, where a counter is active."""
    if _COUNTER is not None:
        _COUNTER.collective(op, buf_bytes, group,
                            wire_bytes(op, buf_bytes, group))


def wire_bytes(op: str, buf: float, g: int) -> float:
    """Bytes one rank sends for a collective, by JAX's dry-run formulas
    (``repro.launch.dryrun_lib.parse_collectives``): all-reduce 2 buf (g -
    1) / g; reduce-scatter buf (g - 1), buf the result (the shard);
    all-gather and all-to-all buf (g - 1) / g, buf the gathered result;
    collective-permute buf.  A ``collective-broadcast`` (not in JAX's
    table: XLA emits none for its programs) counts buf, a permute's."""
    g = max(g, 1)
    if op == "all-reduce":
        return 2 * buf * (g - 1) / g
    if op == "reduce-scatter":
        return buf * (g - 1)
    if op in ("all-gather", "all-to-all"):
        return buf * (g - 1) / g
    if op in ("collective-permute", "collective-broadcast"):
        return buf
    raise ValueError(f"unknown collective {op!r}")
