"""Overload control: replica circuit breaking and graded brownout.

Two small, independently testable controllers the router consults on its
hot paths:

* :class:`CircuitBreaker` — a replica that crash-loops (N deaths inside a
  sliding window) is *quarantined*: the router stops ranking it for
  dispatch for a cooldown, then re-admits it through a **half-open**
  probe — exactly one request is allowed through; an ack closes the
  breaker, another death re-opens it with a fresh cooldown.  This is the
  standard three-state breaker ("Large-Scale Intelligent Microservices"
  calls it the first prerequisite of fleet stability): without it a
  flapping worker keeps winning ranking rounds and every retry lands on
  the same corpse.

* :class:`BrownoutController` — graded degradation *before* shedding.
  Overload pressure is the max of queue occupancy and KV-pool occupancy;
  crossing a level's enter threshold raises the level, and the level only
  drops after pressure falls below the (lower) exit threshold — classic
  hysteresis, so a workload oscillating around a boundary does not flap
  the ladder.  The levels degrade in cost order:

    ===== ==============================================================
    level effect
    ===== ==============================================================
    0     normal service
    1     speculative decode off (frees draft + verify compute)
    2     \\+ effective ``max_new`` halved (streams finish in half the
          decode budget, so *every* admitted stream can meet its
          deadline instead of a few finishing full-length while the
          rest expire)
    3     \\+ admission tightened (queue bound scaled down — load is
          shed at the front door rather than expiring in queues)
    ===== ==============================================================

Both take an injectable clock so tests never sleep.

Copied from ``repro.cluster.overload``; the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    #: deaths within ``window_s`` that trip the breaker
    crash_threshold: int = 3
    window_s: float = 30.0
    #: quarantine duration before the half-open probe
    cooldown_s: float = 5.0


class CircuitBreaker:
    """Per-replica crash-loop breaker: closed -> open -> half_open.

    The router records every replica death (:meth:`record_crash`) and asks
    :meth:`allow` before ranking a replica for dispatch.  ``allow`` is
    side-effect free (a replica may be ranked without being offered work);
    the probe slot is consumed by :meth:`note_dispatch` on the first
    *successful* offer after the cooldown — that request is the probe —
    and the breaker answers False until the probe resolves via
    :meth:`record_ack` (close) or :meth:`record_crash` (re-open, fresh
    cooldown).
    """

    def __init__(self, cfg: BreakerConfig = BreakerConfig(),
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self._crashes: Dict[int, Deque[float]] = {}
        self._state: Dict[int, str] = {}        # default: "closed"
        self._open_until: Dict[int, float] = {}

    def state(self, rid: int) -> str:
        return self._state.get(rid, "closed")

    def record_crash(self, rid: int) -> bool:
        """Note a death; returns True when this crash *trips* (or
        re-trips) the breaker."""
        now = self.clock()
        if self._state.get(rid) == "half_open":
            # the probe failed: straight back to open, fresh cooldown
            self._state[rid] = "open"
            self._open_until[rid] = now + self.cfg.cooldown_s
            return True
        hist = self._crashes.setdefault(
            rid, deque(maxlen=self.cfg.crash_threshold))
        hist.append(now)
        if len(hist) == self.cfg.crash_threshold and \
                now - hist[0] <= self.cfg.window_s and \
                self._state.get(rid) != "open":
            self._state[rid] = "open"
            self._open_until[rid] = now + self.cfg.cooldown_s
            return True
        return False

    def record_ack(self, rid: int) -> None:
        """A completed request closes a half-open breaker (and clears the
        crash history — the replica earned a clean slate)."""
        if self._state.get(rid) == "half_open":
            self._state[rid] = "closed"
            self._crashes.pop(rid, None)

    def allow(self, rid: int) -> bool:
        """May the router rank this replica for dispatch right now?
        Side-effect free — ranking does not imply an offer."""
        st = self._state.get(rid, "closed")
        if st == "closed":
            return True
        if st == "open":
            return self.clock() >= self._open_until.get(rid, 0.0)
        # half_open: the single probe is already in flight
        return False

    def note_dispatch(self, rid: int) -> None:
        """A request was actually offered to this replica.  The first
        offer after an open breaker's cooldown becomes the half-open
        probe; everything else is a no-op."""
        if self._state.get(rid) == "open" and \
                self.clock() >= self._open_until.get(rid, 0.0):
            self._state[rid] = "half_open"

    def forget(self, rid: int) -> None:
        """Replica removed from the pool: drop its breaker state."""
        self._crashes.pop(rid, None)
        self._state.pop(rid, None)
        self._open_until.pop(rid, None)


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    #: pressure thresholds entering levels 1..3 (monotone increasing)
    enter: tuple = (0.60, 0.75, 0.90)
    #: pressure thresholds for *leaving* levels 1..3 (each strictly below
    #: its enter threshold — the hysteresis band)
    exit: tuple = (0.45, 0.60, 0.75)

    def __post_init__(self):
        if len(self.enter) != 3 or len(self.exit) != 3:
            raise ValueError("brownout ladder has exactly 3 levels")
        if any(x >= e for e, x in zip(self.enter, self.exit)):
            raise ValueError("each exit threshold must sit below its "
                             "enter threshold (hysteresis band)")


class BrownoutController:
    """Hysteretic overload ladder over a scalar pressure signal.

    ``tick(queue_frac, kv_used_frac)`` folds the two occupancy signals
    into ``pressure = max(...)`` and moves the level at most one rung per
    call: up when pressure crosses the next enter threshold, down when it
    falls below the current level's exit threshold.  Returns the level;
    ``changed`` is True when this tick moved it (the caller broadcasts
    only on transitions).
    """

    def __init__(self, cfg: BrownoutConfig = BrownoutConfig()):
        self.cfg = cfg
        self.level = 0
        self.changed = False

    def tick(self, queue_frac: float, kv_used_frac: float = 0.0,
             extra: float = 0.0) -> int:
        """``extra`` admits additional pressure sources beyond the two
        occupancy signals — e.g. a firing SLO burn alert
        (``SLOEngine.pressure``) browning the service out *before* the
        queues themselves look full."""
        pressure = max(float(queue_frac), float(kv_used_frac),
                       float(extra))
        before = self.level
        if self.level < 3 and pressure >= self.cfg.enter[self.level]:
            self.level += 1
        elif self.level > 0 and pressure < self.cfg.exit[self.level - 1]:
            self.level -= 1
        self.changed = self.level != before
        return self.level

    #: admission scale at each level (L3 tightens the front door to 50%)
    ADMIT_SCALE = (1.0, 1.0, 1.0, 0.5)

    def admission_scale(self) -> float:
        return self.ADMIT_SCALE[self.level]
