"""Straggler mitigation for the batch driver, the port of
``repro.core.fault`` (paper §3: "autonomous fault-tolerant mechanisms").

  * speculative_map: partitions whose latency exceeds ``straggler_factor``
    x the running median are speculatively re-dispatched; the first
    completion wins (Spark's ``spark.speculation``).  Worker failures
    (exceptions) are retried on other workers up to ``max_retries``.

Plain Python threads, copied with two repairs.  A straggler's latency
is counted from when its attempt starts running, where the JAX copy
counts from submission, so every partition queued behind the workers
(more partitions than workers) looked like a straggler and ran again;
and at most two attempts of a partition are in flight, which the JAX
copy meant (``list(set).count(i) < 2`` is always true).

  * ReplayLog: the trainer's append-only jsonl of processed
    micro-batches (``fault.py:105-133``), a verbatim copy.

  * ElasticRunner: the weights held across a mesh and re-placed when the
    mesh is rescaled (node loss, scale-up), on ``torch.distributed``.
    JAX has one controller for all devices; here each rank runs its own,
    so every rank of the world builds the new mesh and calls
    :meth:`ElasticRunner.rescale` together.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional, Sequence


# ----------------------------------------------------------------------
@dataclasses.dataclass
class SpecStats:
    launched: int = 0
    speculated: int = 0
    retried_failures: int = 0
    wasted_completions: int = 0


def speculative_map(fn: Callable[[Any], Any], partitions: Sequence[Any],
                    n_workers: int, *, straggler_factor: float = 3.0,
                    min_median_s: float = 1e-4, max_retries: int = 2,
                    poll_s: float = 0.005) -> tuple[List[Any], SpecStats]:
    """Run fn over partitions on a worker pool with straggler re-dispatch
    and failure retry.  Returns (results in order, stats)."""
    stats = SpecStats()
    results: List[Any] = [None] * len(partitions)
    done = [False] * len(partitions)
    attempts: Dict[int, int] = {i: 0 for i in range(len(partitions))}
    durations: List[float] = []
    lock = threading.Lock()
    started: Dict[int, float] = {}         # attempt id -> when it started

    def run_one(i, aid):
        t0 = started[aid] = time.perf_counter()
        out = fn(partitions[i])
        return i, out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        futures: Dict[Future, tuple[int, int]] = {}

        def launch(i):
            attempts[i] += 1
            stats.launched += 1
            futures[ex.submit(run_one, i, stats.launched)] = (i,
                                                              stats.launched)

        for i in range(len(partitions)):
            launch(i)

        while futures:
            finished, _ = wait(list(futures), timeout=poll_s,
                               return_when=FIRST_COMPLETED)
            for f in finished:
                i, _ = futures.pop(f)
                try:
                    idx, out, dur = f.result()
                except Exception:
                    stats.retried_failures += 1
                    if attempts[i] <= max_retries:
                        launch(i)
                    else:
                        raise
                    continue
                with lock:
                    durations.append(dur)
                    if done[idx]:
                        stats.wasted_completions += 1
                    else:
                        results[idx] = out
                        done[idx] = True
            # speculate on stragglers: attempts that have run (not waited
            # in the pool's queue) longer than the cutoff, at most two
            # attempts of a partition in flight
            if durations:
                med = sorted(durations)[len(durations) // 2]
                cutoff = max(med * straggler_factor, min_median_s)
                now = time.perf_counter()
                inflight = [i for (i, _) in futures.values()]
                for f, (i, aid) in list(futures.items()):
                    t_start = started.get(aid)
                    if not done[i] and t_start is not None and \
                            now - t_start > cutoff and \
                            inflight.count(i) < 2 and \
                            attempts[i] <= max_retries:
                        stats.speculated += 1
                        inflight.append(i)
                        launch(i)
    return results, stats


# ----------------------------------------------------------------------
class ReplayLog:
    """Append-only jsonl of processed micro-batches for crash replay."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def record(self, mb_id: int, offset: int, seed: int = 0, **extra):
        entry = {"mb_id": mb_id, "offset": offset, "seed": seed,
                 "t": time.time(), **extra}
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def entries(self) -> List[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def resume_point(self, checkpoint_mb: int) -> Optional[dict]:
        """First entry after the last checkpoint: where replay starts."""
        for e in self.entries():
            if e["mb_id"] > checkpoint_mb:
                return e
        return None


# ----------------------------------------------------------------------
class ElasticRunner:
    """Holds ``(params, mesh, policy)`` and re-places the weights when the
    mesh is rescaled (``fault.py:135-155``).  Construction places the
    tree (``core.broadcast.place_params``: under ``broadcast`` rank 0 of
    the mesh ships it); :meth:`rescale` moves it onto a new mesh of the
    same world and bumps ``generation``.  A rank outside the mesh holds
    no weights (``params`` None).  ``shipped_bytes`` and ``rescale_s``
    are the last rescale's bytes moved to or from this rank and its
    seconds."""

    def __init__(self, params, axes_tree, mesh, policy: str = "broadcast"):
        import torch

        from repro_torch.core.broadcast import place_params
        from repro_torch.tree import tree_map
        self.axes_tree = axes_tree
        self.policy = policy
        self.mesh = mesh
        # shapes and dtypes only: what a rank that joins later allocates
        self.template = tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), params)
        self.params, self.shardings = place_params(params, axes_tree, mesh,
                                                   policy) \
            if mesh.is_member else (None, None)
        self.generation = 0
        self.shipped_bytes = 0
        self.rescale_s = 0.0

    def rescale(self, new_mesh):
        """Elastic re-mesh, on every rank of the world at once: the old
        mesh's ranks rebuild the whole tree from their slices (nothing to
        do under a replicated policy), the new mesh's rank 0 ships it to
        the ranks of the new mesh, each keeps what the policy gives it,
        and a rank outside the new mesh drops its weights.  The new mesh's
        rank 0 must hold the weights: a mesh over ranks ``0 .. n - 1``
        (``launch.mesh.compat_make_mesh``) always has it."""
        from repro_torch.core.broadcast import REPLICATED, place_params, \
            placement_shardings, ship, unshard
        t0 = time.perf_counter()
        full = self.template
        if self.params is not None:
            full = self.params if self.policy in REPLICATED else \
                unshard(self.params, self.shardings)
        self.params = self.shardings = None
        self.mesh = new_mesh
        self.shipped_bytes = 0
        if new_mesh.is_member:
            full, self.shipped_bytes = ship(full, new_mesh)
            if self.policy in REPLICATED:
                self.params = full
                self.shardings = placement_shardings(
                    self.axes_tree, new_mesh, self.policy)
            else:
                self.params, self.shardings = place_params(
                    full, self.axes_tree, new_mesh, self.policy)
        del full
        self.generation += 1
        self.rescale_s = time.perf_counter() - t0
        return self.params
