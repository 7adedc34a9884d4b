"""Micro-batch stream runtime, the port of ``repro.core.stream`` (paper
§5.2 / §6.2).

The host slices the input flow into fixed-capacity micro-batches every
``period`` seconds, pads each to a static shape and runs one step on the
device.  The phase-2 join scope is either a sliding time window over ring
buffers on the device (Listing 3, lines 17-23) or the stateful per-file
claim collection (line 11).  Both score their pairs with the hand-written
pair-score kernel on a CUDA tensor (``svm.link_score_matrix``), where the
JAX stream scores them with plain ``jnp``.

The sustainable-rate finder reproduces the paper's evaluation: ramp the
input rate and report the largest rate for which the micro-batch
processing time stays under the micro-batch period (Fig. 6b).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.cluster.metrics import MetricsRegistry
from repro_torch.core import joins
from repro_torch.core.filtering import compact_by_score
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.models import svm as svm_mod


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    period: float = 1.0             # micro-batch period, seconds
    capacity: int = 256             # max instances per micro-batch
    scope: str = "window"           # "window" | "file"
    window: float = 10.0            # seconds (scope-window)
    ring_capacity: int = 512        # claims/evidence retained on device


class RingState(NamedTuple):
    feats: torch.Tensor    # (cap, d)
    ts: torch.Tensor       # (cap,) float32 arrival time
    keys: torch.Tensor     # (cap,) int32 doc key
    valid: torch.Tensor    # (cap,) bool
    cursor: torch.Tensor   # () next write slot


def init_ring(cap: int, d: int, device="cpu") -> RingState:
    return RingState(
        torch.zeros((cap, d), dtype=torch.float32, device=device),
        torch.full((cap,), -torch.inf, dtype=torch.float32, device=device),
        torch.full((cap,), -1, dtype=torch.int32, device=device),
        torch.zeros((cap,), dtype=torch.bool, device=device),
        torch.zeros((), dtype=torch.int64, device=device))


def ring_append(state: RingState, feats, ts, keys, valid) -> RingState:
    """Write the valid rows into the ring in order from the cursor (the
    oldest are overwritten); invalid rows write nothing."""
    src, cursor = joins.ring_writes(state.cursor, valid,
                                    state.feats.shape[0])
    return RingState(joins.ring_put(state.feats, feats, src),
                     joins.ring_put(state.ts, ts, src),
                     joins.ring_put(state.keys, keys, src),
                     joins.ring_put(state.valid, valid, src),
                     cursor)


class StreamState(NamedTuple):
    claims: RingState
    evidence: RingState
    microbatch_id: int          # replay cursor


def init_stream_state(scfg: StreamConfig, pcfg: PipelineConfig,
                      device="cpu") -> StreamState:
    return StreamState(init_ring(scfg.ring_capacity, pcfg.feat_dim, device),
                       init_ring(scfg.ring_capacity, pcfg.feat_dim, device),
                       0)


# ----------------------------------------------------------------------
def make_stream_step(pcfg: PipelineConfig, scfg: StreamConfig):
    """``step(models, state, X, keys, ts, valid) -> (state, (scores, mask,
    n_dropped))``.  X: (capacity, d) padded micro-batch on the models'
    device; ``valid`` marks real rows; ``ts`` is float32 (so is every
    window test, as in the JAX package: float64 would move rows across
    the window's edge)."""
    kw = dict(gamma=pcfg.svm_gamma, coef0=pcfg.svm_coef0,
              degree=pcfg.svm_degree)

    def step(models, state: StreamState, X, keys, ts, valid):
        neg = torch.full_like(ts, -torch.inf)
        c_sc = torch.where(valid, svm_mod.svm_score(models["claim"], X, **kw),
                           neg)
        e_sc = torch.where(valid,
                           svm_mod.svm_score(models["evidence"], X, **kw), neg)
        claims = compact_by_score(X, c_sc, keys, pcfg.claim_capacity,
                                  pcfg.threshold)
        evid = compact_by_score(X, e_sc, keys, pcfg.evid_capacity,
                                pcfg.threshold)
        c_ts = torch.where(claims.valid, ts[claims.index.clamp(min=0)],
                           -torch.inf)
        e_ts = torch.where(evid.valid, ts[evid.index.clamp(min=0)],
                           -torch.inf)

        new_claims = ring_append(state.claims, claims.feats, c_ts,
                                 claims.keys, claims.valid)
        new_evid = ring_append(state.evidence, evid.feats, e_ts,
                               evid.keys, evid.valid)

        if scfg.scope == "window":
            now = torch.max(torch.where(valid, ts, neg))
            in_win_c = new_claims.valid & (new_claims.ts > now - scfg.window)
            in_win_e = new_evid.valid & (new_evid.ts > now - scfg.window)
            scores = svm_mod.link_score_matrix(models["link"],
                                               new_claims.feats,
                                               new_evid.feats)
            mask = joins.pair_mask_window(new_claims.ts, new_evid.ts,
                                          in_win_c, in_win_e, scfg.window)
        else:  # scope-file: retained claims x NEW evidence only
            scores = svm_mod.link_score_matrix(models["link"],
                                               new_claims.feats, evid.feats)
            mask = ((new_claims.keys[:, None] ==
                     evid.keys[None, :].to(torch.int32))
                    & new_claims.valid[:, None] & evid.valid[None, :])

        state = StreamState(new_claims, new_evid, state.microbatch_id + 1)
        return state, (scores, mask, claims.n_dropped + evid.n_dropped)

    return step


# ----------------------------------------------------------------------
@dataclasses.dataclass
class MicrobatchStats:
    mb_id: int
    n_in: int
    busy_s: float
    n_links: int


class StreamRuntime:
    """Host driver: slices an instance flow into micro-batches and runs the
    step on the models' device; tracks per-micro-batch busy time
    (fall-behind detection).  With a ``checkpointer`` (the port's
    ``Checkpointer``) it saves ``{"state": ...}`` after every
    ``checkpoint_every``-th micro-batch under JAX's keys
    (``state/.claims/.feats``, ..., ``state/.microbatch_id``), the
    micro-batch id as a 0-d int32 array as JAX keeps it; :meth:`restore`
    reads such a step, the JAX runtime's included, and the stream goes on
    from it exactly."""

    def __init__(self, models, pcfg: PipelineConfig, scfg: StreamConfig,
                 checkpointer=None, checkpoint_every: int = 0,
                 metrics: Optional[MetricsRegistry] = None):
        self.models = models
        self.pcfg, self.scfg = pcfg, scfg
        self.device = models["link"]["w"].device
        self.step = make_stream_step(pcfg, scfg)
        self.state = init_stream_state(scfg, pcfg, self.device)
        self.stats: List[MicrobatchStats] = []
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    def _saved_state(self) -> StreamState:
        return self.state._replace(microbatch_id=np.asarray(
            self.state.microbatch_id, dtype=np.int32))

    def restore(self, step: Optional[int] = None) -> None:
        """The stream state of checkpoint ``step`` (default the latest),
        on the models' device in this runtime's dtypes."""
        self.state = self.checkpointer.restore(
            {"state": self._saved_state()}, step)["state"]
        self.state = self.state._replace(
            microbatch_id=int(self.state.microbatch_id))

    def process_microbatch(self, X: np.ndarray, keys: np.ndarray,
                           ts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Process one micro-batch period's worth of input.  Input beyond the
        device capacity is processed in successive chunks within the same
        period (busy time accumulates: this is what makes the runtime
        *fall behind* at excessive rates instead of silently dropping).
        Returns the last chunk's scores and links (mask & score > 0)."""
        cap = self.scfg.capacity
        total = len(X)
        busy = 0.0
        sc = ok = None
        n_links = 0
        dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        for start in range(0, max(total, 1), cap):
            n = min(cap, total - start) if total else 0
            Xp = np.zeros((cap, self.pcfg.feat_dim), np.float32)
            kp = np.full((cap,), -1, np.int32)
            tp = np.full((cap,), -np.inf, np.float32)
            vp = np.zeros((cap,), bool)
            if n:
                sl = slice(start, start + n)
                Xp[:n], kp[:n], tp[:n], vp[:n] = X[sl], keys[sl], ts[sl], True
            t0 = time.perf_counter()
            self.state, (scores, mask, n_drop) = self.step(
                self.models, self.state, dev(Xp), dev(kp), dev(tp), dev(vp))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            busy += time.perf_counter() - t0
            sc = scores.cpu().numpy()
            ok = mask.cpu().numpy() & (sc > 0)
            n_links += int(ok.sum())

        mb_id = self.state.microbatch_id
        self.stats.append(MicrobatchStats(mb_id, total, busy, n_links))
        self.metrics.counter("stream.microbatches").inc()
        self.metrics.counter("stream.instances").inc(total)
        self.metrics.counter("stream.links").inc(n_links)
        self.metrics.histogram("stream.busy_s").observe(busy)
        self.metrics.gauge("stream.falling_behind").set(
            float(self.falling_behind()))
        if self.checkpointer and self.checkpoint_every and \
                mb_id % self.checkpoint_every == 0:
            self.checkpointer.save(mb_id, {"state": self._saved_state()})
        return sc, ok

    def falling_behind(self, last_k: int = 3) -> bool:
        recent = self.stats[-last_k:]
        return bool(recent) and all(s.busy_s > self.scfg.period for s in recent)


def find_sustainable_rate(make_runtime: Callable[[], "StreamRuntime"],
                          gen_microbatch: Callable[[int, float], tuple],
                          rates: List[float], mb_per_rate: int = 5) -> float:
    """Paper Fig. 6b methodology: ramp the input rate (instances/sec of
    stream content), return the highest rate that does not fall behind."""
    best = 0.0
    for rate in rates:
        rt = make_runtime()
        n_per_mb = max(1, int(rate * rt.scfg.period))
        for i in range(mb_per_rate):
            X, keys, ts = gen_microbatch(n_per_mb, i * rt.scfg.period)
            rt.process_microbatch(X, keys, ts)
        if rt.falling_behind(last_k=max(1, mb_per_rate - 2)):
            break
        best = rate
    return best
