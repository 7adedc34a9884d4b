"""Phase-2 join semantics, the port of ``repro.core.joins`` (paper §5.1
batch join, §5.2 stream scopes).

Every join is a pair grid: claims (C, d) x evidence (E, d) with a
validity mask, the static-shape form of the paper's per-key Cartesian
product.  Three scopes:

  scope-batch   pairs valid iff same document key        (Listing 2 `join`)
  scope-window  pairs valid iff timestamps within a window   (Listing 3 `window`)
  scope-file    stateful: a growing claim collection per key joined against
                newly arrived evidence               (Listing 3 `updateStateByKey`)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.filtering import Compacted


def pair_mask_batch(claims: Compacted, evidence: Compacted) -> torch.Tensor:
    """(C, E) bool: same-key valid pairs."""
    same = claims.keys[:, None] == evidence.keys[None, :]
    return same & claims.valid[:, None] & evidence.valid[None, :]


def pair_mask_window(claim_ts, evid_ts, claims_valid, evid_valid,
                     window: float) -> torch.Tensor:
    """(C, E) bool: pairs whose arrival timestamps lie within ``window``
    (float32 timestamps, as in the JAX package)."""
    dt = torch.abs(claim_ts[:, None] - evid_ts[None, :])
    return (dt <= window) & claims_valid[:, None] & evid_valid[None, :]


# ----------------------------------------------------------------------
def ring_writes(cursor, valid, cap: int):
    """Where a ring of ``cap`` rows whose next free slot is ``cursor``
    takes the valid rows of a batch, in order: for each ring slot the
    batch row written there (-1 for none), and the new cursor.

    Invalid rows write nothing, which is what the JAX package's scatter
    to slot ``cap`` with ``mode="drop"`` does (``index_put_`` would raise
    on that slot, and clamping it would overwrite the last slot).  Where
    more than ``cap`` valid rows arrive, the later row wins a slot.  No
    host sync: the rows are found by a scatter-max, not by ``nonzero``."""
    rank = torch.cumsum(valid.to(torch.int64), 0)
    slots = (cursor + rank - 1) % cap
    rows = torch.arange(valid.shape[0], device=valid.device)
    src = torch.full((cap,), -1, dtype=torch.int64, device=valid.device)
    src.scatter_reduce_(0, torch.where(valid, slots, 0),
                        torch.where(valid, rows, -1), reduce="amax")
    return src, (cursor + valid.sum()) % cap


def ring_put(old, new, src):
    """``old`` with slot s replaced by ``new[src[s]]`` where ``src[s] >=
    0`` (``src`` from :func:`ring_writes`)."""
    if new.shape[0] == 0:
        return old
    hit = (src >= 0).view(-1, *([1] * (old.dim() - 1)))
    return torch.where(hit, new[src.clamp(min=0)].to(old.dtype), old)


class FileScopeState(NamedTuple):
    """Stateful claim collection (paper's updateStateByKey), fixed capacity.

    A ring of the most recent ``cap`` claims with doc keys; new evidence
    joins against every retained claim with a matching key.
    """
    feats: torch.Tensor    # (cap, d)
    scores: torch.Tensor   # (cap,)
    keys: torch.Tensor     # (cap,)
    valid: torch.Tensor    # (cap,)
    cursor: torch.Tensor   # () next write slot


def init_file_scope(cap: int, d: int, device="cpu") -> FileScopeState:
    return FileScopeState(
        feats=torch.zeros((cap, d), dtype=torch.float32, device=device),
        scores=torch.zeros((cap,), dtype=torch.float32, device=device),
        keys=torch.full((cap,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((cap,), dtype=torch.bool, device=device),
        cursor=torch.zeros((), dtype=torch.int64, device=device),
    )


def update_file_scope(state: FileScopeState, new: Compacted) -> FileScopeState:
    """Append newly detected claims into the ring (oldest evicted)."""
    src, cursor = ring_writes(state.cursor, new.valid, state.feats.shape[0])
    return FileScopeState(ring_put(state.feats, new.feats, src),
                          ring_put(state.scores, new.scores, src),
                          ring_put(state.keys, new.keys, src),
                          ring_put(state.valid, new.valid, src),
                          cursor)


def file_scope_mask(state: FileScopeState, evidence: Compacted) -> torch.Tensor:
    same = state.keys[:, None] == evidence.keys[None, :].to(torch.int32)
    return same & state.valid[:, None] & evidence.valid[None, :]
