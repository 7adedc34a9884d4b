"""Static-shape filtering, the port of ``repro.core.filtering``: the
paper's ``.filter(score > 0)`` (Listing 1, lines 30-31) as "compact the
top-``capacity`` rows by score into a fixed buffer plus a validity mask".

The result is exact whenever the positives fit the capacity; overflow
drops the lowest-scoring positives and is counted in ``n_dropped``.  The
compacted buffer, not the whole input, is what phase 2 joins.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Compacted(NamedTuple):
    feats: torch.Tensor      # (capacity, d)   compacted feature rows
    scores: torch.Tensor     # (capacity,)
    keys: torch.Tensor       # (capacity,)     join key (doc id)
    index: torch.Tensor      # (capacity,)     original row index, -1 invalid
    valid: torch.Tensor      # (capacity,)     bool
    n_dropped: torch.Tensor  # ()              positives that did not fit


def compact_by_score(feats, scores, keys, capacity: int,
                     threshold: float = 0.0) -> Compacted:
    """Rows with ``score > threshold``, densely packed by descending score,
    in a buffer of ``min(capacity, n)`` rows.  Equal scores keep their
    input order (a stable sort, as ``jnp.argsort``), so the buffer equals
    the JAX package's element for element."""
    pos = scores > threshold
    sort_key = torch.where(pos, scores, torch.full_like(scores, -torch.inf))
    take = torch.argsort(-sort_key, stable=True)[:capacity]
    valid = pos[take]
    n_pos = pos.sum()
    return Compacted(
        feats=torch.where(valid[:, None], feats[take], 0.0),
        scores=torch.where(valid, scores[take], 0.0),
        keys=torch.where(valid, keys[take], -1),
        index=torch.where(valid, take, -1),
        valid=valid,
        n_dropped=torch.clamp(n_pos - capacity, min=0),
    )


def concat_compacted(a: Compacted, b: Compacted) -> Compacted:
    return Compacted(*[torch.cat([x, y], dim=0) for x, y in
                       list(zip(a, b))[:5]],
                     n_dropped=a.n_dropped + b.n_dropped)
