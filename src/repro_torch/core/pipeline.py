"""The two-phase pipeline, the paper's contribution, ported from
``repro.core.pipeline``.

Phase 1 (map):   every instance is scored independently by the broadcast
                 models (claim + evidence detectors).          [Listing 1]
Filter:          static-shape compaction of positives (per shard), which
                 is what bounds the phase-2 shuffle.           [§3.1 / §3.2]
Phase 2 (join+map): the compacted claims are all-gathered over the data
                 axis (the shuffle), evidence stays local, and every shard
                 scores its (C_total x E_local) pair block; pairs of one
                 document are valid.                           [Listing 2]

On one device the step is :func:`batch_step_local`.  On a mesh
(``make_batch_step(pcfg, mesh)``) each rank of the ``data`` axis runs
JAX's ``shard_map`` body on its own rows, over ``torch.distributed``
(``core.collectives``); ranks that differ only on other axes compute the
same blocks, as ``shard_map`` replicates over them.

Phase 2's full-rank scoring always runs the hand-written pair-score
kernel on a CUDA tensor (``svm.link_score_matrix`` ->
``kernels.ops.pair_score``); ``use_pair_kernel`` is kept for parity with
the JAX config, where it chooses between the Pallas kernel and plain
``jnp``, and does not change the port's route.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.core import collectives, joins
from repro_torch.core.filtering import Compacted, compact_by_score
from repro_torch.models import svm as svm_mod


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    feat_dim: int = 1024
    claim_capacity: int = 64        # per shard
    evid_capacity: int = 128        # per shard
    threshold: float = 0.0
    svm_gamma: float = 0.1
    svm_coef0: float = 1.0
    svm_degree: int = 2
    link_rank: int = 0              # 0 -> full bilinear
    use_pair_kernel: bool = False   # JAX's route switch; see module doc


class PipelineOut(NamedTuple):
    link_scores: torch.Tensor   # (C, E) pair scores, fp32
    pair_valid: torch.Tensor    # (C, E) bool
    claim_index: torch.Tensor   # (C,) original row ids (-1 invalid)
    evid_index: torch.Tensor    # (E,)
    claim_keys: torch.Tensor    # (C,)
    evid_keys: torch.Tensor     # (E,)
    n_dropped: torch.Tensor     # () compaction overflow count


def init_models(pcfg: PipelineConfig, generator: torch.Generator,
                n_sv: int = 1024, device="cuda"):
    """Claim/evidence polynomial SVMs of ``n_sv`` support vectors each and
    the link model (the paper's three classifiers), drawn from
    ``generator``, which must live on ``device``."""
    return {
        "claim": svm_mod.init_svm(generator, n_sv, pcfg.feat_dim, device),
        "evidence": svm_mod.init_svm(generator, n_sv, pcfg.feat_dim, device),
        "link": svm_mod.init_link(generator, pcfg.feat_dim,
                                  rank=pcfg.link_rank, device=device),
    }


# ----------------------------------------------------------------------
def _phase1_local(models, X, keys, pcfg: PipelineConfig):
    kw = dict(gamma=pcfg.svm_gamma, coef0=pcfg.svm_coef0,
              degree=pcfg.svm_degree)
    c_sc = svm_mod.svm_score(models["claim"], X, **kw)
    e_sc = svm_mod.svm_score(models["evidence"], X, **kw)
    claims = compact_by_score(X, c_sc, keys, pcfg.claim_capacity,
                              pcfg.threshold)
    evid = compact_by_score(X, e_sc, keys, pcfg.evid_capacity,
                            pcfg.threshold)
    return claims, evid


def _phase2_local(models, claims: Compacted, evid: Compacted):
    scores = svm_mod.link_score_matrix(models["link"], claims.feats,
                                       evid.feats)
    return scores, joins.pair_mask_batch(claims, evid)


def batch_step_local(models, X, keys, pcfg: PipelineConfig) -> PipelineOut:
    """Single-device step: X (n, d) fp32 features and keys (n,) int32
    document ids on the models' device."""
    claims, evid = _phase1_local(models, X, keys, pcfg)
    scores, mask = _phase2_local(models, claims, evid)
    return PipelineOut(scores, mask, claims.index, evid.index,
                       claims.keys, evid.keys,
                       claims.n_dropped + evid.n_dropped)


def make_batch_step(pcfg: PipelineConfig, mesh=None,
                    data_axis: str = "data"):
    """``step(models, X, keys) -> PipelineOut``.  Without a mesh, on one
    device.  With one, ``X`` (n_local, d) and ``keys`` (n_local,) are this
    rank's block of rows along ``data_axis`` (``collectives.local_block``;
    n_local the same on every rank), and the step is JAX's ``shard_map``
    body (``pipeline.py:111-132``): phase 1 on the rank's rows, its compacted
    indices offset by ``axis_index * n_local`` to global row ids, the
    compacted claims all-gathered in axis order and ``n_dropped`` summed
    (the shuffle), then phase 2 over (C_total, E_local) pairs.  The
    output is this rank's blocks as JAX's ``out_specs`` lay them out:
    ``link_scores`` and ``pair_valid`` (C_total, E_local), the claims'
    ``claim_index`` / ``claim_keys`` whole, the evidence's its own,
    ``n_dropped`` the global count."""
    if mesh is None:
        return functools.partial(batch_step_local, pcfg=pcfg)
    mesh.axes_key(data_axis)           # raises for an axis the mesh lacks

    def step(models, X, keys) -> PipelineOut:
        claims, evid = _phase1_local(models, X, keys, pcfg)
        offset = collectives.axis_index(data_axis, mesh) * X.shape[0]
        claims = claims._replace(index=torch.where(
            claims.valid, claims.index + offset, -1))
        evid = evid._replace(index=torch.where(
            evid.valid, evid.index + offset, -1))
        # THE SHUFFLE: gather only the compacted claims (paper §3.1)
        claims_all = Compacted(
            *(collectives.all_gather(t, data_axis, mesh=mesh)
              for t in claims[:5]),
            n_dropped=collectives.psum(claims.n_dropped, data_axis, mesh))
        scores, mask = _phase2_local(models, claims_all, evid)
        n_drop = claims_all.n_dropped + collectives.psum(
            evid.n_dropped, data_axis, mesh)
        return PipelineOut(scores, mask, claims_all.index, evid.index,
                           claims_all.keys, evid.keys, n_drop)

    return step



# ----------------------------------------------------------------------
def extract_links(out: PipelineOut, threshold: float = 0.0):
    """Host-side: positive, valid (claim_row, evidence_row, score)
    triples, in row-major order of the pair grid."""
    ok = out.pair_valid & (out.link_scores > threshold)
    ci, ei = torch.nonzero(ok, as_tuple=True)
    rows = out.claim_index[ci].tolist()
    cols = out.evid_index[ei].tolist()
    scores = out.link_scores[ci, ei].tolist()
    return list(zip(rows, cols, scores))


def gather_links(out: PipelineOut, mesh, data_axis: str = "data",
                 threshold: float = 0.0):
    """The global links of a sharded step, on every rank: each rank's
    :func:`extract_links` of its own (C_total, E_local) block, gathered
    over ``data_axis`` in axis order, the set JAX's ``extract_links``
    gives on the whole output (its order is evidence shard, then the
    block's row-major order)."""
    parts = collectives.gather_objects(extract_links(out, threshold),
                                       data_axis, mesh)
    return [link for part in parts for link in part]
