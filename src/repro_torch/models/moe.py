"""Mixture-of-Experts FFN of the port (``repro.models.moe.apply_moe``): a
top-k router and capacity-based dispatch into per-expert buffers, the
experts' SwiGLU as batched products, the weighted combine, and the shared
experts' dense MLP where the config has them (deepseek-v2-lite).

Expert capacity couples the rows of a batch: ``cap = int(max(1, (T*k) //
E * capacity_factor))`` slots an expert, filled in token order, so a
token's output depends on which other tokens share its call.  The port
copies the capacity rule, the stable token order and the clip exactly, so
its tokens match the JAX engines' whatever shares a step.

Every shape is fixed by ``(T, k, E, cap)`` and nothing reads back to the
host, so a decode step stays capturable.  The dispatch is JAX's
scatter-add: a buffer slot receives at most one kept row and otherwise
exact zeros, so its sum is exact in any order.  The combine is a sum over
each token's k picks, not a scatter-add, so a run's bf16 result does not
depend on the order of atomics.  The router, the dispatch and the expert
products are PyTorch ops, as the JAX package computes them in plain
``jnp`` outside any Pallas kernel.

On a batch split over mesh axes (``core.sharding.batch_axes``: each rank
holds its own rows), capacity, slots and the aux loss are the whole
batch's, as JAX's GSPMD computes them: the ranks' (E,) counts of picks
and of first picks are all-gathered, a pick's slot is its rank's offset
(the picks of the ranks before it at that expert, the global token list
being batch-major) plus its slot among the rank's own picks, and the aux
loss takes the whole batch's first-pick density times this rank's mean
router probability, so that the ranks' mean of it (the data-parallel
step's weighting) is the whole batch's aux loss and so is its gradient.
A rank's buffers then hold ``min(cap, T_local)`` slots an expert.

On a sequence split too (``seqtp`` at a sharded length: ``seq``, the
rank holding positions ``[off, off + S_loc)`` of each of its rows), the
global token (b, s) is number b S + s, so a pick at an expert comes
after every pick of the rows before b on every rank and the picks of row
b on the ranks of ``model`` before this one: the (row, expert) counts
are all-gathered over ``model`` and a pick's slot takes those offsets
(the batch split of the paragraph above is the case of whole rows a
rank, and the two compose on a (data, model) mesh).  The aux loss's mean
router probability is then the whole sequence's, summed over ``model``
(``collectives.seq_sum_same``), so every rank of ``model`` computes the
same aux loss, the one-rank loss of its rows: over ``model`` the ranks
compute one loss (the train step weights each rank's gradients by 1 /
n), over the data axes they take the mean.  Under
``tp`` (``core.sharding.tp_mesh``) each rank fills and runs its E / n
experts' buffers; the router runs whole on every rank (its gradient is
then whole too: the combine weights enter the region, so their gradient
is summed over ``model`` before it reaches the router, and the aux loss
is every rank's own), and the combine, with the shared experts' partial
MLP, is summed over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.core.sharding import batch_axes, current_ctx, tp_mesh
from repro_torch.models.attention import SEQSHARD_ROUTES
from repro_torch.models.layers import apply_mlp


def capacity(T: int, cfg) -> int:
    """Slots an expert for ``T`` tokens (``moe.py:51``)."""
    return int(max(1, (T * cfg.top_k) // cfg.n_experts *
                   cfg.capacity_factor))


def _exclusive_cumsum(x, dim):
    return torch.cumsum(x, dim) - x


def apply_moe(params, x, cfg, seq=None):
    """x: (B, S, d) -> (out (B, S, d), aux loss, an fp32 scalar)
    (``moe.py:33-84``); with shared experts their dense MLP
    (``params["shared"]``) is added to every token's routed sum
    (``:82-83``).  ``seq``: the mesh of a sequence-sharded pass, x this
    rank's positions of its rows (the module docstring)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xf = x.reshape(T, d)
    tp = tp_mesh()
    rows = batch_axes()

    logits = (xf @ params["router"]).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                 # (T, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    # picks and first picks an expert, and the same of the whole batch
    flat_e = top_e.reshape(-1)                                  # (T*k,)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    first = torch.zeros(E, dtype=torch.float32, device=dev).scatter_add_(
        0, top_e[:, 0], torch.ones(T, dtype=torch.float32, device=dev))
    # the picks before this rank's, at each pick's expert: of the rows
    # before its row on every rank of ``model`` and of its row on the
    # ranks before this one (a sequence split), then of the data ranks
    # before this one
    before, T_all, group, first_all, pm = 0, T, counts, first, None
    if seq is not None:
        SEQSHARD_ROUTES["moe"] += 1
        row_e = (torch.arange(T * k, device=dev) // (k * S)) * E + flat_e
        C = torch.zeros(B * E, dtype=torch.long, device=dev).scatter_add_(
            0, row_e, torch.ones_like(flat_e)).view(B, E)
        every = collectives.all_gather(
            torch.cat([C, first.long()[None]]), "model", tiled=False,
            mesh=seq)                                       # (n, B + 1, E)
        Cm = every[:, :B]
        i = collectives.axis_index("model", seq)
        before = (_exclusive_cumsum(Cm.sum(0), 0) + Cm[:i].sum(0) -
                  _exclusive_cumsum(C, 0)).view(-1)[row_e]
        T_all = T * every.shape[0]
        group, first_all = Cm.sum((0, 1)), every[:, B].sum(0).float()
        pm = collectives.seq_sum_same(probs.sum(0), "model", seq) / T_all
    if rows:
        mesh = current_ctx().mesh
        every = collectives.all_gather(
            torch.stack([group, first_all.long()]), rows, tiled=False,
            mesh=mesh)                                          # (n, 2, E)
        before = before + every[:collectives.axis_index(rows, mesh), 0].sum(
            0)[flat_e]
        T_all = T_all * every.shape[0]
        first_all = every[:, 1].sum(0).float()
    cap = capacity(T_all, cfg)
    cap_buf = min(cap, T) if T_all != T else cap

    # load-balancing aux loss (Switch-style)
    density = first_all / T_all           # the mean of one_hot(top_e[:, 0])
    pm = probs.mean(0) if pm is None else pm
    aux = (density * pm).mean() * (E * E) * cfg.router_aux_weight

    # slot of each (token, pick) within its expert: its rank in a stable
    # sort of the flat expert ids, which keeps token order within an
    # expert.  A token's k experts are distinct, so the order of topk's
    # picks within a token does not change any slot.
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    slot_sorted = torch.arange(T * k, device=dev) - starts[flat_e[order]]
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    keep = slot + before < cap

    # this rank's experts: all E, or under tp its block of E / n
    if tp is None:
        E_loc, e_rel, w_p, xs = E, flat_e, top_p, xf
    else:
        E_loc = params["w_gate"].shape[0]
        e_rel = flat_e - collectives.axis_index("model", tp) * E_loc
        keep = keep & (e_rel >= 0) & (e_rel < E_loc)
        e_rel = e_rel.clamp(0, E_loc - 1)
        w_p = collectives.tp_enter(top_p, "model", tp)
        xs = collectives.tp_enter(xf, "model", tp)
    dest = e_rel * cap_buf + slot.clamp(0, cap_buf - 1)

    # scatter the kept picks' tokens into (E*cap, d) expert buffers
    src = torch.arange(T * k, device=dev) // k
    contrib = torch.where(keep[:, None], xs[src],
                          torch.zeros((), dtype=x.dtype, device=dev))
    buf = torch.zeros(E_loc * cap_buf, d, dtype=x.dtype,
                      device=dev).index_add_(0, dest, contrib).view(
        E_loc, cap_buf, d)

    # the experts' SwiGLU, batched over experts
    g = F.silu(torch.bmm(buf, params["w_gate"]))
    h = g * torch.bmm(buf, params["w_up"])
    eout = torch.bmm(h, params["w_down"]).reshape(E_loc * cap_buf, d)

    # combine: each token sums its k weighted picks; a dropped pick weighs 0
    w = (w_p.reshape(-1) * keep).to(x.dtype)
    out = (eout[dest] * w[:, None]).view(T, k, d).sum(1).reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + apply_mlp(params["shared"], x, cfg, reduce=tp is None)
    if tp is not None:
        out = collectives.tp_reduce(out, "model", tp)
    return out, aux
