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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp


def capacity(T: int, cfg) -> int:
    """Slots an expert for ``T`` tokens (``moe.py:51``)."""
    return int(max(1, (T * cfg.top_k) // cfg.n_experts *
                   cfg.capacity_factor))


def apply_moe(params, x, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux loss, an fp32 scalar)
    (``moe.py:33-84``); with shared experts their dense MLP
    (``params["shared"]``) is added to every token's routed sum
    (``:82-83``)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xf = x.reshape(T, d)

    logits = (xf @ params["router"]).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                 # (T, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    # load-balancing aux loss (Switch-style)
    first = torch.zeros(E, dtype=torch.float32, device=dev).scatter_add_(
        0, top_e[:, 0], torch.ones(T, dtype=torch.float32, device=dev))
    density = first / T                   # the mean of one_hot(top_e[:, 0])
    aux = (density * probs.mean(0)).mean() * (E * E) * cfg.router_aux_weight

    # slot of each (token, pick) within its expert: its rank in a stable
    # sort of the flat expert ids, which keeps token order within an
    # expert.  A token's k experts are distinct, so the order of topk's
    # picks within a token does not change any slot.
    cap = capacity(T, cfg)
    flat_e = top_e.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    slot_sorted = torch.arange(T * k, device=dev) - starts[flat_e[order]]
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    keep = slot < cap
    dest = flat_e * cap + slot.clamp(0, cap - 1)

    # scatter the kept picks' tokens into (E*cap, d) expert buffers
    src = torch.arange(T * k, device=dev) // k
    contrib = torch.where(keep[:, None], xf[src],
                          torch.zeros((), dtype=x.dtype, device=dev))
    buf = torch.zeros(E * cap, d, dtype=x.dtype, device=dev).index_add_(
        0, dest, contrib).view(E, cap, d)

    # the experts' SwiGLU, batched over experts
    g = F.silu(torch.bmm(buf, params["w_gate"]))
    h = g * torch.bmm(buf, params["w_up"])
    eout = torch.bmm(h, params["w_down"]).reshape(E * cap, d)

    # combine: each token sums its k weighted picks; a dropped pick weighs 0
    w = (top_p.reshape(-1) * keep).to(x.dtype)
    out = (eout[dest] * w[:, None]).view(T, k, d).sum(1).reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + apply_mlp(params["shared"], x, cfg)
    return out, aux
