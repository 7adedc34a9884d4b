"""AdamW, the cosine schedule and global-norm clipping of the port
(``repro.optim.adamw``): plain PyTorch, as JAX's are plain ``jnp``, with
JAX's arithmetic in the same order.  The learning rate of a step comes
from the step count *before* the increment, so step 0 trains at lr 0 and
leaves the parameters as they are (its moments still move).  Weight decay
0.1 applies to every leaf, norms and the embedding included.  The moments
are fp32, the update is computed in fp32 and cast back to each parameter's
dtype, and ``step`` is an int32 scalar.  Trees are those of
:mod:`repro_torch.tree`; nothing is updated in place.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import collectives
from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero moments in fp32 beside each parameter, step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree_map(zeros, params), tree_map(zeros, params))


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``min_ratio * peak_lr`` at ``total`` (``adamw.py:28-34``);
    ``step`` an integer tensor, the result an fp32 scalar."""
    step = step.float()
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def clip_by_global_norm(grads, max_norm: float, shardings=None):
    """``(grads * min(1, max_norm / max(norm, 1e-9)), norm)`` with the
    norm over every leaf in fp32 (``adamw.py:37-41``).  As JAX promotes a
    bf16 gradient times the fp32 scale, the clipped leaves are fp32.

    With ``shardings`` (a tree of ``core.sharding.NamedSharding`` beside
    ``grads``: each leaf is this rank's block) every leaf counts once:
    the sums of squares of the leaves that a spec splits over the same
    mesh axes are added, and that sum is summed over those axes."""
    leaves = tree_leaves(grads)
    if shardings is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in leaves))
    else:
        groups = {}
        for g, s in zip(leaves, tree_leaves(shardings)):
            axes = tuple(a for d in range(len(s.spec))
                         for a in s.dim_axes(d))
            part = torch.sum(torch.square(g.float()))
            groups[axes] = groups[axes] + part if axes in groups else part
        mesh = tree_leaves(shardings)[0].mesh
        gn = torch.sqrt(sum(collectives.psum(v, axes, mesh) if axes else v
                            for axes, v in groups.items()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    clip = lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale  # noqa: E731
    return tree_map(clip, grads), gn


def adamw_update(params, grads, state: AdamWState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1):
    """One AdamW step (``adamw.py:44-65``) -> (new params, new state)."""
    step = state.step + 1
    t = step.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * g32 * g32
        mhat = m2 / (1 - b1 ** t)
        vhat = v2 / (1 - b2 ** t)
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state.m, state.v)
    # unzip the 3-tuples
    is_triple = lambda o: isinstance(o, tuple) and len(o) == 3 and \
        isinstance(o[0], torch.Tensor)  # noqa: E731
    new_p, new_m, new_v = (tree_map(lambda o: o[i], out, is_leaf=is_triple)
                           for i in range(3))
    return new_p, AdamWState(step, new_m, new_v)
