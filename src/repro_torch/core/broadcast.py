"""Weight placement of the port (``repro.core.broadcast``): the paper's
broadcast variable, and beyond, on ``torch.distributed``.

:func:`place_params` puts a parameter tree on a mesh under a policy:

  broadcast, seqtp — every rank holds the whole tree: rank 0 of the mesh
              ships its tree to every other rank with ``dist.broadcast``,
              leaf by leaf (the paper's §3.1 solution: the model is
              immutable during prediction, send it once);
  tp, fsdp_tp — each rank keeps its slice of each leaf, as the leaf's spec
              cuts it (the paper Conclusion's "portion of the trained
              model per node"); every rank holds the whole host value
              before, as every process does in a multi-controller
              ``jax.device_put``.

A rank that receives the broadcast passes a tree of the same structure
whose leaves give only shapes and dtypes (``models.weights.empty_params``
or tensors on the ``meta`` device).  :func:`per_chip_bytes` is JAX's
count, from names and sizes alone.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import collectives
from repro_torch.core.sharding import NamedSharding, ShardingCtx, _rules, \
    param_shardings
from repro_torch.tree import tree_leaves, tree_map

#: the policies whose ranks each hold the whole tree
REPLICATED = ("broadcast", "seqtp")


def placement_shardings(axes_tree, mesh, policy: str):
    ctx = ShardingCtx(mesh, policy, _rules(policy, mesh.axis_names))
    return param_shardings(axes_tree, ctx)


def ship(params, mesh):
    """Rank 0 of ``mesh``'s tree on every rank of it, leaf by leaf with
    ``dist.broadcast``, each leaf on the rank's device; a receiving
    rank's leaves give shapes and dtypes only.  Returns ``(tree, bytes
    moved to or from this rank)``."""
    dev = mesh.device
    sent = [0]

    def one(t):
        out = t.to(dev) if t.device.type != "meta" and \
            mesh.axis_index(mesh.axis_names) == 0 else \
            torch.empty(t.shape, dtype=t.dtype, device=dev)
        collectives.broadcast(out, mesh)
        if mesh.size > 1:
            sent[0] += out.numel() * out.element_size()
        return out

    return tree_map(one, params), sent[0]


def place_params(params, axes_tree, mesh, policy: str = "broadcast"):
    """The tree placed on ``mesh`` under ``policy``; returns ``(placed,
    shardings)``, a tree of :class:`NamedSharding` beside it."""
    sh = placement_shardings(axes_tree, mesh, policy)
    if policy in REPLICATED:
        placed, _ = ship(params, mesh)
    else:
        placed = tree_map(lambda t, s: s.local_slice(t.to(mesh.device))
                          .contiguous(), params, sh)
    return placed, sh


def unshard(placed, shardings):
    """The whole leaves back from every rank's slices (an all-gather over
    each sharded dimension's axes), on every rank of the mesh."""
    def one(x, s: NamedSharding):
        for dim in range(len(s.spec)):
            axes = s.dim_axes(dim)
            if axes:
                x = collectives.all_gather(x, axes, dim=dim, mesh=s.mesh)
        return x
    return tree_map(one, placed, shardings)


def broadcast_bytes(params) -> int:
    """Bytes a broadcast placement ships to every rank."""
    return int(sum(math.prod(p.shape) * p.element_size()
                   for p in tree_leaves(params)))


def per_chip_bytes(params, shardings) -> int:
    """Bytes a rank holds under a sharded placement, JAX's count: each
    leaf's bytes over the product of its spec's mesh axis sizes."""
    total = 0
    for p, s in zip(tree_leaves(params), tree_leaves(shardings)):
        n_shards = s.n_shards() or 1
        total += int(math.prod(p.shape) * p.element_size() / n_shards)
    return total
