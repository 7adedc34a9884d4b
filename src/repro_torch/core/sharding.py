"""Logical-axis sharding of the port (``repro.core.sharding``): the
paper's "broadcast variable" (§3.1) and its Conclusion's "give each node
a portion of the trained model", on ``torch.distributed``.

Every parameter has a tuple of *logical* axis names (``"embed"``,
``"ff"``, ``"heads"``, ``"experts"``, ...; ``models.weights.param_axes``).
A policy maps logical names to mesh axes (:func:`_rules`, JAX's table):

  * ``broadcast`` — the weights replicated on every rank, the batch split
    over every rank, data axes and ``model`` alike;
  * ``tp``        — ff / heads / vocab / experts / inner / lru split over
    ``model``, replicated over the data axes;
  * ``fsdp_tp``   — ``tp``, plus ``embed`` split over the data axes;
  * ``seqtp``     — the weights replicated, the sequence split over
    ``model`` (``models.attention.seqshard_attn_forward``).

A spec is JAX's ``PartitionSpec`` as a tuple: one entry a dimension,
each None, a mesh axis name, or a tuple of names.  Specs need only the
mesh's axis names and sizes (``launch.mesh.abstract_mesh``).

Unlike GSPMD, nothing here moves activations: each rank's activations
are already its own rows (or, under ``seqtp``, positions), so
:func:`shard` checks the rank of ``x`` and returns it.  Under ``tp`` and
``fsdp_tp`` the layers compute on their blocks themselves (the
tensor-parallel layers, Megatron's scheme): a replicated activation
enters a ``model`` region through ``collectives.tp_enter``, a column
block's product stays local, a row block's partial product leaves through
``collectives.tp_reduce``, and under ``fsdp_tp`` a layer's leaves are
gathered over the data axes at its start (:func:`fsdp_gather`).  The
helpers here say what a rank holds: :func:`tp_mesh`, :func:`col_block`,
:func:`head_block` (which heads and kv heads a ``heads`` block computes,
and whether it cuts a head) and :func:`gathered_columns` (columns of a
column-sharded matrix outside this rank's block).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import collectives
from repro_torch.tree import tree_map

Spec = Tuple


def is_axes(t) -> bool:
    """A logical-axes leaf: a tuple of None and names (JAX's ``is_axes``)."""
    return isinstance(t, tuple) and not hasattr(t, "_fields") and all(
        a is None or isinstance(a, str) for a in t)


def _rules(policy: str, mesh_axes: Tuple[str, ...]):
    data_axes = tuple(a for a in ("pod", "data") if a in mesh_axes)
    model = "model" if "model" in mesh_axes else None
    if policy == "broadcast":
        return {"batch": data_axes + ((model,) if model else ())}
    if policy == "tp":
        return {"batch": data_axes, "ff": model, "heads": model,
                "vocab": model, "experts": model, "inner": model,
                "lru": model}
    if policy == "fsdp_tp":
        return {"batch": data_axes, "ff": model, "heads": model,
                "vocab": model, "experts": model, "inner": model,
                "lru": model, "embed": data_axes}
    if policy == "seqtp":
        return {"batch": data_axes, "seq": model}
    raise ValueError(f"unknown policy {policy!r}")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``); a leaf of the
    port's trees."""
    mesh: object
    spec: Spec

    def __post_init__(self):
        # a one-name tuple is that name and an empty one None, as
        # PartitionSpec normalises them
        object.__setattr__(self, "spec", tuple(
            (p[0] if len(p) == 1 else p or None) if isinstance(p, tuple)
            else p for p in self.spec))
        axes = [a for i in range(len(self.spec)) for a in self.dim_axes(i)]
        if len(set(axes)) != len(axes):
            raise ValueError(f"spec {self.spec} maps a mesh axis to more "
                             f"than one dimension (as jax.sharding."
                             f"NamedSharding refuses)")

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        part = self.spec[dim] if dim < len(self.spec) else None
        return () if part is None else ((part,) if isinstance(part, str)
                                        else tuple(part))

    def n_shards(self) -> int:
        """How many blocks the spec cuts a leaf into."""
        return math.prod(self.mesh.shape[a] for i in range(len(self.spec))
                         for a in self.dim_axes(i))

    def local_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``x`` (a view): each
        dimension cut into its axes' row-major product of equal blocks."""
        for dim in range(len(self.spec)):
            if self.dim_axes(dim):
                x = collectives.local_block(x, self.dim_axes(dim), self.mesh,
                                            dim)
        return x


class ShardingCtx(NamedTuple):
    mesh: object
    policy: str
    rules: dict

    def spec_for(self, logical_axes: Tuple[Optional[str], ...]) -> Spec:
        """JAX's ``spec_for``: each logical axis's mesh axes, a mesh axis
        used at most once (the first dimension that asks keeps it)."""
        parts, used = [], set()
        for ax in logical_axes:
            m = self.rules.get(ax)
            if m is None:
                parts.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(a for a in ms if a not in used)
            used.update(ms)
            parts.append(None if not ms else (ms[0] if len(ms) == 1 else ms))
        return tuple(parts)

    def sharding_for(self, logical_axes) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(logical_axes))


_local = threading.local()


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, policy: str = "broadcast", rules=None):
    prev = current_ctx()
    if mesh is None:
        _local.ctx = None
    else:
        _local.ctx = ShardingCtx(
            mesh, policy,
            rules if rules is not None else _rules(policy, mesh.axis_names))
    try:
        yield _local.ctx
    finally:
        _local.ctx = prev


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """JAX's activation constraint: ``x`` as it is (each rank holds its
    own rows or positions already) after checking its rank."""
    ctx = current_ctx()
    if ctx is not None and len(logical_axes) != x.dim():
        raise ValueError(f"axes {logical_axes} vs rank {x.dim()}")
    return x


# ----------------------------------------------------------------------
# What a rank holds under a weight-sharded policy
TP_POLICIES = ("tp", "fsdp_tp")


def tp_mesh():
    """The mesh whose ``model`` axis splits the weights: the context's
    under ``tp`` / ``fsdp_tp`` with more than one rank on ``model``, else
    None (every layer then runs its one-device code)."""
    ctx = current_ctx()
    if ctx is None or ctx.policy not in TP_POLICIES or \
            ctx.mesh.shape.get("model", 1) == 1:
        return None
    return ctx.mesh


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering a ``model`` region under ``tp``
    (``collectives.tp_enter``: its gradient summed over ``model``); ``x``
    itself otherwise."""
    mesh = tp_mesh()
    return x if mesh is None else collectives.tp_enter(x, "model", mesh)


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """A row block's partial product summed over ``model`` under ``tp``
    (``collectives.tp_reduce``); ``x`` itself otherwise."""
    mesh = tp_mesh()
    return x if mesh is None else collectives.tp_reduce(x, "model", mesh)


def col_block(n: int, mesh) -> Tuple[int, int]:
    """This rank's block ``[c0, c1)`` of ``n`` columns split over
    ``model``."""
    k = mesh.axis_size("model")
    if n % k:
        raise ValueError(f"{n} columns do not split over model ({k} ranks)")
    i = mesh.axis_index("model")
    return i * n // k, (i + 1) * n // k


class HeadBlock(NamedTuple):
    """A ``heads`` block's attention: columns ``[c0, c1)`` of the H * hd
    (the rank's block of ``wq``'s columns and ``wo``'s rows), the heads
    ``[h0, h1)`` it computes and the kv heads ``[kv0, kv1)`` they read.
    ``cuts``: the computed heads are not the block's columns (the block
    cuts a head, or its whole heads do not map onto whole kv heads), so
    q's columns come from a gather over ``model``."""
    c0: int
    c1: int
    h0: int
    h1: int
    kv0: int
    kv1: int
    hd: int
    cuts: bool

    @property
    def heads(self) -> int:
        return self.h1 - self.h0


def head_block(H: int, KV: int, hd: int, mesh) -> HeadBlock:
    """The heads this rank computes for its block of the H * hd columns:
    the whole heads the block touches, which read kv heads ``h // G``
    (G = H / KV).  Where they span more than one kv head and do not
    start and end on a group's edge, whole groups are computed, so that
    the kernels' mapping (q head j reads kv head j // G_local) holds."""
    c0, c1 = col_block(H * hd, mesh)
    G = H // KV
    h0, h1 = c0 // hd, -(-c1 // hd)
    kv0, kv1 = h0 // G, (h1 - 1) // G + 1
    if kv1 - kv0 > 1 and (h0 % G or h1 % G):
        h0, h1 = kv0 * G, kv1 * G
    return HeadBlock(c0, c1, h0, h1, kv0, kv1, hd,
                     (h0 * hd, h1 * hd) != (c0, c1))


def gathered_columns(x: torch.Tensor, w: torch.Tensor, spans, mesh):
    """``x @ W[:, lo:hi]`` for each ``(lo, hi)`` of ``spans``, where W is
    the whole matrix whose column block ``w`` this rank holds: through an
    all-gather over ``model`` of the smaller of the product's blocks
    (tokens x columns) and the weight's (rows x columns)."""
    tokens = x.numel() // max(x.shape[-1], 1)
    if tokens < w.shape[0]:
        whole = collectives.tp_gather(x @ w, "model", -1, mesh)
        return [whole[..., lo:hi] for lo, hi in spans]
    W = collectives.tp_gather(w, "model", -1, mesh)
    return [x @ W[:, lo:hi] for lo, hi in spans]


def fsdp_active() -> bool:
    """Does the context split ``embed`` over the data axes (``fsdp_tp``)?"""
    ctx = current_ctx()
    return ctx is not None and bool(ctx.rules.get("embed"))


def fsdp_gather_leaf(x: torch.Tensor, logical_axes) -> torch.Tensor:
    """The leaf whole over the data axes under ``fsdp_tp``: each dimension
    the policy splits over them all-gathered (``collectives.tp_gather``:
    its gradient reduce-scattered back); ``x`` itself otherwise."""
    if not fsdp_active():
        return x
    ctx = current_ctx()
    spec = NamedSharding(ctx.mesh, ctx.spec_for(logical_axes))
    for d in range(len(logical_axes)):
        axes = tuple(a for a in spec.dim_axes(d) if a != "model")
        if axes:
            x = collectives.tp_gather(x, axes, d, ctx.mesh)
    return x


def stack_axes(axes_tree):
    """One repeat's logical axes of a stacked tree's (each leaf's leading
    ``"layers"`` dropped), for :func:`fsdp_gather`."""
    return tree_map(lambda a: a[1:], axes_tree, is_leaf=is_axes)


def fsdp_gather(tree, axes_tree):
    """:func:`fsdp_gather_leaf` of every leaf of ``tree`` (a layer's
    parameters) with its logical axes from ``axes_tree``; ``tree`` itself
    where ``axes_tree`` is None."""
    if axes_tree is None:
        return tree
    return tree_map(fsdp_gather_leaf, tree, axes_tree)


def batch_axes() -> Tuple[str, ...]:
    """The mesh axes the batch's rows are split over under the current
    context, where each rank holds its own rows (under ``seqtp`` the data
    axes, ``model`` taking the sequence); ``()`` where they are not
    split."""
    ctx = current_ctx()
    if ctx is None:
        return ()
    m = ctx.rules.get("batch") or ()
    axes = (m,) if isinstance(m, str) else tuple(m)
    return axes if axes and ctx.mesh.axis_size(axes) > 1 else ()


def param_shardings(axes_tree, ctx: Optional[ShardingCtx] = None):
    """A tree of :class:`NamedSharding` for a logical-axes tree."""
    ctx = ctx or current_ctx()
    if ctx is None:
        return None
    return tree_map(ctx.sharding_for, axes_tree, is_leaf=is_axes)


def batch_spec(ctx: Optional[ShardingCtx], extra_dims: int = 1) -> Spec:
    """The spec of (batch, ...) inputs."""
    if ctx is None:
        return ()
    m = ctx.rules.get("batch") or ()
    first = m if len(m) > 1 else (m[0] if m else None)
    return (first,) + (None,) * extra_dims
