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

Unlike GSPMD, nothing here moves activations: under ``broadcast`` and
``seqtp`` each rank's activations are already its own rows or positions,
so :func:`shard` checks the rank of ``x`` and returns it.  The compute of
the weight-sharded policies (tensor-parallel layers) is not in the port:
a model forward under ``tp`` or ``fsdp_tp`` raises
(:func:`require_replicated_weights`, ROADMAP.md, Queue 1, item 14).
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


def require_replicated_weights(what: str) -> None:
    """Raise under a weight-sharded policy, whose layers the port cannot
    compute yet."""
    ctx = current_ctx()
    if ctx is not None and ctx.policy in ("tp", "fsdp_tp"):
        raise NotImplementedError(
            f"{what} under policy {ctx.policy!r}: the tensor-parallel "
            f"layers are not in the port yet: ROADMAP.md, Queue 1, item 14")


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """JAX's activation constraint: ``x`` as it is (each rank holds its
    own rows or positions already) after checking its rank; raises under
    a weight-sharded policy."""
    ctx = current_ctx()
    if ctx is None:
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"axes {logical_axes} vs rank {x.dim()}")
    require_replicated_weights("shard")
    return x


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
