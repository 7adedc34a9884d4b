"""Device meshes of the port (``repro.launch.mesh``) over the ranks of a
``torch.distributed`` process group.

A :class:`Mesh` names axes (``("data", "model")``, or ``("pod", "data",
"model")``) over the first ``prod(shape)`` ranks of the world, laid out
row-major: rank r sits at the coordinates of r in ``shape``.  It records
the shape, this rank's coordinate on each axis, and a process group for
each line of the mesh along every non-empty set of its axes (the ranks
that differ only on those axes, in coordinate order), which the
collectives of :mod:`repro_torch.core.collectives` run over.  Building a
mesh is itself collective: every rank of the world creates every group,
in the same order, as ``dist.new_group`` requires, members or not; a rank
outside the mesh has no coordinates.

The spec logic needs no process group: :func:`abstract_mesh` gives a
mesh of names and sizes alone, from which ``core.sharding`` computes
specs and ``core.broadcast.per_chip_bytes`` sizes, so the production
shapes (16, 16) and (2, 16, 16) can be reasoned about without 256 or 512
ranks; with ``rank0=True`` it acts as the mesh's first rank (coordinates
all 0), which is how the dry run counts one rank's work on fake tensors
(the collectives' count route calls no group).

Each rank's device is explicit: ``cuda:(rank % device_count)`` for
``"cuda"`` or the CPU, as the process group was started with
(``collectives.init_process_group``).  Nothing falls back to another
device or backend.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

AxesKey = Tuple[str, ...]


class Mesh:
    """Named axes over ranks.  ``shape`` maps each axis name to its size
    in axis order, as ``jax.sharding.Mesh.shape`` does.  ``ranks`` is
    None for an abstract mesh (names and sizes alone)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None, rank: int = -1,
                 device: Optional[torch.device] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match "
                             f"axes {tuple(axis_names)}")
        self.axis_names: AxesKey = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.ranks = tuple(ranks) if ranks is not None else None
        self.rank = rank
        self.device = device
        self.coords: Optional[Dict[str, int]] = None
        if self.ranks is not None and rank in self.ranks:
            idx = self.ranks.index(rank)
            self.coords = dict(zip(self.axis_names, _unravel(
                idx, tuple(self.shape.values()))))
        self._groups: Dict[AxesKey, object] = {}

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords})")

    @property
    def is_member(self) -> bool:
        return self.coords is not None

    def axes_key(self, axis) -> AxesKey:
        """``axis`` (a name or a sequence of names) in the mesh's axis
        order."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in names if a not in self.shape]
        if unknown or len(set(names)) != len(names):
            raise ValueError(f"axes {names} are not distinct axes of "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[a] for a in self.axes_key(axis))

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis``; over several axes, the
        row-major index over them (JAX's ``axis_index`` of a tuple)."""
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in {self!r}")
        idx = 0
        for a in self.axes_key(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axis=None):
        """The process group of this rank's line along ``axis`` (None: the
        whole mesh)."""
        if self.ranks is None:
            raise RuntimeError("an abstract mesh has no process groups")
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in {self!r}")
        key = self.axis_names if axis is None else self.axes_key(axis)
        return self._groups[key]


def _unravel(idx: int, sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for n in reversed(sizes):
        out.append(idx % n)
        idx //= n
    return tuple(reversed(out))


def _line(mesh: Mesh, key: AxesKey, at: Dict[str, int]):
    """Global ranks of the line along ``key`` through coordinates ``at``
    (the other axes fixed), row-major over ``key``."""
    sizes = tuple(mesh.shape.values())
    out = []
    for sub in itertools.product(*(range(mesh.shape[a]) for a in key)):
        c = dict(at)
        c.update(zip(key, sub))
        idx = 0
        for a, n in zip(mesh.axis_names, sizes):
            idx = idx * n + c[a]
        out.append(mesh.ranks[idx])
    return out


def abstract_mesh(shape: Sequence[int], axis_names: Sequence[str],
                  rank0: bool = False) -> Mesh:
    """Names and sizes alone: for specs and byte counts, no ranks; with
    ``rank0``, acting as rank 0 (every coordinate 0, still no groups)."""
    mesh = Mesh(shape, axis_names)
    if rank0:
        mesh.rank = 0
        mesh.coords = dict.fromkeys(mesh.axis_names, 0)
    return mesh


def compat_make_mesh(shape: Sequence[int],
                     axis_names: Sequence[str]) -> Mesh:
    """A mesh over ranks ``0 .. prod(shape) - 1`` of the initialised
    world, with every line's process group (collective: every rank of
    the world calls it with the same arguments), on the device this
    rank's process group was started for."""
    import torch.distributed as dist

    from repro_torch.core import collectives
    if not dist.is_initialized():
        raise RuntimeError("compat_make_mesh needs an initialised process "
                           "group (collectives.init_process_group, "
                           "collectives.spawn or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = math.prod(int(s) for s in shape)
    if n > world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; "
                         f"the world has {world}")
    mesh = Mesh(shape, axis_names, ranks=range(n), rank=rank,
                device=collectives.rank_device())
    # every rank creates every group in the same order
    for r in range(1, len(mesh.axis_names) + 1):
        for key in itertools.combinations(mesh.axis_names, r):
            others = [a for a in mesh.axis_names if a not in key]
            for fixed in itertools.product(*(range(mesh.shape[a])
                                             for a in others)):
                at = dict(zip(others, fixed))
                at.update({a: 0 for a in key})
                line = _line(mesh, key, at)
                g = dist.new_group(line)
                if mesh.coords is not None and \
                        all(mesh.coords[a] == at[a] for a in others):
                    mesh._groups[key] = g
    return mesh


def production_shape(multi_pod: bool = False):
    """The production mesh's shape and axes: (16, 16) over ``("data",
    "model")``, or (2, 16, 16) with ``"pod"``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """:func:`production_shape`'s mesh: the world must hold 256 (512)
    ranks, as ``jax.make_mesh`` fails without the devices."""
    import torch.distributed as dist
    shape, axes = production_shape(multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} over {axes} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return compat_make_mesh(shape, axes)


def make_local_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """``(n_data, n_model)`` over ``("data", "model")``."""
    return compat_make_mesh((n_data, n_model), ("data", "model"))
