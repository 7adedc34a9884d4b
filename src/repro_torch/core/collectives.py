"""The collectives of the multi-device paths, over one mesh axis's process
group (port-only: JAX has them as ``lax`` primitives inside
``shard_map``), and :func:`spawn`, which starts the ranks.

Each collective takes ``axis`` (a mesh axis name, or a tuple of names for
their row-major product) and a :class:`repro_torch.launch.mesh.Mesh`, by
default the mesh of the current sharding context
(``core.sharding.use_sharding``).  They use only the list forms of
``dist.all_gather``, ``dist.all_reduce`` and ``dist.broadcast``, which
both gloo and NCCL take on CUDA tensors (gloo moves them through the
host).  Gloo has no CUDA ``send`` / ``recv``, so :func:`ppermute_next`,
JAX's ``ppermute`` over the pairs (i, i + 1), is an all-gather of every
rank's rows of which each rank keeps its predecessor's.  A bool tensor
travels as uint8.  Over an axis of size 1 no collective calls a group.

On a fake tensor (``core.flags.counted``) a collective
takes the count route: it allocates what it would allocate, calls no
group, and reports ``(op, buf_bytes, group, wire_bytes)`` to the active
counter under the HLO op it stands for, with JAX's wire formulas
(``core.flags.wire_bytes``).  The mesh may then be an abstract one
acting as a rank (``launch.mesh.abstract_mesh(..., rank0=True)``): no
process group is needed.

Backends and devices are the caller's: rank r takes ``cuda:(r %
device_count)`` or the CPU, as :func:`init_process_group` was told, and
NCCL with more ranks than cards raises (it refuses two ranks on one
card) instead of giving way to gloo.
"""
from __future__ import annotations

import datetime
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import flags

#: the device kind ("cuda" or "cpu") this process's group was started for
_DEVICE_KIND: list = []


def check_backend(backend: str, world: int, device: str) -> None:
    """Raise on a backend / device pair that cannot run ``world`` ranks:
    NCCL needs a card a rank, and CUDA tensors; gloo takes both devices."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the nccl backend moves CUDA tensors only; "
                             "name device='cuda' or the gloo backend")
        n = torch.cuda.device_count()
        if world > n:
            raise ValueError(
                f"nccl with {world} ranks needs {world} cards and this "
                f"machine has {n}: NCCL refuses two ranks on one card. "
                f"Name the gloo backend to share a card among ranks "
                f"(its collectives go through the host)")
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")


def init_process_group(backend: str, rank: int, world: int, init_method: str,
                       device: str, timeout_s: float) -> None:
    """``dist.init_process_group`` at ``init_method`` (``tcp://host:port``)
    with a timeout on every collective, recording the device kind that
    :func:`rank_device` gives each rank."""
    check_backend(backend, world, device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE_KIND[:] = [device]
    if device == "cuda":
        torch.cuda.set_device(rank_device())


def rank_device() -> torch.device:
    """This rank's device: ``cuda:(rank % device_count)`` or the CPU, as
    the process group was started for.  Raises where none was recorded."""
    if not _DEVICE_KIND:
        raise RuntimeError("no device recorded for this process group: "
                           "start it with collectives.init_process_group "
                           "or collectives.spawn")
    if _DEVICE_KIND[0] == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.core.sharding import current_ctx
    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError("a collective needs a mesh: pass one, or run "
                           "under core.sharding.use_sharding(mesh, ...)")
    return ctx.mesh


def axis_size(axis, mesh=None) -> int:
    return _mesh(mesh).axis_size(axis)


def axis_index(axis, mesh=None) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    return _mesh(mesh).axis_index(axis)


def _wire(x: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def all_gather(x: torch.Tensor, axis, dim: int = 0, tiled: bool = True,
               mesh=None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, in axis order: concatenated on
    ``dim`` (``tiled``, as ``lax.all_gather(..., tiled=True)``) or stacked
    on a new ``dim``."""
    m = _mesh(mesh)
    n = m.axis_size(axis)
    if n == 1:
        return x if tiled else x.unsqueeze(dim)
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(n)]
    if flags.counted(w):
        flags.add_collective("all-gather",
                             n * w.numel() * w.element_size(), n)
    else:
        dist.all_gather(parts, w, group=m.group(axis))
    parts = [p.to(x.dtype) for p in parts] if w.dtype != x.dtype else parts
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _all_reduce(x: torch.Tensor, axis, op, mesh) -> torch.Tensor:
    m = _mesh(mesh)
    if m.axis_size(axis) == 1:
        return x
    y = x.reshape(1).clone() if x.dim() == 0 else x.clone().contiguous()
    if flags.counted(y):
        flags.add_collective("all-reduce", y.numel() * y.element_size(),
                             m.axis_size(axis))
    else:
        dist.all_reduce(y, op=op, group=m.group(axis))
    return y.reshape(x.shape)


def psum(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axis``, on every rank."""
    return _all_reduce(x, axis, dist.ReduceOp.SUM, mesh)


def pmax(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """The elementwise max of every rank's ``x`` along ``axis``."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX, mesh)


def ppermute_next(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """The halo shift: rank i gets rank i - 1's ``x`` along ``axis`` and
    rank 0 gets zeros (``lax.ppermute`` over the pairs (i, i + 1)).  An
    all-gather of every rank's ``x``, since gloo has no CUDA send / recv:
    keep ``x`` to the rows the next rank needs.  So a count records the
    all-gather the port issues, not the collective-permute JAX's HLO
    holds."""
    m = _mesh(mesh)
    i = m.axis_index(axis)
    if m.axis_size(axis) == 1:
        return torch.zeros_like(x)
    every = all_gather(x, axis, dim=0, tiled=False, mesh=m)
    return every[i - 1] if i > 0 else torch.zeros_like(x)


def broadcast(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The ``x`` of the mesh's first rank, written into every other
    rank's ``x`` in place."""
    m = _mesh(mesh)
    if m.size == 1:
        return x
    w = _wire(x)
    if flags.counted(w):
        flags.add_collective("collective-broadcast",
                             w.numel() * w.element_size(), m.size)
        return x
    dist.broadcast(w, src=m.ranks[0], group=m.group())
    if w is not x:
        x.copy_(w.to(x.dtype))
    return x


def local_block(x: torch.Tensor, axis, mesh=None, dim: int = 0):
    """This rank's block of ``x`` along ``dim``: block ``axis_index`` of
    ``axis_size`` equal blocks, the layout of a dimension a spec splits
    over ``axis`` (a view)."""
    m = _mesh(mesh)
    n = m.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {axis} ({n} ranks)")
    step = x.shape[dim] // n
    return x.narrow(dim, m.axis_index(axis) * step, step)


def gather_objects(obj: Any, axis, mesh=None) -> list:
    """Every rank's picklable ``obj`` along ``axis``, in axis order."""
    m = _mesh(mesh)
    if m.axis_size(axis) == 1:
        return [obj]
    out = [None] * m.axis_size(axis)
    dist.all_gather_object(out, obj, group=m.group(axis))
    return out


# ----------------------------------------------------------------------
def free_port() -> int:
    """A TCP port on the loopback that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(fn, rank, world, backend, device, port, timeout_s, threads,
              args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_process_group(backend, rank, world, f"tcp://127.0.0.1:{port}",
                           device, timeout_s)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:           # noqa: BLE001 - reported to the caller
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable[..., Any], world: int, *, backend: str, device: str,
          timeout_s: float, args: Sequence = (), threads: int = 0) -> list:
    """Run ``fn(rank, *args)`` on ``world`` spawned processes, each in a
    process group of ``backend`` over a free loopback port, every
    collective bounded by ``timeout_s``; return the ranks' return values
    (pickled across: return host values), rank by rank.  ``fn`` must be
    importable by name (a module-level function).  ``threads`` sets each
    rank's torch CPU threads (0 leaves torch's default).

    A rank that raises makes this raise with that rank's traceback; a rank
    that exits without a result, or a run that outlasts ``timeout_s``,
    makes it raise too.  Every process is stopped before it returns or
    raises."""
    import multiprocessing as mp
    check_backend(backend, world, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_run_rank, daemon=True, args=(
        fn, r, world, backend, device, port, timeout_s, threads, tuple(args),
        results)) for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: ranks {sorted(set(range(world)) - set(got))} "
                    f"did not finish within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a result put just before the exit may still be in
                    # flight: one more look before calling the rank lost
                    try:
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"spawn: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} raised:\n{payload}")
            got[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(got) == world else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(world)]

