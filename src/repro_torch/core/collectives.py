"""The collectives of the multi-device paths, over one mesh axis's process
group (port-only: JAX has them as ``lax`` primitives inside
``shard_map``), and :func:`spawn`, which starts the ranks.

Each collective takes ``axis`` (a mesh axis name, or a tuple of names for
their row-major product) and a :class:`repro_torch.launch.mesh.Mesh`, by
default the mesh of the current sharding context
(``core.sharding.use_sharding``).  They use only the list forms of
``dist.all_gather``, ``dist.all_reduce`` and ``dist.broadcast``, which
both gloo and NCCL take on CUDA tensors (gloo moves them through the
host).  The tensor-parallel layers use the differentiable forms
:func:`tp_enter`, :func:`tp_reduce`, :func:`tp_gather` and
:func:`tp_reduce_scatter`; the sequence-sharded layers (``seqtp``)
:func:`tp_gather` (K/V, MLA's latent), :func:`halo_cat` (the halo
shift), :func:`shard_scan` (a recurrence's state passed rank to rank)
and :func:`seq_gather_same` /
:func:`seq_sum_same` (a tensor every rank then uses whole, identically:
the last hidden states, the router's mean probability).  Gloo has no
CUDA ``send`` / ``recv``, so
:func:`ppermute_next`, JAX's ``ppermute`` over the pairs (i, i + 1), is
an all-gather of every
rank's rows of which each rank keeps its predecessor's.  A bool tensor
travels as uint8.  Over an axis of size 1 no collective calls a group.

Every collective reports ``(op, buf_bytes, group, wire_bytes)`` to the
active counter (``core.flags``), if any, under the HLO op it stands for,
with JAX's wire formulas (``core.flags.wire_bytes``).  On a fake tensor
(``core.flags.counted``) a collective takes the count route: it
allocates what it would allocate and calls no group.  The mesh may then
be an abstract one acting as a rank (``launch.mesh.abstract_mesh(...,
rank0=True)``): no process group is needed.

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
    flags.add_collective("all-gather", n * w.numel() * w.element_size(), n)
    if not flags.counted(w):
        dist.all_gather(parts, w, group=m.group(axis))
    parts = [p.to(x.dtype) for p in parts] if w.dtype != x.dtype else parts
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _all_reduce(x: torch.Tensor, axis, op, mesh) -> torch.Tensor:
    m = _mesh(mesh)
    if m.axis_size(axis) == 1:
        return x
    y = x.reshape(1).clone() if x.dim() == 0 else x.clone().contiguous()
    flags.add_collective("all-reduce", y.numel() * y.element_size(),
                         m.axis_size(axis))
    if not flags.counted(y):
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


# ----------------------------------------------------------------------
# The tensor-parallel layers' collectives, as autograd Functions (JAX's
# GSPMD derives them; ``dist`` ops are not differentiable, and
# ``torch.distributed.nn``'s all-reduce sums in its backward too, which is
# wrong for a row-parallel exit).  Each sums in fp32 and rounds once; over
# an axis of size 1 each is the identity and builds no node.
class _Enter(torch.autograd.Function):
    """Entering a region whose ranks each use part of ``x``: identity
    forward, the gradients' sum backward."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.float(), ctx.axis, ctx.mesh).to(g.dtype), None, None


class _Reduce(torch.autograd.Function):
    """Leaving a row-parallel product: the partial products' sum forward,
    identity backward."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        return psum(x.float(), axis, mesh).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """Every rank's block along ``dim`` forward (all-gather); this rank's
    block of the summed gradient backward (a reduce-scatter, as psum then
    slice: gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return all_gather(x.contiguous(), axis, dim=dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        s = psum(g.float(), ctx.axis, ctx.mesh).to(g.dtype)
        return local_block(s, ctx.axis, ctx.mesh, ctx.dim).contiguous(), \
            None, None, None


class _Scatter(torch.autograd.Function):
    """The adjoint of :class:`_Gather`: this rank's block of the sum
    forward, every rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        s = psum(x.float(), axis, mesh).to(x.dtype)
        return local_block(s, axis, mesh, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.axis, dim=ctx.dim,
                          mesh=ctx.mesh), None, None, None


class _HaloCat(torch.autograd.Function):
    """The previous rank's last ``rows`` rows of ``x`` (B, S_loc, ...)
    before ``x``'s own along dim 1 (:func:`ppermute_next`); rank 0 puts
    zeros there where ``zeros_first``, else returns ``x`` as it is.
    Backward: each rank's gradient of the rows it received goes back to
    the rank they came from and is added to its last ``rows`` rows.  The
    output always holds ``x``, so every rank runs the backward's
    collective, rank 0 included."""

    @staticmethod
    def forward(ctx, x, rows, zeros_first, axis, mesh):
        ctx.rows, ctx.axis, ctx.mesh = rows, axis, mesh
        h = ppermute_next(x[:, -rows:].contiguous(), axis, mesh)
        ctx.prepended = mesh.axis_index(axis) > 0 or zeros_first
        return torch.cat([h, x], dim=1) if ctx.prepended else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        m, rows = ctx.mesh, ctx.rows
        i, n = m.axis_index(ctx.axis), m.axis_size(ctx.axis)
        if ctx.prepended:
            gh, gx = g[:, :rows], g[:, rows:]
        else:
            gh, gx = torch.zeros_like(g[:, -rows:]), g
        every = all_gather(gh.contiguous(), ctx.axis, dim=0, tiled=False,
                           mesh=m)
        if i + 1 < n:
            gx = torch.cat([gx[:, :-rows], gx[:, -rows:] + every[i + 1]],
                           dim=1)
        return gx, None, None, None, None


class _Carry(torch.autograd.Function):
    """The carry of a diagonal recurrence into this rank's shard: from
    every rank's affine map h -> P_r h + F_r of its shard (gathered), c_0
    = 0 and c_{r+1} = P_r c_r + F_r, folded in rank order.  Backward, the
    fold's adjoint from this rank's carry back to every earlier rank's P
    and F, summed over the ranks (each rank gets the sum of the gradients
    of its own P and F).  ``through`` passes as it is: each rank routes
    through it a tensor that its result depends on (rank 0, whose carry
    is zero, its output; every other rank its second scan's input: the
    last rank's P and F, read by no rank, need no gradient), so that the
    Function is in every rank's graph and every rank runs the backward's
    collective (:func:`shard_scan`)."""

    @staticmethod
    def forward(ctx, P, F, through, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        every = all_gather(torch.stack([P, F]).contiguous(), axis, dim=0,
                           tiled=False, mesh=mesh)
        c = torch.zeros_like(F)
        for r in range(mesh.axis_index(axis)):
            c = every[r, 0] * c + every[r, 1]
        ctx.save_for_backward(every)
        return c, through.view_as(through)

    @staticmethod
    def backward(ctx, gc, gt):
        (every,) = ctx.saved_tensors
        i = ctx.mesh.axis_index(ctx.axis)
        cs = [torch.zeros_like(every[0, 1])]
        for r in range(i):
            cs.append(every[r, 0] * cs[-1] + every[r, 1])
        grads = torch.zeros_like(every)
        lam = gc
        for r in range(i - 1, -1, -1):
            grads[r, 1] = lam
            grads[r, 0] = lam * cs[r]
            lam = lam * every[r, 0]
        own = psum(grads, ctx.axis, ctx.mesh)[i]
        return own[0], own[1], gt, None, None


def halo_cat(x: torch.Tensor, rows: int, axis="model", mesh=None,
             zeros_first: bool = False) -> torch.Tensor:
    """The previous rank's last ``rows`` rows of ``x`` (B, S_loc, ...)
    along ``axis`` concatenated before ``x``'s own on dim 1, differentiably
    (the halo of a sequence shard: a local attention's keys, a causal
    conv's inputs); rank 0 has no previous rank and gets zeros where
    ``zeros_first`` (a conv's zero padding), else ``x`` alone."""
    m = _mesh(mesh)
    if m.axis_size(axis) == 1:
        return torch.cat([torch.zeros_like(x[:, :rows]), x], dim=1) \
            if zeros_first else x
    return _HaloCat.apply(x, rows, zeros_first, axis, m)


def shard_scan(scan: Callable, x: torch.Tensor, P: torch.Tensor,
               axis="model", mesh=None):
    """``(out, h_final)`` of this rank's shard of a diagonal recurrence
    h_t = a_t h_{t-1} + b_t split over ``axis``, where ``scan(x, h0)``
    runs the shard from the state ``h0`` (None: zeros) and ``P`` is the
    product of the shard's a_t: each shard is the affine map h -> P h + F
    (F its final state from zeros); every rank's (P, F) is all-gathered
    and folded in rank order into the state entering each shard, c_0 = 0
    (:class:`_Carry`, differentiable), and a shard is scanned again from
    it.  Rank 0, whose carry is zero, and the last rank, whose F no rank
    reads, scan once; every other rank twice."""
    m = _mesh(mesh)
    i, n = m.axis_index(axis), m.axis_size(axis)
    if i == n - 1:
        out0, F = None, torch.zeros_like(P)
    else:
        out0, F = scan(x, None)
    # rank 0's output, and the other ranks' scan input, pass through the
    # carry, so that it is in every rank's graph
    c, through = _Carry.apply(P, F, x if i else out0, axis, m)
    if i == 0:
        return through, F
    return scan(through, c)


class _GatherSame(torch.autograd.Function):
    """Every rank's block along ``dim`` forward, a tensor every rank then
    uses whole in the same way (so the gradient reaching it is the same on
    every rank); backward, the reduce-scatter of that gradient, which is
    ``n`` times this rank's block of it: no collective."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return all_gather(x.contiguous(), axis, dim=dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.axis_size(ctx.axis)
        return (local_block(g, ctx.axis, ctx.mesh, ctx.dim) * n
                ).contiguous(), None, None, None


class _SumSame(torch.autograd.Function):
    """The sum over ``axis`` of every rank's ``x`` forward, a tensor every
    rank then uses in the same way; backward, the sum of the ranks' equal
    gradients, ``n`` times this rank's: no collective."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.n = mesh.axis_size(axis)
        return psum(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None, None


def seq_gather_same(x: torch.Tensor, axis, dim: int,
                    mesh=None) -> torch.Tensor:
    """Every rank's block of ``x`` along ``axis``, concatenated on
    ``dim``, for a caller whose every rank goes on to compute the same
    function of the whole (the sequence-sharded forward's last hidden
    states, before the head and a loss every rank computes whole).  Its
    backward is :func:`tp_gather`'s reduce-scatter, taken without a
    collective: each rank's gradient is the same, so the sum over the
    ranks of this rank's block is ``n`` times its own.  A step that sums
    the replicated leaves' gradients over ``axis`` weights each rank's by
    ``1 / n`` (``launch/steps.py``), which leaves the head's leaves, each
    rank's the whole gradient, counted once."""
    m = _mesh(mesh)
    return x if m.axis_size(axis) == 1 else _GatherSame.apply(
        x, axis, dim % x.dim(), m)


def seq_sum_same(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``x``, for a caller whose
    every rank uses it in the same way (the router's mean probability
    under ``seqtp``): backward, ``n`` times the gradient, the sum of the
    ranks' equal ones, without a collective (:func:`seq_gather_same`'s
    rule)."""
    m = _mesh(mesh)
    return x if m.axis_size(axis) == 1 else _SumSame.apply(x, axis, m)


def tp_enter(x: torch.Tensor, axis="model", mesh=None) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``axis`` in the backward:
    a replicated tensor (an activation or a leaf) that each rank uses only
    in part."""
    m = _mesh(mesh)
    return x if m.axis_size(axis) == 1 else _Enter.apply(x, axis, m)


def tp_reduce(x: torch.Tensor, axis="model", mesh=None) -> torch.Tensor:
    """The sum over ``axis`` of every rank's partial ``x`` (fp32, rounded
    once to ``x``'s dtype); the gradient passes as it is."""
    m = _mesh(mesh)
    return x if m.axis_size(axis) == 1 else _Reduce.apply(x, axis, m)


def tp_gather(x: torch.Tensor, axis, dim: int, mesh=None) -> torch.Tensor:
    """Every rank's block of ``x`` along ``axis``, concatenated on
    ``dim``; backward, this rank's block of the summed gradient."""
    m = _mesh(mesh)
    return x if m.axis_size(axis) == 1 else _Gather.apply(x, axis,
                                                          dim % x.dim(), m)


def tp_reduce_scatter(x: torch.Tensor, axis, dim: int,
                      mesh=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``axis`` of every
    rank's ``x``; backward, the gradient's blocks all-gathered."""
    m = _mesh(mesh)
    return x if m.axis_size(axis) == 1 else _Scatter.apply(
        x, axis, dim % x.dim(), m)


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

