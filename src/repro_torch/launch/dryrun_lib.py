"""Dry-run core of the port (``repro.launch.dryrun_lib``): count every
(arch x shape) cell's per-device work on a production mesh, and emit the
roofline terms.  Nothing is allocated and nothing is launched.

Where JAX lowers and compiles each cell on host devices and reads XLA's
``cost_analysis()`` and ``memory_analysis()``, the port runs its own
per-rank step (``launch/steps.py``) once on fake tensors
(``torch._subclasses.fake_tensor``) under a :class:`Counter`, a
``TorchDispatchMode`` stacked with ``torch.utils.flop_counter.
FlopCounterMode``:

  * FLOPs: ``FlopCounterMode``'s count of the eager ops (2 a multiply-add
    of every product), plus each hand-written kernel's operations from
    ``kernels/work.py``: every kernel op and collective takes its count
    route on a fake tensor (``kernels/ops.py``, ``core/collectives.py``)
    and reports its call to the counter through ``core/flags.py``;
  * launches: each kernel's calls as the counter saw them (a call on the
    count route launches nothing, so ``kernels.LAUNCHES`` stays as it
    was), kept in :data:`LAST_OPS`'s ``kernel:<name>`` rows;
  * bytes: what each eager aten op reads and writes (views move nothing),
    plus each kernel's least HBM bytes from ``kernels/work.py``;
  * collectives: each one the port issues, under the HLO op it stands for,
    with JAX's wire formulas;
  * memory: the bytes of the step's inputs on this rank, and the peak of
    the tensor storages alive during the step less those inputs, each
    storage found as an op's output and dropped by a weakref finalizer
    when it is freed, and rounded as the CUDA caching allocator rounds a
    block (512 bytes).

The mesh is ``launch/mesh.abstract_mesh(..., rank0=True)``: rank 0 of the
production shape, with no process group.  The port counts every trip of
every Python loop, so the cost pass runs the full-depth config: JAX's
depth samples, their extrapolation and its ``COST_MODE`` are not needed
(``tests/test_torch_dryrun.py`` shows the count equal to that
extrapolation).  The training cells' gradient accumulation comes from the
port's own memory pass (:func:`train_accum`), not from a TPU's table.

Cells under ``tp`` and ``fsdp_tp`` (JAX's defaults: ``fsdp_tp`` for train,
``tp`` for serve) report ``ok=False`` with the port's refusal: the
tensor-parallel layers are ROADMAP.md, Queue 1, item 14.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, SHAPE_BY_NAME, ShapeCase
from repro_torch.core import flags
from repro_torch.core.sharding import NamedSharding, ShardingCtx, _rules, \
    is_axes, use_sharding
from repro_torch.kernels import work
from repro_torch.launch import steps as steps_mod
from repro_torch.models import api
from repro_torch.optim import adamw_init
from repro_torch.tree import flatten_with_paths, tree_leaves, tree_map

# One NVIDIA H100 SXM at its 700 W power limit (NVIDIA H100 Tensor Core GPU
# data sheet, dense peaks): bf16 tensor-core FLOP/s (fp32 on the CUDA cores
# beside it, as in kernels/work.PEAK_OPS), HBM3 bytes/s, NVLink bytes/s
# each way, and the card's 80 GB of HBM
HW = dict(peak_flops=work.PEAK_OPS["bfloat16"],
          peak_flops_fp32=work.PEAK_OPS["float32"], hbm_bw=work.HBM_BPS,
          ici_bw=450e9, hbm_bytes=80e9)

LONG_CONTEXT_ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b", "gemma3-4b")

#: the device the fake tensors report.  Every kernel op and collective
#: takes its count route on a fake tensor whatever its device, and the
#: counts read shapes, dtypes and ops alone; autograd on a fake CUDA
#: tensor aborts a build of torch without CUDA, so the count runs as
#: "cpu" on every machine, the card's too
DEVICE = "cpu"
#: the CUDA caching allocator's block granularity: a tensor's block holds
#: its bytes rounded up to it
BLOCK_BYTES = 512

#: the per-op table of the last cost pass (``dryrun.py --verbose-hlo``)
LAST_OPS: Dict[str, List[float]] = {}


def cell_applicable(arch: str, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, ("pure full-attention KV at 500k tokens is quadratic-"
                       "prefill / unbounded-cache; run only for SSM/hybrid/"
                       "mostly-local archs (DESIGN.md §5)")
    return True, ""


# ----------------------------------------------------------------------
def model_param_counts(cfg: ArchConfig) -> Dict[str, float]:
    params_abs, axes = api.abstract_params(cfg)
    leaves = tree_leaves(params_abs)
    ax_leaves = list(flatten_with_paths(axes, is_leaf=is_axes).values())
    total = sum(math.prod(l.shape) for l in leaves)
    expert = sum(math.prod(l.shape) for l, a in zip(leaves, ax_leaves)
                 if "experts" in a)
    embed = 0
    for l in leaves:
        if l.shape and cfg.vocab in l.shape:
            embed += math.prod(l.shape)
    active = total - expert
    if cfg.n_experts:
        active += expert * cfg.top_k / cfg.n_experts
    return dict(total=total, active=active, experts=expert, embed=embed)


@dataclasses.dataclass
class CellResult:
    """One cell, per device (rank 0 of the mesh).  JAX's fields, read the
    port's way: ``lower_s`` is the cost pass's wall and ``compile_s`` the
    memory pass's; ``flops_dev`` the eager ops' products plus the
    kernels' operations; ``bytes_dev`` what the eager port moves, op by
    op, plus the kernels' least bytes: XLA's "bytes accessed" of a fused
    program is not that; ``arg_bytes_dev`` the step's inputs on the rank
    (parameters, moments, batch, caches), ``out_bytes_dev`` its outputs,
    ``temp_bytes_dev`` the peak of the storages alive during the step
    less the inputs."""
    arch: str
    shape: str
    mesh: str
    policy: str
    ok: bool
    skipped: bool = False
    reason: str = ""
    lower_s: float = 0.0
    compile_s: float = 0.0
    flops_dev: float = 0.0
    bytes_dev: float = 0.0
    coll_wire_bytes_dev: float = 0.0
    n_collectives: int = 0
    coll_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    arg_bytes_dev: int = 0
    out_bytes_dev: int = 0
    temp_bytes_dev: int = 0
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    model_flops_dev: float = 0.0
    useful_ratio: float = 0.0
    params_total: float = 0.0
    params_active: float = 0.0
    error: str = ""

    def to_json(self):
        return dataclasses.asdict(self)


# ----------------------------------------------------------------------
def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _block(nbytes: int) -> int:
    return -(-nbytes // BLOCK_BYTES) * BLOCK_BYTES


_EMPTY_FACTORIES = {torch.ops.aten.empty.memory_format,
                    torch.ops.aten.empty_strided.default,
                    torch.ops.aten.empty_like.default,
                    torch.ops.aten.new_empty.default,
                    torch.ops.aten.new_empty_strided.default}

_FINALIZERS_CHECKED: list = []


def _check_storage_finalizers() -> None:
    """The memory count needs a storage's Python object to live as long as
    the storage (torch's PyObject preservation): a finalizer on it fires
    when the last view is freed, not before.  Raise where this torch does
    not."""
    if _FINALIZERS_CHECKED:
        return
    fired = []
    x = torch.empty(8, device="meta")
    weakref.finalize(x.untyped_storage(), fired.append, 1)
    y = x.view(2, 4)
    del x
    gc.collect()
    early = bool(fired)
    del y
    gc.collect()
    if early or not fired:
        raise RuntimeError(
            f"torch {torch.__version__} frees a storage's Python object "
            f"{'before' if early else 'apart from'} the storage: the dry "
            f"run's memory count cannot track storages here")
    _FINALIZERS_CHECKED.append(True)


class Counter(TorchDispatchMode):
    """Counts the ops of what runs under it: each aten op's bytes read and
    written, the kernels' calls and work and the collectives reported
    through ``core/flags.py``, and the peak bytes of the tensor storages
    made under it and still alive.  Stack it with ``FlopCounterMode`` for
    the eager ops' FLOPs (:func:`counting`).  Works on fake tensors and on
    the card's; a counter entered inside another reports to it again
    when it exits."""

    def __init__(self):
        super().__init__()
        _check_storage_finalizers()
        self.ops: Dict[str, List[float]] = {}      # name -> [calls, bytes]
        self.kernels: Dict[str, List[float]] = {}  # name -> [calls, flops,
        #                                            bytes]
        self.colls: List[dict] = []
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._prev = None

    # -- core.flags' counter interface
    def kernel(self, name: str, w: work.Work) -> None:
        row = self.kernels.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += w.flops
        row[2] += w.bytes

    def collective(self, op, buf_bytes, group, wire_bytes) -> None:
        self.colls.append(dict(op=op, buf_bytes=buf_bytes, group=group,
                               wire_bytes=wire_bytes))

    def __enter__(self):
        self._prev = flags.set_counter(self)
        return super().__enter__()

    def __exit__(self, *exc):
        flags.set_counter(self._prev)
        return super().__exit__(*exc)

    # -- the eager ops
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        in_keys = {_storage_key(t) for t in ins}
        for t in outs:
            key = _storage_key(t)
            if key in self._live or key in in_keys:
                continue            # a view, or written in place
            size = _block(t.untyped_storage().nbytes())
            self._live[key] = size
            self.live_bytes += size
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(t.untyped_storage(), self._free, key)
        if func.is_view or func in _EMPTY_FACTORIES or not outs:
            moved = 0           # no data moved, or a query (prim.device)
        else:
            moved = sum(_tensor_bytes(t) for t in ins + outs)
        row = self.ops.setdefault(str(func.overloadpacket), [0, 0])
        row[0] += 1
        row[1] += moved
        return out

    # -- readings
    def kernel_flops(self) -> float:
        return sum(r[1] for r in self.kernels.values())

    def bytes_moved(self) -> float:
        return (sum(r[1] for r in self.ops.values()) +
                sum(r[2] for r in self.kernels.values()))

    def launches(self) -> Dict[str, int]:
        return {k: int(r[0]) for k, r in self.kernels.items()}


@contextlib.contextmanager
def counting():
    """``(flop_counter, counter)``: a ``FlopCounterMode`` and a
    :class:`Counter` stacked; FLOPs = ``flop_counter.get_total_flops() +
    counter.kernel_flops()``."""
    with FlopCounterMode(display=False) as fc, Counter() as c:
        yield fc, c


def step_flops(fc: FlopCounterMode, c: Counter) -> float:
    return float(fc.get_total_flops()) + c.kernel_flops()


def op_table(fc: FlopCounterMode, c: Counter) -> Dict[str, List[float]]:
    """name -> [calls, FLOPs, bytes]: every aten op, each kernel
    (``kernel:<name>``) and each collective (``collective:<op>``)."""
    flops = {str(k): v for k, v in
             fc.get_flop_counts().get("Global", {}).items()}
    table = {name: [r[0], float(flops.get(name, 0)), float(r[1])]
             for name, r in c.ops.items()}
    for name, r in c.kernels.items():
        table[f"kernel:{name}"] = [r[0], r[1], r[2]]
    for col in c.colls:
        row = table.setdefault(f"collective:{col['op']}", [0, 0.0, 0.0])
        row[0] += 1
        row[2] += col["wire_bytes"]
    return table


# ----------------------------------------------------------------------
def _local_empty(t: torch.Tensor, s: Optional[NamedSharding]):
    """An empty tensor of rank 0's block of ``t`` under ``s`` (each
    sharded dimension cut into its axes' product of equal blocks), on
    :data:`DEVICE`: fake under a ``FakeTensorMode``."""
    shape = list(t.shape)
    if s is not None:
        for dim in range(len(shape)):
            n = math.prod(s.mesh.shape[a] for a in s.dim_axes(dim))
            if shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(t.shape)} does "
                                 f"not split over {s.dim_axes(dim)} ({n} "
                                 f"ranks)")
            shape[dim] //= n
    return torch.empty(shape, dtype=t.dtype, device=DEVICE)


def _n_data(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.axis_names
                     if a in ("pod", "data"))


def build_cell(cfg: ArchConfig, sc: ShapeCase, mesh, policy: str,
               accum_steps: int = 1):
    """Returns ``(fn, args, in_shardings, out_shardings, donate,
    act_rules)``, JAX's tuple, with ``args`` as rank 0 of ``mesh`` takes
    them: empty tensors on :data:`DEVICE` (call it under a
    ``FakeTensorMode``).  The parameters and moments are the rank's blocks
    of the policy's specs; a serve step's batch and caches are its rows
    (the port holds a cache whole in the sequence: it has no
    sequence-sharded cache); a data-parallel train step takes the global
    batch and picks its own rows (``steps.local_rows``)."""
    rules = dict(_rules(policy, mesh.axis_names))
    if sc.global_batch < _n_data(mesh):
        rules["batch"] = None                      # don't shard tiny batch
    ctx = ShardingCtx(mesh, policy, rules)
    batch_axes = rules.get("batch") or ()
    n_batch = mesh.axis_size(batch_axes) if batch_axes else 1

    params_abs, axes = api.abstract_params(cfg)
    param_sh = steps_mod.shardings_like(axes, ctx)
    params = tree_map(_local_empty, params_abs, param_sh)
    repl = NamedSharding(mesh, ())

    def bsh(nd):
        return NamedSharding(mesh, (batch_axes or None,) + (None,) * (nd - 1))

    batch_abs = api.input_specs(cfg, "train" if sc.kind != "decode"
                                else "decode", sc.global_batch, sc.seq_len,
                                batch_sharding=bsh)
    batch_sh = {k: v.sharding for k, v in batch_abs.items()}

    if sc.kind == "train":
        steps_mod.check_policy(cfg, policy, data_parallel=n_batch > 1)
        opt = adamw_init(params)
        opt_sh = steps_mod.opt_shardings(param_sh)
        if n_batch > 1:
            step = steps_mod.make_train_step(cfg, accum_steps=accum_steps,
                                             mesh=mesh, policy=policy)
            batch = {k: _local_empty(v, None) for k, v in batch_abs.items()}
        else:
            step = steps_mod.make_train_step(cfg, accum_steps=accum_steps)
            batch = {k: _local_empty(v, batch_sh[k])
                     for k, v in batch_abs.items()}
        metric_sh = {k: repl for k in ("loss", "ce", "aux", "grad_norm", "lr")}
        return (step, (params, opt, batch), (param_sh, opt_sh, batch_sh),
                (param_sh, opt_sh, metric_sh), (0, 1), rules)

    max_len = sc.seq_len
    caches_abs = api.init_caches(cfg, sc.global_batch, max_len,
                                 enc_len=sc.seq_len, device="meta")
    cache_ctx = ShardingCtx(mesh, policy, {"batch": rules.get("batch")})
    cache_sh = tree_map(cache_ctx.sharding_for,
                        steps_mod.cache_logical_axes(cfg, max_len),
                        is_leaf=is_axes)
    caches = tree_map(_local_empty, caches_abs, cache_sh)
    batch = {k: _local_empty(v, batch_sh[k]) for k, v in batch_abs.items()}
    logits_sh = NamedSharding(mesh, (rules.get("batch"), None,
                                     rules.get("vocab")))
    if sc.kind == "prefill":
        step = steps_mod.make_prefill_step(cfg, max_len)
    else:
        step = steps_mod.make_decode_step(cfg)
    return (step, (params, batch, caches), (param_sh, batch_sh, cache_sh),
            (logits_sh, cache_sh), (2,), rules)


def count_cell(cfg, sc: ShapeCase, mesh, policy: str,
               accum_steps: int = 1) -> Dict[str, Any]:
    """Run rank 0's step of the cell once on fake tensors under
    :func:`counting`: flops, bytes, wire, ncoll, by_op, launches, args,
    out and temp bytes, and the per-op table (:func:`op_table`).  Raises
    what the step raises."""
    with FakeTensorMode():
        fn, args, _, _, _, rules = build_cell(cfg, sc, mesh, policy,
                                              accum_steps)
        # rank 0's blocks: per_chip_bytes of the global trees where they
        # divide (build_cell raises where they do not)
        arg_bytes = sum(_tensor_bytes(t) for t in tree_leaves(args))
        # the train step enables grad for its own value_and_grad
        with use_sharding(mesh, policy, rules=rules), torch.no_grad(), \
                counting() as (fc, c):
            out = fn(*args)
        outs = {_storage_key(t): _tensor_bytes(t)
                for t in tree_leaves(out) if isinstance(t, torch.Tensor)}
    by_op: Dict[str, float] = {}
    for col in c.colls:
        by_op[col["op"]] = by_op.get(col["op"], 0.0) + col["wire_bytes"]
    return dict(flops=step_flops(fc, c), bytes=c.bytes_moved(),
                wire=float(sum(col["wire_bytes"] for col in c.colls)),
                ncoll=float(len(c.colls)), by_op=by_op,
                launches=c.launches(), arg_bytes=int(arg_bytes),
                out_bytes=int(sum(outs.values())),
                temp_bytes=int(c.peak_bytes), ops=op_table(fc, c))


def cost_pass(cfg: ArchConfig, sc: ShapeCase, mesh, policy: str):
    """Per-device cost of the full-depth config, counted on fake tensors;
    its per-op table (each kernel's launches among it) is kept in
    :data:`LAST_OPS`."""
    global LAST_OPS
    cost = count_cell(cfg, sc, mesh, policy)
    LAST_OPS = cost["ops"]
    return cost


def per_rank_batch(sc: ShapeCase, mesh, policy: str) -> int:
    """The rows rank 0 takes: the global batch over the policy's batch
    axes (not split where it is smaller than the data axes)."""
    axes = _rules(policy, mesh.axis_names).get("batch") or ()
    if sc.global_batch < _n_data(mesh) or not axes:
        return sc.global_batch
    return max(sc.global_batch // mesh.axis_size(axes), 1)


def train_accum(cfg, sc: ShapeCase, mesh, policy: str, first=None):
    """The smallest power of two that divides rank 0's batch and whose
    predicted peak (args + temp) fits the card's ``HW["hbm_bytes"]``, and
    its count; the largest such power if none fits.  ``first`` is the
    count at accumulation 1 where the caller has it."""
    rows = per_rank_batch(sc, mesh, policy)
    accum, got = 1, first
    while True:
        if got is None:
            got = count_cell(cfg, sc, mesh, policy, accum_steps=accum)
        if got["arg_bytes"] + got["temp_bytes"] <= HW["hbm_bytes"] or \
                rows % (2 * accum):
            return accum, got
        accum, got = 2 * accum, None


def run_cell(arch: str, shape_name, mesh, policy: Optional[str] = None,
             cfg_override=None, skip_memory_pass: bool = False,
             skip_cost_pass: bool = False) -> CellResult:
    """One cell on ``mesh`` (``abstract_mesh(..., rank0=True)``);
    ``shape_name`` is a name of :data:`SHAPE_BY_NAME` or a
    :class:`ShapeCase` of its own."""
    sc = shape_name if isinstance(shape_name, ShapeCase) else \
        SHAPE_BY_NAME[shape_name]
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    ok, reason = cell_applicable(arch, sc.name)
    policy = policy or ("fsdp_tp" if sc.kind == "train" else "tp")
    res = CellResult(arch=arch, shape=sc.name, mesh=mesh_name,
                     policy=policy, ok=False)
    if not ok:
        res.skipped = True
        res.reason = reason
        res.ok = True
        return res

    cfg = get_config(arch)
    cfg = cfg.replace(remat="full" if sc.kind == "train" else "none")
    if cfg_override:
        cfg = cfg.replace(**cfg_override)
    counts = model_param_counts(cfg)
    res.params_total, res.params_active = counts["total"], counts["active"]

    try:
        cost = None
        if not skip_cost_pass:
            t0 = time.perf_counter()
            cost = cost_pass(cfg, sc, mesh, policy)
            res.lower_s = time.perf_counter() - t0
            res.flops_dev = cost["flops"]
            res.bytes_dev = cost["bytes"]
            res.coll_wire_bytes_dev = cost["wire"]
            res.n_collectives = int(cost["ncoll"])
            res.coll_by_op = cost["by_op"]

        # ---- memory pass: train cells take the accumulation that fits
        # the card (the cost is accumulation-invariant in FLOPs)
        if not skip_memory_pass:
            t0 = time.perf_counter()
            if sc.kind == "train":
                accum, mem = train_accum(cfg, sc, mesh, policy, first=cost)
            else:
                accum = 1
                mem = cost or count_cell(cfg, sc, mesh, policy)
            res.compile_s = time.perf_counter() - t0
            res.policy = policy + (f"+accum{accum}" if accum > 1 else "")
            res.arg_bytes_dev = mem["arg_bytes"]
            res.out_bytes_dev = mem["out_bytes"]
            res.temp_bytes_dev = mem["temp_bytes"]

        # ---- roofline terms (per card, seconds)
        res.t_compute = res.flops_dev / HW["peak_flops"]
        res.t_memory = res.bytes_dev / HW["hbm_bw"]
        res.t_collective = res.coll_wire_bytes_dev / HW["ici_bw"]
        res.dominant = max(
            [("compute", res.t_compute), ("memory", res.t_memory),
             ("collective", res.t_collective)], key=lambda kv: kv[1])[0]

        # ---- useful-FLOPs ratio
        n_chips = mesh.size
        tokens = sc.global_batch * (sc.seq_len if sc.kind != "decode" else 1)
        mult = 6 if sc.kind == "train" else 2
        res.model_flops_dev = mult * counts["active"] * tokens / n_chips
        res.useful_ratio = (res.model_flops_dev / res.flops_dev
                            if res.flops_dev else 0.0)
        res.ok = True
    except Exception as e:  # noqa: BLE001 — report per-cell failures
        res.error = f"{type(e).__name__}: {e}"[:2000]
        res.ok = False
    return res


def save_result(res: CellResult, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    base_policy = res.policy.split("+")[0]
    name = f"{res.arch}__{res.shape}__{res.mesh}__{base_policy}.json"
    path = os.path.join(out_dir, name)
    d = res.to_json()
    # memory-only re-runs (skip_cost) merge into existing cost numbers
    if res.ok and not res.skipped and res.flops_dev == 0 and \
            os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        for k in ("flops_dev", "bytes_dev", "coll_wire_bytes_dev",
                  "n_collectives", "coll_by_op", "t_compute", "t_memory",
                  "t_collective", "dominant", "model_flops_dev",
                  "useful_ratio", "lower_s"):
            d[k] = old.get(k, d[k])
    with open(path, "w") as f:
        json.dump(d, f, indent=1)
