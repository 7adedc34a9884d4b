"""Training driver of the port, after ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 6 --batch 2 --seq 32 --ckpt-dir "$(mktemp -d)"
    PYTHONPATH=src python -m repro_torch.launch.train --device cuda \
        --steps 50 --batch 8 --seq 128 --ckpt-dir "$(mktemp -d)"

It trains the arch's ``reduced()`` config with AdamW from the port's
seeded init on the ``synthetic_tokens`` stream, saves ``{"params",
"opt"}`` with a ``Checkpointer`` every ``--ckpt-every`` steps and at the
end, records each step in a ``ReplayLog`` beside the checkpoints, and
prints JAX's ``[train]`` lines.  ``--reduced`` is JAX's flag as it is:
``store_true`` with default True, so the CLI always trains the reduced
config; :func:`train` takes any config (``chip_smoke.py`` trains
internlm2-1.8b at full width through it).  ``--device cuda`` (the
default) runs the kernels, flash forward and backward included; ``cpu``
runs their plain versions under autograd.  ``--warmup`` is the train
step's (JAX's driver leaves it at ``make_train_step``'s 100).

Resume: a run whose checkpoint directory holds a step restores it and
goes on from the optimizer's step count (the number of updates the
checkpoint holds), drawing the stream's next batch, so a resumed run
takes the same steps as an uninterrupted one.  JAX's driver resumes at
the checkpoint's label, which is one short of the updates a periodic
checkpoint holds, and re-seeds the stream with it (ROADMAP.md, Queue 3).
So give each run a directory of its own: the default, JAX's
``/tmp/repro_train`` (under ``$TMPDIR`` where that is set), is shared by
every run on the machine, and ``Checkpointer.restore`` refuses only a
step of another shape.
Several ranks: under ``torchrun`` (``WORLD_SIZE`` > 1) the driver
starts the process group (``--backend``, by default nccl on ``cuda`` and
gloo on ``cpu``; nccl refuses more ranks than cards) and trains on the
local mesh ``(1, world)``, or on the production mesh with
``--production-mesh`` (which needs 256 ranks, as JAX's needs 256
devices).  Under ``--policy broadcast`` that is data parallelism
(``steps.make_train_step(..., mesh=)``): rank 0's initial tree is
broadcast to every rank, each rank takes its rows of every batch, the
gradients are all-reduced, and rank 0 alone prints, logs and writes the
checkpoints.  Under ``tp`` / ``fsdp_tp`` each rank keeps its blocks of
every leaf and the tensor-parallel layers compute on them (on one rank,
the mesh ``(1, 1)``, as JAX's driver makes ``make_local_mesh(1, 1)``);
a checkpoint holds the whole leaves (every rank's blocks gathered,
``broadcast.unshard``), so any policy and any world restores it.
Under ``seqtp`` the weights are replicated as under ``broadcast`` and
each rank takes the positions of its shard of ``model`` in every layer
(at a sequence of at least 1,024 tokens that divides over the ranks, as
JAX shards; a shorter one runs whole on every rank): the collectives'
backwards and flash's backward at a query offset give each rank its
share of the gradients, which are summed over the mesh
(``launch/steps.py``); on one rank it is the one-device step.
An encoder-decoder config (whisper-base) raises ``ValueError`` before
its first step: the driver feeds token batches only, as JAX's does,
whose first step then fails on the missing ``frames``; its train step
runs through ``steps.make_train_step`` on a ``{"frames", "tokens"}``
batch.
"""
from __future__ import annotations

import argparse
import itertools
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.core import collectives
from repro_torch.core.broadcast import REPLICATED, place_params, unshard
from repro_torch.core.fault import ReplayLog
from repro_torch.core.sharding import NamedSharding
from repro_torch.data.text import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh, make_local_mesh, \
    make_production_mesh
from repro_torch.launch.steps import check_policy, make_train_step
from repro_torch.models import api, weights
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.tree import tree_map

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_train")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--policy", default="broadcast")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--backend", default=None,
                    help="the process group's backend under torchrun: nccl "
                         "(default on cuda) or gloo (default on cpu)")
    return ap


def train(cfg, *, steps: int = 50, batch: int = 8, seq: int = 128,
          accum: int = 1, lr: float = 3e-4, warmup: int = 100,
          ckpt_dir: str = DEFAULT_CKPT_DIR, ckpt_every: int = 25,
          device="cuda", on_step: Optional[Callable[[Dict], None]] = None,
          mesh=None, policy: str = "broadcast") -> Dict:
    """Train ``cfg`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint), as the CLI does.  ``on_step`` gets each step's
    record: ``step``, ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``
    (floats) and ``ms``, the step's host wall time up to its metrics on
    the host.  With a ``mesh`` every rank calls it: data parallelism
    under ``policy`` ``broadcast`` (the module docstring).  Returns
    ``{"params", "opt", "start", "history"}``."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: the training driver feeds token batches only, and "
            f"the encoder-decoder family's loss needs frames too (JAX's "
            f"driver fails at its first step on batch['frames']); train it "
            f"through steps.make_train_step on a {{'frames', 'tokens'}} "
            f"batch")
    dev = resolve_device(device) if mesh is None else mesh.device
    lead = mesh is None or mesh.axis_index(mesh.axis_names) == 0
    params, axes = api.init(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev, with_axes=True)
    sh = None
    if mesh is not None:
        params, sh = place_params(params, axes, mesh, policy)
        if policy in REPLICATED:
            sh = None
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, lr=lr, warmup=warmup, total=steps,
                              accum_steps=accum, mesh=mesh, policy=policy)
    ck = Checkpointer(ckpt_dir, async_save=True)
    log = ReplayLog(f"{ckpt_dir}/replay.jsonl")
    say = print if lead else (lambda *a, **k: None)

    def whole(params, opt):
        """The tree a checkpoint holds: every leaf whole."""
        if sh is None:
            return {"params": params, "opt": opt}
        return {"params": unshard(params, sh),
                "opt": AdamWState(opt.step, unshard(opt.m, sh),
                                  unshard(opt.v, sh))}

    start = 0
    if ck.latest_step() is not None:
        if sh is None:
            state = ck.restore({"params": params, "opt": opt})
        else:
            like = weights.empty_params(cfg, "meta")
            f32 = lambda p: torch.empty(  # noqa: E731
                p.shape, dtype=torch.float32, device="meta")
            state = ck.restore(
                {"params": like, "opt": AdamWState(
                    torch.empty((), dtype=torch.int32, device="meta"),
                    tree_map(f32, like), tree_map(f32, like))},
                shardings={"params": sh, "opt": AdamWState(
                    NamedSharding(mesh, ()), sh, sh)})
        params, opt = state["params"], state["opt"]
        del state
        start = int(opt.step)
        say(f"[train] resumed from checkpoint step {ck.latest_step()} "
            f"({start} updates)")

    data = itertools.islice(synthetic_tokens(0, batch, seq, cfg.vocab,
                                             n_batches=steps), start, None)
    history: List[Dict] = []
    t0 = time.perf_counter()
    for i, tokens in enumerate(data):
        step = start + i
        t_step = time.perf_counter()
        params, opt, m = step_fn(
            params, opt, {"tokens": torch.from_numpy(tokens).to(dev)})
        rec = {k: float(v) for k, v in m.items()}
        rec.update(step=step, ms=(time.perf_counter() - t_step) * 1e3)
        history.append(rec)
        if on_step is not None:
            on_step(rec)
        if lead:
            log.record(step, offset=step * batch)
        if step % 10 == 0 or step == steps - 1:
            say(f"[train] step {step:4d} loss={rec['loss']:.4f} "
                f"gnorm={rec['grad_norm']:.3f} "
                f"({time.perf_counter() - t0:.1f}s)")
        if ckpt_every and step and step % ckpt_every == 0:
            tree = whole(params, opt)
            if lead:
                ck.save(step, tree)
            del tree
    tree = whole(params, opt)
    if lead:
        ck.save(steps, tree)
        ck.wait()
    del tree
    say(f"[train] done; checkpoints at {ck.steps()}")
    return {"params": params, "opt": opt, "start": start,
            "history": history}


def _mesh(args):
    """The mesh of a run: None on one rank without ``--production-mesh``;
    under torchrun the process group is started here (a caller that
    started its own, as ``collectives.spawn`` does, keeps it)."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("WORLD_SIZE", 1))
    if world > 1 and not dist.is_initialized():
        backend = args.backend or ("nccl" if args.device == "cuda"
                                   else "gloo")
        collectives.init_process_group(
            backend, int(os.environ["RANK"]), world, "env://", args.device,
            timeout_s=1800)
    if args.production_mesh:
        return make_production_mesh()
    if world > 1:
        return make_local_mesh(1, world)
    if args.policy in ("tp", "fsdp_tp"):
        # JAX's make_local_mesh(1, 1): one rank, no process group needed
        # (no collective calls a group over an axis of one rank)
        return Mesh((1, 1), ("data", "model"), ranks=(0,), rank=0,
                    device=resolve_device(args.device))
    return None


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    check_policy(args.policy)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 accum=args.accum, lr=args.lr, warmup=args.warmup,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 device=args.device, mesh=_mesh(args), policy=args.policy)


if __name__ == "__main__":
    main()
