"""Multi-pod dry run of the port (``repro.launch.dryrun``): count every
(arch x shape) cell's per-device work on the production mesh, on fake
tensors, and emit the roofline terms.  No card and no process group are
needed, and nothing is allocated:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape train_4k --policy broadcast

The mesh is rank 0 of (16, 16) (``--mesh single``) or (2, 16, 16)
(``multi``), ``launch/mesh.abstract_mesh(..., rank0=True)``.  Each cell
prints an ``OK``, ``SKIP`` or ``FAIL`` line and writes its JSON to
``--out``; the exit code is 1 if any cell failed.  Under the default
policies (``fsdp_tp`` for train, ``tp`` for serve) every cell fails,
naming ROADMAP.md Queue 1 item 14, until the port has tensor-parallel
layers.
"""
import argparse
import sys
import time

from repro_torch.configs import ARCH_IDS
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun_lib
from repro_torch.launch.mesh import abstract_mesh, production_shape


def _print_table(table) -> None:
    rows = sorted(table.items(), key=lambda kv: -kv[1][2])
    print(f"    {'op':<44} {'calls':>8} {'FLOPs':>12} {'bytes':>12}")
    for name, (calls, flops, nbytes) in rows:
        print(f"    {name:<44} {int(calls):>8} {flops:>12.4e} "
              f"{nbytes:>12.4e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-pod dry run: count "
                                 "every (arch x shape) cell's per-device "
                                 "work on fake tensors on the production "
                                 "mesh; emit roofline terms.")
    ap.add_argument("--arch", default="all",
                    help=f"one of {list(ARCH_IDS)} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {[s.name for s in SHAPES]} or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--policy", default=None,
                    help="override placement policy (broadcast|tp|fsdp_tp|"
                         "seqtp); default: fsdp_tp for train, tp for serve")
    ap.add_argument("--remat", default=None, help="override remat policy")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-cost", action="store_true",
                    help="memory only (multi-pod sharding proof; the "
                         "roofline table is single-pod)")
    ap.add_argument("--verbose-hlo", action="store_true",
                    help="print each cell's per-op table (aten ops, "
                         "kernels, collectives: calls, FLOPs, bytes) of the "
                         "counted step; the port has no HLO")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_fail = 0
    for multi_pod in meshes:
        mesh = abstract_mesh(*production_shape(multi_pod), rank0=True)
        for arch in archs:
            for shape in shapes:
                t0 = time.perf_counter()
                override = {"remat": args.remat} if args.remat else None
                dryrun_lib.LAST_OPS = {}
                res = dryrun_lib.run_cell(arch, shape, mesh,
                                          policy=args.policy,
                                          cfg_override=override,
                                          skip_cost_pass=args.skip_cost)
                dryrun_lib.save_result(res, args.out)
                wall = time.perf_counter() - t0
                if res.skipped:
                    print(f"SKIP {arch:>22} {shape:<12} {res.mesh:<9} "
                          f"{res.reason[:60]}", flush=True)
                elif res.ok:
                    print(f"OK   {arch:>22} {shape:<12} {res.mesh:<9} "
                          f"pol={res.policy:<8} "
                          f"flops/dev={res.flops_dev:.3e} "
                          f"coll={res.coll_wire_bytes_dev:.3e}B "
                          f"dom={res.dominant:<10} "
                          f"useful={res.useful_ratio:.2f} "
                          f"compile={res.compile_s:.1f}s wall={wall:.1f}s",
                          flush=True)
                    if args.verbose_hlo and dryrun_lib.LAST_OPS:
                        _print_table(dryrun_lib.LAST_OPS)
                else:
                    n_fail += 1
                    print(f"FAIL {arch:>22} {shape:<12} {res.mesh:<9} "
                          f"{res.error[:200]}", flush=True)
    print(f"\ndone; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
