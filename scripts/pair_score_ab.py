"""Time the port's pair score of one or more checkouts in turns, on one
CUDA card.

    python3 scripts/pair_score_ab.py [TREE ...]

Each TREE is the root of a checkout of this repository (default: this
one); give trees in the order to run them, e.g. ``parent change change
parent``, so that two versions are compared within one call on one card.
Each tree runs in its own process, builds its kernels into its own
``build/`` and prints, beside the card's name and power limit, for fp32
inputs at MARGOT's batch partition (256, 512, 1024), the stream's chunk
(1024, 1024, 1024) and a tiny shape (8, 8, 64): the device ms per call
from a CUDA-graph replay (``chip_smoke._time_ms``, three input copies in
turn), the cuBLAS yardstick's on the same inputs (``chip_smoke.
_pair_library``: the same function as GEMMs and elementwise calls), and
the host's time to issue one call from Python (``issue_ms``,
``chip_smoke._issue_ms``: the wrapper, its plan, output and workspace,
the tensor maps, the launches).  At the tiny shape the device time is a
few microseconds, so ``issue_ms`` there is the host's cost alone.  Every
timed call is first held against the plain version in fp64 at
``chip_smoke.PAIR_REL``.  Without a card it exits non-zero.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((256, 512, 1024), (1024, 1024, 1024), (8, 8, 64))


def run_tree(tree: Path, label: str) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(REPO))
    import torch
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import build, ops, ref
    if not torch.cuda.is_available():
        sys.exit("pair_score_ab: no CUDA card")
    assert Path(repro_torch.__file__).resolve().is_relative_to(tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for N, M, d in SHAPES:
        sets = [cs._pair_inputs(gen, dev, N, M, d, torch.float32)
                for _ in range(3)]
        link = lambda s: {"W": s[2], "w": s[3], "bias": s[4]}  # noqa
        C, E, W, w, b = sets[0]
        want = ref.pair_score_ref(*(t.double() for t in
                                    (C, E, W, w[:d], w[d:], b)))
        rel = float((ops.pair_score(link(sets[0]), C, E).double() - want)
                    .abs().max() / want.abs().max())
        if not rel <= cs.PAIR_REL:
            sys.exit(f"pair_score_ab: {label} ({N}, {M}, {d}) is off by "
                     f"{rel:.3e} of max |score|, limit {cs.PAIR_REL}")
        ms = cs._time_ms([lambda s=s: ops.pair_score(link(s), s[0], s[1])
                          for s in sets])
        cublas = cs._time_ms([lambda s=s: cs._pair_library(*s)
                              for s in sets])
        issue = cs._issue_ms(lambda: ops.pair_score(link(sets[0]), C, E))
        print(f"[ab] {label} pair_score ({N}, {M}, {d}): ms={ms:.4f} "
              f"cublas_ms={cublas:.4f} issue_ms={issue:.4f} "
              f"rel_err={rel:.3e} on {smi}", flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--one":
        run_tree(Path(argv[1]).resolve(), argv[2] if len(argv) > 2 else "")
        return
    trees = [Path(t).resolve() for t in argv] or [REPO]
    for i, tree in enumerate(trees):
        subprocess.run([sys.executable, __file__, "--one", str(tree),
                        f"{i}:{tree.name}"], check=True, timeout=600)


if __name__ == "__main__":
    main(sys.argv[1:])
