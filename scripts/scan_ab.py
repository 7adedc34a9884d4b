"""Time the port's scan kernels of one or more checkouts in turns, on one
CUDA card.

    python3 scripts/scan_ab.py [TREE ...]

Each TREE is the root of a checkout of this repository (default: this
one); give trees in the order to run them, e.g. ``parent change change
parent``, so that two versions are compared within one call on one card.
Each tree runs in its own process, builds its kernels into its own
``build/`` and prints, beside the card's name and power limit, device ms
per call from a CUDA-graph replay (``chip_smoke._time_ms``) of:
``ssm_scan_blocked`` at the Mamba serve's admit shape (4, 512, 8192, 16)
and at recurrentgemma-2b's RG-LRU admits (1, 512, 2560, 1) and (1, 2200,
2560, 1), each on three copies of its inputs in turn; and ``ops.ssm_scan``
(the Mamba op: whatever route the tree takes on a CUDA tensor) at (4,
512), (1, 1000) and (1, 100) with di 8192, N 16.  Every timed call is
first held against the plain sequential recurrence at atol = rtol =
1e-4.  Without a card it exits non-zero.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4


def _plain_op(ref, xc, dt, Bc, Cc, A, D):
    """The op composed in torch around the plain recurrence."""
    import torch
    a_bar = (dt[..., None] * A).exp()
    b_bar = (dt * xc)[..., None] * Bc[:, :, None, :]
    h0 = torch.zeros_like(a_bar[:, 0])
    hs, hT = ref.ssm_scan_ref(a_bar, b_bar, h0)
    return torch.einsum("bsdn,bsn->bsd", hs, Cc) + xc * D, hT


def _close(name, got, want):
    import torch
    for g, w in zip(got, want):
        if not torch.allclose(g, w, atol=TOL, rtol=TOL):
            sys.exit(f"scan_ab: {name} off the plain version by "
                     f"{(g - w).abs().max().item():.3e}")


def run_tree(tree: Path, label: str) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(REPO))
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import ssm_scan as ss
    if not torch.cuda.is_available():
        sys.exit("scan_ab: no CUDA card")
    assert Path(repro_torch.__file__).resolve().is_relative_to(tree)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for shape in ((4, 512, 8192, 16), (1, 512, 2560, 1), (1, 2200, 2560, 1)):
        copies = 1 if shape[0] == 4 else 3       # 3.2 GB a copy at (4, 512)
        sets = [cs._scan_inputs(gen, dev, *shape) for _ in range(copies)]
        _close(f"ssm_scan_blocked {shape}", ss.ssm_scan_blocked(*sets[0]),
               ref.ssm_scan_ref(*sets[0]))
        rows.append((f"ssm_scan_blocked {shape}", cs._time_ms(
            [lambda s=s: ss.ssm_scan_blocked(*s) for s in sets],
            iters=5 if copies == 1 else 20)))
        del sets
    for B, S in ((4, 512), (1, 1000), (1, 100)):
        rnd = lambda *s: cs._randn(gen, s, torch.float32, dev)  # noqa
        xc, dt = rnd(B, S, 8192), F.softplus(rnd(B, S, 8192))
        _, Bc, Cc = torch.split(rnd(B, S, 7 + 32), [7, 16, 16], dim=-1)
        args = (xc, dt, Bc, Cc, -torch.exp(rnd(8192, 16)), rnd(8192))
        _close(f"ops.ssm_scan ({B}, {S})", ops.ssm_scan(*args),
               _plain_op(ref, *args))
        rows.append((f"ops.ssm_scan ({B}, {S}, 8192, 16)",
                     cs._time_ms([lambda: ops.ssm_scan(*args)], iters=5)))
        del args
        torch.cuda.empty_cache()
    for name, ms in rows:
        print(f"[ab] {label} {name}: ms={ms:.4f} on {smi}", flush=True)


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
