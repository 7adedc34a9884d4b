"""Time the port's bf16 attention kernels of one or more checkouts in
turns, on one CUDA card.

    python3 scripts/attention_ab.py [TREE ...]

Each TREE is the root of a checkout of this repository (default: this
one); give trees in the order to run them, e.g. ``parent change change
parent``, so that two versions are compared within one call on one card.
Each tree runs in its own process, builds its kernels into its own
``build/`` and prints, beside the card's name and power limit: flash at
the dense path's prefill (B=3, S=512) and at (1, 2048), causal; the
paged extend at the paged path's admit (B=4, S=256, pos0
16/256/768/1792, bs=16) and at one long-prefix admit (B=1, S=256, pos0
1792); and the paged and split-K decode at ``chip_smoke.DECODE_SHAPES``:
phase 2's ragged lengths (B=8, up to 2048), the serves' decode (B=8,
lengths 301-329, tables and stripes of 2048 rows) and a tiny shape (B=1,
length 8).  Each is given as device ms per call from a CUDA-graph replay
(``chip_smoke._time_ms``), with SDPA's time on the same inputs for flash
and the decodes, and the host's time to issue one call from Python
(``issue_ms``, ``chip_smoke._issue_ms``: the wrapper, its scratch and
tensor maps, the launch).  Where a call's device time is above its issue
time, calls issued back to back wait on the card and ``issue_ms`` tracks
the device; so flash and the extend are also issued at a tiny shape (S=8,
B=1, pos0 0 for the extend), as the decodes are at (B=1, length 8),
whose device time is a few microseconds, where ``issue_ms`` is the
host's cost alone.  Every timed kernel is first held against its plain
version at chip_smoke's bf16 limits.  Without a card it exits non-zero.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def run_tree(tree: Path, label: str) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(REPO))
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import build, ops, ref
    if not torch.cuda.is_available():
        sys.exit("attention_ab: no CUDA card")
    assert Path(repro_torch.__file__).resolve().is_relative_to(tree)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf, H, KV, hd = torch.bfloat16, 16, 8, 128
    rows = []
    for B, S in ((3, 512), (1, 2048), (1, 8)):
        sets = [[cs._randn(gen, sh, bf, dev) for sh in
                 ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
                for _ in range(3)]
        q, k, v = sets[0]
        cs._compare(f"flash ({B}, {S})", ops.flash_attention(q, k, v),
                    ref.flash_attention_ref(q.float(), k.float(), v.float()))
        sd = [[t.transpose(1, 2).contiguous() for t in st] for st in sets]
        rows.append((f"flash ({B}, {S})",
                     cs._time_ms([lambda s=s: ops.flash_attention(*s)
                                  for s in sets]),
                     cs._time_ms([lambda a=a: F.scaled_dot_product_attention(
                         *a, is_causal=True, enable_gqa=True) for a in sd]),
                     cs._issue_ms(lambda: ops.flash_attention(q, k, v))))
    bs, nb = 16, 128
    cases = []
    for p0, S in (((16, 256, 768, 1792), 256), ((1792,), 256), ((0,), 8)):
        B = len(p0)
        pos0 = torch.tensor(p0, dtype=torch.int32, device=dev)
        sets = [cs._paged_inputs(gen, B, nb, bs, KV, hd, (B, S, H, hd), bf,
                                 dev) for _ in range(3)]
        q, kp, vp, bt = sets[0]
        cases.append((f"extend ({B}, {S}) pos0 {p0}", pos0, sets,
                      ref.paged_extend_attention_ref(
                          q.float(), kp.float(), vp.float(), bt, pos0)))
    for name, pos0, sets, want in cases:
        cs._compare(name, ops.paged_extend_attention(*sets[0], pos0), want)
        rows.append((name, cs._time_ms([
            lambda s=s: ops.paged_extend_attention(*s, pos0) for s in sets]),
            None, cs._issue_ms(
                lambda: ops.paged_extend_attention(*sets[0], pos0))))
    for shape, lengths, max_len in cs.DECODE_SHAPES:
        for name, st in cs._decode_bench(gen, dev, lengths, max_len).items():
            rows.append((f"{name} at {shape}", st["ms"], st["library_ms"],
                         st["issue_ms"]))
    for name, ms, sdpa, issue in rows:
        print(f"[ab] {label} {name}: ms={ms:.4f}" +
              (f" sdpa_ms={sdpa:.4f}" if sdpa else "") +
              f" issue_ms={issue:.4f} on {smi}", flush=True)


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
