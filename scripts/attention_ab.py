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
host's cost alone.  The MLA decode (bf16, 16 heads, r 512, rope 64, L
2048) is timed the same way at the serve's decode (B=8, lengths
301-329), at 2,048 keys a row (B=8) and at B=1, length 1; in a tree
whose wrapper has ``MIN_KEYS`` (the split-by-live-length design), a sweep
of it (16, 32, 64, 128, 256) at the first two shapes follows, each
setting also held against the plain version first.  Every timed kernel
is first held against its plain version at chip_smoke's bf16 limits.
Last, the flash backward (bf16) at the training shape (B 4, S 1024
causal, H 16, KV 8, hd 128) and at hd 256 with window 1024 over S 2048:
device ms of one ``torch.autograd.grad`` replayed from a CUDA graph
(``chip_smoke._time_bwd_ms``, forwards excluded) beside SDPA's backward,
each first held against the plain fp32 gradients.  Without a card it
exits non-zero.

    python3 scripts/attention_ab.py --softcap [TREE ...]

times instead the soft-capped kernels (c 50, Gemma 2's
``attn_logit_softcapping``, over inputs whose scaled scores spread to
about +-100) at the main paths' shapes (bf16, H 16, KV 8, hd 128): flash
(B 3, S 512 causal), the paged extend (B 4, S 256 at pos0 16-1792), the
paged and the split-K decode (B 8 at chip_smoke's ragged lengths up to
2,048) and the flash backward at the training shape (B 4, S 1,024), each
beside its uncapped time and its library time: FlexAttention
(``torch.nn.attention.flex_attention`` compiled, a ``c * tanh(score /
c)`` score_mod and the kernel's mask as a block mask; the decodes and the
extend over K/V gathered through the table, the gather not timed).  Each
FlexAttention result is first held to the capped plain version at
chip_smoke's library tolerance; where it does not compile or run at a
shape, its time is "none" with the error.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def run_tree(tree: Path, label: str, softcap: bool = False) -> None:
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
    if softcap:
        for name, ms, ms0, flex in _softcap_rows(cs, gen, dev):
            print(f"[ab] {label} softcap {name}: ms={ms:.4f} "
                  f"uncapped_ms={ms0:.4f} flex_ms={flex} on {smi}",
                  flush=True)
        return
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
    rows += _mla_rows(cs, gen, dev)
    for name, ms, sdpa, issue in rows:
        print(f"[ab] {label} {name}: ms={ms:.4f}" +
              (f" sdpa_ms={sdpa:.4f}" if sdpa else "") +
              f" issue_ms={issue:.4f} on {smi}", flush=True)
    for name, ms, sdpa in _bwd_rows(cs, gen, dev):
        print(f"[ab] {label} {name}: ms={ms:.4f} sdpa_ms={sdpa:.4f} on "
              f"{smi}", flush=True)


def _bwd_rows(cs, gen, dev):
    """The flash backward (``ops.flash_attention`` under grad) at the
    training shape (B 4, S 1024 causal, H 16, KV 8, hd 128) and at hd 256
    with window 1024 over S 2048 (H 8, KV 4): each first held against the
    plain fp32 gradients (``chip_smoke._bwd_check``: chip_smoke's bf16
    limit, a second call bit for bit), then device ms of one backward
    from a captured ``torch.autograd.grad`` (``chip_smoke._time_bwd_ms``),
    beside SDPA's backward on K/V expanded to the query heads (the flash
    backend where causal, the band as a mask otherwise)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops
    bf = torch.bfloat16
    rows = []
    for B, S, H, KV, hd, window in ((4, 1024, 16, 8, 128, 0),
                                    (1, 2048, 8, 4, 256, 1024)):
        name = f"flash bwd ({B}, {S}) H {H} KV {KV} hd {hd} causal" + \
            (f" window {window}" if window else "")
        sets = [[cs._randn(gen, sh, bf, dev) for sh in
                 ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                  (B, S, H, hd))] for _ in range(3)]
        cs._bwd_check(name, *sets[0], True, window)
        ms = cs._time_bwd_ms(lambda q, k, v: ops.flash_attention(
            q, k, v, causal=True, window=window),
            [(st[:3], st[3]) for st in sets])
        G = H // KV
        sd = [([st[0].transpose(1, 2).contiguous()] +
               [t.repeat_interleave(G, 2).transpose(1, 2).contiguous()
                for t in st[1:3]], st[3].transpose(1, 2).contiguous())
              for st in sets]
        if window:
            t = torch.arange(S, device=dev)
            band = (t[None, :] <= t[:, None]) & \
                (t[None, :] > t[:, None] - window)
            sdpa_ms = cs._time_bwd_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=band), sd)
        else:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                sdpa_ms = cs._time_bwd_ms(
                    lambda q, k, v: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True), sd)
        rows.append((name, ms, sdpa_ms))
    return rows


def _mla_rows(cs, gen, dev):
    """The MLA decode at the serve's decode, 2,048 keys a row and B=1,
    length 1 (device ms, issue ms), then the MIN_KEYS sweep where the
    tree's wrapper has one."""
    import math

    import torch
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import ops, ref
    bf, L, scale = torch.bfloat16, 2048, 1.0 / math.sqrt(192)
    shapes = (("serve", list(range(301, 330, 4))), ("2048", [2048] * 8),
              ("B1 len1", [1]))
    cases = []
    for label, lens in shapes:
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        sets = [cs._mla_inputs(gen, dev, len(lens), L, bf)
                for _ in range(3)]
        cases.append((label, lengths, sets, ref.mla_decode_attention_ref(
            *cs._f32(*sets[0]), lengths, scale)))

    def timed(label, lengths, sets, want):
        cs._compare(f"mla_decode {label}", ops.mla_decode_attention(
            *sets[0], lengths, scale), want)
        return (f"mla_decode at {label}", cs._time_ms(
            [lambda s=s: ops.mla_decode_attention(*s, lengths, scale)
             for s in sets]), None, cs._issue_ms(
            lambda: ops.mla_decode_attention(*sets[0], lengths, scale)))
    rows = [timed(*c) for c in cases]
    if hasattr(md, "MIN_KEYS"):
        chosen = md.MIN_KEYS
        try:
            for min_keys in (16, 32, 64, 128, 256):
                md.MIN_KEYS = min_keys
                for label, lengths, sets, want in cases[:2]:
                    rows.append(timed(f"{label} MIN_KEYS {min_keys}",
                                      lengths, sets, want))
        finally:
            md.MIN_KEYS = chosen
    return rows


def _flex_none(e) -> str:
    return f"none ({type(e).__name__}: {str(e).splitlines()[0]})"


def _flex_close(cs, name, got, want):
    """FlexAttention's ``got`` within chip_smoke's library tolerance of
    the plain ``want``, relative to its largest magnitude; raises
    ``ValueError`` (its row then reads "none") otherwise."""
    err = (got.float() - want).abs().max().item()
    top = want.abs().max().item()
    if err > cs.LIBRARY_TOL * max(top, 1.0):
        raise ValueError(f"{name} computes another function: max |err| "
                         f"{err:.3e} over {top:.3e}")


def _softcap_rows(cs, gen, dev):
    """(name, capped ms, uncapped ms, FlexAttention ms or "none (error)")
    of each capped kernel at the main paths' shapes (the module
    docstring)."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    from repro_torch.kernels import ops, ref
    bf, H, KV, hd, c = torch.bfloat16, 16, 8, 128, 50.0
    # the backward's timing replays torch.autograd.grad with retain_graph,
    # which a compiled backward with donated buffers refuses
    import torch._functorch.config as functorch_config
    functorch_config.donated_buffer = False
    flex = torch.compile(flex_attention, dynamic=False)

    def cap(score, b, h, q_idx, kv_idx):
        return c * torch.tanh(score / c)

    def flex_ms(name, want, sets, mask, squeeze):
        """FlexAttention over ``sets`` ((B, H, S, hd) q and (B, KV, T, hd)
        k, v) with ``mask``, held to ``want`` (the output through
        ``squeeze``), then timed; "none (error)" where it fails."""
        def call(a):
            return flex(*a, score_mod=cap, block_mask=mask, enable_gqa=True)
        try:
            _flex_close(cs, name, squeeze(call(sets[0])), want)
            return f"{cs._time_ms([lambda a=a: call(a) for a in sets]):.4f}"
        except Exception as e:       # reported in the row, not raised
            return _flex_none(e)

    def kernel_ms(fn, sets):
        return [cs._time_ms([lambda s=s: fn(s, cc) for s in sets])
                for cc in (c, 0.0)]

    rows = []
    lens = torch.tensor(cs.CAP_LENGTHS, dtype=torch.int32, device=dev)
    pos0 = torch.tensor(cs.CAP_POS0, dtype=torch.int32, device=dev)
    # flash, causal
    sets = [cs._cap_qkv(gen, dev, (3, 512, H, hd), (3, 512, KV, hd), c, bf)
            for _ in range(3)]
    want = ref.flash_attention_ref(*cs._f32(*sets[0]), softcap=c)
    cs._compare("flash", ops.flash_attention(*sets[0], softcap=c), want)
    mask = create_block_mask(lambda b, h, q, kv: kv <= q, None, None, 512,
                             512, device=dev)
    rows.append(("flash (3, 512) causal", *kernel_ms(
        lambda s, cc: ops.flash_attention(*s, softcap=cc), sets),
        flex_ms("flash", want, [[t.transpose(1, 2).contiguous() for t in st]
                                for st in sets], mask,
                lambda o: o.transpose(1, 2))))
    # the paged extend and the paged decode, over the gathered K/V
    bs, nb = 16, 128
    sig = cs.CAP_SPREAD[c] ** 0.5

    def paged(B, q_shape):
        out = []
        for _ in range(3):
            q, kp, vp, bt = cs._paged_inputs(gen, B, nb, bs, KV, hd,
                                             q_shape, torch.float32, dev)
            out.append(((q * sig).to(bf), (kp * sig).to(bf), vp.to(bf), bt))
        return out

    def gathered(s):
        q, kp, vp, bt = s
        B = bt.shape[0]
        return [t[bt.long()].reshape(B, nb * bs, KV, hd).transpose(1, 2)
                .contiguous() for t in (kp, vp)]

    ext = paged(4, (4, 256, H, hd))
    want = ref.paged_extend_attention_ref(*cs._f32(*ext[0][:3]), ext[0][3],
                                          pos0, c)
    cs._compare("extend", ops.paged_extend_attention(*ext[0], pos0,
                                                     softcap=c), want)
    mask = create_block_mask(lambda b, h, q, kv: kv <= pos0[b] + q, 4, None,
                             256, nb * bs, device=dev)
    rows.append(("paged extend (4, 256) pos0 16-1792", *kernel_ms(
        lambda s, cc: ops.paged_extend_attention(*s, pos0, softcap=cc), ext),
        flex_ms("extend", want, [[s[0].transpose(1, 2).contiguous()] +
                                 gathered(s) for s in ext], mask,
                lambda o: o.transpose(1, 2))))
    mask = create_block_mask(lambda b, h, q, kv: kv < lens[b], 8, None, 1,
                             nb * bs, device=dev)
    pdec = paged(8, (8, H, hd))
    want = ref.paged_decode_attention_ref(*cs._f32(*pdec[0][:3]),
                                          pdec[0][3], lens, c)
    cs._compare("paged decode", ops.paged_decode_attention(
        *pdec[0], lens, softcap=c), want)
    rows.append(("paged decode (8) lengths to 2048", *kernel_ms(
        lambda s, cc: ops.paged_decode_attention(*s, lens, softcap=cc),
        pdec), flex_ms("paged decode", want,
                       [[s[0][:, :, None]] + gathered(s) for s in pdec],
                       mask, lambda o: o[:, :, 0])))
    dec = [cs._cap_qkv(gen, dev, (8, H, hd), (8, 2048, KV, hd), c, bf)
           for _ in range(3)]
    want = ref.decode_attention_ref(*cs._f32(*dec[0]), lens, c)
    cs._compare("decode", ops.decode_attention(*dec[0], lens, softcap=c),
                want)
    rows.append(("split-K decode (8, 2048) lengths to 2048", *kernel_ms(
        lambda s, cc: ops.decode_attention(*s, lens, softcap=cc), dec),
        flex_ms("decode", want, [[q[:, :, None], k.transpose(1, 2)
                                  .contiguous(), v.transpose(1, 2)
                                  .contiguous()] for q, k, v in dec], mask,
                lambda o: o[:, :, 0])))
    # the backward at the training shape
    B, S = 4, 1024
    bsets = []
    for _ in range(3):
        q, k, v = cs._cap_qkv(gen, dev, (B, S, H, hd), (B, S, KV, hd), c, bf)
        bsets.append(((q, k, v), cs._randn(gen, (B, S, H, hd), bf, dev)))
    (q, k, v), dout = bsets[0]
    cs._cap_bwd_check("training shape", q, k, v, dout, True, 0, c)
    ms = [cs._time_bwd_ms(lambda q, k, v, cc=cc: ops.flash_attention(
        q, k, v, softcap=cc), bsets) for cc in (c, 0.0)]
    mask = create_block_mask(lambda b, h, q, kv: kv <= q, None, None, S, S,
                             device=dev)
    tsets = [([t.transpose(1, 2).contiguous() for t in st],
              d.transpose(1, 2).contiguous()) for st, d in bsets]

    def fwd(a, b, d):
        return flex(a, b, d, score_mod=cap, block_mask=mask, enable_gqa=True)

    try:
        leaves = [t.clone().requires_grad_(True) for t in tsets[0][0]]
        got = torch.autograd.grad(fwd(*leaves), leaves, tsets[0][1])
        want = cs._cap_grads(q, k, v, dout, True, 0, c, torch.float32)[1]
        for g, w in zip(got, want):
            _flex_close(cs, "flex bwd", g.transpose(1, 2), w)
        flex_b = f"{cs._time_bwd_ms(fwd, tsets):.4f}"
    except Exception as e:           # reported in the row, not raised
        flex_b = _flex_none(e)
    rows.append((f"flash bwd ({B}, {S}) causal", *ms, flex_b))
    return rows


def main(argv):
    softcap = "--softcap" in argv
    argv = [a for a in argv if a != "--softcap"]
    if len(argv) >= 2 and argv[0] == "--one":
        run_tree(Path(argv[1]).resolve(), argv[2] if len(argv) > 2 else "",
                 softcap)
        return
    trees = [Path(t).resolve() for t in argv] or [REPO]
    for i, tree in enumerate(trees):
        subprocess.run([sys.executable, __file__, "--one", str(tree),
                        f"{i}:{tree.name}"] +
                       (["--softcap"] if softcap else []), check=True,
                       timeout=900)


if __name__ == "__main__":
    main(sys.argv[1:])
