"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

It drives the port's two serving paths, the paged engine on the Hopper
paged attention kernels and the dense fused engine (the serve driver's
default) on the flash attention and split-K decode kernels, the dense
engine on the Mamba-1 family on the selective-scan kernel, and the
paper's MARGOT pipeline (batch and stream) on the pair-score kernel, and
holds every kernel against its plain PyTorch version.  One line per
phase:

1. device: the card's name and power limit (``nvidia-smi``), then the
   build of ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``, one
   process per source, all started together (timed), and ptxas's
   registers and spills for the two wgmma attention kernels and the
   split-key decode kernel of both decode sources (a spill fails the
   run);
2. kernels against their plain versions (``repro_torch.kernels.ref``) at
   the main paths' shapes in bf16 (H=16, KV=8, hd=128; paged: bs=16,
   ragged lengths up to 2048, an extend of S=256 at pos0 > 0; dense: a
   causal flash prefill of B=3, S=512, a decode of B=8 over L=2048 at
   ragged lengths), plus a small grid over every head_dim and dtype the
   kernels are built for (and flash's three mask modes, and a decode row
   of length 0), and the wgmma kernels' tile edges (flash at S 63, 64,
   65, 129, 200 and G 1, 4, 8; the extend at bs 8 and 16 with pages
   straddled and a row past the table; a long-prefix extend of 2,048
   keys; an extend whose unseen pool rows hold NaN), and the split-key
   decode's edges in fp32 and bf16 (lengths around one and two
   128-key chunks, pages of 8, 16, 32, 12 and 128 rows, G 1 to 16, a length past
   the table and table entries past the pool, rows of length 0, caches
   whose rows past every live key hold NaN), each
   held against the plain version's fp32 result on the
   same inputs, with a control (P rounded to bf16) that the bf16 limit
   must reject; flash also at (1, 2048), above the bf16 ridge; both
   decodes also at the serves' shape (B=8, lengths 301-329) and at a tiny
   one (B=1, length 8), with the host's issue time; the pair
   score at the batch shape (256, 512, 1024) and the stream's (1024,
   1024, 1024) on MARGOT features and on random
   inputs, and on a small grid in fp32 and bf16, each held against the
   plain version in fp64, with a TF32 control that the limit must
   reject; the selective scan at the Mamba serve's admit shapes (4, 512,
   8192, 16), (1, 1000, 8192, 16), (1, 100, 8192, 16) and on a small grid
   (N 8 and 16, S 1 and ragged, an odd D N and a misaligned view), each
   held against the plain version at atol = rtol = 1e-4, with a control
   (the carry zeroed at every 64-step chunk) that the limit must reject;
   kernel, plain and library times and the bound;
3. token-exact: the two-layer fp32 reduced config served on the card by
   the paged and the dense engine, each through the kernels and forced
   through the plain versions; all four runs give the same tokens; then
   the two-layer fp32 reduced falcon-mamba-7b through the dense engine,
   through the kernel and forced through the plain version, with prompts
   of 130 and 100 tokens among them: both give the same tokens;
4. full-width serves: internlm2-1.8b (24 layers, bf16, seeded random
   weights), 8 slots, max_len 2048, K=8, 8 requests of 16-512 tokens, two
   sharing a 256-token prefix, max_new 32, first paged (block_size 16),
   then dense; each path's kernel launch counts, read right after its own
   run, must be > 0 with no plain calls; then one profiled decode sync of
   each.  Then, with those engines freed, falcon-mamba-7b (64 layers,
   d_model 4096, d_inner 8192, bf16, seeded random weights), 8 slots,
   max_len 2048, K=8, 8 requests (4 x 512, 1000, 2 x 256, 100 tokens,
   same lengths adjacent), max_new 32: ``ssm_scan`` launches must be 64 a
   prefill batch (256) with no plain calls; then one profiled decode sync
   and one profiled admit;
5. MARGOT at full size (d=1024, the paper's dataset sizes): DS1 through
   the kernel and through the plain version (equal link sets), the DS2
   batch through ``repro_torch.launch.argmining`` (its launch counts read
   right after it), DS1 with M3's 30,363 support vectors, the stream's
   rate ramp in both scopes, and one profiled batch partition;
6. the ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  With
``--kernels-only`` it runs phases 1 and 2 alone (the build and every
kernel check and time) and prints no result lines.  Without a card, or
outside a checkout of the repository, it exits non-zero and prints no
result.  The whole ``nvcc`` output goes to ``chiprun_out/``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16/fp32 ops/s
HBM_BPS = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# Tolerances.  Each kernel is held against its plain version run in fp32
# on the same inputs.  fp32: atol = rtol = 2e-5 (tests/test_kernels.py:16).
# bf16: the kernels keep scores and P in fp32, as the TPU kernels do, so
# the only loss is the final rounding to bf16 plus fp32 noise from another
# order of summation.  Hence every element lies within one bf16 unit in the
# last place (plus 1e-4 absolute) of the fp32 result, and at most 1% of
# the elements differ from that result rounded to bf16.  The control,
# the plain version with P rounded to bf16 before P.V as the model's
# plain mha does, must fail the 1% limit, or the check could not see that
# rounding.  Phase 2 prints both readings beside the limit: the share of
# the kernel's elements off the rounded fp32 result, and the control's.
FP32_TOL = 2e-5
BF16_ATOL = 1e-4
BF16_MISMATCH = 0.01
# the library call rounds P to bf16 itself; this looser check only shows
# that it computes the same function, so that its time is a fair yardstick
LIBRARY_TOL = 3e-2
# The pair score is held against its plain version run in fp64 on the same
# inputs: max |kernel - fp64| <= PAIR_REL * max |fp64|.  The kernel sums d
# fp32 products per output (about 2e-7 of the largest score, measured on
# an emulation of the kernel on the CPU); TF32 keeps 10 mantissa bits, so
# its products are off by up to 2^-11 and its scores by ~1e-4 of the
# largest, which the control (the plain version in fp32 with TF32 on)
# shows by failing the limit at the batch and stream shapes.
PAIR_REL = 1e-5
# The selective scan is held against its plain version (fp32, one step at
# a time) at the repo's scan tolerance, atol = rtol = 1e-4
# (tests/test_kernels.py:199-200).  The kernel runs the same recurrence
# with one FMA a step, so only rounding separates them.  The control, the
# plain version with the carry zeroed at every 64-step chunk (what a
# chunked kernel that lost its carry would give), must fail the limit, or
# the check could not see the carry across chunks.
SCAN_TOL = 1e-4
SCAN_CHUNK = 64


def fail(msg: str):
    print(f"[smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def main():
    kernels_only = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] and not kernels_only:
        fail(f"usage: python3 chip_smoke.py [--kernels-only]; got "
             f"{sys.argv[1:]}")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        fail("src/repro_torch not found beside chip_smoke.py: run it from "
             "the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA "
             "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    stats = phase_kernels()
    if kernels_only:
        print("[smoke] --kernels-only: phases 1-2 passed; phases 3-6 and "
              "the result lines skipped")
        return
    phase_token_exact()
    launches = phase_serve()
    launches.update(phase_margot())
    phase_list(stats, launches, smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ----------------------------------------------------------------------
def phase_device() -> str:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pair_score as ps
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssm_scan as ss
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    for module in (pa, fa, da, ps, ss):
        module._library()
    build_s = time.perf_counter() - t0
    usage = [ln.strip() for log in build.BUILD_LOG.values()
             for ln in log.splitlines() if "registers" in ln]
    line = (f"[build] {len(build.SOURCES)} source(s) in {build_s:.2f}s; "
            f"ptxas: {len(usage)} kernels, e.g. "
            f"{usage[-1] if usage else '-'}")
    print(line)
    for source, module in (("flash_attention.cu", fa),
                           ("paged_attention.cu", pa)):
        smem = module._library().repro_attention_sm90_smem(128)
        print(f"[build] {source} "
              f"{_sm90_usage(build.BUILD_LOG, source, smem)}")
    for source in ("paged_attention.cu", "decode_attention.cu"):
        print(f"[build] {source} {_decode_usage(build.BUILD_LOG, source)}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text("\n".join(
        [smi, line] + [f"== {s}\n{log}" for s, log in
                       build.BUILD_LOG.items()]))
    return smi


# ----------------------------------------------------------------------
def _ptxas_reports(logs, source, kernel):
    """ptxas's report (stack, spills, registers, shared memory) of every
    instantiation of ``kernel`` in ``source``'s build, by its mangled
    template arguments; a spill, or no report for ``source``, fails the
    run.  ``logs`` is ``build.BUILD_LOG``, which holds the report kept
    beside a library built by an earlier process too."""
    check(source in logs, f"{source}: no nvcc report for its library")
    lines = logs[source].splitlines()
    found = {}
    for i, ln in enumerate(lines):
        args = re.search(kernel + r"I(\w+?)EEv", ln)
        if "Compiling entry function" in ln and args:
            info = " ".join(x.split("info    :")[-1].strip()
                            for x in lines[i + 2:i + 4])
            check("0 bytes spill stores, 0 bytes spill loads" in info,
                  f"{source}: {kernel}<{args[1]}> spills: {info}")
            found[args[1]] = info
    return found


def _sm90_usage(logs, source, smem) -> str:
    """The wgmma kernel of ``source`` at every head dim (each must have a
    report), shown for hd = 128 beside ``smem``, the dynamic shared
    memory it asks for at launch (``Tile<128>::SMEM`` in
    csrc/attention_sm90.cuh)."""
    found = {int(re.match(r"Li(\d+)E", k)[1]): v for k, v in
             _ptxas_reports(logs, source, "attention_sm90_kernel").items()}
    check(sorted(found) == [16, 32, 64, 128],
          f"{source}: ptxas reported attention_sm90_kernel at head dims "
          f"{sorted(found)}, not 16, 32, 64, 128")
    return (f"attention_sm90_kernel<128>: {found[128]}; dynamic shared "
            f"memory {smem} bytes; no spills at hd 16, 32, 64, 128")


def _decode_usage(logs, source) -> str:
    """The split-key decode kernel of ``source`` at every instantiation
    (fp32 and bf16, hd 16-128, 1-8 rows a CTA; each must have a report),
    shown at 2 rows a CTA (the main path's G) for each head dim."""
    found = {}
    for k, info in _ptxas_reports(logs, source, "decode_sm90_kernel").items():
        m = re.match(r"(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", k)
        smem = re.search(r"(\d+) bytes smem", info)
        found[(m[1], int(m[2]), int(m[3]))] = (
            int(re.search(r"Used (\d+) registers", info)[1]),
            int(smem[1]) if smem else 0)
    want = {(t, hd, gr) for t in ("f", "13__nv_bfloat16")
            for hd in (16, 32, 64, 128) for gr in (1, 2, 4, 8)}
    check(set(found) == want, f"{source}: ptxas reported decode_sm90_kernel "
          f"for {sorted(found)}, not every dtype x head dim x rows")
    show = "; ".join(
        f"{dn} " + ", ".join(f"hd {hd} {found[(t, hd, 2)][0]} registers "
                             f"{found[(t, hd, 2)][1]} B" for hd in
                             (16, 32, 64, 128))
        for t, dn in (("13__nv_bfloat16", "bf16"), ("f", "fp32")))
    most = max(r for r, _ in found.values())
    return (f"decode_sm90_kernel at 2 rows a CTA: {show} (static shared "
            f"memory); up to {most} registers at 8 rows; no spills in "
            f"{len(found)} instantiations")


def _time_ms(fns, iters: int = 20) -> float:
    """Device ms per call: ``iters`` calls cycling through ``fns`` (each on
    its own copy of the inputs, so the 50 MB L2 holds no earlier call's
    K/V, as on the main path where 24 layers take turns) are captured in
    one CUDA graph, and a replay of the graph is timed with CUDA events,
    so the host's time to issue each call is left out.  The warm-up calls
    run on the capturing stream, as PyTorch's graph warm-up does, so what
    a kernel keeps per stream (the decode's ticket counters) exists before
    the capture."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for f in fns:
            f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def _issue_ms(fn, iters: int = 20, batches: int = 5) -> float:
    """Host ms per call of ``fn`` issued back to back from Python and
    timed with CUDA events, the median of ``batches`` batches of ``iters``
    calls (the host's time moves between batches): where the device is
    faster than the host, this is the host's cost to issue one call."""
    import statistics

    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(batches):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _paged_inputs(gen, B, nb, bs, KV, hd, q_shape, dtype, dev):
    import torch
    n_blocks = B * nb + 1
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev,  # noqa
                                 dtype=torch.float32).to(dtype)
    q = rnd(*q_shape)
    kp, vp = rnd(n_blocks, bs, KV, hd), rnd(n_blocks, bs, KV, hd)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(B, nb).to(torch.int32).contiguous()
    return q, kp, vp, bt


def _sdpa_args(q, kp, vp, bt, keep):
    """SDPA inputs on the K/V gathered through the table (the gather is
    not timed): q (B,H,Sq,hd), k/v (B,KV,L,hd), bool mask (B,1,Sq,L)."""
    B, nb = bt.shape
    bs, KV, hd = kp.shape[1:]
    k = kp[bt.long()].reshape(B, nb * bs, KV, hd).transpose(1, 2)
    v = vp[bt.long()].reshape(B, nb * bs, KV, hd).transpose(1, 2)
    return q, k.contiguous(), v.contiguous(), keep


def _bf16_ulp(x):
    """bf16's unit in the last place at each value of ``x``."""
    import torch
    _, e = torch.frexp(x.abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x), e - 8)


def _compare(name, out, want):
    """``out`` against ``want``, the plain version's fp32 result on the
    same inputs, at the tolerances above; returns (max_abs_err, share of
    bf16 elements that differ from ``want`` rounded to bf16)."""
    import torch
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite")
    err = (out.float() - want).abs()
    max_err = err.max().item()
    if out.dtype == torch.float32:
        check(torch.allclose(out, want, atol=FP32_TOL, rtol=FP32_TOL),
              f"{name}: max_abs_err {max_err:.3e} beyond atol=rtol="
              f"{FP32_TOL}")
        return max_err, 0.0
    share = (out != want.to(out.dtype)).float().mean().item()
    ulp_ok = bool((err <= _bf16_ulp(want) + BF16_ATOL).all())
    check(ulp_ok and share <= BF16_MISMATCH,
          f"{name}: max_abs_err {max_err:.3e}, {share:.4%} of elements off "
          f"the rounded fp32 result (limit {BF16_MISMATCH:.0%}), all within "
          f"one bf16 ulp + {BF16_ATOL}: {ulp_ok}")
    return max_err, share


def _rounded_p(q, k, v, keep):
    """The control: plain attention of q (B,S,H,hd) over k/v (B,L,KV,hd)
    where keep (B,S,L) allows, with P rounded to bf16 before P.V, as the
    model's plain mha does."""
    import torch
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd).float()
    sc = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    sc = sc.masked_fill(~keep[:, None, None], -2e38)
    p = torch.softmax(sc, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.float()).reshape(
        B, S, H, hd)


def _plain_rounded_p(q, kp, vp, bt, pos0):
    """The control of the paged extend (q (B,S,H,hd), queries at
    pos0 + s), on the K/V gathered through the table."""
    import torch
    B, S, H, hd = q.shape
    nb = bt.shape[1]
    bs, KV = kp.shape[1:3]
    k = kp[bt.long()].reshape(B, nb * bs, KV, hd)
    v = vp[bt.long()].reshape(B, nb * bs, KV, hd)
    qpos = pos0[:, None].long() + torch.arange(S, device=q.device)[None]
    keep = (torch.arange(nb * bs, device=q.device)[None, None, :] <=
            qpos[:, :, None])
    return _rounded_p(q, k, v, keep)


def _check_control(name, ctl, want):
    """The control ``ctl`` must differ from the rounded fp32 result in
    more than BF16_MISMATCH of its elements."""
    import torch
    ctl = ctl.reshape(want.shape)
    share = (ctl.to(torch.bfloat16) != want.to(torch.bfloat16)
             ).float().mean().item()
    check(share > BF16_MISMATCH,
          f"{name}: the bf16-P control differs in only {share:.4%} of "
          f"elements; the limit {BF16_MISMATCH:.0%} cannot see P rounding")
    return share


def _library_close(name, lib_out, want):
    import torch
    check(torch.allclose(lib_out.float(), want, atol=LIBRARY_TOL,
                         rtol=LIBRARY_TOL), f"{name}: the library call "
          f"computes another function (atol=rtol={LIBRARY_TOL})")


def _f32(*ts):
    return [t.float() for t in ts]


def phase_kernels():
    """Each kernel against its plain version, on the card."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # every head_dim x dtype the kernels are built for, small shapes
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for hd in (16, 32, 64, 128):
            B, H, KV, bs, nb, S = 3, 8, 2, 8, 6, 7
            q, kp, vp, bt = _paged_inputs(gen, B, nb, bs, KV, hd,
                                          (B, H, hd), dtype, dev)
            lengths = torch.tensor([1, 17, nb * bs], dtype=torch.int32,
                                   device=dev)
            _compare(f"decode hd={hd} {dname}",
                     ops.paged_decode_attention(q, kp, vp, bt, lengths),
                     ref.paged_decode_attention_ref(*_f32(q, kp, vp), bt,
                                                    lengths))
            qs = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
            pos0 = torch.tensor([0, 9, nb * bs - 3], dtype=torch.int32,
                                device=dev)     # row 2 runs past the table
            _compare(f"extend hd={hd} {dname}",
                     ops.paged_extend_attention(qs, kp, vp, bt, pos0),
                     ref.paged_extend_attention_ref(*_f32(qs, kp, vp), bt,
                                                    pos0))
            n += 2
            n += _dense_grid(gen, dtype, dname, hd, dev)
    torch.cuda.synchronize()
    print(f"[kernels] grid: {n} checks over hd 16/32/64/128 x fp32 "
          f"(atol=rtol={FP32_TOL}) and bf16 (within one ulp + {BF16_ATOL}, "
          f"<= {BF16_MISMATCH:.0%} of elements off the rounded fp32 plain "
          f"result) passed: paged decode and extend; flash at S 37 and 192 "
          f"x causal / window 64 / bidirectional; split-K decode at "
          f"lengths 0, 1, 37, L")
    _attention_edges(gen, dev)
    _decode_edges(gen, dev)

    # main-path shapes, bf16; 3 copies of the inputs for cold-L2 timing
    B, H, KV, hd, bs, max_len = 8, 16, 8, 128, 16, 2048
    nb, esz = max_len // bs, 2
    stats, shares = {}, {}
    lengths = torch.tensor([2048, 1, 1537, 300, 16, 977, 2000, 64],
                           dtype=torch.int32, device=dev)
    sets = [_paged_inputs(gen, B, nb, bs, KV, hd, (B, H, hd),
                          torch.bfloat16, dev) for _ in range(3)]
    q, kp, vp, bt = sets[0]
    out = ops.paged_decode_attention(q, kp, vp, bt, lengths)
    want = ref.paged_decode_attention_ref(*_f32(q, kp, vp), bt, lengths)
    err, share = _compare("decode main-path", out, want)
    shares["paged_decode_attention"] = (share, _check_control(
        "decode main-path", _plain_rounded_p(q[:, None], kp, vp, bt,
                                             lengths - 1), want))
    keep = (torch.arange(max_len, device=dev)[None, :] <
            lengths[:, None].long())[:, None, None, :]
    sd = [_sdpa_args(s[0][:, :, None], s[1], s[2], s[3], keep) for s in sets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True)[:, :, 0]
    _library_close("decode", lib_out, want)
    n_tok = int(lengths.sum())
    by = (2 * n_tok * KV * hd * esz                 # K and V rows needed
          + 2 * B * H * hd * esz                    # q in, out
          + 4 * sum(-(-int(x) // bs) for x in lengths) + 4 * B)  # bt, len
    ops_n = 4 * H * hd * n_tok                      # QK^T and PV
    issue = {"paged_decode_attention": _issue_ms(
        lambda: ops.paged_decode_attention(q, kp, vp, bt, lengths))}
    stats["paged_decode_attention"] = _stats(
        err, by, ops_n, "bfloat16",
        _time_ms([lambda s=s: ops.paged_decode_attention(
            s[0], s[1], s[2], s[3], lengths) for s in sets]),
        _time_ms([lambda s=s: ref.paged_decode_attention_ref(
            s[0], s[1], s[2], s[3], lengths) for s in sets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))

    Be, S = 4, 256
    pos0 = torch.tensor([16, 256, 768, 1792], dtype=torch.int32, device=dev)
    esets = [_paged_inputs(gen, Be, nb, bs, KV, hd, (Be, S, H, hd),
                           torch.bfloat16, dev) for _ in range(3)]
    q, kp, vp, bt = esets[0]
    out = ops.paged_extend_attention(q, kp, vp, bt, pos0)
    want = ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt, pos0)
    err, share = _compare("extend main-path", out, want)
    shares["paged_extend_attention"] = (share, _check_control(
        "extend main-path", _plain_rounded_p(q, kp, vp, bt, pos0), want))
    qpos = pos0[:, None].long() + torch.arange(S, device=dev)[None, :]
    keep = (torch.arange(max_len, device=dev)[None, None, :] <=
            qpos[:, :, None])[:, None]
    sd = [_sdpa_args(s[0].transpose(1, 2).contiguous(), s[1], s[2], s[3],
                     keep) for s in esets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True).transpose(1, 2)
    _library_close("extend", lib_out, want)
    n_keys = [int(p) + S for p in pos0]             # keys each row needs
    by = (2 * sum(n_keys) * KV * hd * esz + 2 * Be * S * H * hd * esz
          + 4 * sum(-(-k // bs) for k in n_keys) + 4 * Be)
    ops_n = 4 * H * hd * sum(S * int(p) + S * (S + 1) // 2 for p in pos0)
    issue["paged_extend_attention"] = _issue_ms(
        lambda: ops.paged_extend_attention(q, kp, vp, bt, pos0))
    stats["paged_extend_attention"] = _stats(
        err, by, ops_n, "bfloat16",
        _time_ms([lambda s=s: ops.paged_extend_attention(
            s[0], s[1], s[2], s[3], pos0) for s in esets]),
        _time_ms([lambda s=s: ref.paged_extend_attention_ref(
            s[0], s[1], s[2], s[3], pos0) for s in esets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))
    _dense_main_path(gen, dev, stats, shares, issue)
    for label, lengths, max_len in DECODE_SHAPES[1:]:
        for name, st in _decode_bench(gen, dev, lengths, max_len).items():
            print(f"[kernels] {name} at {label}: "
                  f"{_decode_row(st, lengths, max_len)}")
    _pair_score_checks(gen, dev, stats, issue)
    _ssm_scan_checks(gen, dev, stats, issue)
    print(f"[kernels] bf16 tolerance: within one bf16 ulp + {BF16_ATOL} of "
          f"the plain version's fp32 result on the same inputs, and at most "
          f"{BF16_MISMATCH:.0%} of elements off that result rounded to bf16 "
          f"(the kernels keep P in fp32, so only fp32 summation order and "
          f"the output rounding separate them); control: the plain version "
          f"with P rounded to bf16 must exceed the {BF16_MISMATCH:.0%}")
    for name, st in stats.items():
        if name not in shares:
            continue
        print(f"[kernels] {name}: max_abs_err={st['max_abs_err']:.3e} "
              f"off_rounded={shares[name][0]:.4%} "
              f"(control with bf16 P: {shares[name][1]:.4%}) "
              f"ms={st['ms']:.4f} "
              f"plain_ms={st['plain_ms']:.4f} "
              f"library_ms={st['library_ms']:.4f} "
              f"bound_ms={st['bound_ms']:.4f} ({st['bound_by']}); "
              f"device ms from a CUDA graph replay; issued one by one "
              f"from Python: {issue[name]:.4f} ms per call")
    return stats


def _randn(gen, shape, dtype, dev):
    import torch
    return torch.randn(*shape, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)


def _dense_grid(gen, dtype, dname, hd, dev):
    """Flash attention and split-K decode at small shapes for one head
    dim and dtype; returns the number of checks."""
    import torch
    from repro_torch.kernels import ops, ref
    n = 0
    B, H, KV = 2, 8, 2
    for S in (37, 192):
        q = _randn(gen, (B, S, H, hd), dtype, dev)
        k, v = (_randn(gen, (B, S, KV, hd), dtype, dev) for _ in range(2))
        for causal, window in ((True, 0), (True, 64), (False, 0)):
            _compare(f"flash hd={hd} {dname} S={S} causal={causal} "
                     f"window={window}",
                     ops.flash_attention(q, k, v, causal=causal,
                                         window=window),
                     ref.flash_attention_ref(*_f32(q, k, v), causal=causal,
                                             window=window))
            n += 1
    L = 96
    # length 0 sees no key: the mean of V, as the TPU kernel gives
    lengths = torch.tensor([0, 1, 37, L], dtype=torch.int32, device=dev)
    for H_, KV_ in ((8, 2), (8, 1)):
        q = _randn(gen, (4, H_, hd), dtype, dev)
        k, v = (_randn(gen, (4, L, KV_, hd), dtype, dev) for _ in range(2))
        _compare(f"split-K decode hd={hd} {dname} G={H_ // KV_}",
                 ops.decode_attention(q, k, v, lengths),
                 ref.decode_attention_ref(*_f32(q, k, v), lengths))
        n += 1
    return n


# The edge shapes of the wgmma design's 64-row, 64-key tiles, as
# tests/test_torch_attention_sm90.py holds the plain versions against the
# JAX oracles and the Pallas kernels at them: flash at S one short of, at
# and one past a tile, two tiles and one past, and 200; G 1, 4 and 8; the
# extend at bs 8 and 16 with pos0 mid-page (the suffix and the last
# visible key straddle pages) and a row past the table's end.
FLASH_EDGE_S = (63, 64, 65, 129, 200)
FLASH_EDGE_G = ((8, 8), (16, 4), (16, 2))
EXTEND_EDGES = ((8, 12, 37, (5, 21, 60)), (16, 6, 37, (13, 50, 70)),
                (8, 6, 20, (3, 40, 45)), (16, 4, 20, (0, 31, 60)))


def _attention_edges(gen, dev):
    """The bf16 flash and extend kernels at the edge shapes above (hd 32
    and 128), a long-prefix extend (one admit of 256 tokens after 1,792
    cached), then an extend whose pool rows that no row may see hold
    NaN, held against the plain version on the same pool with those rows
    zeroed (bs 16, 8, and 12, which the producer warp copies without
    TMA); each against the plain version's fp32 result at the bf16
    limits."""
    import torch
    from repro_torch.kernels import ops, ref
    bf, n = torch.bfloat16, 0
    for hd in (32, 128):
        for S in FLASH_EDGE_S:
            q = _randn(gen, (2, S, 8, hd), bf, dev)
            k, v = (_randn(gen, (2, S, 2, hd), bf, dev) for _ in range(2))
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                _compare(f"flash edge hd={hd} S={S} causal={causal} "
                         f"window={window}",
                         ops.flash_attention(q, k, v, causal=causal,
                                             window=window),
                         ref.flash_attention_ref(*_f32(q, k, v),
                                                 causal=causal,
                                                 window=window))
                n += 1
        for H, KV in FLASH_EDGE_G:
            q = _randn(gen, (2, 129, H, hd), bf, dev)
            k, v = (_randn(gen, (2, 129, KV, hd), bf, dev) for _ in range(2))
            _compare(f"flash edge hd={hd} G={H // KV}",
                     ops.flash_attention(q, k, v, causal=True),
                     ref.flash_attention_ref(*_f32(q, k, v), causal=True))
            n += 1
        for bs, nb, S, p0 in EXTEND_EDGES:
            for H, KV in ((8, 2), (8, 8)):
                q, kp, vp, bt = _paged_inputs(gen, len(p0), nb, bs, KV, hd,
                                              (len(p0), S, H, hd), bf, dev)
                pos0 = torch.tensor(p0, dtype=torch.int32, device=dev)
                _compare(f"extend edge hd={hd} bs={bs} pos0={p0} G="
                         f"{H // KV}",
                         ops.paged_extend_attention(q, kp, vp, bt, pos0),
                         ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt,
                                                        pos0))
                n += 1
    # one long-prefix admit: 64 CTAs, each walking 1,824-2,048 keys
    q, kp, vp, bt = _paged_inputs(gen, 1, 128, 16, 8, 128, (1, 256, 16, 128),
                                  bf, dev)
    pos0 = torch.tensor([1792], dtype=torch.int32, device=dev)
    _compare("extend long prefix",
             ops.paged_extend_attention(q, kp, vp, bt, pos0),
             ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt, pos0))
    n += 1
    for bs in (16, 8, 12):
        B, nb, S, H, KV, hd = 4, 96 // bs, 37, 16, 8, 128
        q, kp, vp, bt = _paged_inputs(gen, B, nb, bs, KV, hd, (B, S, H, hd),
                                      bf, dev)
        pos0 = torch.tensor([5, 21, 44, 70], dtype=torch.int32, device=dev)
        last = (pos0.long() + S - 1).clamp(max=nb * bs - 1)   # per sequence
        seen = torch.zeros(kp.shape[:2], dtype=torch.bool, device=dev)
        key = torch.arange(nb * bs, device=dev)
        for b in range(B):
            rows = key[key <= last[b]]
            seen[bt[b].long()[rows // bs], rows % bs] = True
        nan_k, nan_v = kp.clone(), vp.clone()
        nan_k[~seen], nan_v[~seen] = float("nan"), float("nan")
        kp[~seen], vp[~seen] = 0, 0
        out = ops.paged_extend_attention(q, nan_k, nan_v, bt, pos0)
        _compare(f"extend NaN pool bs={bs}", out,
                 ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt, pos0))
        n += 1
    torch.cuda.synchronize()
    print(f"[kernels] attention edges: {n} checks passed: flash at S "
          f"{FLASH_EDGE_S} x causal / window 64 / bidirectional and G 1, 4, "
          f"8 at S 129; extend at (bs, nb, S, pos0) {EXTEND_EDGES} x G 4, "
          f"1; hd 32 and 128; a long-prefix extend (1, 256) at pos0 1792; "
          f"an extend whose unseen pool rows hold NaN (bs 16, "
          f"8, 12) equal to the plain version with them zeroed")


# The edge shapes of the split-key decode (chunks of decode_plan.CHUNK_KEYS
# keys a CTA), as tests/test_torch_decode_sm90.py holds the plain versions
# at them: lengths one short of, at and one past a chunk, one past two
# chunks, the longest row and a short row whose later chunks exit at once;
# pages (bs, nb) of 8, 16 and 32 rows, of 12 (straddling chunk ends) and
# of 128 (spanning two chunks); G 1, 4, 8 and 16 (two row groups).
DECODE_EDGE_PAGES = ((8, 40), (16, 20), (32, 10), (12, 27), (128, 3))
DECODE_EDGE_G = ((2, 2), (8, 2), (16, 2), (32, 2))


def _edge_lengths(max_keys):
    from repro_torch.kernels import decode_plan
    c = decode_plan.CHUNK_KEYS
    return [c - 1, c, c + 1, 2 * c + 1, max_keys, 3]


def _paged_decode_case(gen, dev, name, bs, nb, H, KV, hd, dtype, lengths,
                       table=None, nan=False):
    """The paged decode kernel against the plain version's fp32 result on
    the same inputs.  ``table`` edits the block table (the plain version
    reads it clamped into the pool, as the kernel does); ``nan`` fills the
    pool rows no live key reads with NaN (the plain version reads them
    zeroed).  A row of length 0 must give 0; returns the number of
    checks."""
    import torch
    from repro_torch.kernels import ops, ref
    B = len(lengths)
    q, kp, vp, bt = _paged_inputs(gen, B, nb, bs, KV, hd, (B, H, hd), dtype,
                                  dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if table is not None:
        table(bt, kp.shape[0])
    read_bt = bt.clamp(0, kp.shape[0] - 1)
    k_in, v_in = kp, vp
    if nan:
        seen = torch.zeros(kp.shape[:2], dtype=torch.bool, device=dev)
        for b, n_live in enumerate(lengths):
            t = torch.arange(min(n_live, nb * bs), device=dev)
            seen[read_bt[b].long()[t // bs], t % bs] = True
        k_in, v_in = kp.clone(), vp.clone()
        k_in[~seen], v_in[~seen] = float("nan"), float("nan")
        kp[~seen], vp[~seen] = 0, 0
    out = ops.paged_decode_attention(q, k_in, v_in, bt, ln)
    want = ref.paged_decode_attention_ref(*_f32(q, kp, vp), read_bt, ln)
    zero = [b for b, n_live in enumerate(lengths) if n_live == 0]
    check(all(bool((out[b] == 0).all()) for b in zero),
          f"{name}: a row of length 0 must give 0")
    live = [b for b in range(B) if b not in zero]
    _compare(name, out[live], want[live])
    return 1


def _dense_decode_case(gen, dev, name, L, H, KV, hd, dtype, lengths,
                       nan=False):
    """The split-K decode kernel against the plain version's fp32 result
    on the same inputs (a row of length 0 gives the mean of V in both);
    ``nan`` fills the cache rows past each row's live keys with NaN (the
    plain version reads them zeroed)."""
    import torch
    from repro_torch.kernels import ops, ref
    B = len(lengths)
    q = _randn(gen, (B, H, hd), dtype, dev)
    k, v = (_randn(gen, (B, L, KV, hd), dtype, dev) for _ in range(2))
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    k_in, v_in = k, v
    if nan:
        past = torch.arange(L, device=dev)[None, :] >= ln[:, None].long()
        k_in, v_in = k.clone(), v.clone()
        k_in[past], v_in[past] = float("nan"), float("nan")
        k[past], v[past] = 0, 0
    _compare(name, ops.decode_attention(q, k_in, v_in, ln),
             ref.decode_attention_ref(*_f32(q, k, v), ln))
    return 1


def _decode_edges(gen, dev):
    """Both decode kernels at the edge shapes above, fp32 and bf16, hd 32
    and 128; then at hd 128: a paged length past nb * bs with table
    entries past the pool, rows of length 0 (paged: 0; dense: the mean of
    V), and caches whose rows past every live key hold NaN."""
    import torch

    def past_the_pool(bt, n):
        bt[0, 1], bt[2, 0], bt[3, -1] = n, n + 5, 2 ** 30

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for hd in (32, 128):
            for bs, nb in DECODE_EDGE_PAGES:
                n += _paged_decode_case(
                    gen, dev, f"paged decode edge {dn} hd={hd} bs={bs}", bs,
                    nb, 4, 2, hd, dtype, _edge_lengths(nb * bs))
            for H, KV in DECODE_EDGE_G:
                n += _paged_decode_case(
                    gen, dev, f"paged decode edge {dn} hd={hd} G={H // KV}",
                    16, 20, H, KV, hd, dtype, _edge_lengths(320))
                n += _dense_decode_case(
                    gen, dev, f"split-K decode edge {dn} hd={hd} "
                    f"G={H // KV}", 320, H, KV, hd, dtype, _edge_lengths(320))
        n += _paged_decode_case(
            gen, dev, f"paged decode clamped {dn}", 16, 9, 16, 8, 128, dtype,
            [100, 144, 145, 1000], table=past_the_pool)
        n += _paged_decode_case(gen, dev, f"paged decode length 0 {dn}", 16,
                                16, 16, 8, 128, dtype, [0, 200, 5, 0])
        n += _dense_decode_case(gen, dev, f"split-K decode length 0 {dn}",
                                256, 16, 8, 128, dtype, [0, 200, 5, 0])
        nan_lengths = [1, 127, 129, 257, 383]
        for bs in (16, 12):
            n += _paged_decode_case(
                gen, dev, f"paged decode NaN pool {dn} bs={bs}", bs,
                384 // bs, 16, 8, 128, dtype, nan_lengths, nan=True)
        n += _dense_decode_case(gen, dev, f"split-K decode NaN cache {dn}",
                                384, 16, 8, 128, dtype, nan_lengths, nan=True)
    torch.cuda.synchronize()
    print(f"[kernels] decode edges: {n} checks passed, fp32 and bf16: "
          f"lengths {_edge_lengths('max_keys')} over paged (bs, nb) "
          f"{DECODE_EDGE_PAGES} at G 2 and G 1, 4, 8, 16 (bs 16; dense "
          f"L 320), hd 32 and 128; a paged length past nb * bs with table "
          f"entries past the pool (read clamped); rows of length 0 (paged "
          f"0, dense the mean of V); caches whose rows past every live key "
          f"hold NaN (paged bs 16 and 12, dense) equal to the plain version "
          f"with them zeroed")


# (label, lengths, rows of a table or stripe): phase 2's ragged decode,
# the serves' decode syncs (8 slots at ~300-330-token contexts), and one
# short row, where the device time is a few microseconds and the host's
# issue time is the host's cost alone
DECODE_SHAPES = (
    ("phase 2's shape (B 8, lengths 2048 ... 64)",
     (2048, 1, 1537, 300, 16, 977, 2000, 64), 2048),
    ("the serves' shape (B 8, lengths 301-329)", tuple(range(301, 330, 4)),
     2048),
    ("a tiny shape (B 1, length 8)", (8,), 64))


def _decode_bench(gen, dev, lengths, max_len):
    """Both decode kernels in bf16 at the main path's widths (H 16, KV 8,
    hd 128; paged bs 16) for rows of ``lengths`` keys in tables or stripes
    of ``max_len`` rows: each held against its plain version at the bf16
    limits, then device ms (3 input copies), the plain version's and
    SDPA's ms, the bound and the host's issue ms.  Returns name -> stats.
    (scripts/attention_ab.py runs it on older checkouts too.)"""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    H, KV, hd, bs, bf = 16, 8, 128, 16, torch.bfloat16
    B, nb = len(lengths), max_len // bs
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    keep = (torch.arange(max_len, device=dev)[None, :] <
            ln[:, None].long())[:, None, None, :]
    n_tok = sum(lengths)
    kv_bytes = 2 * n_tok * KV * hd * 2 + 2 * B * H * hd * 2 + 4 * B
    ops_n = 4 * H * hd * n_tok
    psets = [_paged_inputs(gen, B, nb, bs, KV, hd, (B, H, hd), bf, dev)
             for _ in range(3)]
    dsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, H, hd), (B, max_len, KV, hd), (B, max_len, KV, hd))]
             for _ in range(3)]
    cases = {
        "paged_decode_attention": (
            psets, ops.paged_decode_attention, ref.paged_decode_attention_ref,
            [_sdpa_args(s[0][:, :, None], s[1], s[2], s[3], keep)
             for s in psets],
            kv_bytes + 4 * sum(-(-x // bs) for x in lengths)),
        "decode_attention": (
            dsets, ops.decode_attention, ref.decode_attention_ref,
            [(s[0][:, :, None], s[1].transpose(1, 2).contiguous(),
              s[2].transpose(1, 2).contiguous(), keep) for s in dsets],
            kv_bytes)}
    out = {}
    for name, (sets, kernel, plain, sd, nbytes) in cases.items():
        err, _ = _compare(f"{name} {lengths}", kernel(*sets[0], ln),
                          plain(*_f32(*sets[0][:3]), *sets[0][3:], ln))
        st = _stats(
            err, nbytes, ops_n, "bfloat16",
            _time_ms([lambda s=s: kernel(*s, ln) for s in sets]),
            _time_ms([lambda s=s: plain(*s, ln) for s in sets]),
            _time_ms([lambda a=a: F.scaled_dot_product_attention(
                *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))
        st["issue_ms"] = _issue_ms(lambda: kernel(*sets[0], ln))
        out[name] = st
    return out


def _decode_row(st, lengths, max_len) -> str:
    """A _decode_bench row, with the CTAs of the split plan that hold live
    keys among those launched (the main path's H 16, KV 8)."""
    from repro_torch.kernels import decode_plan
    c = decode_plan.CHUNK_KEYS
    n_chunks = decode_plan.split_plan(len(lengths), 16, 8, 128,
                                      max_len).n_chunks
    return (f"max_abs_err={st['max_abs_err']:.3e} ms={st['ms']:.4f} "
            f"plain_ms={st['plain_ms']:.4f} library_ms={st['library_ms']:.4f} "
            f"bound_ms={st['bound_ms']:.4f} ({st['bound_by']}) issue_ms="
            f"{st['issue_ms']:.4f} live_ctas="
            f"{8 * sum(-(-x // c) for x in lengths)} of "
            f"{8 * len(lengths) * n_chunks}")


def _dense_main_path(gen, dev, stats, shares, issue):
    """Flash attention and split-K decode at the dense path's shapes, bf16:
    a causal prefill of B=3, S=512 and a decode of B=8 over L=2048 at
    ragged lengths, each on 3 copies of its inputs for cold-L2 timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    H, KV, hd, esz, bf = 16, 8, 128, 2, torch.bfloat16

    B, S = 3, 512
    fsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
             for _ in range(3)]
    q, k, v = fsets[0]
    out = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(*_f32(q, k, v), causal=True)
    err, share = _compare("flash main-path", out, want)
    keep = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    shares["flash_attention"] = (share, _check_control(
        "flash main-path", _rounded_p(q, k, v, keep.expand(B, S, S)), want))
    sd = [[t.transpose(1, 2).contiguous() for t in st] for st in fsets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0], is_causal=True, enable_gqa=True).transpose(1, 2)
    _library_close("flash", lib_out, want)
    by = (2 * B * S * H * hd + 2 * B * S * KV * hd) * esz   # q, k, v, out
    ops_n = 4 * hd * H * B * S * (S + 1) // 2    # QK^T and PV, causal half
    issue["flash_attention"] = _issue_ms(
        lambda: ops.flash_attention(q, k, v, causal=True))
    stats["flash_attention"] = _stats(
        err, by, ops_n, "bfloat16",
        _time_ms([lambda s=s: ops.flash_attention(*s, causal=True)
                  for s in fsets]),
        _time_ms([lambda s=s: ref.flash_attention_ref(*s, causal=True)
                  for s in fsets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a, is_causal=True, enable_gqa=True) for a in sd]))
    _flash_long(gen, dev)

    B, L = 8, 2048
    lengths = torch.tensor([2048, 1, 1537, 300, 16, 977, 2000, 64],
                           dtype=torch.int32, device=dev)
    dsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, H, hd), (B, L, KV, hd), (B, L, KV, hd))]
             for _ in range(3)]
    q, k, v = dsets[0]
    out = ops.decode_attention(q, k, v, lengths)
    want = ref.decode_attention_ref(*_f32(q, k, v), lengths)
    err, share = _compare("split-K decode main-path", out, want)
    keep = (torch.arange(L, device=dev)[None, :] <
            lengths[:, None].long())[:, None]           # (B, 1, L)
    shares["decode_attention"] = (share, _check_control(
        "split-K decode main-path", _rounded_p(q[:, None], k, v, keep),
        want))
    sd = [(st[0][:, :, None], st[1].transpose(1, 2).contiguous(),
           st[2].transpose(1, 2).contiguous(), keep[:, None])
          for st in dsets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True)[:, :, 0]
    _library_close("split-K decode", lib_out, want)
    n_tok = int(lengths.sum())
    by = (2 * n_tok * KV * hd * esz                 # K and V rows needed
          + 2 * B * H * hd * esz + 4 * B)           # q in, out, lengths
    ops_n = 4 * H * hd * n_tok                      # QK^T and PV
    issue["decode_attention"] = _issue_ms(
        lambda: ops.decode_attention(q, k, v, lengths))
    stats["decode_attention"] = _stats(
        err, by, ops_n, "bfloat16",
        _time_ms([lambda s=s: ops.decode_attention(*s, lengths)
                  for s in dsets]),
        _time_ms([lambda s=s: ref.decode_attention_ref(*s, lengths)
                  for s in dsets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))


def _flash_long(gen, dev):
    """Flash at (B=1, S=2048) causal, above the bf16 ridge: checked, and
    timed beside its bound, plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, S, H, KV, hd, bf = 1, 2048, 16, 8, 128, torch.bfloat16
    fsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
             for _ in range(3)]
    q, k, v = fsets[0]
    want = ref.flash_attention_ref(*_f32(q, k, v), causal=True)
    err, share = _compare("flash (1, 2048)",
                          ops.flash_attention(q, k, v, causal=True), want)
    sd = [[t.transpose(1, 2).contiguous() for t in st] for st in fsets]
    by = (2 * B * S * H * hd + 2 * B * S * KV * hd) * 2
    st = _stats(
        err, by, 4 * hd * H * B * S * (S + 1) // 2, "bfloat16",
        _time_ms([lambda s=s: ops.flash_attention(*s, causal=True)
                  for s in fsets]),
        _time_ms([lambda s=s: ref.flash_attention_ref(*s, causal=True)
                  for s in fsets], iters=3),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a, is_causal=True, enable_gqa=True) for a in sd]))
    print(f"[kernels] flash_attention (1, 2048) causal bf16: max_abs_err="
          f"{err:.3e} off_rounded={share:.4%} ms={st['ms']:.4f} plain_ms="
          f"{st['plain_ms']:.4f} library_ms={st['library_ms']:.4f} "
          f"bound_ms={st['bound_ms']:.4f} ({st['bound_by']})")


def _pair_inputs(gen, dev, N, M, d, dtype, wdtype=None):
    """Random pair-score inputs: claims (N, d) and evidence (M, d)
    N(0, 1), W N(0, 1)/sqrt(d), w N(0, 1), bias 0.3."""
    import torch
    wdtype = wdtype or dtype
    W = _randn(gen, (d, d), torch.float32, dev) / math.sqrt(d)
    return (_randn(gen, (N, d), dtype, dev), _randn(gen, (M, d), dtype, dev),
            W.to(wdtype), _randn(gen, (2 * d,), wdtype, dev),
            torch.tensor(0.3, device=dev))


def _margot_pair_inputs(dev, N, M):
    """MARGOT's own pair-score inputs at d = 1024: L2-normalized hashed
    bag-of-words rows of the synthetic corpus (claims the first N, evidence
    the next M) and the MARGOT link model."""
    import torch
    from repro_torch.configs.margot_svm import PIPELINE
    from repro_torch.data.text import margot_models
    from repro_torch.launch.argmining import make_corpus
    X = torch.from_numpy(make_corpus(N + M, PIPELINE.feat_dim)[0]).to(dev)
    link = margot_models(PIPELINE, device=dev)["link"]
    return (X[:N].contiguous(), X[N:].contiguous(), link["W"], link["w"],
            link["bias"])


def _pair_check(name, C, E, W, w, b, control=False):
    """The kernel's pair score against the plain version run in fp64 on
    the same inputs, at max |kernel - fp64| <= PAIR_REL * max |fp64|; with
    ``control``, the plain version in fp32 with TF32 on must fail that
    limit.  Returns (max abs error, its share of max |fp64|, the
    control's share or None)."""
    import torch
    from repro_torch.kernels import ops, ref
    d = C.shape[1]
    out = ops.pair_score({"W": W, "w": w, "bias": b}, C, E)
    check(out.dtype == torch.float32 and
          tuple(out.shape) == (C.shape[0], E.shape[0]) and
          bool(torch.isfinite(out).all()), f"{name}: bad output")
    want = ref.pair_score_ref(*(t.double() for t in (C, E, W, w[:d], w[d:],
                                                     b)))
    scale = want.abs().max().item()
    err = (out.double() - want).abs().max().item()
    check(err <= PAIR_REL * scale, f"{name}: max |kernel - fp64| {err:.3e} "
          f"is {err / scale:.3e} of max |score|, limit {PAIR_REL}")
    ctl = None
    if control:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = ref.pair_score_ref(C, E, W, w[:d], w[d:], b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        ctl = (tf32.double() - want).abs().max().item() / scale
        check(ctl > PAIR_REL, f"{name}: the TF32 control is off by only "
              f"{ctl:.3e} of max |score|: the limit {PAIR_REL} cannot see "
              f"TF32")
    return err, err / scale, ctl


def _pair_library(C, E, W, w, b):
    """The yardstick: the same function as cuBLAS and elementwise calls
    (no single PyTorch call computes it), TF32 off."""
    d = C.shape[1]
    return (C @ W) @ E.T + (C @ w[:d])[:, None] + (E @ w[d:])[None, :] + b


def _pair_score_checks(gen, dev, stats, issue):
    """The pair score against its plain version in fp64: a grid of small
    shapes in fp32 and bf16, then the batch path's shape (256, 512, 1024)
    and the stream's (1024, 1024, 1024) in fp32 on MARGOT's features and on
    random inputs, each with the TF32 control; times at both shapes."""
    import torch
    from repro_torch.kernels import ops, ref
    worst = 0.0
    for N, M, d in ((64, 128, 256), (100, 60, 128), (128, 128, 512),
                    (1, 1, 1024), (257, 513, 130)):
        for dtype in (torch.float32, torch.bfloat16):
            _, rel, _ = _pair_check(f"pair_score ({N}, {M}, {d}) {dtype}",
                                    *_pair_inputs(gen, dev, N, M, d, dtype))
            worst = max(worst, rel)
    _, rel, _ = _pair_check("pair_score bf16 claims, fp32 W",
                            *_pair_inputs(gen, dev, 100, 60, 128,
                                          torch.bfloat16, torch.float32))
    worst = max(worst, rel)
    print(f"[kernels] pair_score grid: 11 checks over (64, 128, 256), "
          f"(100, 60, 128), (128, 128, 512), (1, 1, 1024), (257, 513, 130) "
          f"x fp32 / bf16 inputs (+ bf16 claims with fp32 W) passed: max "
          f"|kernel - fp64| <= {worst:.3e} of max |score| (limit "
          f"{PAIR_REL})")
    d = 1024
    for label, N, M in (("batch", 256, 512), ("stream", 1024, 1024)):
        read = {}
        for kind, args in (("margot", _margot_pair_inputs(dev, N, M)),
                           ("random", _pair_inputs(gen, dev, N, M, d,
                                                   torch.float32))):
            read[kind] = _pair_check(f"pair_score {label} {kind}", *args,
                                     control=True)
        sets = [_pair_inputs(gen, dev, N, M, d, torch.float32)
                for _ in range(3)]
        link = lambda s: {"W": s[2], "w": s[3], "bias": s[4]}  # noqa
        C, E, W, w, b = sets[0]
        check(torch.allclose(_pair_library(C, E, W, w, b),
                             ref.pair_score_ref(C, E, W, w[:d], w[d:], b),
                             atol=1e-4, rtol=1e-4),
              "pair_score: the yardstick computes another function")
        by = 4 * (N * d + M * d + d * d + 2 * d + N * M + 1)
        n_ops = 2 * N * d * (d + M) + 2 * (N + M) * d
        st = _stats(
            read["random"][0], by, n_ops, "float32",
            _time_ms([lambda s=s: ops.pair_score(link(s), s[0], s[1])
                      for s in sets]),
            _time_ms([lambda s=s: ref.pair_score_ref(
                s[0], s[1], s[2], s[3][:d], s[3][d:], s[4]) for s in sets]),
            _time_ms([lambda s=s: _pair_library(*s) for s in sets]))
        iss = _issue_ms(lambda: ops.pair_score(link(sets[0]), C, E))
        print(f"[kernels] pair_score {label} ({N}, {M}, {d}) fp32: "
              f"|kernel - fp64| / max|score| margot={read['margot'][1]:.3e} "
              f"random={read['random'][1]:.3e}, TF32 control "
              f"margot={read['margot'][2]:.3e} random={read['random'][2]:.3e} "
              f"(limit {PAIR_REL}); max_abs_err={st['max_abs_err']:.3e} "
              f"ms={st['ms']:.4f} plain_ms={st['plain_ms']:.4f} "
              f"library_ms={st['library_ms']:.4f} (cuBLAS GEMMs + "
              f"elementwise, several calls) bound_ms={st['bound_ms']:.4f} "
              f"({st['bound_by']}); issued one by one from Python: "
              f"{iss:.4f} ms per call")
        if label == "batch":
            # no one PyTorch call computes this function: the JSON line's
            # library_ms is null, the yardstick is printed above
            stats["pair_score"] = dict(st, library_ms=None)
            issue["pair_score"] = iss


def _scan_inputs(gen, dev, B, S, D, N):
    """Stable dynamics as tests/test_kernels.py:189-194: a in (0, 1), b
    small, h0 nonzero; fp32."""
    import torch
    a = torch.sigmoid(_randn(gen, (B, S, D, N), torch.float32, dev))
    b = _randn(gen, (B, S, D, N), torch.float32, dev) * 0.1
    return a, b, _randn(gen, (B, D, N), torch.float32, dev)


def _chunk_zeroed(a, b, h0):
    """The control: the plain recurrence with the carry zeroed at every
    SCAN_CHUNK-step chunk boundary."""
    import torch
    hs, h = torch.empty_like(b), h0
    for t in range(a.shape[1]):
        if t and t % SCAN_CHUNK == 0:
            h = torch.zeros_like(h)
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs, h


def _scan_check(name, a, b, h0, control=False):
    """The kernel's (h_seq, h_final) against the plain version's on the
    same inputs at atol = rtol = SCAN_TOL; with ``control`` the chunk-
    zeroed recurrence must fail that limit.  Returns (max abs error of
    both outputs, the control's max abs error or None)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    hs, hT = ss.ssm_scan_blocked(a, b, h0)
    torch.cuda.synchronize()
    want = ref.ssm_scan_ref(a, b, h0)
    err = 0.0
    for got, w, what in ((hs, want[0], "h_seq"), (hT, want[1], "h_final")):
        check(got.shape == w.shape and bool(torch.isfinite(got).all()),
              f"{name} {what}: bad output")
        err = max(err, (got - w).abs().max().item())
        check(torch.allclose(got, w, atol=SCAN_TOL, rtol=SCAN_TOL),
              f"{name} {what}: max_abs_err {err:.3e} beyond atol=rtol="
              f"{SCAN_TOL}")
    ctl = None
    if control:
        zs, zT = _chunk_zeroed(a, b, h0)
        ctl = max((zs - want[0]).abs().max().item(),
                  (zT - want[1]).abs().max().item())
        check(not (torch.allclose(zs, want[0], atol=SCAN_TOL, rtol=SCAN_TOL)
                   and torch.allclose(zT, want[1], atol=SCAN_TOL,
                                      rtol=SCAN_TOL)),
              f"{name}: the chunk-zeroed control passes the limit "
              f"{SCAN_TOL}: the check cannot see the carry")
    return err, ctl


def _ssm_scan_checks(gen, dev, stats, issue):
    """The selective scan against its plain version: a grid of small
    shapes (N 8 and 16, S 1 and ragged, an odd D N and a misaligned view,
    which take the kernel's one-channel threads), then the Mamba serve's
    admit shapes with the chunk-zeroed control and times."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    worst = 0.0
    grid = [(2, S, 64, N) for N in (8, 16) for S in (1, 37, 130)]
    grid += [(3, 9, 5, 3)]
    for B, S, D, N in grid:
        err, _ = _scan_check(f"ssm_scan ({B}, {S}, {D}, {N})",
                             *_scan_inputs(gen, dev, B, S, D, N))
        worst = max(worst, err)
    a, b, h0 = _scan_inputs(gen, dev, 2, 37, 64, 8)
    buf = torch.empty(a.numel() + 1, device=dev)
    buf[1:].copy_(a.reshape(-1))
    err, _ = _scan_check("ssm_scan misaligned view",
                         buf[1:].view(a.shape), b, h0)
    worst = max(worst, err)
    print(f"[kernels] ssm_scan grid: {len(grid) + 1} checks over (B, S, D, "
          f"N) in {grid} and a view starting 4 bytes past a 16-byte "
          f"boundary passed: max |kernel - plain| {worst:.3e} (limit atol="
          f"rtol={SCAN_TOL})")
    for B, S in ((4, 512), (1, 1000), (1, 100)):
        D, N = 8192, 16
        a, b, h0 = _scan_inputs(gen, dev, B, S, D, N)
        err, ctl = _scan_check(f"ssm_scan ({B}, {S}, {D}, {N})", a, b, h0,
                               control=True)
        n_el = B * S * D * N
        by = 4 * (3 * n_el + 2 * B * D * N)    # a, b in; h_seq, h0, h_final
        st = _stats(err, by, 2 * n_el, "float32",
                    _time_ms([lambda: ss.ssm_scan_blocked(a, b, h0)],
                             iters=5),
                    _time_ms([lambda: ref.ssm_scan_ref(a, b, h0)], iters=2),
                    _time_ms([lambda: torch.cumsum(b, dim=1)], iters=5))
        iss = _issue_ms(lambda: ss.ssm_scan_blocked(a, b, h0), iters=10)
        print(f"[kernels] ssm_scan ({B}, {S}, {D}, {N}) fp32: "
              f"max_abs_err={err:.3e} (limit atol=rtol={SCAN_TOL}; control "
              f"with the carry zeroed every {SCAN_CHUNK} steps: "
              f"{ctl:.3e}) ms={st['ms']:.4f} plain_ms={st['plain_ms']:.4f} "
              f"yardstick torch.cumsum(b_bar, dim=1) ms="
              f"{st['library_ms']:.4f} (one tensor read, one written: 2/3 "
              f"of the scan's bytes; no PyTorch call computes the "
              f"recurrence) bound_ms={st['bound_ms']:.4f} "
              f"({st['bound_by']}); issued one by one from Python: "
              f"{iss:.4f} ms per call")
        if (B, S) == (4, 512):
            stats["ssm_scan"] = dict(st, library_ms=None)
            issue["ssm_scan"] = iss
        del a, b, h0
    torch.cuda.empty_cache()


def _stats(err, nbytes, n_ops, dtype, ms, plain_ms, library_ms):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ----------------------------------------------------------------------
def _drain(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run_until_drained()
    return reqs


PAGED_KERNELS = ("paged_decode_attention", "paged_extend_attention")
DENSE_KERNELS = ("flash_attention", "decode_attention")
SSM_KERNELS = ("ssm_scan",)


def _forced_plain(plain: bool):
    """A context in which every op takes its plain version on the card
    (counted in ``ops.PLAIN_CALLS``), if ``plain``."""
    from repro_torch import kernels
    from repro_torch.kernels import ops

    def plain_route(name, q):
        kernels.count(ops.PLAIN_CALLS, name)
        return False
    return mock.patch.object(ops, "_route", plain_route) if plain else \
        contextlib.nullcontext()


def phase_token_exact():
    """fp32, two-layer reduced config: on each path the kernels give the
    plain versions' tokens, and the dense path the paged path's."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import ScanGroup, get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models.weights import init_params
    from repro_torch.serving import Engine, ServeConfig
    dev = torch.device("cuda", 0)
    cfg = reduced(get_config("internlm2-1.8b")).replace(
        n_layers=2, groups=(ScanGroup(("A",), 2),))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rng = np.random.RandomState(0)
    common = rng.randint(0, cfg.vocab, 16).astype(np.int32)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 9, 7, 12, 6)]
    prompts += [np.concatenate([common, rng.randint(0, cfg.vocab, n)])
                .astype(np.int32) for n in (4, 3)]

    def run(scfg, plain):
        ops.reset_counts()
        with _forced_plain(plain):
            reqs = _drain(Engine(params, cfg, scfg, device=dev), prompts, 6)
        return reqs, dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)

    tokens, used = {}, {}
    for label, keys, scfg in (
            ("paged", PAGED_KERNELS, ServeConfig(
                max_len=64, slots=2, sync_every=4, paged=True,
                block_size=8)),
            ("dense", DENSE_KERNELS, ServeConfig(max_len=64, slots=2,
                                                 sync_every=4))):
        kern, k_launch, k_plain = run(scfg, plain=False)
        check(all(k_launch[k] > 0 for k in keys) and
              sum(k_launch.values()) == sum(k_launch[k] for k in keys) and
              not any(k_plain.values()),
              f"{label} kernel run: launches {k_launch}, plain {k_plain}")
        plain, p_launch, p_plain = run(scfg, plain=True)
        check(all(p_plain[k] > 0 for k in keys) and
              not any(p_launch.values()),
              f"{label} plain run: launches {p_launch}, plain {p_plain}")
        for i, (a, b) in enumerate(zip(kern, plain)):
            check(a.out_tokens == b.out_tokens and
                  a.finish_reason == b.finish_reason,
                  f"{label} request {i}: kernel {a.out_tokens} "
                  f"({a.finish_reason}) != plain {b.out_tokens} "
                  f"({b.finish_reason})")
        tokens[label] = [(r.out_tokens, r.finish_reason) for r in kern]
        used[label] = {k: k_launch[k] for k in keys}
    check(tokens["dense"] == tokens["paged"],
          f"dense tokens {tokens['dense']} != paged {tokens['paged']}")
    n_tok = sum(len(t) for t, _ in tokens["dense"])
    print(f"[token-exact] fp32 2-layer reduced: {len(prompts)} requests, "
          f"{n_tok} tokens identical through the kernels and the plain "
          f"versions on the paged path ({used['paged']}) and the dense path "
          f"({used['dense']}), and between the two paths")
    _token_exact_mamba()


def _token_exact_mamba():
    """fp32, two-layer reduced falcon-mamba-7b on the dense engine: the
    scan kernel gives the plain version's tokens, on prompts of 130 tokens
    (at and past the JAX kernel gate, S >= 128) and of 100 (not a
    multiple of the TPU kernel's 64-step chunk)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import ScanGroup, get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models.weights import init_params
    from repro_torch.serving import Engine, ServeConfig
    dev = torch.device("cuda", 0)
    cfg = reduced(get_config("falcon-mamba-7b")).replace(
        n_layers=2, groups=(ScanGroup(("S",), 2),))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (130, 5, 100, 9, 7, 7)]
    scfg = ServeConfig(max_len=256, slots=2, sync_every=4)
    runs = {}
    for label, plain in (("kernel", False), ("plain", True)):
        ops.reset_counts()
        with _forced_plain(plain):
            eng = Engine(params, cfg, scfg, device=dev)
            reqs = _drain(eng, prompts, 6)
        launches, calls = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
        batches = eng.metrics.counter("engine.prefill_batches").value
        used, unused = (calls, launches) if plain else (launches, calls)
        check(used["ssm_scan"] == 2 * batches and
              sum(used.values()) == used["ssm_scan"] and
              not any(unused.values()),
              f"mamba {label} run: launches {launches}, plain {calls}, "
              f"prefill batches {batches}")
        runs[label] = [(r.out_tokens, r.finish_reason) for r in reqs]
        if not plain:
            n_launch = launches["ssm_scan"]
    check(runs["kernel"] == runs["plain"],
          f"mamba: kernel tokens {runs['kernel']} != plain {runs['plain']}")
    print(f"[token-exact] fp32 2-layer reduced falcon-mamba-7b, dense "
          f"engine: {len(prompts)} requests of "
          f"{[len(p) for p in prompts]} tokens, "
          f"{sum(len(t) for t, _ in runs['kernel'])} tokens identical "
          f"through the scan kernel ({n_launch} launches in "
          f"{batches} prefill batches) and the plain version")


# ----------------------------------------------------------------------
def phase_serve():
    """internlm2-1.8b at full width through the paged path, then through
    the dense path; returns each kernel's launches in its path's run."""
    launches = {}
    for paged in (True, False):
        launches.update(_serve_path(paged))
    launches.update(_serve_mamba())
    return launches


def _serve_path(paged: bool):
    import gc

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    dev = torch.device("cuda", 0)
    label = "paged" if paged else "dense"
    keys = PAGED_KERNELS if paged else DENSE_KERNELS
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = build_engine("internlm2-1.8b", max_len=2048, slots=8,
                       sync_every=8, paged=paged, block_size=16, seed=0,
                       device=dev)
    torch.cuda.synchronize()
    cfg = eng.cfg
    check(cfg.n_layers == 24 and cfg.d_model == 2048 and
          eng.params["lm_head"].dtype == torch.bfloat16 and
          eng.paged == paged, "not the full-width bf16 config")
    kv = (f"pool {eng.alloc.num_blocks} blocks x 16" if paged else
          "dense caches 8 x 2048")
    print(f"[serve {label}] built internlm2-1.8b (24 layers, d_model 2048, "
          f"bf16, {kv}) in {time.perf_counter() - t0:.1f}s; device memory "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    rng = np.random.RandomState(1)
    tok = lambda n: rng.randint(0, cfg.vocab, n).astype(np.int32)  # noqa
    # warm-up request (cuBLAS handles, allocator), then the measured run
    _drain(eng, [tok(40)], 8)
    prefix = tok(256)
    # a request of another bucket sits between the two that share the
    # prefix, so the second is admitted after the first published it
    prompts = [np.concatenate([prefix, tok(44)]), tok(16),
               np.concatenate([prefix, tok(100)]), tok(64), tok(512),
               tok(200), tok(33), tok(128)]
    max_new = 32
    hits0 = eng.metrics.counter("engine.prefix_hit_blocks").value
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = _drain(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
    hits = eng.metrics.counter("engine.prefix_hit_blocks").value - hits0
    for r in reqs:
        check(r.finish_reason == "max_new" and
              len(r.out_tokens) == max_new + 1 and
              all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.rid}: {r.finish_reason}, {r.out_tokens}")
    check(all(launches[k] > 0 for k in keys) and
          sum(launches.values()) == sum(launches[k] for k in keys),
          f"{label}: kernels not launched, or another path's: {launches}")
    check(not any(plain.values()), f"plain versions ran: {plain}")
    if paged:
        check(hits >= 16, f"prefix cache hit {hits} blocks, expected >= 16")
        check(eng.alloc.free_blocks + eng.alloc.cached_blocks ==
              eng.alloc.num_blocks, "blocks leaked")
    gen = sum(r.decoded for r in reqs)
    ttft = sorted(r.first_token_t - r.submit_t for r in reqs)
    print(f"[serve {label}] internlm2-1.8b {len(reqs)} requests "
          f"({sum(len(p) for p in prompts)} prompt tokens) max_new={max_new}"
          f": wall={wall:.3f}s decoded={gen} tok/s={gen / wall:.1f} "
          f"ttft_max={ttft[-1]:.3f}s prefix_hit_blocks={hits} "
          f"launches={launches} plain_calls={plain} "
          f"prefill_batches={eng.metrics.counter('engine.prefill_batches').value}"
          f" peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}GiB")
    _profile_decode_sync(eng, tok, label)
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in keys}


def _serve_mamba():
    """falcon-mamba-7b at full width on the dense engine, after the
    internlm2 engines are freed; returns the scan's launches in the run."""
    import gc

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated(dev) < 2**30,
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still "
          f"allocated before the Mamba serve")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = build_engine("falcon-mamba-7b", max_len=2048, slots=8,
                       sync_every=8, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, mixer = eng.cfg, eng.params["groups"][0][0]["mixer"]
    check(cfg.n_layers == 64 and cfg.d_model == 4096 and
          cfg.d_inner == 8192 and cfg.ssm_state == 16 and
          cfg.dt_rank == 256 and cfg.conv_k == 4 and cfg.vocab == 65024 and
          cfg.tie_embeddings and "lm_head" not in eng.params and
          mixer["in_proj"].shape == (64, 4096, 16384) and
          mixer["in_proj"].dtype == torch.bfloat16 and
          mixer["A_log"].dtype == torch.float32 and not eng.paged,
          "not the full-width bf16 falcon-mamba-7b on the dense engine")
    print(f"[serve mamba] built falcon-mamba-7b (64 layers, d_model 4096, "
          f"d_inner 8192, state 16, bf16, dense state 8 slots) in "
          f"{build_s:.1f}s; device memory "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, peak during "
          f"the init {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    rng = np.random.RandomState(1)
    tok = lambda n: rng.randint(0, cfg.vocab, n).astype(np.int32)  # noqa
    _drain(eng, [tok(40)], 8)           # warm-up (cuBLAS, allocator)
    # same lengths adjacent, so each group shares one exact-length admit
    prompts = [tok(512) for _ in range(4)] + [tok(1000), tok(256), tok(256),
                                             tok(100)]
    max_new = 32
    b0 = eng.metrics.counter("engine.prefill_batches").value
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = _drain(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
    batches = eng.metrics.counter("engine.prefill_batches").value - b0
    for r in reqs:
        check(r.finish_reason == "max_new" and
              len(r.out_tokens) == max_new + 1 and
              all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.rid}: {r.finish_reason}, {r.out_tokens}")
    check(batches == 4 and launches["ssm_scan"] == 64 * batches and
          sum(launches.values()) == launches["ssm_scan"],
          f"mamba: launches {launches} in {batches} prefill batches, "
          f"expected ssm_scan = 64 x 4 and no other kernel")
    check(not any(plain.values()), f"plain versions ran: {plain}")
    gen = sum(r.decoded for r in reqs)
    ttft = sorted(r.first_token_t - r.submit_t for r in reqs)
    print(f"[serve mamba] falcon-mamba-7b {len(reqs)} requests "
          f"({sum(len(p) for p in prompts)} prompt tokens) max_new={max_new}"
          f": wall={wall:.3f}s decoded={gen} tok/s={gen / wall:.1f} "
          f"ttft_max={ttft[-1]:.3f}s launches={launches} plain_calls={plain} "
          f"prefill_batches={batches} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}GiB")
    _profile_decode_sync(eng, tok, "mamba")
    _profile_admit(eng, tok)
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return {"ssm_scan": launches["ssm_scan"]}


def _profile_admit(eng, tok):
    """One admit of 4 x 512 tokens (64 layers) on the host clock, then the
    next one under ``torch.profiler``: the scan kernel's device time
    against what runs around it in torch: the broadcast multiplies that
    build a_bar and b_bar, the exp of a_bar, the C contraction (a batched
    GEMV), the projection GEMMs and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def admit():
        for _ in range(4):
            eng.submit(tok(512), max_new=1)
        eng._admit_fused()
        torch.cuda.synchronize()
        eng.run_until_drained()

    admit()
    t0 = time.perf_counter()
    admit()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            eng.submit(tok(512), max_new=1)
        eng._admit_fused()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_drained()
    busy_us, rows, top = _device_time(prof, "mamba_admit")
    share = dict.fromkeys(("scan", "mul", "exp", "gemv", "gemm", "other"),
                          0.0)
    for us, _, name in rows:
        low = name.lower()
        kind = ("scan" if "ssm_scan" in low else
                "mul" if "mulfunctor<float> > >" in low and
                "binaryfunctor<float" in low else
                "exp" if "exp_kernel" in low else
                "gemv" if "gemv" in low else
                "gemm" if any(k in low for k in ("nvjet", "gemm", "cutlass",
                                                 "xmma")) else
                "other")
        share[kind] += us / 1e3
    print(f"[profile mamba admit] one admit of 4 x 512 tokens (64 layers): "
          f"unprofiled wall {host_ms:.2f}ms with its one-token drain; "
          f"profiled admit wall={wall_ms:.2f}ms device_busy="
          f"{busy_us / 1e3:.2f}ms idle_share="
          f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f} kernels="
          f"{sum(n for _, n, _ in rows)}; device ms by kind: " +
          ", ".join(f"{k} {v:.2f}" for k, v in share.items()) +
          f"; top: {top}")


def _device_time(prof, label):
    """From a profile: the device's busy time (the union of its kernels'
    intervals, us), (us, count, name) rows by kernel, written to
    ``OUT_DIR / chip_smoke_profile_<label>.txt``, and the top five."""
    from torch.autograd import DeviceType
    by_name, spans = {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False):
            continue
        t = ev.time_range
        spans.append((t.start, t.end))
        us, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (us + t.end - t.start, n + 1)
    busy_us, last_end = 0.0, float("-inf")
    for a, b in sorted(spans):          # union of device intervals
        if b > last_end:
            busy_us += b - max(a, last_end)
            last_end = b
    rows = sorted(((us, n, k) for k, (us, n) in by_name.items()),
                  reverse=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"chip_smoke_profile_{label}.txt").write_text("\n".join(
        f"{us / 1e3:10.3f} ms {n:6d}x  {key}" for us, n, key in rows))
    top = "; ".join(f"{key[:40]} {us / 1e3:.2f}ms/{n}x"
                    for us, n, key in rows[:5])
    return busy_us, rows, top


def _profile_decode_sync(eng, tok, label):
    """One K=8 decode sync of 8 slots timed on the host clock, then the
    next one under ``torch.profiler``: device time by kernel and the
    device's idle share of that sync's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for p in [tok(300) for _ in range(8)]:
        eng.submit(p, max_new=24)
    eng.step()                          # admit + first sync
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()                          # second sync, unprofiled
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()                      # third sync, profiled
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_drained()
    busy_us, rows, top = _device_time(prof, label)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:8]
    print(f"[profile {label}] host self time under the profiler, top: " +
          "; ".join(f"{e.key[:36]} {e.self_cpu_time_total / 1e3:.1f}ms/"
                    f"{e.count}x" for e in host))
    print(f"[profile {label}] one decode sync (K=8, 8 slots, ~300-token "
          f"contexts): unprofiled wall={step_ms:.2f}ms; profiled "
          f"wall={wall_ms:.2f}ms"
          f" device_busy={busy_us / 1e3:.2f}ms idle_share="
          f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f} kernels="
          f"{sum(n for _, n, _ in rows)}; top: {top}")
    decode = [f"{key[:60]} {us / 1e3:.3f}ms/{n}x ({us / n:.2f}us a call)"
              for us, n, key in rows if "decode" in key.lower()]
    if decode:
        print(f"[profile {label}] decode attention kernels: " +
              "; ".join(decode))


# ----------------------------------------------------------------------
def _links(res):
    return {(c, e): s for c, e, s in res.links}


def phase_margot():
    """The paper's pipeline at d = 1024 through the port's argmining
    driver; returns the pair score's launches in the DS2 batch."""
    import statistics

    import torch
    from repro_torch import kernels
    from repro_torch.configs.margot_svm import DATASETS, PIPELINE
    from repro_torch.data.text import margot_models
    from repro_torch.kernels import ops
    from repro_torch.launch import argmining
    dev = torch.device("cuda", 0)
    others = [k for k in kernels.LAUNCHES if k != "pair_score"]

    def counts():
        return dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)

    # (a) DS1 through the kernel, then forced onto the plain version
    X, keys, _ = argmining.make_corpus(DATASETS["DS1"], PIPELINE.feat_dim)
    models = margot_models(PIPELINE, device=dev)
    runs = {}
    for label, plain in (("kernel", False), ("plain", True)):
        ops.reset_counts()
        with _forced_plain(plain):
            res = argmining.run_batch(models, X, keys, PIPELINE, 12, 2, dev)
        launches, calls = counts()
        used, unused = (calls, launches) if plain else (launches, calls)
        check(res.n_dropped == 0 and used["pair_score"] == res.launched and
              not any(unused.values()) and
              not any(launches[k] for k in others),
              f"DS1 {label} run: n_dropped {res.n_dropped}, launched "
              f"{res.launched}, launches {launches}, plain {calls}")
        runs[label] = _links(res)
    kern, plain = runs["kernel"], runs["plain"]
    limit = PAIR_REL * max(abs(x) for x in [*kern.values(), *plain.values()])
    only = {p: (kern.get(p), plain.get(p)) for p in kern.keys() ^ plain.keys()}
    check(all(abs(a if a is not None else b) <= limit
              for a, b in only.values()),
          f"DS1: links differ beyond |score| {limit:.3e}: {only}")
    diff = max(abs(kern[p] - plain[p]) for p in kern.keys() & plain.keys())
    check(diff <= limit, f"DS1: common links' scores differ by {diff:.3e}, "
          f"limit {limit:.3e}")
    print(f"[margot DS1] {len(X)} sentences, {len(kern)} links through the "
          f"kernel, {len(plain)} through the plain version on the card: "
          f"{len(only)} pairs in one set only (each |score| <= {limit:.3e}),"
          f" common scores within {diff:.3e} (limit {PAIR_REL} x max "
          f"|score|)")

    # (b) the DS2 batch through the entry point
    ops.reset_counts()
    res = argmining.main(["batch", "--device", "cuda", "--dataset", "DS2",
                          "--workers", "2"])
    launches, calls = counts()
    check(res.n_dropped == 0, f"DS2: n_dropped {res.n_dropped}")
    check(launches["pair_score"] == res.launched and
          not any(launches[k] for k in others) and not any(calls.values()),
          f"DS2: launches {launches}, plain {calls}, partition runs "
          f"{res.launched}")
    print(f"[margot DS2] pair_score launches={launches['pair_score']} "
          f"(partitions={res.partitions}, speculated={res.speculated}) "
          f"plain_calls={sum(calls.values())} links={len(res.links)} "
          f"n_dropped=0 wall={res.wall_s:.3f}s sentences/s="
          f"{DATASETS['DS2'] / res.wall_s:.1f}")
    ds2_launches = launches["pair_score"]

    # (c) Table 2's largest model, M3, on DS1
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_counts()
    res = argmining.main(["batch", "--device", "cuda", "--dataset", "DS1",
                          "--model-sv", "M3", "--workers", "2"])
    launches, calls = counts()
    check(launches["pair_score"] == res.launched and
          not any(calls.values()), f"M3: launches {launches}, plain {calls}")
    print(f"[margot M3] DS1 with 30,363 support vectors per SVM: wall="
          f"{res.wall_s:.3f}s n_dropped={res.n_dropped} links="
          f"{len(res.links)} pair_score launches={launches['pair_score']} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}GiB")

    # (d) the stream's rate ramp, scope-window then scope-file
    for scope in ("window", "file"):
        ops.reset_counts()
        rt, rate = argmining.main(["stream", "--device", "cuda", "--scope",
                                   scope])
        launches, calls = counts()
        check(launches["pair_score"] > 0 and
              not any(launches[k] for k in others) and
              not any(calls.values()) and rate > 0,
              f"stream {scope}: rate {rate}, launches {launches}, plain "
              f"{calls}")
        busy = statistics.median(st.busy_s for st in rt.stats)
        print(f"[margot stream {scope}] max sustainable rate {rate:.0f} "
              f"inst/s; pair_score launches={launches['pair_score']} "
              f"plain_calls=0; steady micro-batch (64 instances, one 1024-row"
              f" chunk) busy median {busy * 1e3:.2f}ms")

    _profile_partition(models, X, keys)
    return {"pair_score": ds2_launches}


def _profile_partition(models, X, keys):
    """One batch partition (12 documents of DS1) on the host clock, then
    under ``torch.profiler``: device busy time, idle share, kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.margot_svm import PIPELINE
    from repro_torch.core.pipeline import extract_links, make_batch_step
    from repro_torch.launch.argmining import partition_bounds
    dev = torch.device("cuda", 0)
    s, e = partition_bounds(keys, 12)[0]
    step = make_batch_step(PIPELINE)

    def part():
        out = step(models, torch.from_numpy(X[s:e]).to(dev),
                   torch.from_numpy(keys[s:e]).to(dev))
        return extract_links(out)

    part()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        part()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, rows, top = _device_time(prof, "margot_partition")
    print(f"[profile margot] one batch partition ({e - s} sentences, "
          f"capacities {PIPELINE.claim_capacity}/{PIPELINE.evid_capacity}): "
          f"unprofiled wall={step_ms:.2f}ms; profiled wall={wall_ms:.2f}ms "
          f"device_busy={busy_us / 1e3:.3f}ms idle_share="
          f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f} kernels="
          f"{sum(n for _, n, _ in rows)}; top: {top}")


# ----------------------------------------------------------------------
def phase_list(stats, launches, smi):
    csrc = "src/repro_torch/kernels/csrc/"
    source = {"paged_decode_attention": csrc + "paged_attention.cu",
              "paged_extend_attention": csrc + "paged_attention.cu",
              "flash_attention": csrc + "flash_attention.cu",
              "decode_attention": csrc + "decode_attention.cu",
              "pair_score": csrc + "pair_score.cu",
              "ssm_scan": csrc + "ssm_scan.cu"}
    replaces = {"paged_decode_attention":
                "src/repro/kernels/paged_attention.py:78",
                "paged_extend_attention":
                "src/repro/kernels/paged_attention.py:178",
                "flash_attention": "src/repro/kernels/flash_attention.py:74",
                "decode_attention":
                "src/repro/kernels/decode_attention.py:40",
                "pair_score": "src/repro/kernels/pair_score.py:41",
                "ssm_scan": "src/repro/kernels/ssm_scan.py:44"}
    kernels = [dict(name=name, route="cuda", source=source[name],
                    replaces=replaces[name], launches=launches[name],
                    **{k: stats[name][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")})
               for name in PAGED_KERNELS + DENSE_KERNELS + ("pair_score",) +
               SSM_KERNELS]
    check(all(math.isfinite(k["ms"]) for k in kernels), "bad timing")
    print(f"[kernels] {len(kernels)} ported kernels on {smi}")
    print(json.dumps({"kernels": kernels}))


if __name__ == "__main__":
    main()
