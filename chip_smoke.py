"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

It drives the port's two serving paths, the paged engine on the Hopper
paged attention kernels and the dense fused engine (the serve driver's
default) on the flash attention and split-K decode kernels, the dense
engine on the Mamba-1 family on the fused selective-scan kernel, the
paper's
MARGOT pipeline (batch and stream) on the pair-score kernel, and the
paper's service architecture (``MLaaSService`` -> ``Router`` -> thread
and process replicas of the engines and of the stream), and the paged
engine's KV lifecycle (speculative decode verified by the paged extend
kernel, copy-on-write forks, KV swap, export/import, brownout and a
migrating drain behind the Router), starcoder2-3b (LayerNorm, a GELU MLP,
24 query heads over 2 kv heads: G 12), internvl2-1b's decoder (G 7, hd 64)
and the MoE family (qwen3-moe-30b-a3b: 128 experts top-8, qk-norm, G 8)
on both attention paths, gemma-7b (head dim 256, MHA, GeGLU) on both and
gemma3-4b (head dim 256, local layers over rings of their window, global
layers, qk-norm) on the dense one, recurrentgemma-2b (RG-LRU layers, their
recurrence on the scan kernel at N = 1, and MQA local attention at G 10,
hd 256) on the dense one, and the telemetry (time series, SLO
engine, stats server, autoscaler) over process replicas, and holds every
kernel against its plain PyTorch version.  One line per phase:

1. device: the card's name and power limit (``nvidia-smi``), then the
   build of ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``, one
   process per source, all started together (timed), and ptxas's
   registers and spills for the two wgmma attention kernels, the fp32
   flash and extend kernels on the CUDA cores, the split-key decode
   kernel of both decode sources (each at hd 16-256), the pair
   score's 3xTF32 wgmma kernel and the three scan kernels (the single
   walk, the chunked scan, the fused selective scan; a spill fails the
   run);
2. kernels against their plain versions (``repro_torch.kernels.ref``) at
   the main paths' shapes in bf16 (H=16, KV=8, hd=128; paged: bs=16,
   ragged lengths up to 2048, an extend of S=256 at pos0 > 0; dense: a
   causal flash prefill of B=3, S=512, a decode of B=8 over L=2048 at
   ragged lengths), plus a small grid over every head_dim and dtype the
   kernels are built for (and flash's three mask modes, and a decode row
   of length 0), and the wgmma kernels' tile edges (flash at S 63, 64,
   65, 129, 200 and G 1, 4, 8, 12; the extend at bs 8 and 16 with pages
   straddled and a row past the table; a long-prefix extend of 2,048
   keys; an extend whose unseen pool rows hold NaN), and the split-key
   decode's edges in fp32 and bf16 (lengths around one and two
   128-key chunks, pages of 8, 16, 32, 12 and 128 rows, G 1 to 16, a
   length past the table and table entries past the pool, rows of length
   0, caches whose rows past every live key hold NaN), each
   held against the plain version's fp32 result on the
   same inputs, with a control (P rounded to bf16) that the bf16 limit
   must reject; flash also at (1, 2048), above the bf16 ridge; both
   decodes also at the serves' shape (B=8, lengths 301-329) and at a tiny
   one (B=1, length 8), with the host's issue time; the pair
   score at the batch shape (256, 512, 1024) and the stream's (1024,
   1024, 1024) on MARGOT features and on random inputs, on the 3xTF32
   wgmma route, and on a small grid in fp32 and bf16 over both routes
   (wgmma: fp32 with d % 4 == 0, with its edges: N and M off its tiles, a
   ragged last depth chunk, d off its 32-deep stages; the CUDA cores: bf16
   or d % 4 != 0), each held against the plain version in fp64 and
   repeated for bit-identical scores, with a TF32 control that the limit
   must reject; the scan kernel at the Mamba serve's admit shapes (4,
   512, 8192, 16), (1, 1000, 8192, 16), (2, 256, 8192, 16), (1, 100, 8192,
   16) (the single walk; phase 4 checks that the serve admits exactly
   these) and on a small grid (N 8 and 16, S 1 and ragged, an odd D N and
   a misaligned view: the chunked scan), each held against the plain
   version at atol = rtol = 1e-4, with a control (the carry zeroed at
   every 64-step chunk) that the limit must reject; kernel, plain and
   library times and the bound; the fused selective scan
   (``ops.ssm_scan``) on the CPU tests' grid (N 3, 8, 16 x S 1, 37, 130,
   with and without h0, B and C as strided views) and at the Mamba admit
   shapes, held against ``ref.selective_scan_ref`` at the same tolerance
   with a control (the carry zeroed every 32 steps), its exponential's
   error, the peak memory of a call, kernel, plain and replaced-route
   times and the bound (bytes or exponentials); and the paged extend
   at the speculative verify's shape (B 8, S 4, pos0 301-329 not
   block-aligned and one window past a 512-key table), with the bf16
   rule and its control, kernel, plain and SDPA times and the bound; then
   the four attention kernels again at the main paths' shapes and lengths
   with starcoder2-3b's heads (H 24, KV 2, G 12), qwen3-moe-30b-a3b's (H
   32, KV 4, G 8) and internvl2-1b's (H 14, KV 2, G 7, hd 64), each with
   the bf16 rule, its control, its times, bound and SDPA's time; last,
   after every check above (so their inputs stay those of earlier runs),
   hd 256: the grid in fp32 and bf16, the wgmma tile edges, the decode's
   edges at G 1, 2, 10 and 16, the four kernels at the main paths'
   shapes with gemma-7b's heads (H 16, KV 16, G 1) and gemma3-4b's (H 8,
   KV 4, G 2), flash at gemma3's window 1024 over S 2048, and flash and
   the extend at the admit shapes of the gemma serves, with the bf16
   rule, controls, times, bounds and SDPA; after those, recurrentgemma-2b:
   flash and the split-K decode at its heads (H 10, KV 1, G 10, hd 256)
   at the main paths' shapes, flash at its window 2048 over S 2,200 and
   at its serve's admit shapes, with the bf16 rule, controls, times,
   bounds and SDPA, and the scan kernel at N = 1 (the RG-LRU recurrence)
   at the split plan's edges (S 1, a chunk - 1, + 0, + 1 at the smallest
   and largest chunk, B 2, w % 4 != 0, a misaligned view) and at every
   admit length of its serve (B 1, w 2560) against the plain version, with
   the control's carry zeroed every chunk of the plan, timed at S 512 and
   2,200 beside its bound and the ``torch.cumsum`` yardstick;
3. token-exact: the two-layer fp32 reduced config served on the card by
   the paged and the dense engine, each through the kernels and forced
   through the plain versions; all four runs give the same tokens, and so
   does the paged engine with ``speculative=True`` (d=3) both ways, on
   the paged extend alone; then
   the two-layer fp32 reduced falcon-mamba-7b through the dense engine,
   through the kernel and forced through the plain version, with prompts
   of 130 and 100 tokens among them: both give the same tokens; and the
   two-layer fp32 reduced starcoder2-3b and internvl2-1b, paged and dense,
   kernel and plain, four times the same tokens; and the two-layer fp32
   reduced qwen3-moe-30b-a3b (8 experts, top-2), paged and dense, kernel
   and plain, the same tokens on each path (paged against dense is not a
   gate for MoE: a prefix hit's admit extends only the suffix, which
   changes the experts' capacity), every admit batch-1, then with
   ``speculative=True``: it falls back (``spec_fallback`` 1) and gives the
   paged tokens; and one MoE FFN call under CUDA's sync debug mode
   ``error`` (nothing reads back to the host); and at head dims 16 and
   256, the two-layer fp32 reduced gemma-7b, paged and dense, kernel and
   plain (four times the same tokens), and the ten-layer fp32 reduced
   gemma3-4b (window 16) dense, kernel and plain, with prompts past the
   window (flash's window mask, rings wrapped in prefill and decode);
   and the eight-layer fp32 reduced recurrentgemma-2b ((R, R, L) x 2 +
   (R, R), window 16, max_len 48) dense, kernel and plain, with prompts
   of 1, 2, 3 and past 16 tokens (flash 2, scan 6 a prefill batch), then
   asked for the paged engine: the same tokens, served dense, the
   fallback counted;
4. full-width serves: internlm2-1.8b (24 layers, bf16, seeded random
   weights), 8 slots, max_len 2048, K=8, 8 requests of 16-512 tokens, two
   sharing a 256-token prefix, max_new 32, first paged (block_size 16),
   then dense; each path's kernel launch counts, read right after its own
   run, must be one a layer per admit batch (extend, flash) and per
   decode step (paged, split-K decode), with no plain calls; then one
   profiled decode sync of each.  Then starcoder2-3b the same two ways at
   full width (30 layers, d_model 3072, 24 heads over 2, d_ff 12288,
   LayerNorm, GELU MLP, tied, bf16, seeded random weights, 3.0 B
   parameters) and internvl2-1b's decoder (24 layers, d_model 896, 14
   heads over 2, hd 64, tied, vocab 151,655 padded to 151,680), their
   launch counts and a profiled decode sync on each path.  Then, with
   those engines freed, falcon-mamba-7b (64 layers,
   d_model 4096, d_inner 8192, bf16, seeded random weights), 8 slots,
   max_len 2048, K=8, 8 requests (4 x 512, 1000, 2 x 256, 100 tokens,
   same lengths adjacent), max_new 32: ``ssm_scan`` launches (the fused
   kernel) must be 64 a prefill batch (256) with no plain calls; then one
   profiled decode sync and one profiled 4 x 512 admit on the fused kernel
   and one on the route it replaced (a_bar, b_bar, the scan kernel,
   einsum), each with its device memory before and at peak and the scan
   kernel its profile names.  Last, each engine alone on the card,
   qwen3-moe-30b-a3b at full width (48 layers, d_model 2048, 32 heads
   over 4, hd 128, 128 experts top-8, expert d_ff 768, qk-norm, vocab
   151,936, bf16, seeded random weights, 30.53 B parameters, no cut),
   paged then dense, as internlm2: parameter count, memory after the init
   and peak per serve, launch counts (48 a decode step and 48 an admit),
   every admit batch-1, tok/s and TTFT, and a profiled decode sync with
   the expert products' device time beside the attention kernels'.
   Before the Mamba serve: gemma-7b (28 layers, d_model 3072, 16 heads
   MHA, hd 256, d_ff 24,576, GeGLU, vocab 256,000, tied, 8.54 B) paged
   and dense, and gemma3-4b (34 layers: 29 local with window 1024 over
   1,024-row rings, 5 global; 8 heads over 4, hd 256, d_ff 10,240,
   vocab 262,144, tied, 3.88 B) asked for the paged engine: it serves
   dense and counts the fallback, with a ninth request of 1,100 tokens
   past the window; each with its launch counts, tok/s, TTFT, memory
   after the init and at peak, and a profiled decode sync.  After
   gemma3-4b, recurrentgemma-2b (26 layers: 18 RG-LRU, 8 local over
   2,048-row rings at max_len 4096; 10 heads over 1, hd 256, d_ff 7,680,
   vocab 256,000, tied, 2.89 B, ``lambda`` fp32) asked for the paged
   engine: it serves dense and counts the fallback, with a ninth request
   of 2,200 tokens; launches exact (flash 8 and the scan 18 a prefill
   batch, the split-K decode 8 a step), a profiled decode sync and
   profiled 2,200-token admit with device time by kind (its scan must be
   the chunked kernel), and the gates of one layer alone;
5. MARGOT at full size (d=1024, the paper's dataset sizes): DS1 through
   the kernel and through the plain version (equal link sets), the DS2
   batch through ``repro_torch.launch.argmining`` (its launch counts read
   right after it), DS1 with M3's 30,363 support vectors, the stream's
   rate ramp in both scopes, and one profiled batch partition;
6. cluster: (a) fp32 reduced internlm2-1.8b, dense then paged, through
   ``MLaaSService`` over a ``Router`` of 2 process replicas, token for
   token equal to an in-process engine on the same seeded weights;
   (b) internlm2-1.8b at full width (as phase 4; 16 requests of 16-512
   prompt tokens, 32 new tokens each) through the service, over 2 thread
   replicas sharing one copy of the weights (paged; the parent's kernel
   launch counts, reset just before), then over 2 process replicas
   (dense; spawn times, the engines' counters and kernel launches over
   the heartbeats), the same requests timed straight into the Router
   (tok/s, TTFT p50/p99), one replica SIGKILLed at the first token (every
   request completes exactly once, on the survivor), and the requests
   again on the survivor alone; (c) the MARGOT stream at phase 5's
   settings on 1 process replica, bit-identical to an in-process runtime
   on the same micro-batches, then on 2 replicas (every micro-batch
   acks); (d) the partition autotuner: ``measure_step`` of the MARGOT
   batch step at 3-48 documents a partition, the fitted cost model and
   ``choose_partition_size`` for a 0.25 s budget, beside the fixed 12;
   the build directory must be unchanged (the workers only load);
7. lifecycle: internlm2-1.8b at phase 4's width (paged, bs 16, 8 slots,
   max_len 2048, K=8, phase 4's 8 requests, max_new 32): (a) speculative
   decode (d=3): its tokens' agreement with phase 4's paged run (bf16, not
   a gate), the acceptance rate, tok/s and TTFT; the paged extend must
   launch 24 x (admit batches + 8 x syncs) times and nothing else;
   (b) a 300-token request forked 3 ways at its first token: each child's
   tokens equal the parent's, with COW copies; (c) KV swap on both tiers
   on an 80-block pool: every request completes once, ``kv_swap_out ==
   kv_swap_in > 0``, no pool exhaustion, each restore re-read bit for bit
   against the bytes swapped out; (d) engine A serves the two requests
   sharing the prefix and exports, engine B imports (its re-export equal
   to A's frame byte for byte) and serves a new prompt on that prefix
   from 16 cached blocks; (e) 2 thread replicas (paged, speculative)
   behind the Router: brownout L1 turns speculation off on both (the spec
   counters stop, every request completes) and a drain with
   ``migrate=True`` ships KV (sessions migrated, the survivor imported
   blocks); the phase's wall time;
8. telemetry: (a) internlm2-1.8b at full width (dense) on 1 process
   replica behind a least-loaded Router, with the serve driver's stats
   stack on its cluster snapshot (a ``TelemetrySampler`` every 0.25 s, an
   ``SLOEngine`` wired into ``router.slo``, a ``StatsServer`` on port 0)
   and an ``Autoscaler`` (1-3 replicas, its factory an ``engine_spec``)
   ticked every 0.25 s: a burst of 96 requests, one every 0.125 s, each
   completing exactly once; at least one scale-up while it lasts (each
   event printed with the seconds its tick took, the spawn), a scale-down
   once the pool is idle; tok/s before and after the first new replica is
   ready; the four routes fetched over HTTP and parsed, ``/metrics``
   carrying the workers' kernel launches; (b) the sampler's overhead: one
   engine, 16 requests with the stats stack off, on, on, off; (c)
   ``python -m repro_torch.launch.serve --stats-dump`` in a process of its
   own; the phase's wall time;
9. the ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  With
``--kernels-only`` it runs phases 1 and 2 alone (the build and every
kernel check and time) and prints no result lines.  Without a card, or
outside a checkout of the repository, it exits non-zero and prints no
result.  The whole ``nvcc`` output goes to ``chiprun_out/``.
"""
from __future__ import annotations

import contextlib
import itertools
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

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and ops/s in bf16
# and TF32 on the tensor cores and fp32 on the CUDA cores; "tf32x3" is the
# rate of fp32-accurate products made of three TF32 ones (the pair score's
# wgmma route)
HBM_BPS = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
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
# inputs: max |kernel - fp64| <= PAIR_REL * max |fp64|.  The fp32 route
# sums three TF32 products a term (3xTF32: hi and lo parts of both
# operands), the other route d fp32 products; both land at ~2e-7 to 9e-7
# of the largest score on an H100 (PERF.md, section 6).  TF32 keeps 10
# mantissa bits, so one TF32 product is off by up to 2^-11 and its scores
# by ~1e-4 of the largest, which the control (the plain version in fp32
# with TF32 on) shows by failing the limit at the batch and stream shapes.
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
# the partition autotuner's latency budget: the stream's period
# (configs/margot_svm.py, STREAM)
STREAM_BUDGET_S = 0.25


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
        print("[smoke] --kernels-only: phases 1-2 passed; phases 3-8 and "
              "the result lines skipped")
        return
    phase_token_exact()
    launches, paged_tokens = phase_serve()
    launches.update(phase_margot())
    phase_cluster()
    phase_lifecycle(paged_tokens)
    phase_telemetry()
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
    ss._fused_library()
    build_s = time.perf_counter() - t0
    usage = [ln.strip() for log in build.BUILD_LOG.values()
             for ln in log.splitlines() if "registers" in ln]
    line = (f"[build] {len(build.SOURCES)} source(s) in {build_s:.2f}s; "
            f"ptxas: {len(usage)} kernels, e.g. "
            f"{usage[-1] if usage else '-'}")
    print(line)
    for source, module in (("flash_attention.cu", fa),
                           ("paged_attention.cu", pa)):
        smem = {hd: module._library().repro_attention_sm90_smem(hd)
                for hd in (128, 256)}
        print(f"[build] {source} "
              f"{_sm90_usage(build.BUILD_LOG, source, smem)}")
    print(f"[build] {_simt_usage(build.BUILD_LOG)}")
    for source in ("paged_attention.cu", "decode_attention.cu"):
        print(f"[build] {source} {_decode_usage(build.BUILD_LOG, source)}")
    print(f"[build] pair_score.cu {_pair_usage(build.BUILD_LOG, ps)}")
    print(f"[build] {_scan_usage(build.BUILD_LOG)}")
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
    report), shown for hd = 128 and 256 beside ``smem[hd]``, the dynamic
    shared memory it asks for at launch (``Tile<hd>::SMEM`` in
    csrc/attention_sm90.cuh)."""
    from repro_torch.kernels import HEAD_DIMS
    found = {int(re.match(r"Li(\d+)E", k)[1]): v for k, v in
             _ptxas_reports(logs, source, "attention_sm90_kernel").items()}
    check(sorted(found) == list(HEAD_DIMS),
          f"{source}: ptxas reported attention_sm90_kernel at head dims "
          f"{sorted(found)}, not {HEAD_DIMS}")
    return "; ".join(f"attention_sm90_kernel<{hd}>: {found[hd]}; dynamic "
                     f"shared memory {smem[hd]} bytes" for hd in smem) + \
        f"; no spills at hd {HEAD_DIMS}"


def _simt_usage(logs) -> str:
    """The fp32 flash and extend kernels on the CUDA cores at every head
    dim (each must have a report and no spill), shown at hd 128 and 256
    (hd 256 takes 32 lanes a key and its 64 KiB merge buffer is dynamic
    shared memory, which ptxas does not count)."""
    from repro_torch.kernels import HEAD_DIMS
    parts = []
    for source, kernel in (("flash_attention.cu", "flash_simt_kernel"),
                           ("paged_attention.cu", "paged_attention_kernel")):
        found = {int(re.search(r"Li(\d+)E", k)[1]): v for k, v in
                 _ptxas_reports(logs, source, kernel).items()}
        check(sorted(found) == list(HEAD_DIMS),
              f"{source}: ptxas reported {kernel} at head dims "
              f"{sorted(found)}, not {HEAD_DIMS}")
        parts += [f"{kernel}<{hd}>: {found[hd]}" for hd in (128, 256)]
    return "; ".join(parts) + f"; no spills at hd {HEAD_DIMS}"


def _decode_usage(logs, source) -> str:
    """The split-key decode kernel of ``source`` at every instantiation
    (fp32 and bf16, hd 16-256, 1-8 rows a CTA; each must have a report),
    shown at 2 rows a CTA (the main path's G) for each head dim, and at
    hd 256 for every row count (its 64 KiB ring is dynamic shared memory,
    which ptxas does not count)."""
    from repro_torch.kernels import HEAD_DIMS
    found = {}
    for k, info in _ptxas_reports(logs, source, "decode_sm90_kernel").items():
        m = re.match(r"(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", k)
        smem = re.search(r"(\d+) bytes smem", info)
        found[(m[1], int(m[2]), int(m[3]))] = (
            int(re.search(r"Used (\d+) registers", info)[1]),
            int(smem[1]) if smem else 0)
    want = {(t, hd, gr) for t in ("f", "13__nv_bfloat16")
            for hd in HEAD_DIMS for gr in (1, 2, 4, 8)}
    check(set(found) == want, f"{source}: ptxas reported decode_sm90_kernel "
          f"for {sorted(found)}, not every dtype x head dim x rows")
    show = "; ".join(
        f"{dn} " + ", ".join(f"hd {hd} {found[(t, hd, 2)][0]} registers "
                             f"{found[(t, hd, 2)][1]} B" for hd in
                             HEAD_DIMS)
        for t, dn in (("13__nv_bfloat16", "bf16"), ("f", "fp32")))
    wide = "; ".join(
        f"{dn} " + ", ".join(f"{gr} rows {found[(t, 256, gr)][0]}"
                             for gr in (1, 2, 4, 8))
        for t, dn in (("13__nv_bfloat16", "bf16"), ("f", "fp32")))
    most = max(r for r, _ in found.values())
    return (f"decode_sm90_kernel at 2 rows a CTA: {show} (static shared "
            f"memory); registers at hd 256 by rows a CTA: {wide}; up to "
            f"{most} registers at 8 rows; no spills in {len(found)} "
            f"instantiations")


def _pair_usage(logs, ps) -> str:
    """The pair score's wgmma kernel, both instantiations (projection and
    score; each must have a report and no spill), beside the dynamic
    shared memory it asks for, and ptxas's warnings that it serialised
    the kernel's wgmma, if any."""
    from repro_torch.kernels import pair_plan
    found = {re.match(r"Lb([01])", k)[1]: v for k, v in _ptxas_reports(
        logs, "pair_score.cu", "pair_sm90_kernel").items()}
    check(sorted(found) == ["0", "1"], f"pair_score.cu: ptxas reported "
          f"pair_sm90_kernel for {sorted(found)}, not both instantiations")
    serial = [ln.strip() for ln in logs["pair_score.cu"].splitlines()
              if "serialized" in ln]
    return (f"pair_sm90_kernel projection: {found['1']}; score: "
            f"{found['0']}; dynamic shared memory "
            f"{pair_plan.smem_bytes(ps._library())} bytes; wgmma "
            f"serialised: {serial[0] if serial else 'no'}")


def _scan_usage(logs) -> str:
    """ptxas's report of the scan kernels: the single walk at V = 4 and 1
    and the chunked scan with 16- and 4-byte staging (ssm_scan.cu), and
    the fused selective scan at each lane count (selective_scan.cu); each
    must have a report and no spill."""
    parts = []
    for source, kernels in (("ssm_scan.cu", ("ssm_scan_kernel",
                                             "ssm_scan_chunked_kernel")),
                            ("selective_scan.cu", ("ssm_scan_fused_kernel",))):
        check(source in logs, f"{source}: no nvcc report for its library")
        lines = logs[source].splitlines()
        for kernel in kernels:
            found = []
            for i, ln in enumerate(lines):
                m = re.search(r"Compiling entry function '(\w+)'", ln)
                if m and re.search(kernel + r"(I|E)", m[1]):
                    info = " ".join(x.split("info    :")[-1].strip()
                                    for x in lines[i + 2:i + 4])
                    check("0 bytes spill stores, 0 bytes spill loads" in
                          info, f"{source}: {kernel} spills: {info}")
                    found.append(re.search(r"Used (\d+) registers",
                                           info)[1])
            check(found, f"{source}: ptxas reported no {kernel}")
            parts.append(f"{kernel} {'/'.join(found)} registers")
    return "scan kernels: " + ", ".join(parts) + "; no spills"


#: the side stream every timing captures on (made at its first use)
_TIMING_STREAM = []


def _timing_stream():
    """One side stream for every capture of :func:`_time_ms`: PyTorch
    keeps a cuBLAS workspace for each stream cuBLAS runs on for the life of
    the process, so a new stream a timing left one behind each time (~1
    GiB allocated, and no tensor alive, by the end of phase 3)."""
    import torch
    if not _TIMING_STREAM:
        _TIMING_STREAM.append(torch.cuda.Stream())
    return _TIMING_STREAM[0]


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
    stream = _timing_stream()
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

    # every head_dim x dtype the kernels are built for, small shapes (hd
    # 256 in _hd256_checks, after every check of the smaller head dims, so
    # that their inputs stay the draws of earlier runs)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (16, 32, 64, 128):
            n += _grid_case(gen, dtype, hd, dev)
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
    stats, shares, issue = {}, {}, {}
    _paged_main_path(gen, dev, MAIN_HEADS, stats, shares, issue)
    _verify_shape(gen, dev)
    _dense_main_path(gen, dev, MAIN_HEADS, stats, shares, issue)
    _flash_long(gen, dev)
    for label, lengths, max_len in DECODE_SHAPES[1:]:
        for name, st in _decode_bench(gen, dev, lengths, max_len).items():
            print(f"[kernels] {name} at {label}: "
                  f"{_decode_row(st, lengths, max_len)}")
    _pair_score_checks(gen, dev, stats, issue)
    _ssm_scan_checks(gen, dev, stats, issue)
    # its own generator, so that the checks after it keep their inputs
    _fused_scan_checks(torch.Generator(device=dev).manual_seed(24), dev,
                       stats, issue)
    print(f"[kernels] bf16 tolerance: within one bf16 ulp + {BF16_ATOL} of "
          f"the plain version's fp32 result on the same inputs, and at most "
          f"{BF16_MISMATCH:.0%} of elements off that result rounded to bf16 "
          f"(the kernels keep P in fp32, so only fp32 summation order and "
          f"the output rounding separate them); control: the plain version "
          f"with P rounded to bf16 must exceed the {BF16_MISMATCH:.0%}")
    _print_main_path(stats, shares, issue, "")
    for arch, heads, hd in OTHER_HEADS:
        _other_heads(gen, dev, arch, heads, hd)
    for arch, heads, hd in (("internlm2-1.8b", MAIN_HEADS, 128),) + \
            OTHER_HEADS:
        _serve_admits(gen, dev, arch, heads, hd)
    _hd256_checks(gen, dev)
    _recurrentgemma_checks(gen, dev, stats)
    return stats


def _grid_case(gen, dtype, hd, dev):
    """The small-shape checks at one head dim and dtype: the paged decode
    and extend (a row past the table's end), flash in its three mask
    modes and the split-K decode; returns the number of checks."""
    import torch
    from repro_torch.kernels import ops, ref
    dname = str(dtype).split(".")[1]
    B, H, KV, bs, nb, S = 3, 8, 2, 8, 6, 7
    q, kp, vp, bt = _paged_inputs(gen, B, nb, bs, KV, hd, (B, H, hd), dtype,
                                  dev)
    lengths = torch.tensor([1, 17, nb * bs], dtype=torch.int32, device=dev)
    _compare(f"decode hd={hd} {dname}",
             ops.paged_decode_attention(q, kp, vp, bt, lengths),
             ref.paged_decode_attention_ref(*_f32(q, kp, vp), bt, lengths))
    qs = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
    pos0 = torch.tensor([0, 9, nb * bs - 3], dtype=torch.int32,
                        device=dev)     # row 2 runs past the table
    _compare(f"extend hd={hd} {dname}",
             ops.paged_extend_attention(qs, kp, vp, bt, pos0),
             ref.paged_extend_attention_ref(*_f32(qs, kp, vp), bt, pos0))
    return 2 + _dense_grid(gen, dtype, dname, hd, dev)


#: (arch, (H, KV), hd) of the head-dim-256 serves of phase 4: gemma-7b (16
#: heads over 16, G 1: MHA) and gemma3-4b (8 over 4, G 2)
GEMMA_HEADS = (("gemma-7b", (16, 16), 256), ("gemma3-4b", (8, 4), 256))


def _hd256_checks(gen, dev):
    """Every kernel check of the smaller head dims at hd 256: the grid in
    fp32 and bf16, the wgmma tile edges, the split-key decode's edges at
    G 1, 2, 10 and 16 (and its clamped table, rows of length 0 and NaN
    rows); then the four attention kernels at the main paths' shapes and
    lengths with gemma-7b's and gemma3-4b's heads, flash at gemma3-4b's
    window 1024 over S 2048, and flash and the paged extend at the admit
    shapes of their phase-4 serves, each held to the bf16 rule with its
    control and timed beside its bound and SDPA."""
    import torch
    n = sum(_grid_case(gen, dtype, 256, dev)
            for dtype in (torch.float32, torch.bfloat16))
    torch.cuda.synchronize()
    print(f"[kernels] grid at hd 256: {n} checks over fp32 and bf16 passed "
          f"(the hd 16-128 grid's shapes and limits)")
    _attention_edges(gen, dev, hds=(256,), extras=False)
    _decode_edges(gen, dev, hds=(256,), heads=DECODE_EDGE_G_256,
                  extra_hd=256)
    for arch, heads, hd in GEMMA_HEADS:
        _other_heads(gen, dev, arch, heads, hd)
    _flash_window(gen, dev, "gemma3-4b", (8, 4), 256, 1024, 2048)
    for arch, heads, hd in GEMMA_HEADS:
        _serve_admits(gen, dev, arch, heads, hd)


#: recurrentgemma-2b's local attention: 10 query heads over 1 kv head (MQA,
#: G 10: the decodes' 8-row groups take 10 heads as 8 + 2) at hd 256
RG_HEADS = ("recurrentgemma-2b", (10, 1), 256)


def _recurrentgemma_checks(gen, dev, scan_stats):
    """After every earlier check, so that their inputs stay those of
    earlier runs: flash and the split-K decode at recurrentgemma-2b's
    heads at phase 2's main-path shapes; flash at its window 2048 over S
    2,200, the serve's long admit, and at the admit shapes of its phase-4
    serve; and the scan kernel at N = 1 at the serve's admit shapes, the
    RG-LRU recurrence."""
    arch, heads, hd = RG_HEADS
    stats, shares, issue = {}, {}, {}
    _dense_main_path(gen, dev, heads, stats, shares, issue, hd)
    H, KV = heads
    _print_main_path(stats, shares, issue,
                     f" at {arch}'s heads (H {H}, KV {KV}, G {H // KV}, "
                     f"hd {hd})")
    _flash_window(gen, dev, arch, heads, hd, _local_window(arch),
                  SERVE_LONG[arch])
    _serve_admits(gen, dev, arch, heads, hd)
    _linear_scan_checks(gen, dev, scan_stats)


#: the chunked scan's edges at N = 1, (B, S, w, misaligned): S 1, the
#: plan's smallest chunk - 1, the chunk, + 1 (single walk, single walk, two
#: chunks), its largest chunk - 1, the chunk and + 1 over 19 chunks
#: (ragged last chunks of 95 and 1 steps), B 2, w % 4 != 0 and a view
#: 4 bytes past a 16-byte boundary (the staging's 4-byte copies)
LINEAR_EDGES = ((1, 1, 2560, False), (1, 15, 2560, False),
                (1, 16, 2560, False), (1, 17, 2560, False),
                (1, 1823, 2560, False), (1, 1824, 2560, False),
                (1, 1825, 2560, False), (2, 600, 2560, False),
                (1, 300, 2559, False), (1, 300, 2560, True))


def _linear_scan_checks(gen, dev, stats):
    """The scan kernel at N = 1, as the RG-LRU recurrence runs it
    (``ops.linear_scan``: (B, S, w) viewed as (B, S, w, 1)): the plan's
    edges (LINEAR_EDGES), then every admit shape of phase 4's
    recurrentgemma-2b serve (B 1, w 2560), each against the plain version
    with the chunk-zeroed control at the plan's chunk; then kernel, plain
    and yardstick times and the bound at S 512 and 2,200 beside the single
    walk's earlier record on an H100 80GB HBM3 at 700 W."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref, scan_plan
    from repro_torch.kernels import ssm_scan as ss
    arch = RG_HEADS[0]
    w = get_config(arch).lru_width
    worst, ctls, plans = 0.0, [], []
    for B, S, width, misaligned in LINEAR_EDGES:
        a, b, h0 = _scan_inputs(gen, dev, B, S, width, 1)
        if misaligned:
            buf = torch.empty(a.numel() + 1, device=dev)
            buf[1:].copy_(a.reshape(-1))
            a = buf[1:].view(a.shape)
        plan = scan_plan.split_plan(B, S, width, 1)
        err, ctl = _scan_check(f"ssm_scan N=1 edge ({B}, {S}, {width})"
                               f"{' misaligned' if misaligned else ''}",
                               a, b, h0, control=plan.n_chunks > 1)
        worst = max(worst, err)
        ctls += [ctl] if ctl is not None else []
        plans.append((B, S, width) + tuple(plan[:2]))
    print(f"[kernels] ssm_scan N = 1 plan edges, (B, S, w, chunk, "
          f"n_chunks): {plans}, the last two on the one-channel threads (w "
          f"% 4 != 0; a view 4 bytes past a 16-byte boundary): max |kernel "
          f"- plain| {worst:.3e} (limit atol=rtol={SCAN_TOL}); the controls "
          f"(carry zeroed every chunk of the plan) off by {min(ctls):.3e} "
          f"to {max(ctls):.3e}, each rejected")
    lengths = sorted({S for S, _ in _admit_shapes(arch, False)})
    worst, ctls = 0.0, []
    for S in lengths:
        a, b, h0 = _scan_inputs(gen, dev, 1, S, w, 1)
        split = scan_plan.split_plan(1, S, w, 1).n_chunks > 1
        err, ctl = _scan_check(f"ssm_scan N=1 (1, {S}, {w})", a, b, h0,
                               control=split or S > SCAN_CHUNK)
        # the op the model calls: (B, S, w) in, the same launch
        hs, hT = ss.ssm_scan_blocked(a, b, h0)
        os_, oT = ops.linear_scan(a[..., 0], b[..., 0], h0[..., 0])
        check(torch.equal(os_, hs[..., 0]) and torch.equal(oT, hT[..., 0]),
              f"ops.linear_scan at (1, {S}, {w}) differs from the kernel "
              f"at N = 1")
        worst = max(worst, err)
        if ctl is not None:
            ctls.append(ctl)
    print(f"[kernels] ssm_scan at N = 1 ({arch}'s RG-LRU recurrence, B 1, "
          f"w {w}) at its serve's admit lengths {lengths}: max |kernel - "
          f"plain| {worst:.3e} (limit atol=rtol={SCAN_TOL}); the controls "
          f"with the carry zeroed every chunk (the plan's, or "
          f"{SCAN_CHUNK} steps on the single walk) off by {min(ctls):.3e} "
          f"to {max(ctls):.3e}, each rejected")
    before = {512: 0.0759, SERVE_LONG[arch]: 0.3234}
    for S in (512, SERVE_LONG[arch]):
        sets = [_scan_inputs(gen, dev, 1, S, w, 1) for _ in range(3)]
        a, b, h0 = sets[0]
        err, _ = _scan_check(f"ssm_scan N=1 (1, {S}, {w}) timed", a, b, h0)
        by = 12 * S * w + 8 * w    # a, b in, h_seq out; h0 in, h_final out
        st = _stats(err, by, 2 * S * w, "float32",
                    _time_ms([lambda s=s: ss.ssm_scan_blocked(*s)
                              for s in sets]),
                    _time_ms([lambda: ref.ssm_scan_ref(a, b, h0)], iters=2),
                    _time_ms([lambda s=s: torch.cumsum(s[1], dim=1)
                              for s in sets]))
        iss = _issue_ms(lambda: ss.ssm_scan_blocked(a, b, h0), iters=10)
        plan = scan_plan.split_plan(1, S, w, 1)
        print(f"[kernels] ssm_scan N=1 (1, {S}, {w}, 1) fp32: "
              f"max_abs_err={err:.3e} ms={st['ms']:.4f} (the single walk "
              f"in 5 CTAs: {before[S]}) plain_ms={st['plain_ms']:.4f} "
              f"yardstick torch.cumsum(b, dim=1) ms="
              f"{st['library_ms']:.4f} bound_ms={st['bound_ms']:.4f} "
              f"({st['bound_by']}: 12 bytes a step-channel, 8 a channel); "
              f"plan: {plan.n_chunks} chunks of {plan.chunk} steps x "
              f"{plan.n_tiles} tiles of {scan_plan.TILE} channels = "
              f"{plan.n_chunks * plan.n_tiles} CTAs of 128 threads; issued "
              f"one by one from Python: {iss:.4f} ms per call")
        if S == SERVE_LONG[arch]:
            # library_ms is null, the yardstick is printed above
            stats["ssm_scan"] = dict(st, library_ms=None)


#: (H, KV) of the main path's attention (internlm2-1.8b: 16 query heads
#: over 8 kv heads, G 2) and of starcoder2-3b (24 over 2, G 12: a 64-row
#: wgmma tile holds 5 1/3 query positions, and the decode's 8-row groups
#: take 12 heads as one full group and one half-full)
MAIN_HEADS = (16, 8)

#: (arch, (H, KV), hd) of the other archs phase 4 serves, whose head
#: layouts phase 2 checks at its shapes: starcoder2-3b (G 12),
#: qwen3-moe-30b-a3b (32 over 4, G 8: one full decode row group) and
#: internvl2-1b (14 over 2 at hd 64, G 7: a row group one row short)
OTHER_HEADS = (("starcoder2-3b", (24, 2), 128),
               ("qwen3-moe-30b-a3b", (32, 4), 128),
               ("internvl2-1b", (14, 2), 64))


def _paged_main_path(gen, dev, heads, stats, shares, issue, hd=128):
    """The paged decode and extend at phase 2's shapes, bf16, bs 16, for
    ``heads`` = (H, KV) and head dim ``hd``: a decode of B=8 at ragged
    lengths up to 2048 and an extend of (4, 256) at pos0 16-1792, each
    against its plain version with the bf16 rule and its control, SDPA,
    and 3 copies of its inputs for cold-L2 timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (H, KV), bs, max_len = heads, 16, 2048
    B, at = 8, f" H={H} KV={KV} hd={hd}"
    nb, esz = max_len // bs, 2
    lengths = torch.tensor([2048, 1, 1537, 300, 16, 977, 2000, 64],
                           dtype=torch.int32, device=dev)
    sets = [_paged_inputs(gen, B, nb, bs, KV, hd, (B, H, hd),
                          torch.bfloat16, dev) for _ in range(3)]
    q, kp, vp, bt = sets[0]
    out = ops.paged_decode_attention(q, kp, vp, bt, lengths)
    want = ref.paged_decode_attention_ref(*_f32(q, kp, vp), bt, lengths)
    err, share = _compare("decode main-path" + at, out, want)
    shares["paged_decode_attention"] = (share, _check_control(
        "decode main-path" + at, _plain_rounded_p(q[:, None], kp, vp, bt,
                                             lengths - 1), want))
    keep = (torch.arange(max_len, device=dev)[None, :] <
            lengths[:, None].long())[:, None, None, :]
    sd = [_sdpa_args(s[0][:, :, None], s[1], s[2], s[3], keep) for s in sets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True)[:, :, 0]
    _library_close("decode" + at, lib_out, want)
    n_tok = int(lengths.sum())
    by = (2 * n_tok * KV * hd * esz                 # K and V rows needed
          + 2 * B * H * hd * esz                    # q in, out
          + 4 * sum(-(-int(x) // bs) for x in lengths) + 4 * B)  # bt, len
    ops_n = 4 * H * hd * n_tok                      # QK^T and PV
    issue["paged_decode_attention"] = _issue_ms(
        lambda: ops.paged_decode_attention(q, kp, vp, bt, lengths))
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
    err, share = _compare("extend main-path" + at, out, want)
    shares["paged_extend_attention"] = (share, _check_control(
        "extend main-path" + at, _plain_rounded_p(q, kp, vp, bt, pos0), want))
    qpos = pos0[:, None].long() + torch.arange(S, device=dev)[None, :]
    keep = (torch.arange(max_len, device=dev)[None, None, :] <=
            qpos[:, :, None])[:, None]
    sd = [_sdpa_args(s[0].transpose(1, 2).contiguous(), s[1], s[2], s[3],
                     keep) for s in esets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True).transpose(1, 2)
    _library_close("extend" + at, lib_out, want)
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


def _print_main_path(stats, shares, issue, label):
    for name, st in stats.items():
        if name not in shares:
            continue
        print(f"[kernels] {name}{label}: max_abs_err={st['max_abs_err']:.3e} "
              f"off_rounded={shares[name][0]:.4%} "
              f"(control with bf16 P: {shares[name][1]:.4%}) "
              f"ms={st['ms']:.4f} "
              f"plain_ms={st['plain_ms']:.4f} "
              f"library_ms={st['library_ms']:.4f} "
              f"bound_ms={st['bound_ms']:.4f} ({st['bound_by']}); "
              f"device ms from a CUDA graph replay; issued one by one "
              f"from Python: {issue[name]:.4f} ms per call")


def _other_heads(gen, dev, arch, heads, hd):
    """The four attention kernels at ``arch``'s heads and head dim, bf16,
    at phase 2's shapes and lengths, each held to the bf16 rule with its
    control and timed beside its bound and SDPA."""
    stats, shares, issue = {}, {}, {}
    _paged_main_path(gen, dev, heads, stats, shares, issue, hd)
    _dense_main_path(gen, dev, heads, stats, shares, issue, hd)
    H, KV = heads
    _print_main_path(stats, shares, issue,
                     f" at {arch}'s heads (H {H}, KV {KV}, G {H // KV}, "
                     f"hd {hd})")


def _admit_shapes(arch, paged):
    """(S, pos0) of each admit of phase 4's requests on ``arch``'s paged
    or dense engine, in order (``paged`` asks for the paged engine; an
    arch that cannot page serves dense): every admit is batch-1 (phase 4
    checks it), its S the engine's bucket for the prompt, or on the paged
    path for the suffix past a prefix hit: the third request extends past
    the 256 tokens it shares with the first, at pos0 256.  gemma3-4b adds
    a ninth request past its window (SERVE_LONG)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeConfig
    from repro_torch.serving.engine import EngineFns
    cfg = get_config(arch)
    paged = paged and tfm.paged_supported(cfg, 2048)
    fns = EngineFns(cfg, ServeConfig(max_len=SERVE_MAX_LEN.get(arch, 2048)))
    # the lengths alone are used
    _, _, prompts = _serve_prompts(2, SERVE_LONG.get(arch, 0))
    pos0 = [256 if paged and i == 2 else 0 for i in range(len(prompts))]
    return [(fns.bucket(len(p) - p0), p0) for p, p0 in zip(prompts, pos0)]


def _window_keep(S, window, dev):
    """(1, S, S) causal mask, with ``t > s - window`` where ``window``."""
    import torch
    keep = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    if window:
        keep &= torch.ones(S, S, dtype=torch.bool, device=dev).triu(
            1 - window)
    return keep[None]


def _local_window(arch) -> int:
    """The window of ``arch``'s local layers, 0 if it has none."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    local = any(k == "L" for g in cfg.groups for k in g.pattern)
    return cfg.window if local else 0


def _serve_admits(gen, dev, arch, heads, hd):
    """Flash and the paged extend (bs 16) at the admit shapes of ``arch``'s
    phase-4 serves, bf16, each held to the bf16 rule with its control: at
    G 8 and G 7 most of them leave the last 64-row tile of S x G query
    rows partly filled.  An arch with local layers runs flash also at
    their window where a prompt is longer than it; one that cannot page
    (gemma3-4b's rings) has no extend admits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tfm
    (H, KV), bf = heads, torch.bfloat16
    at = f"{arch} admit (H {H}, KV {KV}, hd {hd})"
    errs, ctls = [], []
    flash = sorted({S for S, _ in _admit_shapes(arch, False)})
    wl = _local_window(arch)
    for S in flash:
        q = _randn(gen, (1, S, H, hd), bf, dev)
        k, v = (_randn(gen, (1, S, KV, hd), bf, dev) for _ in range(2))
        for window in (0, wl) if wl and S > wl else (0,):
            want = ref.flash_attention_ref(*_f32(q, k, v), causal=True,
                                           window=window)
            name = f"flash {at} S={S} window={window}"
            errs.append(_compare(name, ops.flash_attention(
                q, k, v, causal=True, window=window), want)[0])
            ctls.append(_check_control(
                name, _rounded_p(q, k, v, _window_keep(S, window, dev)),
                want))
    paged = tfm.paged_supported(get_config(arch), 2048)
    extend = sorted(set(_admit_shapes(arch, True))) if paged else []
    for S, p0 in extend:
        q, kp, vp, bt = _paged_inputs(gen, 1, -(-(p0 + S) // 16), 16, KV, hd,
                                      (1, S, H, hd), bf, dev)
        pos0 = torch.tensor([p0], dtype=torch.int32, device=dev)
        want = ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt, pos0)
        name = f"extend {at} S={S} pos0={p0}"
        errs.append(_compare(name, ops.paged_extend_attention(
            q, kp, vp, bt, pos0), want)[0])
        ctls.append(_check_control(
            name, _plain_rounded_p(q, kp, vp, bt, pos0), want))
    windows = f" (and window {wl} past it)" if wl else ""
    print(f"[kernels] {at}: flash at B 1, S {flash}{windows} and the paged "
          f"extend at B 1, (S, pos0) {extend}, the shapes phase 4's serves "
          f"admit: "
          f"max_abs_err={max(errs):.3e}, each within the bf16 rule; the "
          f"bf16-P controls off the rounded result in {min(ctls):.4%} to "
          f"{max(ctls):.4%} of elements, each rejected")


#: the speculative verify's shape at phase 7's serve: 8 windows of d+1 = 4
#: queries at ragged positions 301-329 that are not block-aligned (318 and
#: 329 straddle a 16-row page), and one at 510 whose last two queries lie
#: past the table's 512 keys
VERIFY_POS0 = (301, 307, 314, 318, 322, 325, 329, 510)
VERIFY_NB = 32


def _flash_window(gen, dev, arch, heads, hd, window, S):
    """Flash at ``arch``'s local layers' sliding window over one prompt of
    ``S`` tokens, bf16: the bf16 rule, its control, kernel, plain and SDPA
    times (SDPA with the band as a boolean mask) and the bound, counting
    only the (query, key) pairs the window lets through."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (H, KV), bf = heads, torch.bfloat16
    fsets = [[_randn(gen, sh, bf, dev) for sh in
              ((1, S, H, hd), (1, S, KV, hd), (1, S, KV, hd))]
             for _ in range(3)]
    q, k, v = fsets[0]
    name = f"flash {arch} window {window} (1, {S}) H={H} KV={KV} hd={hd}"
    want = ref.flash_attention_ref(*_f32(q, k, v), causal=True,
                                   window=window)
    err, share = _compare(name, ops.flash_attention(q, k, v, causal=True,
                                                    window=window), want)
    keep = _window_keep(S, window, dev)
    ctl = _check_control(name, _rounded_p(q, k, v, keep), want)
    sd = [[t.transpose(1, 2).contiguous() for t in st] for st in fsets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0], attn_mask=keep[:, None], enable_gqa=True).transpose(1, 2)
    _library_close(name, lib_out, want)
    pairs = sum(min(s + 1, window) for s in range(S))
    st = _stats(
        err, (2 * S * H * hd + 2 * S * KV * hd) * 2, 4 * hd * H * pairs,
        "bfloat16",
        _time_ms([lambda s=s: ops.flash_attention(*s, causal=True,
                                                  window=window)
                  for s in fsets]),
        _time_ms([lambda s=s: ref.flash_attention_ref(*s, causal=True,
                                                      window=window)
                  for s in fsets], iters=3),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a, attn_mask=keep[:, None], enable_gqa=True) for a in sd]))
    print(f"[kernels] {name}: max_abs_err={err:.3e} off_rounded="
          f"{share:.4%} (control with bf16 P: {ctl:.4%}) ms={st['ms']:.4f} "
          f"plain_ms={st['plain_ms']:.4f} library_ms={st['library_ms']:.4f} "
          f"bound_ms={st['bound_ms']:.4f} ({st['bound_by']})")


def _verify_shape(gen, dev):
    """The paged extend at the verify shape (B 8, S 4, H 16, KV 8, hd 128,
    bs 16, a table of 32 blocks) against its plain version with the bf16
    rule and its control, with kernel, plain and SDPA times, the host's
    issue time and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, S, H, KV, hd, bs, nb = 8, 4, 16, 8, 128, 16, VERIFY_NB
    L = nb * bs
    pos0 = torch.tensor(VERIFY_POS0, dtype=torch.int32, device=dev)
    sets = [_paged_inputs(gen, B, nb, bs, KV, hd, (B, S, H, hd),
                          torch.bfloat16, dev) for _ in range(3)]
    q, kp, vp, bt = sets[0]
    out = ops.paged_extend_attention(q, kp, vp, bt, pos0)
    want = ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt, pos0)
    err, share = _compare("extend verify shape", out, want)
    ctl = _check_control("extend verify shape",
                         _plain_rounded_p(q, kp, vp, bt, pos0), want)
    qpos = pos0[:, None].long() + torch.arange(S, device=dev)[None, :]
    keep = (torch.arange(L, device=dev)[None, None, :] <=
            qpos[:, :, None])[:, None]
    sd = [_sdpa_args(s[0].transpose(1, 2).contiguous(), s[1], s[2], s[3],
                     keep) for s in sets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True).transpose(1, 2)
    _library_close("extend verify shape", lib_out, want)
    seen = [min(p + s + 1, L) for p in VERIFY_POS0 for s in range(S)]
    rows = [min(p + S, L) for p in VERIFY_POS0]     # keys each row needs
    by = (2 * sum(rows) * KV * hd * 2 + 2 * B * S * H * hd * 2
          + 4 * sum(-(-k // bs) for k in rows) + 4 * B)
    st = _stats(
        err, by, 4 * H * hd * sum(seen), "bfloat16",
        _time_ms([lambda s=s: ops.paged_extend_attention(
            s[0], s[1], s[2], s[3], pos0) for s in sets]),
        _time_ms([lambda s=s: ref.paged_extend_attention_ref(
            s[0], s[1], s[2], s[3], pos0) for s in sets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))
    issue = _issue_ms(lambda: ops.paged_extend_attention(q, kp, vp, bt, pos0))
    print(f"[kernels] paged_extend_attention at the verify shape (B 8, S 4, "
          f"pos0 {list(VERIFY_POS0)}, {L} keys a table, the last window "
          f"past it): max_abs_err={st['max_abs_err']:.3e} "
          f"off_rounded={share:.4%} (control with bf16 P: {ctl:.4%}) "
          f"ms={st['ms']:.4f} plain_ms={st['plain_ms']:.4f} "
          f"library_ms={st['library_ms']:.4f} bound_ms={st['bound_ms']:.4f} "
          f"({st['bound_by']}); issued one by one from Python: "
          f"{issue:.4f} ms per call")


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
# and one past a tile, two tiles and one past, and 200; G 1, 4, 8 (over 2
# and over 4 kv heads, qwen3-moe-30b-a3b's), 12 and 7 (internvl2-1b's; a
# tile's rows end inside a query position); the extend at bs 8 and 16
# with pos0 mid-page (the suffix and the last visible key straddle pages)
# and a row past the table's end, at G 4, 1, 12, 8 and 7.
FLASH_EDGE_S = (63, 64, 65, 129, 200)
FLASH_EDGE_G = ((8, 8), (16, 4), (16, 2), (24, 2), (32, 4), (14, 2))
EXTEND_EDGE_G = ((8, 2), (8, 8), (24, 2), (32, 4), (14, 2))
EXTEND_EDGES = ((8, 12, 37, (5, 21, 60)), (16, 6, 37, (13, 50, 70)),
                (8, 6, 20, (3, 40, 45)), (16, 4, 20, (0, 31, 60)))


def _attention_edges(gen, dev, hds=(32, 64, 128), extras=True):
    """The bf16 flash and extend kernels at the edge shapes above (head
    dims ``hds``), and with ``extras`` a long-prefix extend (one admit of
    256 tokens after 1,792 cached), then an extend whose pool rows that no
    row may see hold NaN, held against the plain version on the same pool
    with those rows zeroed (bs 16, 8, and 12, which the producer warp
    copies without TMA); each against the plain version's fp32 result at
    the bf16 limits."""
    import torch
    from repro_torch.kernels import ops, ref
    bf, n = torch.bfloat16, 0
    for hd in hds:
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
            for H, KV in EXTEND_EDGE_G:
                q, kp, vp, bt = _paged_inputs(gen, len(p0), nb, bs, KV, hd,
                                              (len(p0), S, H, hd), bf, dev)
                pos0 = torch.tensor(p0, dtype=torch.int32, device=dev)
                _compare(f"extend edge hd={hd} bs={bs} pos0={p0} G="
                         f"{H // KV}",
                         ops.paged_extend_attention(q, kp, vp, bt, pos0),
                         ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt,
                                                        pos0))
                n += 1
    if not extras:
        torch.cuda.synchronize()
        print(f"[kernels] attention edges at hd {hds}: {n} checks passed: "
              f"flash at S {FLASH_EDGE_S} x causal / window 64 / "
              f"bidirectional and (H, KV) {FLASH_EDGE_G} at S 129; extend "
              f"at (bs, nb, S, pos0) {EXTEND_EDGES} x (H, KV) "
              f"{EXTEND_EDGE_G}")
        return
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
          f"{FLASH_EDGE_S} x causal / window 64 / bidirectional and (H, KV) "
          f"{FLASH_EDGE_G} at S 129; extend at (bs, nb, S, pos0) "
          f"{EXTEND_EDGES} x (H, KV) {EXTEND_EDGE_G}; hd 32, 64 and 128; a "
          f"long-prefix extend (1, 256) at pos0 1792; "
          f"an extend whose unseen pool rows hold NaN (bs 16, "
          f"8, 12) equal to the plain version with them zeroed")


# The edge shapes of the split-key decode (chunks of decode_plan.CHUNK_KEYS
# keys a CTA), as tests/test_torch_decode_sm90.py holds the plain versions
# at them: lengths one short of, at and one past a chunk, one past two
# chunks, the longest row and a short row whose later chunks exit at once;
# pages (bs, nb) of 8, 16 and 32 rows, of 12 (straddling chunk ends) and
# of 128 (spanning two chunks); G 1, 4, 8 (one full row group, over 2 and
# over 4 kv heads), 12 (one full and one half-full), 16 (two) and 7 (one
# row short of a group).
DECODE_EDGE_PAGES = ((8, 40), (16, 20), (32, 10), (12, 27), (128, 3))
DECODE_EDGE_G = ((2, 2), (8, 2), (16, 2), (24, 2), (32, 2), (32, 4),
                 (14, 2))
#: hd 256: G 1 (gemma-7b), 2 (gemma3-4b), 10 (recurrentgemma-2b's MQA: one
#: full row group and one of 2) and 16 (two full groups)
DECODE_EDGE_G_256 = ((2, 2), (4, 2), (20, 2), (32, 2))


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


def _decode_edges(gen, dev, hds=(32, 64, 128), heads=DECODE_EDGE_G,
                  extra_hd=128):
    """Both decode kernels at the edge shapes above, fp32 and bf16, head
    dims ``hds`` and (H, KV) ``heads``; then at ``extra_hd``: a paged
    length past nb * bs with table entries past the pool, rows of length 0
    (paged: 0; dense: the mean of V), and caches whose rows past every
    live key hold NaN."""
    import torch

    def past_the_pool(bt, n):
        bt[0, 1], bt[2, 0], bt[3, -1] = n, n + 5, 2 ** 30

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for hd in hds:
            for bs, nb in DECODE_EDGE_PAGES:
                n += _paged_decode_case(
                    gen, dev, f"paged decode edge {dn} hd={hd} bs={bs}", bs,
                    nb, 4, 2, hd, dtype, _edge_lengths(nb * bs))
            for H, KV in heads:
                n += _paged_decode_case(
                    gen, dev, f"paged decode edge {dn} hd={hd} G={H // KV}",
                    16, 20, H, KV, hd, dtype, _edge_lengths(320))
                n += _dense_decode_case(
                    gen, dev, f"split-K decode edge {dn} hd={hd} "
                    f"G={H // KV}", 320, H, KV, hd, dtype, _edge_lengths(320))
        xh = extra_hd
        n += _paged_decode_case(
            gen, dev, f"paged decode clamped {dn} hd={xh}", 16, 9, 16, 8, xh,
            dtype, [100, 144, 145, 1000], table=past_the_pool)
        n += _paged_decode_case(
            gen, dev, f"paged decode length 0 {dn} hd={xh}", 16, 16, 16, 8,
            xh, dtype, [0, 200, 5, 0])
        n += _dense_decode_case(
            gen, dev, f"split-K decode length 0 {dn} hd={xh}", 256, 16, 8,
            xh, dtype, [0, 200, 5, 0])
        nan_lengths = [1, 127, 129, 257, 383]
        for bs in (16, 12):
            n += _paged_decode_case(
                gen, dev, f"paged decode NaN pool {dn} bs={bs} hd={xh}", bs,
                384 // bs, 16, 8, xh, dtype, nan_lengths, nan=True)
        n += _dense_decode_case(
            gen, dev, f"split-K decode NaN cache {dn} hd={xh}", 384, 16, 8,
            xh, dtype, nan_lengths, nan=True)
    torch.cuda.synchronize()
    print(f"[kernels] decode edges: {n} checks passed, fp32 and bf16: "
          f"lengths {_edge_lengths('max_keys')} over paged (bs, nb) "
          f"{DECODE_EDGE_PAGES} at G 2 and (H, KV) {heads} (bs 16; "
          f"dense L 320), hd {hds}; at hd {xh} a paged length past nb * bs "
          f"with table entries past the pool (read clamped); rows of length "
          f"0 (paged 0, dense the mean of V); caches whose rows past every "
          f"live key hold NaN (paged bs 16 and 12, dense) equal to the "
          f"plain version with them zeroed")


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


def _dense_main_path(gen, dev, heads, stats, shares, issue, hd=128):
    """Flash attention and split-K decode at the dense path's shapes, bf16,
    for ``heads`` = (H, KV) and head dim ``hd``: a causal prefill of B=3,
    S=512 and a decode of B=8 over L=2048 at ragged lengths, each on 3
    copies of its inputs for cold-L2 timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (H, KV), esz, bf = heads, 2, torch.bfloat16
    at = f" H={H} KV={KV} hd={hd}"

    B, S = 3, 512
    fsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
             for _ in range(3)]
    q, k, v = fsets[0]
    out = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(*_f32(q, k, v), causal=True)
    err, share = _compare("flash main-path" + at, out, want)
    keep = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    shares["flash_attention"] = (share, _check_control(
        "flash main-path" + at, _rounded_p(q, k, v, keep.expand(B, S, S)),
        want))
    sd = [[t.transpose(1, 2).contiguous() for t in st] for st in fsets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0], is_causal=True, enable_gqa=True).transpose(1, 2)
    _library_close("flash" + at, lib_out, want)
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

    B, L = 8, 2048
    lengths = torch.tensor([2048, 1, 1537, 300, 16, 977, 2000, 64],
                           dtype=torch.int32, device=dev)
    dsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, H, hd), (B, L, KV, hd), (B, L, KV, hd))]
             for _ in range(3)]
    q, k, v = dsets[0]
    out = ops.decode_attention(q, k, v, lengths)
    want = ref.decode_attention_ref(*_f32(q, k, v), lengths)
    err, share = _compare("split-K decode main-path" + at, out, want)
    keep = (torch.arange(L, device=dev)[None, :] <
            lengths[:, None].long())[:, None]           # (B, 1, L)
    shares["decode_attention"] = (share, _check_control(
        "split-K decode main-path" + at, _rounded_p(q[:, None], k, v, keep),
        want))
    sd = [(st[0][:, :, None], st[1].transpose(1, 2).contiguous(),
           st[2].transpose(1, 2).contiguous(), keep[:, None])
          for st in dsets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True)[:, :, 0]
    _library_close("split-K decode" + at, lib_out, want)
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


def _pair_check(name, C, E, W, w, b, control=False, route=None):
    """The kernel's pair score against the plain version run in fp64 on
    the same inputs, at max |kernel - fp64| <= PAIR_REL * max |fp64|, on
    the route the plan gives (which must be ``route`` when given); a
    second call on the same inputs must give the same bits; with
    ``control``, the plain version in fp32 with TF32 on must fail that
    limit.  Returns (max abs error, its share of max |fp64|, the
    control's share or None)."""
    import torch
    from repro_torch.kernels import ops, pair_plan, ref
    N, d = C.shape
    got = pair_plan.plan(N, E.shape[0], d, C.dtype, W.dtype).route
    check(route is None or got == route,
          f"{name}: planned on the {got} route, not {route}")
    link = {"W": W, "w": w, "bias": b}
    out = ops.pair_score(link, C, E)
    check(out.dtype == torch.float32 and
          tuple(out.shape) == (C.shape[0], E.shape[0]) and
          bool(torch.isfinite(out).all()), f"{name}: bad output")
    check(torch.equal(ops.pair_score(link, C, E), out),
          f"{name}: two calls on the same inputs differ")
    want = ref.pair_score_ref(*(t.double() for t in (C, E, W, w[:d], w[d:],
                                                     b)))
    scale = want.abs().max().item()
    err = (out.double() - want).abs().max().item()
    check(err <= PAIR_REL * scale, f"{name} ({got}): max |kernel - fp64| "
          f"{err:.3e} is {err / scale:.3e} of max |score|, limit {PAIR_REL}")
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
    shapes in fp32 and bf16 on both routes (the wgmma route's edges: N and
    M not multiples of its 128 x 128 tiles, a depth split with a ragged
    last chunk, d = 4k but not a multiple of 32), then the batch path's
    shape (256, 512, 1024) and the stream's (1024, 1024, 1024) in fp32 on
    MARGOT's features and on random inputs, each with the TF32 control;
    every call repeated for bit-identical scores; times at both shapes."""
    import torch
    from repro_torch.kernels import ops, pair_plan, ref
    worst = {"wgmma": 0.0, "simt": 0.0}
    n = 0
    for N, M, d in ((64, 128, 256), (100, 60, 128), (128, 128, 512),
                    (1, 1, 1024), (257, 513, 130), (100, 60, 132),
                    (257, 513, 1028)):
        for dtype in (torch.float32, torch.bfloat16):
            route = ("wgmma" if dtype == torch.float32 and d % 4 == 0
                     else "simt")
            name = f"pair_score ({N}, {M}, {d}) {str(dtype)[6:]}"
            _, rel, _ = _pair_check(
                name, *_pair_inputs(gen, dev, N, M, d, dtype), route=route)
            pl = pair_plan.plan(N, M, d, dtype, dtype)
            split = (f" (splits {pl.project.split} x {pl.project.per_split}"
                     f" / {pl.score.split} x {pl.score.per_split} steps)"
                     if pl.project else "")
            print(f"[kernels] {name}: route {route}{split}, |kernel - "
                  f"fp64| / max|score| {rel:.3e}")
            worst[route] = max(worst[route], rel)
            n += 1
    _, rel, _ = _pair_check("pair_score bf16 claims, fp32 W",
                            *_pair_inputs(gen, dev, 100, 60, 128,
                                          torch.bfloat16, torch.float32),
                            route="simt")
    worst["simt"] = max(worst["simt"], rel)
    print(f"[kernels] pair_score grid: {n + 1} checks (+ bf16 claims with "
          f"fp32 W on the simt route), each repeated bit for bit, passed: "
          f"max |kernel - fp64| <= {worst['wgmma']:.3e} (wgmma), "
          f"{worst['simt']:.3e} (simt) of max |score| (limit {PAIR_REL})")
    d = 1024
    for label, N, M in (("batch", 256, 512), ("stream", 1024, 1024)):
        read = {}
        for kind, args in (("margot", _margot_pair_inputs(dev, N, M)),
                           ("random", _pair_inputs(gen, dev, N, M, d,
                                                   torch.float32))):
            read[kind] = _pair_check(f"pair_score {label} {kind}", *args,
                                     control=True, route="wgmma")
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
            read["random"][0], by, n_ops, "tf32x3",
            _time_ms([lambda s=s: ops.pair_score(link(s), s[0], s[1])
                      for s in sets]),
            _time_ms([lambda s=s: ref.pair_score_ref(
                s[0], s[1], s[2], s[3][:d], s[3][d:], s[4]) for s in sets]),
            _time_ms([lambda s=s: _pair_library(*s) for s in sets]))
        iss = _issue_ms(lambda: ops.pair_score(link(sets[0]), C, E))
        core_ms = n_ops / PEAK_OPS["float32"] * 1e3
        pl = pair_plan.plan(N, M, d, torch.float32, torch.float32)
        print(f"[kernels] pair_score {label} ({N}, {M}, {d}) fp32, route "
              f"wgmma ({pl.project.ctas} + {pl.score.ctas} CTAs, splits "
              f"{pl.project.split} / {pl.score.split}), repeat calls bit-"
              f"identical: |kernel - fp64| / max|score| "
              f"margot={read['margot'][1]:.3e} random={read['random'][1]:.3e}"
              f", TF32 control margot={read['margot'][2]:.3e} "
              f"random={read['random'][2]:.3e} (limit {PAIR_REL}); "
              f"max_abs_err={st['max_abs_err']:.3e} ms={st['ms']:.4f} "
              f"plain_ms={st['plain_ms']:.4f} library_ms="
              f"{st['library_ms']:.4f} (cuBLAS GEMMs + elementwise, several "
              f"calls) bound_ms={st['bound_ms']:.4f} ({st['bound_by']}, "
              f"3xTF32 at 495/3 TFLOP/s; on the CUDA cores' 67 TFLOP/s "
              f"{core_ms:.4f}); issued one by one from Python: {iss:.4f} ms "
              f"per call")
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


def _chunk_zeroed(a, b, h0, period):
    """The control: the plain recurrence with the carry zeroed at every
    ``period``-step chunk boundary."""
    import torch
    hs, h = torch.empty_like(b), h0
    for t in range(a.shape[1]):
        if t and t % period == 0:
            h = torch.zeros_like(h)
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs, h


def _control_period(shape):
    """The control's period for a scan of ``shape``: the plan's chunk where
    the chunked kernel runs (a lost carry there fails the limit), else
    SCAN_CHUNK, the TPU kernel's chunk."""
    from repro_torch.kernels import scan_plan
    plan = scan_plan.split_plan(*shape)
    return plan.chunk if plan.n_chunks > 1 else SCAN_CHUNK


def _within(name, pairs):
    """Each (got, want) pair finite, of one shape and within atol = rtol =
    SCAN_TOL; returns the largest |got - want|."""
    import torch
    err = 0.0
    for got, w, what in pairs:
        check(got.shape == w.shape and bool(torch.isfinite(got).all()),
              f"{name} {what}: bad output")
        err = max(err, (got - w).abs().max().item())
        check(torch.allclose(got, w, atol=SCAN_TOL, rtol=SCAN_TOL),
              f"{name} {what}: max_abs_err {err:.3e} beyond atol=rtol="
              f"{SCAN_TOL}")
    return err


def _rejected(name, pairs):
    """The control's pairs must fail the SCAN_TOL limit, or the check could
    not see a lost carry; returns the control's largest error."""
    import torch
    check(not all(torch.allclose(c, w, atol=SCAN_TOL, rtol=SCAN_TOL)
                  for c, w in pairs),
          f"{name}: the chunk-zeroed control passes the limit {SCAN_TOL}: "
          f"the check cannot see the carry")
    return max((c - w).abs().max().item() for c, w in pairs)


def _scan_check(name, a, b, h0, control=False):
    """The kernel's (h_seq, h_final) against the plain version's on the
    same inputs at atol = rtol = SCAN_TOL; with ``control`` the
    chunk-zeroed recurrence (period: :func:`_control_period`) must fail
    that limit.  Returns (max abs error of both outputs, the control's max
    abs error or None)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    hs, hT = ss.ssm_scan_blocked(a, b, h0)
    torch.cuda.synchronize()
    want = ref.ssm_scan_ref(a, b, h0)
    err = _within(name, ((hs, want[0], "h_seq"), (hT, want[1], "h_final")))
    ctl = None
    if control:
        zs, zT = _chunk_zeroed(a, b, h0, _control_period(tuple(a.shape)))
        ctl = _rejected(name, ((zs, want[0]), (zT, want[1])))
    return err, ctl


#: the Mamba serve's prompt lengths in submit order: same lengths
#: adjacent, so each run of them shares one exact-length admit
MAMBA_PROMPTS = (512, 512, 512, 512, 1000, 256, 256, 100)


def _mamba_admits(lengths=MAMBA_PROMPTS):
    """(n, S) of each admit of prompts of ``lengths`` (the Mamba serve's),
    in order: the dense engine admits a run of one exact length as one
    batch (its 8 slots are all free when they arrive); phase 4 checks that
    it did."""
    return [(len(list(run)), S) for S, run in itertools.groupby(lengths)]


def _ssm_scan_checks(gen, dev, stats, issue):
    """The scan kernel at N 8 and 16 against its plain version: a grid of
    small shapes (N 8 and 16, S 1 and ragged, an odd D N and a misaligned
    view; the plan runs them on the chunked kernel, the odd and misaligned
    ones on its one-channel threads), then the Mamba serve's admit shapes
    on the single walk with the chunk-zeroed control and times, and the
    chunked kernel forced at the largest of them and over a sweep of
    channel counts (:func:`_scan_crossover`).  The Mamba serve's op runs
    the fused kernel (:func:`_fused_scan_checks`)."""
    import torch
    from repro_torch.kernels import ref, scan_plan
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
    plans = [scan_plan.split_plan(*g)[:2] for g in grid]
    print(f"[kernels] ssm_scan grid: {len(grid) + 1} checks over (B, S, D, "
          f"N) in {grid} (the plan's (chunk, n_chunks): {plans}) and a "
          f"view starting 4 bytes past a 16-byte boundary passed: max "
          f"|kernel - plain| {worst:.3e} (limit atol=rtol={SCAN_TOL})")
    # its own generator for an admit shape past these three, so that the
    # checks after this one keep their inputs from ``gen``
    own = torch.Generator(device=dev).manual_seed(25)
    for B, S in _mamba_admits():
        D, N = 8192, 16
        a, b, h0 = _scan_inputs(
            gen if (B, S) in ((4, 512), (1, 1000), (1, 100)) else own, dev,
            B, S, D, N)
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
        before = " (this design's earlier record: 1.0865)" \
            if (B, S) == (4, 512) else ""
        print(f"[kernels] ssm_scan ({B}, {S}, {D}, {N}) fp32, the single "
              f"walk (plan: {scan_plan.split_plan(B, S, D, N).n_chunks} "
              f"chunk): max_abs_err={err:.3e} (limit atol=rtol={SCAN_TOL}; "
              f"control with the carry zeroed every {SCAN_CHUNK} steps: "
              f"{ctl:.3e}) ms={st['ms']:.4f}{before} plain_ms="
              f"{st['plain_ms']:.4f} yardstick torch.cumsum(b_bar, dim=1) "
              f"ms={st['library_ms']:.4f} (one tensor read, one written: 2/3 "
              f"of the scan's bytes; no PyTorch call computes the "
              f"recurrence) bound_ms={st['bound_ms']:.4f} "
              f"({st['bound_by']}); issued one by one from Python: "
              f"{iss:.4f} ms per call")
        del a, b, h0
    torch.cuda.empty_cache()
    _scan_crossover(dev)


#: the crossover sweep's shapes at S 512, by single-walk threads (B ceil(D
#: N / 4)): recurrentgemma-2b's row (640), 4,096 to 65,536, the Mamba 4 x
#: 512 admit's (131,072)
CROSSOVER_SHAPES = ((1, 512, 2560, 1), (1, 512, 16384, 1),
                    (1, 512, 32768, 1), (1, 512, 65536, 1),
                    (1, 512, 131072, 1), (2, 512, 131072, 1),
                    (4, 512, 8192, 16))


def _scan_crossover(dev):
    """The scan's two kernels on the same inputs over a sweep of channel
    counts at S 512: the single walk (``scan_plan.FILL_THREADS`` patched to
    0) against the chunked kernel (patched above every shape), each held
    against the plain version and timed, beside the route the plan picks
    (it takes the single walk from ``FILL_THREADS`` threads up).  Its
    own generator: the checks after it keep their inputs."""
    import torch
    from repro_torch.kernels import scan_plan
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device=dev).manual_seed(26)
    rows = []
    for B, S, D, N in CROSSOVER_SHAPES:
        a, b, h0 = _scan_inputs(gen, dev, B, S, D, N)
        ms = {}
        for route, fill in (("single", 0), ("chunked", 2**62)):
            with mock.patch.object(scan_plan, "FILL_THREADS", fill):
                plan = scan_plan.split_plan(B, S, D, N)
                _scan_check(f"ssm_scan {route} ({B}, {S}, {D}, {N})", a, b,
                            h0)
                ms[route] = _time_ms(
                    [lambda: ss.ssm_scan_blocked(a, b, h0)], iters=5)
                if route == "chunked":
                    ctas = plan.n_chunks * B * plan.n_tiles
                    split = f"{plan.chunk} x {plan.n_chunks} chunks"
        picked = "chunked" if scan_plan.split_plan(B, S, D, N).n_chunks > 1 \
            else "single"
        threads = B * -(-D * N // 4)
        rows.append((threads, ms["single"], ms["chunked"], picked))
        print(f"[kernels] ssm_scan crossover ({B}, {S}, {D}, {N}): "
              f"{threads} single-walk threads ms={ms['single']:.4f}; chunked "
              f"({split}, {ctas} CTAs) ms={ms['chunked']:.4f}; both within "
              f"atol=rtol={SCAN_TOL} of the plain version; the plan takes "
              f"the {picked} kernel")
        del a, b, h0
    torch.cuda.empty_cache()
    faster = [t for t, single, chunked, _ in rows if single <= chunked]
    wrong = [t for t, single, chunked, picked in rows
             if picked != ("single" if single <= chunked else "chunked")]
    print(f"[kernels] ssm_scan crossover at S 512: the single walk is no "
          f"slower than the chunked kernel at "
          f"{faster or 'none'} single-walk threads of "
          f"{[t for t, *_ in rows]}; the plan's FILL_THREADS = "
          f"{scan_plan.FILL_THREADS} picks the slower kernel at "
          f"{wrong or 'none'}")


#: the fused kernel's stage (FCHUNK in csrc/selective_scan.cu): the
#: control zeroes the carry at its boundaries
FUSED_STAGE = 32
#: exponentials a clock on each SM (the special-function units), and SMs
SFU_PER_CLOCK, H100_SMS = 16, 132


def _fused_inputs(gen, dev, B, S, di, N, with_h0=True, dt_rank=7):
    """The op's inputs as the Mamba block makes them: softplus dt, A =
    -exp(.), Bc and Cc cut by ``torch.split`` from one projection (strided
    views, unit stride over N); fp32."""
    import torch
    import torch.nn.functional as F
    rnd = lambda *s: _randn(gen, s, torch.float32, dev)  # noqa: E731
    xc, dt = rnd(B, S, di), F.softplus(rnd(B, S, di))
    _, Bc, Cc = torch.split(rnd(B, S, dt_rank + 2 * N), [dt_rank, N, N],
                            dim=-1)
    A, D = -torch.exp(rnd(di, N)), rnd(di)
    return xc, dt, Bc, Cc, A, D, (rnd(B, di, N) if with_h0 else None)


def _compose(scan, xc, dt, Bc, Cc, A, D, h0=None):
    """The op as ``ops.ssm_scan`` composed it before the fused kernel:
    a_bar and b_bar built in torch, ``scan(a_bar, b_bar, h0)``, the C
    contraction by einsum.  With the scan kernel it is the route the fused
    kernel replaces; with :func:`_chunk_zeroed` it is the fused check's
    control."""
    import torch
    a_bar = (dt[..., None] * A).exp_()
    b_bar = (dt * xc)[..., None] * Bc[:, :, None, :]
    if h0 is None:
        h0 = torch.zeros((xc.shape[0], xc.shape[2], A.shape[-1]),
                         dtype=torch.float32, device=xc.device)
    h_seq, h_fin = scan(a_bar, b_bar, h0)
    return torch.einsum("bsdn,bsn->bsd", h_seq, Cc) + xc * D, h_fin


def _composed_route(*args, **kw):
    """The route the fused kernel replaces: :func:`_compose` around the
    scan kernel."""
    from repro_torch.kernels import ssm_scan as ss
    return _compose(ss.ssm_scan_blocked, *args, **kw)


def _fused_check(name, args, control=False):
    """The fused kernel's (y, h_final) against ``ref.selective_scan_ref``
    at SCAN_TOL; with ``control`` the carry zeroed every FUSED_STAGE steps
    must fail it.  Returns (max abs error, the control's or None)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    y, hT = ss.selective_scan_fused(*args)
    torch.cuda.synchronize()
    wy, wT = ref.selective_scan_ref(*args)
    err = _within(name, ((y, wy, "y"), (hT, wT, "h_final")))
    ctl = None
    if control:
        zy, zT = _compose(lambda a, b, h: _chunk_zeroed(a, b, h,
                                                        FUSED_STAGE), *args)
        ctl = _rejected(name, ((zy, wy), (zT, wT)))
    return err, ctl


def _sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.split()[0]
    return float(out) * 1e6


def _fused_scan_checks(gen, dev, stats, issue):
    """The fused selective scan (``ops.ssm_scan`` on a CUDA tensor) against
    its plain version: the CPU tests' grid (N 3, 8, 16 x S 1, 37, 130, with
    and without h0, Bc and Cc as strided ``torch.split`` views), the
    exponential's error, then the Mamba serve's admit shapes with the
    control, the peak memory of one call, and times: the kernel, the plain
    version, the route it replaces and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    worst, ctls, n = 0.0, [], 0
    for N in (3, 8, 16):
        for S in (1, 37, 130):
            for with_h0 in (False, True):
                args = _fused_inputs(gen, dev, 2, S, 64, N, with_h0)
                err, ctl = _fused_check(f"fused ssm_scan (2, {S}, 64, {N}) "
                                        f"h0 {with_h0}", args,
                                        control=S > FUSED_STAGE)
                worst, n = max(worst, err), n + 1
                ctls += [ctl] if ctl is not None else []
    print(f"[kernels] ssm_scan fused: {n} checks over (B 2, S 1/37/130, di "
          f"64, N 3/8/16) with and without h0, Bc and Cc strided views "
          f"passed: max |kernel - plain| over y and h_final {worst:.3e} "
          f"(limit atol=rtol={SCAN_TOL}); the controls (carry zeroed every "
          f"{FUSED_STAGE} steps) off by {min(ctls):.3e} to {max(ctls):.3e}, "
          f"each rejected")
    # the exponential alone: x = 0 and h0 = 1 at S = 1 leave h_final = a
    dt = torch.rand(1, 1, 64, device=dev, generator=gen) * 5
    A = -torch.rand(64, 16, device=dev, generator=gen) * 20
    Bc = torch.zeros(1, 1, 16, device=dev)
    _, a = ss.selective_scan_fused(torch.zeros_like(dt), dt, Bc, Bc, A,
                                   torch.zeros(64, device=dev),
                                   torch.ones(1, 64, 16, device=dev))
    want = torch.exp(dt[0, 0, :, None].double() * A.double())
    keep = want > 1e-30
    rel = ((a[0].double() - want).abs() / want)[keep].max().item()
    plain = ((torch.exp(dt[0, 0, :, None] * A).double() - want).abs() /
             want)[keep].max().item()
    check(rel < SCAN_TOL, f"fused ssm_scan: exp off by {rel:.3e} relative")
    print(f"[kernels] ssm_scan fused exp (ex2.approx.ftz.f32 of dt (A "
          f"log2 e)) over dt A in [-100, 0], values above 1e-30: max "
          f"relative error {rel:.3e} against fp64 exp (torch.exp in fp32: "
          f"{plain:.3e})")
    clock = _sm_clock_hz()
    for B, S in _mamba_admits():
        di, N = 8192, 16
        args = _fused_inputs(gen, dev, B, S, di, N)
        err, ctl = _fused_check(f"fused ssm_scan ({B}, {S}, {di}, {N})",
                                args, control=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ss.selective_scan_fused(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        n_el = B * S * di * N
        check(peak < 4 * n_el, f"fused ssm_scan ({B}, {S}): {peak} bytes "
              f"allocated, a (B, S, di, N) fp32 tensor is {4 * n_el}")
        by = 4 * (3 * B * S * di + 2 * B * S * N + di * N + di +
                  2 * B * di * N)
        n_ops = 6 * n_el + 3 * B * S * di
        t_exp = n_el / (SFU_PER_CLOCK * H100_SMS * clock) * 1e3
        st = _stats(err, by, n_ops, "float32",
                    _time_ms([lambda: ss.selective_scan_fused(*args)],
                             iters=10),
                    _time_ms([lambda: ref.selective_scan_ref(*args)],
                             iters=2), None)
        t_bytes = by / HBM_BPS * 1e3
        if t_exp > st["bound_ms"]:
            st.update(bound_ms=t_exp, bound_by="operations")
        route_ms = _time_ms([lambda: _composed_route(*args)], iters=2)
        iss = _issue_ms(lambda: ss.selective_scan_fused(*args), iters=10)
        print(f"[kernels] ssm_scan fused ({B}, {S}, {di}, {N}) fp32: "
              f"max_abs_err={err:.3e} (limit atol=rtol={SCAN_TOL}; control "
              f"with the carry zeroed every {FUSED_STAGE} steps: "
              f"{ctl:.3e}) ms={st['ms']:.4f} plain_ms={st['plain_ms']:.4f} "
              f"the route it replaces (a_bar, b_bar, the scan kernel, "
              f"einsum) ms={route_ms:.4f} bound_ms={st['bound_ms']:.4f} "
              f"(bytes {t_bytes:.4f}, fp32 operations "
              f"{n_ops / PEAK_OPS['float32'] * 1e3:.4f}, exponentials "
              f"{t_exp:.4f} at {SFU_PER_CLOCK} a clock x {H100_SMS} SMs x "
              f"{clock / 1e6:.0f} MHz: {'exponentials' if t_exp >= t_bytes else 'bytes'}"
              f" bind); peak allocation of a call {peak / 2**20:.1f} MiB "
              f"(a (B, S, di, N) fp32 tensor: {4 * n_el / 2**20:.1f} MiB); "
              f"issued one by one from Python: {iss:.4f} ms per call; "
              f"library_ms null (no PyTorch call computes the op)")
        if (B, S) == (4, 512):
            stats["ssm_scan_fused"] = dict(st, library_ms=None)
            issue["ssm_scan_fused"] = iss
        del args
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


def _reduced_two_layers(arch, **over):
    """``arch``'s fp32 reduced config, two layers deep (an arch of several
    layer kinds keeps reduced()'s groups: gemma3-4b's ten layers, local
    and global, in two scan groups), with the fields ``over`` replaced,
    and its seeded weights on the card."""
    import torch
    from repro_torch.configs import ScanGroup, get_config, reduced
    from repro_torch.models.weights import init_params
    dev = torch.device("cuda", 0)
    full = get_config(arch)
    cfg = reduced(full)
    if len(full.groups) == 1 and len(full.groups[0].pattern) == 1:
        cfg = cfg.replace(n_layers=2,
                          groups=(ScanGroup(full.groups[0].pattern, 2),))
    cfg = cfg.replace(**over)
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)


def _token_exact_paths(arch, paths=("paged", "dense"), extra=(), **over):
    """fp32, two-layer reduced ``arch`` (fields ``over`` replaced) on the
    paged and the dense engine (``paths``), each through the kernels and
    forced through the plain versions: the same tokens on each path both
    ways, and the same on both paths; ``extra`` adds prompts of those
    lengths after the others.  An
    MoE arch's paths agree on all but the last request, the one admitted
    after a prefix hit: the paged admit extends only its suffix, so the
    experts' capacity sees other rows, and it decodes beside a finished
    slot, whose token-0 row reads the finished sequence's stale cache on
    the dense path and the slot's nulled table row on the paged path, and
    takes capacity on both.  The others are admitted in pairs of equal
    ``max_new`` that finish together.  Returns the runner (``run(scfg, plain)`` -> requests,
    launches, plain calls, engine), the paged tokens and their count."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, ServeConfig
    dev = torch.device("cuda", 0)
    cfg, params = _reduced_two_layers(arch, **over)
    rng = np.random.RandomState(0)
    common = rng.randint(0, cfg.vocab, 16).astype(np.int32)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 9, 7, 12, 6)]
    prompts += [np.concatenate([common, rng.randint(0, cfg.vocab, n)])
                .astype(np.int32) for n in (4, 3)]
    prompts += [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
                for n in extra]

    def run(scfg, plain):
        ops.reset_counts()
        with _forced_plain(plain):
            eng = Engine(params, cfg, scfg, device=dev)
            reqs = _drain(eng, prompts, 6)
        return reqs, dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS), eng

    tokens, used = {}, {}
    for label, keys, scfg in (
            ("paged", PAGED_KERNELS, ServeConfig(
                max_len=64, slots=2, sync_every=4, paged=True,
                block_size=8)),
            ("dense", DENSE_KERNELS, ServeConfig(max_len=64, slots=2,
                                                 sync_every=4))):
        if label not in paths:
            continue
        kern, k_launch, k_plain, _ = run(scfg, plain=False)
        check(all(k_launch[k] > 0 for k in keys) and
              sum(k_launch.values()) == sum(k_launch[k] for k in keys) and
              not any(k_plain.values()),
              f"{arch} {label} kernel run: launches {k_launch}, plain "
              f"{k_plain}")
        plain, p_launch, p_plain, _ = run(scfg, plain=True)
        check(all(p_plain[k] > 0 for k in keys) and
              not any(p_launch.values()),
              f"{arch} {label} plain run: launches {p_launch}, plain "
              f"{p_plain}")
        for i, (a, b) in enumerate(zip(kern, plain)):
            check(a.out_tokens == b.out_tokens and
                  a.finish_reason == b.finish_reason,
                  f"{arch} {label} request {i}: kernel {a.out_tokens} "
                  f"({a.finish_reason}) != plain {b.out_tokens} "
                  f"({b.finish_reason})")
        tokens[label] = [(r.out_tokens, r.finish_reason) for r in kern]
        used[label] = {k: k_launch[k] for k in keys}
    coupled = any(k == "M" for g in cfg.groups for k in g.pattern)
    agree = len(prompts) - 1 if coupled else len(prompts)
    if len(paths) == 2:
        check(tokens["dense"][:agree] == tokens["paged"][:agree],
              f"{arch}: dense tokens {tokens['dense'][:agree]} != paged "
              f"{tokens['paged'][:agree]}")
    n_tok = sum(len(t) for t, _ in tokens[paths[-1]])
    between = "and between the two paths" if not coupled else \
        f"and on the first {agree} requests between the two paths (the " \
        f"last, after a prefix hit: paged == dense " \
        f"{tokens['dense'][-1] == tokens['paged'][-1]}, not a gate)"
    if len(paths) == 1:
        between = f"(the {paths[0]} path alone)"
    window = f", window {cfg.window}" if cfg.window else ""
    print(f"[token-exact] {arch} fp32 {cfg.n_layers}-layer reduced (H "
          f"{cfg.n_heads}, KV {cfg.n_kv_heads}, hd {cfg.head_dim}{window}, "
          f"{cfg.norm}, {cfg.mlp}, {cfg.family}): {len(prompts)} requests "
          f"of {[len(p) for p in prompts]} tokens, {n_tok} tokens identical "
          f"through the kernels and the plain versions on " +
          " and ".join(f"the {p} path ({used[p]})" for p in paths) +
          f", {between}")
    return run, tokens.get("paged"), n_tok


def phase_token_exact():
    """fp32, two-layer reduced configs: on each path the kernels give the
    plain versions' tokens, and the dense path the paged path's; for
    internlm2-1.8b also the speculative paged engine, for falcon-mamba-7b
    the scan."""
    from repro_torch.serving import ServeConfig
    run, paged_tokens, n_tok = _token_exact_paths("internlm2-1.8b")
    _token_exact_paths("starcoder2-3b")
    _token_exact_paths("internvl2-1b")
    _token_exact_gemma()
    _token_exact_moe()
    # speculative decode: every verify window runs the paged extend, and
    # greedy tokens are the non-speculative ones on either route
    spec = ServeConfig(max_len=64, slots=2, sync_every=4, paged=True,
                       block_size=8, speculative=True)
    for plain in (False, True):
        reqs, launch, calls, _ = run(spec, plain)
        used, unused = (calls, launch) if plain else (launch, calls)
        label = "plain" if plain else "kernel"
        check(used["paged_extend_attention"] > 0 and
              sum(used.values()) == used["paged_extend_attention"] and
              not any(unused.values()),
              f"speculative {label} run: launches {launch}, plain {calls}")
        got = [(r.out_tokens, r.finish_reason) for r in reqs]
        check(got == paged_tokens,
              f"speculative {label} tokens {got} != paged {paged_tokens}")
        if not plain:
            n_ext = launch["paged_extend_attention"]
    print(f"[token-exact] fp32 2-layer reduced, paged speculative (d=3): "
          f"the same {n_tok} tokens through the kernels ({n_ext} paged "
          f"extend launches, no paged decode) and the plain versions")
    _token_exact_mamba()
    _token_exact_recurrentgemma()


def _token_exact_gemma():
    """fp32 reduced gemma-7b (two layers, GeGLU, MHA) paged and dense, and
    gemma3-4b (its ten local and global layers, window 16) dense, each
    kernel against plain, at the reduced head dim 16 and at 256, so that
    the fp32 kernels run at hd 256 on a real path.  gemma3's prompts of
    19, 20 and 40 tokens pass its window, so flash's window mask and the
    local layers' rings wrap in the prefill, and decoding past 16
    positions wraps them in the decode; with 2 slots, later requests reuse
    the slots of longer ones."""
    for hd in (16, 256):
        _token_exact_paths("gemma-7b", head_dim=hd)
        _token_exact_paths("gemma3-4b", paths=("dense",), extra=(40,),
                           head_dim=hd)


def _token_exact_moe():
    """fp32, two-layer reduced qwen3-moe-30b-a3b (8 experts, top-2, qk-norm)
    paged and dense, kernel against plain, with every admit batch-1; then
    the paged engine with ``speculative=True``: it falls back (counted
    once) and gives the paged tokens through the kernels."""
    from repro_torch.cluster import tracing
    from repro_torch.serving import ServeConfig
    arch = "qwen3-moe-30b-a3b"
    seq0 = tracing.current_recorder().last_seq
    run, paged_tokens, n_tok = _token_exact_paths(arch)
    admits = [e["n"] for e in tracing.current_recorder().events()
              if e["seq"] > seq0 and e["kind"] == "admit"]
    check(admits and set(admits) == {1},
          f"{arch}: admit batches {admits}, expected all batch-1")
    spec = ServeConfig(max_len=64, slots=2, sync_every=4, paged=True,
                       block_size=8, speculative=True)
    reqs, launch, calls, eng = run(spec, False)
    got = [(r.out_tokens, r.finish_reason) for r in reqs]
    fallback = eng.metrics.counter("engine.spec_fallback").value
    check(eng.paged and not eng.speculative and fallback == 1 and
          launch["paged_decode_attention"] > 0 and not any(calls.values()),
          f"{arch} speculative: paged {eng.paged}, speculative "
          f"{eng.speculative}, spec_fallback {fallback}, launches {launch}, "
          f"plain {calls}")
    check(got == paged_tokens,
          f"{arch} speculative tokens {got} != paged {paged_tokens}")
    print(f"[token-exact] {arch} with speculative=True: falls back to "
          f"paged decode (engine.speculative False, spec_fallback "
          f"{fallback}), the same {n_tok} tokens; {len(admits)} admits, "
          f"all batch-1")
    _moe_never_syncs(arch)


def _moe_never_syncs(arch):
    """One MoE FFN call at an 8-slot decode's shape with CUDA's sync
    debug mode set to error: the router, the dispatch and the combine
    read nothing back to the host, so a decode step stays capturable."""
    import torch
    from repro_torch.models import moe
    cfg, params = _reduced_two_layers(arch)
    ffn = {k: v[0] for k, v in params["groups"][0][0]["ffn"].items()}
    x = torch.randn(8, 1, cfg.d_model, device=torch.device("cuda", 0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe.apply_moe(ffn, x, cfg)
    except RuntimeError as e:
        fail(f"apply_moe synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux)),
          "apply_moe gave non-finite values")
    print(f"[token-exact] {arch} apply_moe at (8, 1, {cfg.d_model}) under "
          f"torch.cuda.set_sync_debug_mode('error'): no synchronising op "
          f"detected")


def _token_exact_mamba():
    """fp32, two-layer reduced falcon-mamba-7b on the dense engine: the
    scan kernel gives the plain version's tokens, on prompts of 130 tokens
    (at and past the JAX kernel gate, S >= 128) and of 100 (not a
    multiple of the TPU kernel's 64-step chunk)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, ServeConfig
    dev = torch.device("cuda", 0)
    cfg, params = _reduced_two_layers("falcon-mamba-7b")
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


def _token_exact_recurrentgemma():
    """fp32 reduced recurrentgemma-2b with its first scan group at 2
    repeats, ``(R, R, L) x 2 + (R, R) x 1`` (6 RG-LRU and 2 local layers,
    R > 1 for both kinds; MQA, hd 16, window 16), max_len 48, on the dense
    engine through the kernels and forced through the plain versions: the
    same tokens, with flash 2 and ``ssm_scan`` 6 a prefill batch and the
    split-K decode 2 a step.  Prompts of 1, 2 and 3 tokens (shorter than
    the conv's K-1 = 3, or equal) and past the window, same lengths
    adjacent; then the paged engine asked for once: it serves dense, with
    the same tokens and the fallback counted."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import ScanGroup, get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models.weights import init_params
    from repro_torch.serving import Engine, ServeConfig
    dev = torch.device("cuda", 0)
    arch = RG_HEADS[0]
    cfg = reduced(get_config(arch)).replace(
        n_layers=8, groups=(ScanGroup(("R", "R", "L"), 2),
                            ScanGroup(("R", "R"), 1)))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (20, 20, 1, 2, 3, 3, 25, 1, 40)]
    n_attn = sum(k == "L" for g in cfg.groups for k in g.pattern * g.repeats)
    n_scan = cfg.n_layers - n_attn
    runs = {}
    for label, plain, extra in (("kernel", False, {}), ("plain", True, {}),
                                ("paged asked", False,
                                 dict(paged=True, block_size=8))):
        ops.reset_counts()
        with _forced_plain(plain):
            eng = Engine(params, cfg, ServeConfig(max_len=48, slots=2,
                                                  sync_every=4, **extra),
                         device=dev)
            reqs = _drain(eng, prompts, 8)
        launches, calls = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
        batches = eng.metrics.counter("engine.prefill_batches").value
        fallback = eng.metrics.counter("engine.paged_fallback_dense").value
        used, unused = (calls, launches) if plain else (launches, calls)
        check(used["flash_attention"] == n_attn * batches and
              used["ssm_scan"] == n_scan * batches and
              used["decode_attention"] > 0 and
              used["decode_attention"] % n_attn == 0 and
              sum(used.values()) == sum(used[k] for k in
                                        DENSE_KERNELS + SSM_KERNELS) and
              not any(unused.values()) and not eng.paged and
              fallback == int("paged" in extra),
              f"{arch} {label} run: launches {launches}, plain {calls}, "
              f"prefill batches {batches}, paged {eng.paged}, "
              f"paged_fallback_dense {fallback}")
        runs[label] = [(r.out_tokens, r.finish_reason) for r in reqs]
        if label == "kernel":
            counts = {k: launches[k] for k in DENSE_KERNELS + SSM_KERNELS}
    for label in ("plain", "paged asked"):
        check(runs[label] == runs["kernel"],
              f"{arch}: {label} tokens {runs[label]} != kernel "
              f"{runs['kernel']}")
    print(f"[token-exact] {arch} fp32 {cfg.n_layers}-layer reduced ((R, R, "
          f"L) x 2 + (R, R); H {cfg.n_heads}, KV {cfg.n_kv_heads}, hd "
          f"{cfg.head_dim}, window {cfg.window}, lru_width "
          f"{cfg.lru_width}), dense engine, max_len 48: {len(prompts)} "
          f"requests of {[len(p) for p in prompts]} tokens, "
          f"{sum(len(t) for t, _ in runs['kernel'])} tokens identical "
          f"through the kernels ({counts} in {batches} prefill batches) and "
          f"the plain versions, and asked for the paged engine (served "
          f"dense, paged_fallback_dense 1)")


# ----------------------------------------------------------------------
def phase_serve():
    """internlm2-1.8b at full width through the paged path, then through
    the dense path, then starcoder2-3b (G 12), internvl2-1b (G 7, hd 64)
    and gemma-7b (G 1, hd 256) the same two ways, gemma3-4b (G 2, hd 256)
    and recurrentgemma-2b (G 10, hd 256, RG-LRU) asked for the paged
    engine (they serve dense), falcon-mamba-7b, and
    qwen3-moe-30b-a3b (G 8, 128 experts) both ways; returns each kernel's
    launches in internlm2's run of its path (the scan kernel's in
    recurrentgemma-2b's, the fused scan's in falcon-mamba-7b's), and the
    paged run's tokens."""
    launches, paged_tokens = _serve_path(True)
    launches.update(_serve_path(False)[0])
    for arch in ("starcoder2-3b", "internvl2-1b", "gemma-7b"):
        for paged in (True, False):
            _serve_path(paged, arch)
    # gemma3-4b's rings cannot page: asked for the paged engine, it serves
    # dense, counted in engine.paged_fallback_dense
    _serve_path(True, "gemma3-4b")
    # nor can recurrentgemma-2b's RG-LRU state and rings (max_len 4096);
    # its RG-LRU recurrence is the scan kernel's path, Mamba's op the fused
    # kernel's (both count under ssm_scan; the profiles name each kernel)
    launches["ssm_scan"] = _serve_path(True, "recurrentgemma-2b")[0][
        "ssm_scan"]
    launches["ssm_scan_fused"] = _serve_mamba()["ssm_scan"]
    # 57 GiB of weights: served last, each engine alone on the card
    for paged in (True, False):
        _serve_path(paged, "qwen3-moe-30b-a3b")
    return launches, paged_tokens


#: phase 4's ninth request, by arch: gemma3-4b's prompt past its 1,024-key
#: window, so that flash's window bites at full width and the local
#: layers' rings wrap in the prefill and in the decode
SERVE_LONG = {"gemma3-4b": 1100, "recurrentgemma-2b": 2200}

#: phase 4's max_len, by arch (2048 for the others): recurrentgemma-2b's
#: local layers keep rings only where the window (2048) is shorter
SERVE_MAX_LEN = {"recurrentgemma-2b": 4096}


def _serve_prompts(vocab, long=0):
    """Phase 4's requests, drawn from one seeded stream: ``tok(n)`` draws
    n more tokens; a warm-up prompt, then 8 prompts of 16-512 tokens, two
    sharing a 256-token prefix, and with ``long`` a ninth of ``long``
    tokens.  A request of another bucket sits between those two, so the
    second is admitted after the first published the prefix."""
    import numpy as np
    rng = np.random.RandomState(1)
    tok = lambda n: rng.randint(0, vocab, n).astype(np.int32)  # noqa
    warm = tok(40)
    prefix = tok(256)
    prompts = [np.concatenate([prefix, tok(44)]), tok(16),
               np.concatenate([prefix, tok(100)]), tok(64), tok(512),
               tok(200), tok(33), tok(128)]
    if long:
        prompts.append(tok(long))
    return tok, warm, prompts


def _serve_path(paged: bool, arch: str = "internlm2-1.8b"):
    """``arch`` at full width (bf16, seeded weights) through the paged or
    the dense engine at phase 4's settings: the requests, the path's
    launch counts read right after them (one a layer per admit batch and
    per decode step, no other kernel, no plain call; an MoE arch's admits
    all batch-1; a recurrent layer's scan once per admit batch), then one
    profiled decode sync (and for an RG-LRU arch its long admit); returns
    (launches, tokens).  An arch that cannot page (gemma3-4b's rings,
    recurrentgemma-2b's state) asked for the paged engine must serve dense
    and count the fallback once.  max_len is 2048, or the arch's
    SERVE_MAX_LEN."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.cluster import tracing
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda", 0)
    max_len = SERVE_MAX_LEN.get(arch, 2048)
    asked, paged = paged, paged and tfm.paged_supported(get_config(arch),
                                                         max_len)
    label = "paged" if paged else "dense"
    if asked and not paged:
        label = "dense fallback"
    if arch != "internlm2-1.8b":
        label = f"{arch} {label}"
    # layers of a recurrent kind (RG-LRU) scan their admits on the scan
    # kernel; the others run attention
    n_scan = sum(k in ("R", "S") for g in get_config(arch).groups
                 for k in g.pattern * g.repeats)
    keys = (PAGED_KERNELS if paged else DENSE_KERNELS) + \
        (SSM_KERNELS if n_scan else ())
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated(dev) < 2**30,
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still "
          f"allocated before the {label} serve")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = build_engine(arch, max_len=max_len, slots=8, sync_every=8,
                       paged=asked, block_size=16, seed=0, device=dev)
    torch.cuda.synchronize()
    init_mem = torch.cuda.memory_allocated(dev)
    cfg = eng.cfg
    n_params = sum(t.numel() for t in _leaves(eng.params))
    fallback = eng.metrics.counter("engine.paged_fallback_dense").value
    fp32 = sorted({k for g in eng.params["groups"] for layer in g
                   for k, t in layer["mixer"].items()
                   if t.dtype == torch.float32})
    check(cfg == get_config(arch) and
          eng.params["embedding"]["table"].dtype == torch.bfloat16 and
          fp32 == (["lambda"] if cfg.lru_width else []) and
          eng.paged == paged and fallback == int(asked and not paged),
          f"{arch}: not the full-width bf16 config on the {label} engine "
          f"(engine.paged {eng.paged}, paged_fallback_dense {fallback}, "
          f"fp32 mixer leaves {fp32})")
    rings = sorted({c["k"].shape[2] for g in eng.caches for c in g
                    if "pos" in c}) if not paged else []
    kv = (f"pool {eng.alloc.num_blocks} blocks x 16" if paged else
          f"dense caches 8 x {max_len}" +
          (f", local layers' rings of {rings} rows" if rings else "") +
          (f", {n_scan} RG-LRU layers' fp32 state, lambda fp32"
           if cfg.lru_width else "") +
          (f", paged_fallback_dense {fallback}" if asked else ""))
    ffn = (f"{cfg.n_experts} experts top-{cfg.top_k}, expert d_ff "
           f"{cfg.expert_d_ff}" if cfg.n_experts else f"d_ff {cfg.d_ff}")
    print(f"[serve {label}] built {arch} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv "
          f"heads, hd {cfg.head_dim}, {ffn}, {cfg.norm}, {cfg.mlp}, "
          f"qk_norm {cfg.qk_norm}, vocab {cfg.vocab}, tied "
          f"{cfg.tie_embeddings}, {n_params / 1e9:.3f} B parameters, bf16, "
          f"{kv}) in {time.perf_counter() - t0:.1f}s; device memory "
          f"{init_mem / 2**30:.2f} GiB, peak during "
          f"the init {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    tok, warm, prompts = _serve_prompts(cfg.vocab, SERVE_LONG.get(arch, 0))
    # warm-up request (cuBLAS handles, allocator), then the measured run
    _drain(eng, [warm], 8)
    max_new = 32
    counter = lambda name: eng.metrics.counter(name).value  # noqa: E731
    hits0, syncs0, batches0 = (counter(f"engine.{k}") for k in (
        "prefix_hit_blocks", "steps", "prefill_batches"))
    seq0 = tracing.current_recorder().last_seq
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = _drain(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
    hits = counter("engine.prefix_hit_blocks") - hits0
    syncs = counter("engine.steps") - syncs0
    batches = counter("engine.prefill_batches") - batches0
    admits = [(e["n"], e["bucket"]) for e in tracing.current_recorder()
              .events() if e["seq"] > seq0 and e["kind"] == "admit"]
    shapes = [(1, S) for S, _ in _admit_shapes(arch, paged)]
    check(admits == shapes,
          f"{label}: admits (n, bucket) {admits}, expected {shapes}, the "
          f"shapes phase 2 held the kernels to")
    admits = [n for n, _ in admits]
    for r in reqs:
        check(r.finish_reason == "max_new" and
              len(r.out_tokens) == max_new + 1 and
              all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.rid}: {r.finish_reason}, {r.out_tokens}")
    # one launch an attention layer for each admit batch (extend or flash)
    # and for each of the 8 decode steps of a sync (paged or split-K
    # decode), one a recurrent layer for each admit batch (the scan)
    n_attn = cfg.n_layers - n_scan
    want = {keys[0 if paged else 1]: n_attn * 8 * syncs,
            keys[1 if paged else 0]: n_attn * batches}
    if n_scan:
        want["ssm_scan"] = n_scan * batches
    check(all(launches[k] == want[k] for k in keys) and
          sum(launches.values()) == sum(launches[k] for k in keys),
          f"{label}: launches {launches}, expected {want} ({syncs} syncs, "
          f"{batches} admit batches) and no other kernel")
    check(not any(plain.values()), f"{label}: plain versions ran: {plain}")
    check(len(admits) == batches and sum(admits) == len(reqs),
          f"{label}: admit events {admits} against {batches} admit batches")
    if eng.fns.row_coupled:
        check(set(admits) == {1}, f"{label}: MoE admits {admits} are not "
              f"all batch-1")
    if paged:
        check(hits >= 16, f"prefix cache hit {hits} blocks, expected >= 16")
        check(eng.alloc.free_blocks + eng.alloc.cached_blocks ==
              eng.alloc.num_blocks, "blocks leaked")
    gen = sum(r.decoded for r in reqs)
    ttft = sorted(r.first_token_t - r.submit_t for r in reqs)
    print(f"[serve {label}] {arch} {len(reqs)} requests "
          f"({sum(len(p) for p in prompts)} prompt tokens) max_new={max_new}"
          f": wall={wall:.3f}s decoded={gen} tok/s={gen / wall:.1f} "
          f"ttft_p50={ttft[len(ttft) // 2]:.3f}s ttft_max={ttft[-1]:.3f}s "
          f"prefix_hit_blocks={hits} "
          f"launches={launches} (= {n_attn} attention layers x {syncs} "
          f"syncs x 8 steps, x {batches} admit batches" +
          (f"; {n_scan} RG-LRU layers x {batches} admit batches"
           if n_scan else "") + f") plain_calls={plain} "
          f"admit batch sizes={admits} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}GiB")
    _profile_decode_sync(eng, tok, label)
    if cfg.lru_width:
        _profile_long_admit(eng, tok, label)
    tokens = [r.out_tokens for r in reqs]
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in keys}, tokens


def _leaves(tree):
    """The tensors of a nested parameter tree."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _serve_mamba():
    """falcon-mamba-7b at full width on the dense engine, after the
    internlm2 engines are freed; returns the scan's launches in the run."""
    import gc

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.cluster import tracing
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
    prompts = [tok(n) for n in MAMBA_PROMPTS]
    max_new = 32
    b0 = eng.metrics.counter("engine.prefill_batches").value
    seq0 = tracing.current_recorder().last_seq
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = _drain(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
    batches = eng.metrics.counter("engine.prefill_batches").value - b0
    admits = [(e["n"], e["bucket"]) for e in tracing.current_recorder()
              .events() if e["seq"] > seq0 and e["kind"] == "admit"]
    check(admits == _mamba_admits(),
          f"mamba: admits (n, S) {admits}, expected {_mamba_admits()}, the "
          f"shapes phase 2 held the scan kernels to")
    for r in reqs:
        check(r.finish_reason == "max_new" and
              len(r.out_tokens) == max_new + 1 and
              all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.rid}: {r.finish_reason}, {r.out_tokens}")
    check(batches == len(admits) and launches["ssm_scan"] == 64 * batches
          and sum(launches.values()) == launches["ssm_scan"],
          f"mamba: launches {launches} in {batches} prefill batches, "
          f"expected ssm_scan = 64 x {len(admits)} and no other kernel")
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


def _scan_kernels(rows):
    """The names of the scan kernels among a profile's rows."""
    return sorted({re.search(r"ssm_scan\w*kernel", name)[0]
                   for _, _, name in rows if "ssm_scan" in name})


def _profile_admit(eng, tok):
    """One admit of 4 x 512 tokens (64 layers) on the host clock, then the
    next one under ``torch.profiler`` with the device memory before it and
    its peak: the scan's device time against what runs around it in
    torch; then the same admit on the route the fused kernel replaced
    (``ops.ssm_scan`` patched to a_bar, b_bar, the scan kernel and einsum),
    profiled the same way: the broadcast multiplies that build a_bar and
    b_bar, the exp of a_bar, the C contraction (a batched GEMV)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    dev = eng.device

    def submit_and_admit():
        for _ in range(4):
            eng.submit(tok(512), max_new=1)
        eng._admit_fused()
        torch.cuda.synchronize()

    def admit():
        submit_and_admit()
        eng.run_until_drained()

    busy = {}
    for route, patch in (("fused", contextlib.nullcontext()),
                         ("composed", mock.patch.object(
                             ops, "ssm_scan", _composed_route))):
        with patch:
            admit()
            t0 = time.perf_counter()
            admit()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                submit_and_admit()
                wall_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(dev)
            eng.run_until_drained()
        busy_us, rows, top = _device_time(prof, f"mamba_admit_{route}")
        want = ["ssm_scan_fused_kernel"] if route == "fused" else \
            ["ssm_scan_kernel"]
        check(_scan_kernels(rows) == want, f"mamba {route} admit: scan "
              f"kernels {_scan_kernels(rows)}, expected {want}")
        share = dict.fromkeys(("scan", "mul", "exp", "gemv", "gemm",
                               "other"), 0.0)
        for us, _, name in rows:
            low = name.lower()
            kind = ("scan" if "ssm_scan" in low else
                    "mul" if "mulfunctor<float> > >" in low and
                    "binaryfunctor<float" in low else
                    "exp" if "exp_kernel" in low else
                    "gemv" if "gemv" in low else
                    "gemm" if any(k in low for k in ("nvjet", "gemm",
                                                     "cutlass", "xmma")) else
                    "other")
            share[kind] += us / 1e3
        busy[route] = busy_us / 1e3
        what = ("the fused kernel" if route == "fused" else
                "the route it replaced: a_bar, b_bar, the scan kernel, "
                "einsum")
        print(f"[profile mamba admit] {what}: one admit of 4 x 512 tokens "
              f"(64 layers): unprofiled wall {host_ms:.2f}ms with its "
              f"one-token drain; profiled admit wall={wall_ms:.2f}ms "
              f"device_busy={busy_us / 1e3:.2f}ms idle_share="
              f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f} kernels="
              f"{sum(n for _, n, _ in rows)}; device memory before "
              f"{before / 2**30:.2f} GiB, peak during the admit "
              f"{peak / 2**30:.2f} GiB (+{(peak - before) / 2**30:.2f}); "
              f"device ms by kind: " +
              ", ".join(f"{k} {v:.2f}" for k, v in share.items()) +
              f"; top: {top}")
    print(f"[profile mamba admit] device busy fused / replaced route: "
          f"{busy['fused']:.2f} / {busy['composed']:.2f} ms "
          f"({busy['fused'] / busy['composed']:.3f}x)")


def _kind_ms(rows):
    """Device ms of a profile's kernel rows by kind: the scan kernel,
    flash, the decode attention kernels, fp32 GEMMs (the RG-LRU gate
    products: cuBLAS's fp32 kernels, TF32 off; a CUDA-core ``sgemm`` at
    an admit, a ``gemvx`` over floats at a decode step), the other GEMMs
    (bf16), copies (the casts, among them the gates' fp32 copies of
    ``w_a`` and ``w_i``) and the rest."""
    kinds = dict.fromkeys(("scan", "flash", "decode attention",
                           "fp32 GEMMs", "bf16 GEMMs", "copies/casts",
                           "other"), 0.0)
    for us, _, name in rows:
        low = name.lower()
        gemm = any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma",
                                      "gemv"))
        fp32 = any(k in low for k in ("sgemm", "f32f32_f32f32", "nvjet_sss",
                                      "kernel<int, int, float,"))
        kind = ("scan" if "ssm_scan" in low else
                "flash" if "flash" in low or "attention_sm90" in low else
                "decode attention" if "decode" in low else
                "fp32 GEMMs" if gemm and fp32 else
                "bf16 GEMMs" if gemm else
                "copies/casts" if "copy" in low else "other")
        kinds[kind] += us / 1e3
    return kinds


def _profile_long_admit(eng, tok, label):
    """The serve's long admit (one prompt of SERVE_LONG tokens, past the
    2,048-key window) on the host clock, then the next one under
    ``torch.profiler``: device ms by kind (:func:`_kind_ms`); then the
    RG-LRU gates of one layer alone (``rglru._gates``: the two fp32
    products with their fp32 copies of ``w_a`` and ``w_i``) at the
    admit's and a decode step's shapes, device ms from a CUDA graph, and
    the bytes those copies move."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import rglru
    S = SERVE_LONG[RG_HEADS[0]]

    def admit():
        eng.submit(tok(S), max_new=1)
        eng._admit_fused()
        torch.cuda.synchronize()

    admit()
    eng.run_until_drained()
    t0 = time.perf_counter()
    admit()
    host_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_drained()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        admit()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_drained()
    busy_us, rows, top = _device_time(prof, f"{label} long admit")
    check(_scan_kernels(rows) == ["ssm_scan_chunked_kernel"],
          f"{label} long admit: scan kernels {_scan_kernels(rows)}, "
          f"expected the chunked scan")
    print(f"[profile {label} admit] one admit of {S} tokens (batch 1): "
          f"unprofiled wall {host_ms:.2f}ms; profiled wall={wall_ms:.2f}ms "
          f"device_busy={busy_us / 1e3:.2f}ms idle_share="
          f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f} kernels="
          f"{sum(n for _, n, _ in rows)}; device ms by kind: " +
          ", ".join(f"{k} {v:.3f}" for k, v in _kind_ms(rows).items()) +
          f"; top: {top}")
    cfg, dev = eng.cfg, eng.device
    mixer = {k: v[0] for k, v in eng.params["groups"][0][0]["mixer"].items()}
    w = cfg.lru_width
    n_r = sum(k == "R" for g in cfg.groups for k in g.pattern * g.repeats)
    parts = []
    for shape in ((1, S, w), (8, 1, w)):
        xs = [torch.randn(shape, device=dev).to(cfg.act_dtype)
              for _ in range(3)]
        ms = _time_ms([lambda x=x: rglru._gates(mixer, x) for x in xs],
                      iters=5)
        parts.append(f"{shape}: {ms:.4f} ms a layer, {n_r * ms:.3f} ms over "
                     f"{n_r} layers")
    copy_gb = 2 * w * w * (2 + 4 + 4) / 1e9   # read bf16, write and read fp32
    print(f"[profile {label} gates] rglru._gates of one layer (two fp32 "
          f"products over fp32 copies of w_a and w_i made at every call): "
          + "; ".join(parts) + f"; the copies move {copy_gb:.3f} GB a layer "
          f"and call, {n_r * copy_gb:.2f} GB a decode step over {n_r} "
          f"layers")


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
    name = label.replace(" ", "_")
    (OUT_DIR / f"chip_smoke_profile_{name}.txt").write_text("\n".join(
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
    if eng.cfg.lru_width:
        print(f"[profile {label}] device ms by kind: " + ", ".join(
            f"{k} {v:.3f}" for k, v in _kind_ms(rows).items()) +
            f"; busy {busy_us / 1e3:.2f}ms")
    if eng.cfg.n_experts:
        # device time of each op's kernels: the expert products are the
        # MoE's three bmm a layer, the other GEMMs the projections and head
        by_op = {e.key: e for e in prof.key_averages()}
        parts = []
        for op, what in (("aten::bmm", "expert products"),
                         ("aten::mm", "other GEMMs"),
                         ("aten::topk", "router top-k"),
                         ("aten::sort", "dispatch sort")):
            e = by_op.get(op)
            us = getattr(e, "device_time_total", 0.0) if e else 0.0
            parts.append(f"{what} ({op}) {us / 1e3:.3f}ms/"
                         f"{e.count if e else 0}x")
        attn_us = sum(us for us, _, key in rows if "decode" in key.lower())
        print(f"[profile {label}] device time by op: " + "; ".join(parts) +
              f"; decode attention kernels {attn_us / 1e3:.3f}ms; busy "
              f"{busy_us / 1e3:.2f}ms")


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
# internlm2-1.8b at full width, as phase 4 serves it; 16 prompts of 16-512
# tokens and 32 new tokens each (the first from the prefill)
CLUSTER_LM = dict(arch="internlm2-1.8b", reduce=False, max_len=2048,
                  slots=8, sync_every=8, seed=0)
CLUSTER_PROMPTS = (16, 512, 100, 300, 64, 200, 33, 450, 128, 256, 40, 380,
                   90, 500, 20, 160)
CLUSTER_NEW = 32


def phase_cluster():
    """The paper's service architecture on the card: ``MLaaSService`` in
    front of a ``Router`` over thread and process replicas of the port's
    engines and of the MARGOT stream, a replica SIGKILLed mid-run, and
    the partition autotuner fitted on the card.  The worker processes only
    load the libraries phase 1 built: the build directory is unchanged."""
    from repro_torch.kernels import build
    before = {p.name: p.stat().st_mtime_ns
              for p in build.BUILD_DIR.iterdir()}
    _cluster_parity()
    _cluster_threads()
    _cluster_processes()
    _cluster_stream()
    _cluster_autotuner()
    after = {p.name: p.stat().st_mtime_ns for p in build.BUILD_DIR.iterdir()}
    check(after == before, f"the workers rebuilt kernels: build directory "
          f"{sorted(before)} became {sorted(after)}")
    print(f"[cluster] every worker loaded the {len(build.SOURCES)} "
          f"libraries phase 1 built; no nvcc ran after phase 1")


def _spawn(router, spec, n, cfg):
    """Add ``n`` process replicas of ``spec`` to ``router``, spawned
    together; returns them and each one's seconds to ready (the worker's
    torch import, CUDA context and backend build)."""
    from concurrent.futures import ThreadPoolExecutor

    def add(_):
        t0 = time.perf_counter()
        w = router.add_replica(spec=spec, cfg=cfg, transport="process")
        return w, time.perf_counter() - t0

    with ThreadPoolExecutor(n) as pool:
        done = list(pool.map(add, range(n)))
    return [w for w, _ in done], [s for _, s in done]


def _worker_launches(router, keys):
    """Kernel launches the process replicas counted and shipped over
    their heartbeats (``kernels.launches.<name>``); after ``stop()``
    the departed replicas' last snapshots hold them."""
    from repro_torch import kernels
    snap = router.cluster_snapshot()
    got = {k: int(snap.get(f"kernels.launches.{k}", 0))
           for k in kernels.LAUNCHES}
    check(all(got[k] > 0 for k in keys) and
          sum(got.values()) == sum(got[k] for k in keys),
          f"worker kernel launches {got}, expected only {keys}")
    return {k: got[k] for k in keys}, snap


def _cluster_parity():
    """fp32 reduced internlm2-1.8b, dense then paged: the service over a
    Router of 2 process replicas gives an in-process engine's greedy
    tokens on the same seeded weights, token for token."""
    import numpy as np
    import torch
    from repro_torch.cluster import ReplicaConfig, Router, engine_spec
    from repro_torch.cluster.backends import make_engine
    from repro_torch.core.service import MLaaSService
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(4)
    for paged in (False, True):
        kw = dict(arch="internlm2-1.8b", reduce=True, max_len=64, slots=2,
                  sync_every=4, paged=paged, block_size=8, seed=0)
        eng = make_engine(device=dev, **kw)
        prompts = [rng.randint(0, eng.cfg.vocab, n).astype(np.int32)
                   for n in (5, 9, 7, 12, 6, 3, 17, 30)]
        want = [r.out_tokens for r in _drain(eng, prompts, 6)]
        del eng
        router = Router(policy="round_robin")
        workers, spawn_s = _spawn(router, engine_spec(device="cuda", **kw),
                                  2, ReplicaConfig(max_batch=8))
        svc = MLaaSService(router=router, capacity=len(prompts)).start()
        reqs = [svc.submit((p, 6), timeout_s=120.0) for p in prompts]
        check(all(q.done.wait(180.0) for q in reqs), "parity: a request "
              "never finished")
        svc.stop()
        router.stop()
        label = "paged" if paged else "dense"
        check([q.result for q in reqs] == want,
              f"parity {label}: process replicas gave "
              f"{[q.result for q in reqs]}, the in-process engine {want}")
        check(all(w.processed > 0 for w in workers),
              f"parity {label}: a replica served nothing")
        used, _ = _worker_launches(
            router, PAGED_KERNELS if paged else DENSE_KERNELS)
        print(f"[cluster parity {label}] fp32 reduced internlm2-1.8b: "
              f"{len(prompts)} requests through MLaaSService -> Router -> 2 "
              f"process replicas ({[w.processed for w in workers]} each, "
              f"spawned in {', '.join(f'{s:.1f}' for s in spawn_s)}s) give "
              f"the in-process engine's {sum(map(len, want))} tokens "
              f"exactly; worker launches {used}")


def _service_run(router, prompts, label):
    """The 16 requests through ``MLaaSService(router=...)``: every one
    completes with its 32 tokens; returns the wall seconds."""
    from repro_torch.core.service import MLaaSService
    svc = MLaaSService(router=router, capacity=len(prompts)).start()
    t0 = time.perf_counter()
    reqs = [svc.submit((p, CLUSTER_NEW - 1), timeout_s=120.0)
            for p in prompts]
    check(all(q.done.wait(300.0) for q in reqs),
          f"{label}: a request never finished")
    wall = time.perf_counter() - t0
    svc.stop()
    for i, q in enumerate(reqs):
        check(isinstance(q.result, list) and len(q.result) == CLUSTER_NEW
              and not q.missed_deadline,
              f"{label}: request {i} gave {q.result!r}")
    return wall


def _lm_prompts(vocab):
    import numpy as np
    rng = np.random.RandomState(5)
    return [rng.randint(0, vocab, n).astype(np.int32)
            for n in CLUSTER_PROMPTS]


def _cluster_threads():
    """Full width, paged, 2 thread replicas sharing one copy of the
    weights behind the service; the parent counts the kernel launches."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.cluster import (EngineBackend, ReplicaConfig, Router,
                                     Status)
    from repro_torch.cluster.backends import make_engine
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine
    dev = torch.device("cuda", 0)
    first = make_engine(device=dev, paged=True, block_size=16, **CLUSTER_LM)
    check(first.cfg.n_layers == 24 and first.cfg.d_model == 2048 and
          first.params["lm_head"].dtype == torch.bfloat16 and first.paged,
          "not the full-width bf16 config")
    engines = [first, Engine(first.params, first.cfg, first.scfg,
                             device=dev)]
    router = Router(policy="round_robin")
    workers = [router.add_replica(EngineBackend(e), ReplicaConfig(max_batch=8))
               for e in engines]
    prompts = _lm_prompts(first.cfg.vocab)
    warm = [router.submit((p[:40], 8), timeout_s=120.0) for p in prompts[:2]]
    check(all(router.wait(q, 180.0) is not None and q.status is Status.OK
              for q in warm), "threads: warm-up failed")
    served = [w.processed for w in workers]
    ops.reset_counts()
    torch.cuda.synchronize()
    wall = _service_run(router, prompts, "threads")
    torch.cuda.synchronize()
    launches, plain = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
    served = [w.processed - s for w, s in zip(workers, served)]
    router.stop()
    check(all(n >= 1 for n in served), f"threads: served {served}")
    check(all(launches[k] > 0 for k in PAGED_KERNELS) and
          sum(launches.values()) == sum(launches[k] for k in PAGED_KERNELS)
          and not any(plain.values()),
          f"threads: launches {launches}, plain {plain}")
    n_tok = len(prompts) * CLUSTER_NEW
    print(f"[cluster threads] internlm2-1.8b full width, paged, "
          f"MLaaSService -> Router -> 2 thread replicas (one copy of the "
          f"weights): {len(prompts)} requests of {min(CLUSTER_PROMPTS)}-"
          f"{max(CLUSTER_PROMPTS)} prompt tokens, {CLUSTER_NEW} new tokens "
          f"each, all OK; served {served}; wall={wall:.3f}s "
          f"tok/s={n_tok / wall:.1f}; launches "
          f"{ {k: launches[k] for k in PAGED_KERNELS} } plain_calls=0")
    del engines, first, workers, router
    gc.collect()
    torch.cuda.empty_cache()


def _timed_run(router, prompts, label):
    """The 16 requests straight into the Router, each with a partial-
    result callback: (tok/s, TTFT p50, TTFT p99) on the host clock, TTFT
    from submission to the first token's frame.  With one replica of 8
    slots the second 8 requests wait for the first 8 to finish."""
    import numpy as np
    from repro_torch.cluster import Status
    first = {}
    reqs = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        reqs.append(router.submit(
            (p, CLUSTER_NEW - 1), cost=CLUSTER_NEW, timeout_s=300.0,
            on_partial=lambda f, i=i: first.setdefault(i, time.monotonic())))
    outs = [router.wait(q, 400.0) for q in reqs]
    wall = time.perf_counter() - t0
    check(all(q.status is Status.OK and len(o) == CLUSTER_NEW
              for q, o in zip(reqs, outs)) and len(first) == len(reqs),
          f"{label}: statuses {[q.status for q in reqs]}")
    ttft = [first[i] - q.submitted_s for i, q in enumerate(reqs)]
    return (len(reqs) * CLUSTER_NEW / wall, float(np.percentile(ttft, 50)),
            float(np.percentile(ttft, 99)))


def _cluster_processes():
    """Full width, dense, 2 process replicas (each its own CUDA context,
    weights and KV): the service run, the same requests timed on 2
    replicas, a SIGKILL of one replica mid-run (every request completes
    exactly once, on the survivor), then the same requests on the
    survivor alone.  The engines' counters arrive over the heartbeats."""
    import threading

    from repro_torch.cluster import (MetricsRegistry, ReplicaConfig, Router,
                                     Status, engine_spec)
    from repro_torch.cluster.replica import ClusterRequest
    from repro_torch.configs import get_config
    m = MetricsRegistry()
    router = Router(policy="round_robin", metrics=m, max_retries=3)
    cfg = ReplicaConfig(max_batch=8)
    workers, spawn_s = _spawn(
        router, engine_spec(device="cuda", paged=False, **CLUSTER_LM), 2,
        cfg)
    check(max(spawn_s) < cfg.spawn_timeout_s, f"spawn took {spawn_s}s")
    print(f"[cluster processes] 2 process replicas of internlm2-1.8b (full "
          f"width, bf16, dense) spawned together, ready in "
          f"{', '.join(f'{s:.1f}' for s in spawn_s)}s (torch import, CUDA "
          f"context, seeded weights on the card; limit "
          f"{cfg.spawn_timeout_s:.0f}s)")
    prompts = _lm_prompts(get_config("internlm2-1.8b").vocab)
    warm = [router.submit((p[:40], 8), timeout_s=120.0) for p in prompts[:2]]
    check(all(router.wait(q, 180.0) is not None and q.status is Status.OK
              for q in warm), "processes: warm-up failed")
    served = [w.processed for w in workers]
    wall = _service_run(router, prompts, "processes")
    served = [w.processed - s for w, s in zip(workers, served)]
    check(all(n >= 1 for n in served), f"processes: served {served}")
    print(f"[cluster processes] MLaaSService -> Router -> 2 process "
          f"replicas: {len(prompts)} requests, {CLUSTER_NEW} new tokens "
          f"each, all OK; served {served}; wall={wall:.3f}s "
          f"tok/s={len(prompts) * CLUSTER_NEW / wall:.1f}")
    two = [_timed_run(router, prompts, "2 replicas") for _ in range(2)]

    # a replica SIGKILLed as the first token arrives: no replica can have
    # acked yet (a batch acks when its last request ends), so every
    # request must complete exactly once, on the survivor
    victim, survivor = workers
    counts, lock, orig = {}, threading.Lock(), ClusterRequest.complete

    def counting(req, result, replica_rid):
        with lock:
            counts[id(req)] = counts.get(id(req), 0) + 1
        return orig(req, result, replica_rid)

    started = threading.Event()
    with mock.patch.object(ClusterRequest, "complete", counting):
        reqs = [router.submit((p, CLUSTER_NEW - 1), cost=CLUSTER_NEW,
                              timeout_s=300.0,
                              on_partial=lambda f: started.set())
                for p in prompts]
        check(started.wait(120.0), "kill: no first token")
        victim.inject_crash()               # SIGKILL
        outs = [router.wait(q, 400.0) for q in reqs]
    check(all(q.status is Status.OK and len(o) == CLUSTER_NEW and
              counts.get(id(q)) == 1 and q.replica_rid == survivor.rid
              for q, o in zip(reqs, outs)),
          f"kill: statuses {[q.status for q in reqs]}, completions "
          f"{[counts.get(id(q)) for q in reqs]}, replicas "
          f"{[q.replica_rid for q in reqs]}")
    check(not victim.alive and router.n_alive() == 1, "kill: victim alive")
    snap = m.snapshot()
    print(f"[cluster kill] SIGKILL of replica {victim.rid} at the first "
          f"token: {len(reqs)} requests each completed exactly once, all "
          f"on replica {survivor.rid}; replica.crashes="
          f"{snap.get('replica.crashes', 0):.0f} router.requeued="
          f"{snap.get('router.requeued', 0):.0f} router.failed="
          f"{snap.get('router.failed', 0):.0f}")
    one = [_timed_run(router, prompts, "1 replica") for _ in range(2)]
    router.stop()
    used, snap = _worker_launches(router, DENSE_KERNELS)
    check(snap.get("engine.requests", 0) >= 2 * len(prompts) and
          snap.get("engine.tokens", 0) > 0,
          f"engine counters over the heartbeats: requests "
          f"{snap.get('engine.requests')}, tokens {snap.get('engine.tokens')}")
    runs = lambda rs: "; ".join(  # noqa: E731
        f"tok/s={r[0]:.1f} TTFT p50={r[1]:.3f}s p99={r[2]:.3f}s" for r in rs)
    print(f"[cluster processes] same {len(prompts)} requests straight into "
          f"the Router, twice each: 1 process replica {runs(one)}; 2 process "
          f"replicas {runs(two)}; over the "
          f"heartbeats: engine.requests={snap['engine.requests']:.0f} "
          f"engine.tokens={snap['engine.tokens']:.0f} "
          f"engine.prefill_batches="
          f"{snap.get('engine.prefill_batches', 0):.0f}, worker launches "
          f"{used}")


def _cluster_stream():
    """The MARGOT stream at phase 5's settings behind the Router: one
    process replica gives an in-process runtime's links on the same
    micro-batches; then 2 replicas, where every micro-batch acks."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.cluster import ReplicaConfig, Router, Status, stream_spec
    from repro_torch.configs.margot_svm import PIPELINE, STREAM
    from repro_torch.core.stream import StreamRuntime
    from repro_torch.data.text import (corpus_arrays, margot_models,
                                       synthetic_corpus)
    dev = torch.device("cuda", 0)
    kw = dict(feat_dim=PIPELINE.feat_dim,
              claim_capacity=PIPELINE.claim_capacity,
              evid_capacity=PIPELINE.evid_capacity,
              **{f.name: getattr(STREAM, f.name)
                 for f in dataclasses.fields(STREAM)})
    X, keys, _ = corpus_arrays(synthetic_corpus(8, 64, seed=1),
                               dim=PIPELINE.feat_dim)
    rng = np.random.RandomState(0)
    n = STREAM.capacity

    def mb(i):
        idx = rng.randint(0, len(keys), n)
        ts = i * STREAM.period + np.linspace(
            0, STREAM.period, n, endpoint=False).astype(np.float32)
        return X[idx], keys[idx], ts

    mbs = [mb(i) for i in range(6)]
    rt = StreamRuntime(margot_models(PIPELINE, device=dev), PIPELINE, STREAM)
    want = [rt.process_microbatch(*b) for b in mbs]
    router = Router(policy="round_robin")
    cfg = ReplicaConfig(max_batch=8)
    _, spawn_s = _spawn(router, stream_spec(device="cuda", **kw), 1, cfg)
    reqs = [router.submit(b, cost=n, timeout_s=120.0) for b in mbs]
    outs = [router.wait(q, 180.0) for q in reqs]
    check(all(q.status is Status.OK for q in reqs),
          f"stream: statuses {[q.status for q in reqs]}")
    links = 0
    for i, ((sc, ok), (wsc, wok)) in enumerate(zip(outs, want)):
        check(isinstance(sc, np.ndarray) and np.array_equal(ok, wok) and
              np.array_equal(sc, wsc),
              f"stream micro-batch {i}: the replica's links differ from "
              f"the in-process runtime's")
        links += int(ok.sum())
    more, more_s = _spawn(router, stream_spec(device="cuda", **kw), 1, cfg)
    reqs = [router.submit(mb(6 + i), cost=n, timeout_s=120.0)
            for i in range(8)]
    outs = [router.wait(q, 180.0) for q in reqs]
    check(all(q.status is Status.OK and o[0].shape == want[0][0].shape
              for q, o in zip(reqs, outs)),
          f"stream, 2 replicas: statuses {[q.status for q in reqs]}")
    router.stop()
    used, _ = _worker_launches(router, ("pair_score",))
    print(f"[cluster stream] MARGOT stream (d={PIPELINE.feat_dim}, "
          f"{n}-row chunks, period {STREAM.period}s, window "
          f"{STREAM.window}s) on 1 process replica (ready in "
          f"{spawn_s[0]:.1f}s): {len(mbs)} micro-batches, scores and "
          f"{links} links bit-identical to the in-process runtime's; then "
          f"2 replicas (the second ready in {more_s[0]:.1f}s): 8 "
          f"micro-batches, all acked; worker launches {used}")


def _cluster_autotuner():
    """``measure_step`` over the port's MARGOT batch step at 3-48
    documents a partition, the fitted cost model and the size it picks
    for a 0.25 s budget, beside ``launch/argmining.py``'s fixed 12.  A
    finding, not a check; the claim capacity caps a partition."""
    import torch
    from repro_torch.configs.margot_svm import PIPELINE
    from repro_torch.core.partitioner import (choose_partition_size,
                                              measure_step)
    from repro_torch.core.pipeline import extract_links, make_batch_step
    from repro_torch.data.text import margot_models
    from repro_torch.launch import argmining
    dev = torch.device("cuda", 0)
    sizes = (3, 6, 12, 24, 48)
    spd = argmining.SENTENCES_PER_DOC
    X, keys, _ = argmining.make_corpus(max(sizes) * spd, PIPELINE.feat_dim)
    models = margot_models(PIPELINE, device=dev)
    step = make_batch_step(PIPELINE)
    dropped = {}

    def step_fn(m):
        n = m * spd
        out = step(models, torch.from_numpy(X[:n]).to(dev),
                   torch.from_numpy(keys[:n]).to(dev))
        extract_links(out)              # reads the result: synchronizes
        dropped[m] = int(out.n_dropped)

    model = measure_step(step_fn, sizes, warmup=1, repeats=5)
    chosen = choose_partition_size(model, latency_budget_s=STREAM_BUDGET_S)
    fits = max(m for m in sizes if dropped[m] == 0)
    print(f"[cluster autotuner] MARGOT batch step at {list(sizes)} documents "
          f"a partition ({spd} sentences each, capacities "
          f"{PIPELINE.claim_capacity}/{PIPELINE.evid_capacity}): fitted "
          f"overhead={model.overhead_s * 1e3:.4f}ms per_doc="
          f"{model.per_item_s * 1e3:.4f}ms r2={model.r2:.4f}; "
          f"choose_partition_size(budget {STREAM_BUDGET_S}s, efficiency "
          f"0.8) = {chosen} documents; dropped rows by size "
          f"{dropped}, so the capacities cap a partition at {fits} of "
          f"these sizes; launch/argmining.py runs "
          f"{argmining.DOCS_PER_PARTITION}")


# ----------------------------------------------------------------------
# internlm2-1.8b at phase 4's full width on the paged engine: bs 16, 8
# slots, max_len 2048, K=8, phase 4's 8 requests, max_new 32
LIFECYCLE = dict(max_len=2048, slots=8, sync_every=8, paged=True,
                 block_size=16, seed=0)
#: phase 7's swap pool: the 8 prompts take 87 blocks of 16 rows once the
#: shared prefix is cached, and 103 with their 32 new tokens; in 80
#: blocks admits wait for room and two sessions swap out as the others
#: grow (the host's decisions depend on lengths alone: a CPU run of the
#: reduced config at these lengths swaps the same two)
SWAP_BLOCKS = 80


def phase_lifecycle(paged_tokens):
    """The paged engine's KV lifecycle at full width: speculative decode
    through the paged extend kernel, a greedy fork, KV swap on both
    tiers, export/import between two engines, and 2 thread replicas
    behind the Router through brownout L1 and a migrating drain."""
    import gc

    import torch
    from repro_torch.launch.serve import build_engine
    t0 = time.perf_counter()
    base = build_engine("internlm2-1.8b", device=torch.device("cuda", 0),
                        **LIFECYCLE)
    check(base.cfg.n_layers == 24 and base.cfg.d_model == 2048 and
          base.params["lm_head"].dtype == torch.bfloat16 and base.paged,
          "not the full-width bf16 config")
    tok, warm, prompts = _serve_prompts(base.cfg.vocab)
    _lifecycle_spec(base, warm, prompts, paged_tokens)
    _lifecycle_fork(base, prompts)
    for tier in ("host", "artifact"):
        _lifecycle_swap(base, prompts, paged_tokens, tier)
    _lifecycle_export(base, prompts, tok)
    _lifecycle_cluster(base, prompts)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lifecycle] phase 7 wall {time.perf_counter() - t0:.1f}s")


def _variant(base, **changes):
    """An engine on ``base``'s weights with its ServeConfig changed."""
    import dataclasses

    from repro_torch.serving import Engine
    return Engine(base.params, base.cfg,
                  dataclasses.replace(base.scfg, **changes),
                  device=base.device)


def _agreement(got, want):
    """Share of equal tokens, and each request's first differing index
    (None where equal)."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    first = [next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                  None if len(g) == len(w) else min(len(g), len(w)))
             for g, w in zip(got, want)]
    return same / sum(len(w) for w in want), first


def _check_served(reqs, vocab, label):
    for r in reqs:
        check(r.finish_reason == "max_new" and len(r.out_tokens) == 33 and
              all(0 <= t < vocab for t in r.out_tokens),
              f"{label}: request {r.rid} {r.finish_reason}, {r.out_tokens}")


def _lifecycle_spec(base, warm, prompts, paged_tokens):
    """(a) Speculative decode, d=3: every verify window and admit runs the
    paged extend (24 launches a pass), no paged decode and no plain
    version; tokens against phase 4's paged run (bf16: not a gate)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    eng = _variant(base, speculative=True, spec_draft=3)
    check(eng.speculative, "speculation fell back")
    _drain(eng, [warm], 8)
    keys = ("engine.prefill_batches", "engine.steps", "engine.spec_proposed",
            "engine.spec_accepted")
    before = {k: eng.metrics.counter(k).value for k in keys}
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = _drain(eng, prompts, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
    n = {k: eng.metrics.counter(k).value - v for k, v in before.items()}
    _check_served(reqs, eng.cfg.vocab, "spec")
    want = eng.cfg.n_layers * (n["engine.prefill_batches"] +
                               eng.scfg.sync_every * n["engine.steps"])
    check(launches["paged_extend_attention"] == want and
          sum(launches.values()) == want and not any(plain.values()),
          f"spec: launches {launches} (expected {want} paged extends "
          f"alone), plain {plain}")
    share, first = _agreement([r.out_tokens for r in reqs], paged_tokens)
    gen = sum(r.decoded for r in reqs)
    ttft = sorted(r.first_token_t - r.submit_t for r in reqs)
    print(f"[lifecycle spec] d=3: {len(reqs)} requests, {gen} decoded in "
          f"{n['engine.steps']} syncs and {n['engine.prefill_batches']} "
          f"admit batches, wall={wall:.3f}s tok/s={gen / wall:.1f} "
          f"ttft_p50={ttft[len(ttft) // 2]:.3f}s ttft_max={ttft[-1]:.3f}s; "
          f"accepted {n['engine.spec_accepted']} of "
          f"{n['engine.spec_proposed']} drafts "
          f"({n['engine.spec_accepted'] / n['engine.spec_proposed']:.4f}); "
          f"paged extend launches {launches['paged_extend_attention']} = "
          f"24 x ({n['engine.prefill_batches']} + 8 x {n['engine.steps']}), "
          f"paged decode 0, plain 0; tokens equal to phase 4's paged run: "
          f"{share:.4f} (bf16; first differing index per request {first})")
    del eng


def _lifecycle_fork(base, prompts):
    """(b) A greedy fork 3 ways at the first token: parent and children
    decode one context in one batch, so every child's tokens are the
    parent's, in bf16 too."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    eng = _variant(base)
    children = []

    def fork_at_first(req, toks, done):
        if len(req.out_tokens) == 1 and not children:
            children.extend(eng.fork(req, max_new=req.max_new)
                            for _ in range(3))

    ops.reset_counts()
    parent = eng.submit(prompts[0], max_new=32, on_tokens=fork_at_first)
    eng.run_until_drained()
    launches = dict(kernels.LAUNCHES)
    check(len(children) == 3, f"fork: {len(children)} children, stream "
          f"errors {eng.metrics.counter('engine.stream_errors').value}")
    _check_served([parent] + children, eng.cfg.vocab, "fork")
    for i, c in enumerate(children):
        diff = _agreement([c.out_tokens], [parent.out_tokens])[1][0]
        check(diff is None, f"fork: child {i} differs from the parent at "
              f"token {diff}: a row-dependent result")
    cow = eng.metrics.counter("engine.kv_cow_copies").value
    check(cow > 0 and eng.alloc.free_blocks + eng.alloc.cached_blocks ==
          eng.alloc.num_blocks, f"fork: {cow} COW copies, or blocks leaked")
    check(launches["paged_decode_attention"] > 0 and
          launches["paged_extend_attention"] > 0, f"fork: {launches}")
    print(f"[lifecycle fork] {len(prompts[0])}-token prompt forked 3 ways "
          f"at its first token: parent and children decode 32 tokens each, "
          f"all 3 children equal to the parent; {cow} COW copies; launches "
          f"{ {k: launches[k] for k in PAGED_KERNELS} }")
    del eng


def _lifecycle_swap(base, prompts, paged_tokens, tier):
    """(c) KV swap on a pool that holds the prompts but not their decode
    growth: every request completes once, swaps out and in as often, no
    pool exhaustion, and each restore writes back exactly the bytes the
    swap-out read."""
    eng = _variant(base, kv_blocks=SWAP_BLOCKS, kv_swap=True,
                   swap_tier=tier)
    trips = []                          # (bytes equal, frame bytes, tokens)
    restore = eng._try_restore

    def checked_restore(free):
        req = eng.queue[0]
        snap = req.kv_snapshot
        done = restore(free)
        slot = next((s for s, r in enumerate(eng.active) if r is req), None)
        if slot is not None and snap.n_blocks:
            data = snap.data if snap.data is not None else \
                eng._swap_payload_store().read_bytes(snap.digest)
            table = eng.alloc.table(eng._seq_of_slot[slot])
            trips.append((eng._gather_block_rows(
                table[:snap.n_blocks]) == data, len(data), snap.pos))
        return done

    eng._try_restore = checked_restore
    t0 = time.perf_counter()
    reqs = _drain(eng, prompts, 32)
    wall = time.perf_counter() - t0
    snap = eng.metrics.snapshot()
    _check_served(reqs, eng.cfg.vocab, f"swap {tier}")
    out, back = snap.get("engine.kv_swap_out", 0), \
        snap.get("engine.kv_swap_in", 0)
    check(sorted(r.rid for r in eng.finished) == sorted(r.rid for r in reqs),
          f"swap {tier}: finished {[r.rid for r in eng.finished]}")
    check(out == back > 0 and not snap.get("engine.kv_pool_exhausted", 0),
          f"swap {tier}: out {out}, in {back}, exhausted "
          f"{snap.get('engine.kv_pool_exhausted', 0)}")
    check(trips and all(t[0] for t in trips),
          f"swap {tier}: {sum(not t[0] for t in trips)} of {len(trips)} "
          f"restores wrote other bytes than the swap-out read")
    check(eng.alloc.free_blocks + eng.alloc.cached_blocks ==
          eng.alloc.num_blocks, f"swap {tier}: blocks leaked")
    share, _ = _agreement([r.out_tokens for r in reqs], paged_tokens)
    nbytes, ntok = sum(t[1] for t in trips), sum(t[2] for t in trips)
    print(f"[lifecycle swap {tier}] pool {SWAP_BLOCKS} blocks x 16: "
          f"{len(reqs)} requests all complete once, wall={wall:.3f}s; "
          f"kv_swap_out = kv_swap_in = {out}, "
          f"{snap.get('engine.kv_swapped_blocks', 0)} blocks swapped, "
          f"kv_pool_exhausted 0; {len(trips)} restores re-read bit for "
          f"bit; {nbytes} frame bytes for {ntok} tokens "
          f"({nbytes / max(ntok, 1) / 1024:.2f} KiB a token); tokens equal "
          f"to phase 4's paged run: {share:.4f} (bf16, other batches)")
    del eng


def _lifecycle_export(base, prompts, tok):
    """(d) Engine A serves the two requests sharing the 256-token prefix
    and exports its prefix cache; engine B imports the frame, holds A's
    rows bit for bit, and serves a new prompt on that prefix from 16
    cached blocks."""
    import numpy as np
    a = _variant(base)
    _drain(a, [prompts[0], prompts[2]], 32)
    state = a.export_kv_state()
    check(state is not None and len(state["hashes"]) == 24,
          f"export: {None if state is None else len(state['hashes'])} "
          f"blocks, expected 18 + 6 full prompt blocks")
    b = _variant(base)
    n = b.import_kv_state(state)
    again = b.export_kv_state()
    check(n == 24 and again["hashes"] == state["hashes"] and
          again["data"] == state["data"],
          f"import: adopted {n}; the re-export differs from A's frame")
    prompt = np.concatenate([prompts[0][:256], tok(60)])
    (rb,) = _drain(b, [prompt], 32)
    (ra,) = _drain(a, [prompt], 32)
    hits = b.metrics.counter("engine.prefix_hit_blocks").value
    check(hits == 16, f"import: B hit {hits} blocks, expected 16")
    _check_served([ra, rb], b.cfg.vocab, "export")
    print(f"[lifecycle export] A exported {len(state['hashes'])} blocks "
          f"({len(state['data'])} bytes); B adopted {n}, its re-export "
          f"equal to A's frame byte for byte; a new prompt on the 256-token "
          f"prefix hit 16 blocks on B; B's tokens equal A's for it: "
          f"{rb.out_tokens == ra.out_tokens}")
    del a, b


def _lifecycle_cluster(base, prompts):
    """(e) 2 thread replicas (paged, speculative) behind the Router with
    session affinity: brownout L1 turns speculation off on both (the spec
    counters stop) with every request completing, then a drain with
    ``migrate=True`` ships the drained replica's KV to the survivor."""
    import numpy as np
    from repro_torch.cluster import (EngineBackend, MetricsRegistry,
                                     ReplicaConfig, Router, Status)
    engines = [_variant(base, speculative=True) for _ in range(2)]
    router = Router(policy="session_affinity", metrics=MetricsRegistry())
    workers = [router.add_replica(EngineBackend(e), ReplicaConfig(max_batch=8),
                                  kind="lm") for e in engines]

    def run(items, label):
        qs = [router.submit((p, n), session_key=key, kind="lm",
                            timeout_s=300.0) for key, p, n in items]
        outs = [router.wait(q, 400.0) for q in qs]
        check(all(q.status is Status.OK and isinstance(o, list) and
                  len(o) == n + 1 for q, o, (_, _, n) in
                  zip(qs, outs, items)),
              f"cluster {label}: {[q.status for q in qs]}")
        return qs, outs

    def proposed():
        return [e.metrics.counter("engine.spec_proposed").value
                for e in engines]

    items = [(f"s{i}", p, 31) for i, p in enumerate(prompts)]
    qs, outs = run(items, "L0")
    spec0 = proposed()
    check(sum(spec0) > 0, "cluster: no verify window ran")
    for w in router.alive_replicas():
        w.set_brownout(1)
    run(items, "L1")
    check(not any(e.speculative for e in engines) and proposed() == spec0,
          f"cluster L1: speculative {[e.speculative for e in engines]}, "
          f"proposed {spec0} -> {proposed()}")
    home = qs[0].replica_rid
    router.remove_replica(home, drain=True, migrate=True)
    moved = [i for i, q in enumerate(qs) if q.replica_rid == home]
    run([(f"s{i}", np.concatenate([prompts[i], np.asarray(outs[i],
                                                          np.int32)]), 8)
         for i in moved], "after the drain")
    survivor = next(w for w in workers if w.rid != home)
    imported = survivor.backend.engine.metrics.counter(
        "engine.kv_import_blocks").value
    migrated = router.metrics.snapshot().get("router.sessions_migrated", 0)
    router.stop()
    check(migrated > 0 and imported > 0,
          f"cluster drain: sessions_migrated {migrated}, survivor imported "
          f"{imported} blocks")
    print(f"[lifecycle cluster] 2 thread replicas (paged, speculative) "
          f"behind the Router: {len(items)} requests OK with {sum(spec0)} "
          f"drafts proposed; brownout L1: speculative off on both, the "
          f"same requests OK with no draft proposed; drain with migrate: "
          f"{migrated:.0f} sessions migrated, the survivor adopted "
          f"{imported} blocks and served the {len(moved)} continuations")
    del engines, workers, router


# ----------------------------------------------------------------------
#: phase 8's burst: phase 6's prompts (16-512 tokens) cycled into 96
#: requests of 32 new tokens, one every 0.125 s (8 a second for 12 s).
#: One process replica of internlm2-1.8b serves 160-194 tok/s, ~6 such
#: requests a second (PERF.md, section 5), and a new replica is ready in
#: ~6.3 s, so the burst outlasts a spawn and the scaled-up pool serves
#: its second half.
BURST_REQUESTS = 96
BURST_GAP_S = 0.125
#: the scaler: up when a replica's outstanding cost passes its 8 slots x
#: 32 tokens (requests queue behind full slots), down after 4 idle ticks
#: (1 s), at most one action every 2 s, 1-3 replicas
SCALER = dict(min_replicas=1, max_replicas=3, scale_up_depth=256.0,
              scale_down_depth=1.0, cooldown_s=2.0, idle_ticks_to_drain=4)
SCALER_TICK_S = 0.25
#: the sampler's period in the serve driver's default (--stats-period)
STATS_PERIOD_S = 0.25


def phase_telemetry():
    """The port's telemetry over full-width internlm2-1.8b behind the
    Router: an autoscaled burst on process replicas with the sampler, the
    SLO engine and the stats server on; the sampler's overhead on one
    engine; the serve driver's ``--stats-dump`` in a process of its own."""
    t0 = time.perf_counter()
    _telemetry_burst()
    _telemetry_overhead()
    _telemetry_driver()
    print(f"[telemetry] phase 8 wall {time.perf_counter() - t0:.1f}s")


def _fetch_routes(server):
    """The four stats routes over HTTP, each parsed (Prometheus text into
    name -> value); the bodies go to ``OUT_DIR``."""
    import urllib.request
    got = {}
    for route, ext in (("/metrics", "txt"), ("/timeseries.json", "json"),
                       ("/slo.json", "json"), ("/dash", "html")):
        with urllib.request.urlopen(server.url + route, timeout=30) as resp:
            check(resp.status == 200, f"{route}: HTTP {resp.status}")
            body = resp.read().decode()
        (OUT_DIR / f"chip_smoke_stats{route.split('.')[0].replace('/', '_')}"
                   f".{ext}").write_text(body)
        got[route] = body
    prom = {}
    for ln in got["/metrics"].splitlines():
        if ln and not ln.startswith("#"):
            name, value = ln.split()
            prom[name] = float(value)
    check(got["/dash"].startswith("<!DOCTYPE html>"), "/dash: not a page")
    return (prom, json.loads(got["/timeseries.json"]),
            json.loads(got["/slo.json"]))


def _telemetry_burst():
    """One process replica of full-width internlm2-1.8b (dense, the serve
    driver's default) behind a least-loaded Router, the serve driver's
    stats stack on its cluster snapshot (sampler, SLO engine wired into
    ``router.slo``, stats server on port 0) and an ``Autoscaler`` (1-3
    replicas, its factory an ``engine_spec``) ticked every 0.25 s, each
    tick timed (a scale-up's tick spans the spawn).  The burst: every
    request completes exactly once with its tokens; at least one scale-up
    while it lasts, then a scale-down once the pool is idle; tok/s before
    and after the first new replica is ready; all four routes parse, and
    ``/metrics`` carries the kernel launches the workers shipped."""
    import threading

    from repro_torch.cluster import (Autoscaler, AutoscalerConfig,
                                     MetricsRegistry, ReplicaConfig, Router,
                                     SLOEngine, SLOObjective, StatsServer,
                                     Status, TelemetrySampler,
                                     TimeSeriesStore, engine_spec)
    from repro_torch.cluster.replica import ClusterRequest
    from repro_torch.configs import get_config
    m = MetricsRegistry()
    router = Router(policy="least_loaded", metrics=m)
    # an inbox that holds the whole burst: a slow spawn makes requests
    # wait, never sheds them
    rcfg = ReplicaConfig(max_batch=8, inbox_capacity=BURST_REQUESTS)
    spec = engine_spec(device="cuda", paged=False, **CLUSTER_LM)
    store = TimeSeriesStore()
    slo = SLOEngine([SLOObjective(kind="any")], m)
    router.slo = slo
    sampler = TelemetrySampler(router.cluster_snapshot, store, registry=m,
                               slo=slo, period_s=STATS_PERIOD_S)
    scaler = Autoscaler(router, lambda: spec, AutoscalerConfig(
        replica_cfg=rcfg, **SCALER), metrics=m, transport="process")
    server = None
    stop = threading.Event()
    ticks = []                          # (event, seconds the tick took)

    def scale_loop():
        while not stop.wait(SCALER_TICK_S):
            t = time.perf_counter()
            ev = scaler.tick()
            if ev is not None:
                ticks.append((ev, time.perf_counter() - t, time.monotonic()))

    loop = threading.Thread(target=scale_loop, name="smoke-scaler",
                            daemon=True)
    prompts = _lm_prompts(get_config("internlm2-1.8b").vocab)
    counts, frames, lock = {}, [], threading.Lock()
    orig = ClusterRequest.complete

    def counting(req, result, replica_rid):
        with lock:
            counts[id(req)] = counts.get(id(req), 0) + 1
        return orig(req, result, replica_rid)

    def on_partial(frame):
        if isinstance(frame, tuple) and frame and isinstance(frame[0], list):
            with lock:
                frames.append((time.monotonic(), len(frame[0])))

    try:
        t_spawn = time.perf_counter()
        router.add_replica(spec=spec, cfg=rcfg, transport="process")
        first_s = time.perf_counter() - t_spawn
        warm = router.submit((prompts[0][:40], 8), timeout_s=120.0)
        check(router.wait(warm, 180.0) is not None and
              warm.status is Status.OK, "telemetry: warm-up failed")
        sampler.start()
        server = StatsServer(router.cluster_snapshot, store, slo=slo,
                             port=0).start()
        loop.start()
        reqs = []
        t_burst = time.monotonic()
        with mock.patch.object(ClusterRequest, "complete", counting):
            for i in range(BURST_REQUESTS):
                reqs.append(router.submit(
                    (prompts[i % len(prompts)], CLUSTER_NEW - 1),
                    cost=CLUSTER_NEW, timeout_s=600.0,
                    on_partial=on_partial))
                time.sleep(BURST_GAP_S)
            t_arrived = time.monotonic()
            outs = [router.wait(q, 600.0) for q in reqs]
        t_done = time.monotonic()
        check(all(q.status is Status.OK and isinstance(o, list) and
                  len(o) == CLUSTER_NEW and counts.get(id(q)) == 1
                  for q, o in zip(reqs, outs)),
              f"telemetry burst: statuses {[q.status for q in reqs]}, "
              f"completions {[counts.get(id(q)) for q in reqs]}")
        ups = [(ev, s, t) for ev, s, t in ticks if ev.action == "up"]
        check(any(t < t_done for _, _, t in ups),
              f"telemetry: no replica was added while the burst lasted: "
              f"{[(e.action, e.n_replicas, e.reason) for e, _, _ in ticks]}")
        deadline = time.monotonic() + 90.0
        while router.n_alive() > SCALER["min_replicas"] and \
                time.monotonic() < deadline:
            time.sleep(0.25)
        check(any(ev.action == "down" for ev, _, _ in ticks) and
              router.n_alive() == SCALER["min_replicas"],
              f"telemetry: the idle pool was not drained: "
              f"{[(ev.action, ev.n_replicas) for ev, _, _ in ticks]}")
        stop.set()
        loop.join(60.0)
        check(not loop.is_alive(), "telemetry: the scaler loop hangs")
        sampler.tick()
        prom, ts, slo_doc = _fetch_routes(server)
    finally:
        stop.set()
        sampler.stop()
        if server is not None:
            server.stop()
        router.stop()
    launched = {k: prom.get(f"repro_kernels_launches_{k}", 0.0)
                for k in DENSE_KERNELS}
    check(all(v > 0 for v in launched.values()),
          f"/metrics: kernel launches {launched}")
    used, _ = _worker_launches(router, DENSE_KERNELS)
    ready = ups[0][2]

    def tok_s(a, b):
        n = sum(k for t, k in frames if a <= t < b)
        return n / (b - a) if b > a else float("nan")

    served = {}
    for q in reqs:
        served[q.replica_rid] = served.get(q.replica_rid, 0) + 1
    events = "; ".join(
        f"{ev.action} to {ev.n_replicas} at +{ev.t - t_burst:.2f}s "
        f"({ev.reason}; the tick took {s:.2f}s)" for ev, s, _ in ticks)
    alerts = {sub: (a["state"], a["fired_count"])
              for o in slo_doc["objectives"] for sub, a in o["alerts"].items()}
    print(f"[telemetry burst] internlm2-1.8b full width, dense, process "
          f"replicas behind a least-loaded Router; the first ready in "
          f"{first_s:.1f}s; {len(reqs)} requests of "
          f"{min(CLUSTER_PROMPTS)}-{max(CLUSTER_PROMPTS)} prompt tokens, "
          f"{CLUSTER_NEW} new tokens each, one every {BURST_GAP_S}s "
          f"(arrivals over {t_arrived - t_burst:.2f}s, done at "
          f"+{t_done - t_burst:.2f}s): all OK, each completed exactly once; "
          f"served by replica {served}; scale events: {events}")
    print(f"[telemetry burst] tok/s from the token frames: "
          f"{tok_s(t_burst, ready):.1f} before the first new replica was "
          f"ready (+{ready - t_burst:.2f}s), {tok_s(ready, t_done):.1f} "
          f"after it, {tok_s(t_burst, t_done):.1f} over the burst; worker "
          f"launches {used}")
    print(f"[telemetry routes] /metrics {len(prom)} samples, kernel "
          f"launches {launched}; /timeseries.json {ts['n_keys']} keys, "
          f"{ts['n_points']}/{ts['max_points']} points, arrival EWMA "
          f"{ts['gauges'].get('timeseries.arrival_rate_hz', {}).get('ewma')}"
          f"; /slo.json {slo_doc['ticks']} ticks, alerts {alerts}, pressure "
          f"{slo_doc['pressure']:.3f}; /dash parsed; sampler ticks "
          f"{sampler.ticks}; bodies in {OUT_DIR.name}/")


def _telemetry_overhead():
    """The sampler's cost: one full-width internlm2-1.8b dense engine in
    this process serves phase 6's 16 requests four times, with the serve
    driver's stats stack (``--stats-period 0.25``, the sampler over the
    engine's registry, the SLO engine) off, on, on, off; tok/s of each."""
    import argparse
    import gc

    import torch
    from repro_torch.cluster import MetricsRegistry
    from repro_torch.cluster.backends import make_engine
    from repro_torch.launch import serve
    dev = torch.device("cuda", 0)
    metrics = MetricsRegistry()
    eng = make_engine(device=dev, paged=False, metrics=metrics, **CLUSTER_LM)
    prompts = _lm_prompts(eng.cfg.vocab)
    _drain(eng, [prompts[0][:40]], 8)
    args = argparse.Namespace(stats_period=STATS_PERIOD_S, stats_port=None,
                              stats_dump=None, stats_host="127.0.0.1",
                              watch=False)
    runs = []
    for on in (False, True, True, False):
        finalize = serve._start_telemetry(args, metrics.snapshot, metrics) \
            if on else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = _drain(eng, prompts, CLUSTER_NEW - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if finalize is not None:
            finalize()
        check(all(len(r.out_tokens) == CLUSTER_NEW for r in reqs),
              "telemetry overhead: short requests")
        runs.append((on, sum(r.decoded for r in reqs) / wall))
    off = [r for on, r in runs if not on]
    on_ = [r for on, r in runs if on]
    print(f"[telemetry overhead] one dense engine, {len(prompts)} requests x "
          f"{CLUSTER_NEW} tokens, the stats stack off/on/on/off: tok/s "
          + ", ".join(f"{'on' if on else 'off'} {r:.1f}" for on, r in runs)
          + f"; mean on / mean off = {sum(on_) / sum(off):.4f}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def _telemetry_driver():
    """``python -m repro_torch.launch.serve --stats-dump PREFIX`` at its
    defaults (full-width internlm2-1.8b on the card) in a process of its
    own: it prints its ``[stats]`` and ``[serve]`` lines and the four
    files parse."""
    import os
    OUT_DIR.mkdir(exist_ok=True)
    prefix = OUT_DIR / "chip_smoke_serve_stats"
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "8",
         "--stats-dump", str(prefix)], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and lines and lines[-1].startswith("[serve]")
          and any(ln.startswith("[stats] dumped 4 routes") for ln in lines),
          f"serve --stats-dump: rc {out.returncode}, stdout {out.stdout!r}, "
          f"stderr {out.stderr[-2000:]!r}")
    for name in ("timeseries", "slo"):
        json.loads(Path(f"{prefix}.{name}.json").read_text())
    metrics = Path(f"{prefix}.metrics.txt").read_text()
    check("repro_engine_tokens" in metrics and
          Path(f"{prefix}.dash.html").read_text().startswith("<!DOCTYPE"),
          "serve --stats-dump: the dumped routes")
    print(f"[telemetry driver] python -m repro_torch.launch.serve "
          f"--requests 8 --stats-dump: {lines[-1]} (process wall "
          f"{wall:.1f}s); 4 routes dumped and parsed")


# ----------------------------------------------------------------------
def phase_list(stats, launches, smi):
    csrc = "src/repro_torch/kernels/csrc/"
    source = {"paged_decode_attention": csrc + "paged_attention.cu",
              "paged_extend_attention": csrc + "paged_attention.cu",
              "flash_attention": csrc + "flash_attention.cu",
              "decode_attention": csrc + "decode_attention.cu",
              "pair_score": csrc + "pair_score.cu",
              "ssm_scan": csrc + "ssm_scan.cu",
              "ssm_scan_fused": csrc + "selective_scan.cu"}
    replaces = {"paged_decode_attention":
                "src/repro/kernels/paged_attention.py:78",
                "paged_extend_attention":
                "src/repro/kernels/paged_attention.py:178",
                "flash_attention": "src/repro/kernels/flash_attention.py:74",
                "decode_attention":
                "src/repro/kernels/decode_attention.py:40",
                "pair_score": "src/repro/kernels/pair_score.py:41",
                "ssm_scan": "src/repro/kernels/ssm_scan.py:44",
                "ssm_scan_fused": "src/repro/kernels/ssm_scan.py:44 with "
                                  "src/repro/kernels/ops.py:98-111"}
    kernels = [dict(name=name, route="cuda", source=source[name],
                    replaces=replaces[name], launches=launches[name],
                    **{k: stats[name][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")})
               for name in PAGED_KERNELS + DENSE_KERNELS + ("pair_score",) +
               SSM_KERNELS + ("ssm_scan_fused",)]
    check(all(math.isfinite(k["ms"]) for k in kernels), "bad timing")
    print(f"[kernels] {len(kernels)} ported kernels on {smi}")
    print(json.dumps({"kernels": kernels}))


if __name__ == "__main__":
    main()
