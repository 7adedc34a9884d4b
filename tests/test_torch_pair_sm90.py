"""The pair score's Hopper design (3xTF32 on wgmma, ``csrc/pair_sm90.cuh``)
held on the CPU, where no card runs it.

- The plan (``kernels/pair_plan.py``): routes, tiles, depth splits and
  workspace at MARGOT's batch shape (256, 512, 1024), the stream's 1024^3
  and the wgmma route's edges; bf16 and d % 4 != 0 go to the CUDA-core
  route; every split covers each depth step once, in as few waves of
  clusters as the card holds.
- The numeric design: a numpy emulation of the kernel's arithmetic (TF32
  hi / lo splits rounded as ``cvt.rna.tf32.f32`` rounds, three products a
  32-deep stage summed in fp32, stages and depth chunks added in order)
  within ``PAIR_REL`` of fp64 at the batch shape, where one TF32 product
  (the control) is not; and, at the edge shapes, within ``PAIR_REL`` of
  the Pallas kernel in interpret mode.
- The wrapper: it rejects CPU tensors, routes by the plan, passes the
  plan's splits to the C entry point, rejects misaligned tensors on the
  wgmma route and counts one launch a call.
- The header, whose tiles the plan mirrors, and the A/B script, which
  refuses to run without a card.

``chip_smoke.py`` phase 2 holds the CUDA kernel itself against its plain
version on the card.
"""
import contextlib
import inspect
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build, pair_plan  # noqa: E402
from repro_torch.kernels import pair_score as ps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: chip_smoke.PAIR_REL: max |kernel - fp64| <= PAIR_REL * max |fp64|
PAIR_REL = 1e-5
F32, BF16 = torch.float32, torch.bfloat16


# ----------------------------------------------------------------------
# the plan

def _steps(d):
    return -(-d // pair_plan.TILE_K)


@pytest.mark.parametrize("N,M,d,project,score", [
    # MARGOT's batch partition and the stream's chunk
    (256, 512, 1024, (16, 6, 6), (8, 8, 4)),
    (1024, 1024, 1024, (64, 2, 16), (64, 2, 16)),
    # N and M off the 128-row tiles, ragged last chunks (33 steps in 4 x 9
    # and 7 x 5), d = 4k off the 32-deep stages
    (257, 513, 1028, (27, 4, 9), (15, 7, 5)),
    (100, 60, 132, (2, 3, 2), (1, 3, 2)),
    (1, 1, 1024, (8, 8, 4), (1, 8, 4)),
])
def test_plan_tiles_and_splits(N, M, d, project, score):
    p = pair_plan.plan(N, M, d, F32, F32)
    assert p.route == "wgmma"
    assert (p.project.rows, p.project.cols) == (d, N)
    assert (p.score.rows, p.score.cols) == (N, M)
    assert (p.project.tiles, p.project.split, p.project.per_split) == project
    assert (p.score.tiles, p.score.split, p.score.per_split) == score
    assert p.ws_floats == N * d + N + M


@pytest.mark.parametrize("N,M,d,c_dtype,w_dtype", [
    (256, 512, 1024, BF16, BF16),
    (256, 512, 1024, BF16, F32),     # bf16 claims, fp32 link model
    (256, 512, 1024, F32, BF16),
    (257, 513, 130, F32, F32),       # rows of 520 bytes: no TMA
    (5, 3, 1, F32, F32),
])
def test_plan_sends_bf16_and_unaligned_widths_to_the_cuda_cores(
        N, M, d, c_dtype, w_dtype):
    p = pair_plan.plan(N, M, d, c_dtype, w_dtype)
    assert p.route == "simt" and p.project is None and p.score is None
    assert p.ws_floats == N * d + N + M


@pytest.mark.parametrize("N,M,d", [
    (1, 1, 4), (1, 1, 32), (64, 128, 256), (128, 128, 512), (100, 60, 128),
    (480, 480, 1024), (1024, 512, 1024), (4096, 4096, 1024), (7, 9, 4092),
    (300, 20, 8192)])
def test_plan_splits_cover_each_depth_step_once(N, M, d):
    """Chunk c holds steps [c per, min(steps, (c + 1) per)): none empty,
    together every step once; the split fits a portable cluster, keeps
    MIN_STEPS steps a chunk when it splits, and no other split gives
    fewer waves of clusters times steps a chunk."""
    steps = _steps(d)
    for g in pair_plan.plan(N, M, d, F32, F32)[2:]:
        chunks = [range(c * g.per_split, min(steps, (c + 1) * g.per_split))
                  for c in range(g.split)]
        assert all(len(c) > 0 for c in chunks)
        assert [s for c in chunks for s in c] == list(range(steps))
        assert 1 <= g.split <= pair_plan.MAX_SPLIT
        assert g.split == 1 or g.per_split >= pair_plan.MIN_STEPS
        waves = lambda s: -(-g.tiles // pair_plan.MAX_CLUSTERS[s])  # noqa
        best = min(waves(s) * -(-steps // s)
                   for s in range(1, pair_plan.MAX_SPLIT + 1)
                   if s == 1 or -(-steps // s) >= pair_plan.MIN_STEPS)
        assert waves(g.split) * g.per_split <= best
        assert g.tiles == (-(-g.rows // pair_plan.TILE_M) *
                           -(-g.cols // pair_plan.TILE_N))


def test_plan_at_the_batch_shape_fills_one_wave():
    """The batch path's two launches run one wave each on the card's
    clusters: 96 and 64 CTAs, every cluster resident at once."""
    p = pair_plan.plan(256, 512, 1024, F32, F32)
    for g in (p.project, p.score):
        assert g.tiles <= pair_plan.MAX_CLUSTERS[g.split]
        assert g.ctas <= pair_plan.MAX_CLUSTERS[1]
    assert (p.project.ctas, p.score.ctas) == (96, 64)


def test_plan_takes_shapes_and_dtypes_only():
    """The plan is a function of plain numbers and dtypes: no tensor, no
    device, the same answer each time."""
    a = pair_plan.plan(256, 512, 1024, F32, F32)
    assert a == pair_plan.plan(256, 512, 1024, F32, F32)
    assert list(inspect.signature(pair_plan.plan).parameters) == \
        ["N", "M", "d", "c_dtype", "w_dtype"]


def test_header_holds_the_plans_tiles():
    """The kernel's tiles and largest split are the plan's, as the library
    itself reports on the card (pair_plan.check_library)."""
    text = (build.CSRC / "pair_sm90.cuh").read_text()
    got = {k: int(v) for k, v in
           re.findall(r"constexpr int (PAIR_B[MNK]|PAIR_MAX_SPLIT) = (\d+);",
                      text)}
    assert got == {"PAIR_BM": pair_plan.TILE_M, "PAIR_BN": pair_plan.TILE_N,
                   "PAIR_BK": pair_plan.TILE_K,
                   "PAIR_MAX_SPLIT": pair_plan.MAX_SPLIT}


def test_pair_score_source_holds_both_routes():
    assert "pair_sm90.cuh" in build.local_includes("pair_score.cu")
    text = "".join((build.CSRC / n).read_text() for n in
                   ["pair_score.cu", *build.local_includes("pair_score.cu")])
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32",
                   "cp.async.bulk.tensor.2d", "barrier.cluster.arrive",
                   "ld.shared::cluster", "griddepcontrol.wait",
                   "project_kernel", "score_kernel",
                   "repro_pair_score_sm90", "repro_pair_sm90_config"):
        assert needle in text, needle
    conds = re.findall(r"^\s*#\s*(?:if|ifdef|ifndef|elif)\b(.*)$",
                       (build.CSRC / "pair_sm90.cuh").read_text(), re.M)
    assert conds == []


# ----------------------------------------------------------------------
# the numeric design

def _tf32_rna(x):
    """x (float32) rounded to TF32 on the bit pattern, as the kernel's
    tf32_rna does: half a TF32 unit added, the low 13 bits cleared."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _gemm_3xtf32(A, B, split, stage=pair_plan.TILE_K):
    """A (rows, K) B^T (cols, K) -> (rows, cols) as the kernel sums it:
    each 32-deep stage's three TF32 products (lo hi, hi lo, hi hi) in a
    fresh fp32 accumulator, the stages of a chunk added in order in fp32,
    the chunks of the split added in order."""
    K = A.shape[1]
    steps = -(-K // stage)
    per = -(-steps // split)
    ah, al = _split(A)
    bh, bl = _split(B)
    out = np.zeros((A.shape[0], B.shape[0]), np.float32)
    for c in range(0, steps, per):
        acc = np.zeros_like(out)
        for s in range(c, min(steps, c + per)):
            k = slice(s * stage, (s + 1) * stage)
            st = al[:, k] @ bh[:, k].T
            st += ah[:, k] @ bl[:, k].T
            st += ah[:, k] @ bh[:, k].T
            acc += st
        out += acc
    return out


def _pair_inputs(seed, N, M, d):
    rng = np.random.RandomState(seed)
    C = rng.randn(N, d).astype(np.float32)
    E = rng.randn(M, d).astype(np.float32)
    W = (rng.randn(d, d) / np.sqrt(d)).astype(np.float32)
    w = rng.randn(2 * d).astype(np.float32)
    return C, E, W, w


def _emulated(C, E, W, w, b):
    N, d = C.shape
    p = pair_plan.plan(N, E.shape[0], d, F32, F32)
    P = _gemm_3xtf32(np.ascontiguousarray(W.T), C, p.project.split).T
    lin_c = (C.astype(np.float32) @ w[:d]).astype(np.float32)
    lin_e = (E.astype(np.float32) @ w[d:]).astype(np.float32)
    bil = _gemm_3xtf32(np.ascontiguousarray(P), E, p.score.split)
    return ((bil + lin_c[:, None]) + lin_e[None, :]) + np.float32(b)


def _fp64(C, E, W, w, b):
    d = C.shape[1]
    C, E, W, w = (x.astype(np.float64) for x in (C, E, W, w))
    return (C @ W) @ E.T + (C @ w[:d])[:, None] + (E @ w[d:])[None, :] + b


def test_tf32_rounding_is_to_nearest_ties_away():
    """The bit-pattern rounding against exact arithmetic: to the nearest
    multiple of the TF32 unit (2^-10 of the binade), ties away from zero,
    a carry into the next binade included."""
    rng = np.random.RandomState(0)
    x = (rng.randn(20000) * 10.0 ** rng.randint(-30, 30, 20000))
    ulp = np.float32(2.0 ** -10)
    ties = (np.float32(1.0) + ulp * (np.arange(1, 65) + np.float32(0.5)))
    x = np.concatenate([x.astype(np.float32), ties, -ties,
                        np.float32([2.0 - 2.0 ** -12, -(2.0 - 2.0 ** -12),
                                    0.0, 1.0])])
    got = _tf32_rna(x).astype(np.float64)
    m, e = np.frexp(x.astype(np.float64))        # x = m 2^e, |m| in [.5, 1)
    q = np.abs(m) * 2.0 ** 11                      # 11 bits: the TF32 mantissa
    want = np.sign(m) * np.floor(q + 0.5) * 2.0 ** (e - 11)
    np.testing.assert_array_equal(got, want)
    assert np.all((_tf32_rna(x).view(np.uint32) & 0x1FFF) == 0)


def test_3xtf32_holds_fp64_where_one_tf32_product_cannot():
    """At the batch shape the emulated kernel is within PAIR_REL of fp64,
    about 20x inside it; the TF32 control, one product of the rounded
    operands, is off by more than the limit, so the limit sees TF32."""
    C, E, W, w = _pair_inputs(7, 256, 512, 1024)
    want = _fp64(C, E, W, w, 0.3)
    scale = np.abs(want).max()
    err = np.abs(_emulated(C, E, W, w, 0.3).astype(np.float64) - want).max()
    assert err <= PAIR_REL * scale / 5, err / scale
    d = C.shape[1]
    P = _tf32_rna(C) @ _tf32_rna(W)
    one = (_tf32_rna(P) @ _tf32_rna(E).T + (C @ w[:d])[:, None]
           + (E @ w[d:])[None, :] + np.float32(0.3))
    ctl = np.abs(one.astype(np.float64) - want).max() / scale
    assert ctl > PAIR_REL, ctl


@pytest.mark.parametrize("N,M,d", [(100, 60, 132), (257, 513, 1028),
                                   (64, 128, 256)])
def test_emulated_kernel_matches_the_pallas_kernel(N, M, d):
    """The kernel's arithmetic, emulated at the wgmma route's edges
    (ragged tiles, a depth split with a short last chunk, d off the
    32-deep stages), against the Pallas kernel in interpret mode and fp64,
    each within PAIR_REL of the largest score: at d = 1028 the scores
    reach ~150, and two fp32 orders of summation differ by more than the
    absolute 1e-4 of tests/test_torch_kernels.py's PAIR_TOL, which its
    widths (d <= 512) keep."""
    C, E, W, w = _pair_inputs(11, N, M, d)
    jlink = {"W": jnp.asarray(W), "w": jnp.asarray(w),
             "bias": jnp.asarray(0.3)}
    pallas = np.asarray(jops.pair_score(jlink, jnp.asarray(C),
                                        jnp.asarray(E), block_n=32,
                                        block_m=64, interpret=True))
    got = _emulated(C, E, W, w, 0.3)
    assert np.abs(got - pallas).max() <= PAIR_REL * np.abs(pallas).max()
    want = _fp64(C, E, W, w, 0.3)
    assert np.abs(got - want).max() <= PAIR_REL * np.abs(want).max()


# ----------------------------------------------------------------------
# the wrapper

def _link(d, dtype=F32):
    return (torch.zeros(d, d, dtype=dtype), torch.zeros(2 * d, dtype=dtype),
            torch.tensor(0.0))


def test_wrapper_takes_cuda_tensors_only():
    W, w, b = _link(32)
    c, e = torch.zeros(5, 32), torch.zeros(3, 32)
    with pytest.raises(ValueError, match="CUDA"):
        ps.pair_score_blocked(c, e, W, w[:32], w[32:], b)


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's path on a card, with the CUDA calls stubbed: every
    tensor passes as a CUDA tensor, and the library records its calls."""
    calls = []

    class Lib:
        def repro_pair_score_sm90(self, *args):
            calls.append(("sm90", args))
            return 0

        def repro_pair_score(self, *args):
            calls.append(("simt", args))
            return 0

    monkeypatch.setattr(ps, "_library", lambda: Lib())
    monkeypatch.setattr(ps, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("N,M,d,dtype,route", [
    (256, 512, 1024, F32, "sm90"), (100, 60, 132, F32, "sm90"),
    (257, 513, 130, F32, "simt"), (256, 512, 1024, BF16, "simt")])
def test_wrapper_routes_by_the_plan_and_counts_one_launch(fake_card, N, M,
                                                          d, dtype, route):
    W, w, b = _link(d, dtype)
    c = torch.zeros(N, d, dtype=dtype)
    e = torch.zeros(M, d, dtype=dtype)
    before = kernels.LAUNCHES["pair_score"]
    for k in range(2):
        out = ps.pair_score_blocked(c, e, W, w[:d], w[d:], b)
        assert tuple(out.shape) == (N, M) and out.dtype == F32
        assert kernels.LAUNCHES["pair_score"] == before + k + 1
    assert [r for r, _ in fake_card] == [route, route]
    args = fake_card[0][1]
    p = pair_plan.plan(N, M, d, dtype, dtype)
    if route == "sm90":
        assert args[8:11] == (N, M, d)
        assert args[11:15] == (p.project.split, p.project.per_split,
                               p.score.split, p.score.per_split)
    else:
        assert args[:2] == (kernels.DTYPE_CODE[dtype],) * 2
        assert args[10:13] == (N, M, d)


def test_wrapper_rejects_misaligned_tensors_on_the_wgmma_route(fake_card):
    """TMA reads the wgmma route's tensors from 16-byte boundaries: a
    contiguous view one float in raises; nothing launches."""
    W, w, b = _link(32)
    c = torch.zeros(5 * 32 + 1)[1:].view(5, 32)
    with pytest.raises(ValueError, match="16-byte"):
        ps.pair_score_blocked(c, torch.zeros(3, 32), W, w[:32], w[32:], b)
    assert fake_card == []


@pytest.mark.parametrize("rc,match", [
    (-1, "plan that does not cover the depth"),
    (-2, "cuTensorMapEncodeTiled could not be found"),
    (-3, "refused a TMA tensor map"),
    (700, "CUDA error 700")])
def test_wrapper_raises_on_a_failed_launch(fake_card, monkeypatch, rc,
                                           match):
    monkeypatch.setattr(ps, "_library", lambda: types.SimpleNamespace(
        repro_pair_score_sm90=lambda *a: rc))
    W, w, b = _link(32)
    before = kernels.LAUNCHES["pair_score"]
    with pytest.raises(RuntimeError, match=match):
        ps.pair_score_blocked(torch.zeros(5, 32), torch.zeros(3, 32), W,
                              w[:32], w[32:], b)
    assert kernels.LAUNCHES["pair_score"] == before


def test_pair_score_ab_script_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("runs on a card")
    done = subprocess.run([sys.executable,
                           str(ROOT / "scripts" / "pair_score_ab.py")],
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert "pair_score_ab: no CUDA card" in done.stderr
    assert "[ab]" not in done.stdout
