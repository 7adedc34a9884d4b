"""The Hopper scan design on the CPU: the split plan of the scan kernel
(``kernels/scan_plan.py``), the chunk algebra of its chunked route
emulated in torch, the fused selective scan's plain version and its
arithmetic emulated in numpy, and both wrappers up to the launch, against
the JAX package (its Pallas kernel in interpret mode, its ``ref`` and its
model's scan).

The CUDA kernels themselves run only on the card (``chip_smoke.py`` phase
2 holds them against these plain versions).  Inputs are made from a seed
with numpy.  Tolerances as tests/test_torch_ssm.py: ``atol = rtol = 1e-4``
for the scan and for the op against JAX's op over the Pallas kernel, and
``1e-3`` against the model's chunked ``associative_scan``
(tests/test_kernels.py:199-218); the chunked emulation reorders fp32
products, so it is held to the scan's tolerance too.
"""
import contextlib
import importlib.util
import inspect
import re
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_blocked  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build, ops, ref, scan_plan  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)

_jpallas_scan = jax.jit(ssm_scan_blocked,
                        static_argnames=("chunk", "block_d", "interpret"))
_jref_scan = jax.jit(jref.ssm_scan_ref)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# the split plan
PLAN_SHAPES = [(4, 512, 8192, 16), (1, 1000, 8192, 16), (2, 256, 8192, 16),
               (1, 100, 8192, 16),
               (1, 2200, 2560, 1), (1, 512, 2560, 1), (1, 1, 2560, 1),
               (2, 17, 2560, 1), (1, 9, 600, 1), (3, 130, 5, 3),
               (1, 33, 40, 16), (8, 300, 64, 1), (1, 512, 32768, 1),
               (1, 512, 65536, 1)]


@pytest.mark.parametrize("B,S,D,N", PLAN_SHAPES)
def test_plan_covers_every_step_of_every_row_once(B, S, D, N):
    p = scan_plan.split_plan(B, S, D, N)
    # chunk c holds steps [c chunk, min(S, (c + 1) chunk)), as the kernel
    # reads them (t0 = c chunk, T = min(chunk, S - t0))
    bounds = [(c * p.chunk, min(S, (c + 1) * p.chunk))
              for c in range(p.n_chunks)]
    steps = [t for lo, hi in bounds for t in range(lo, hi)]
    assert steps == list(range(S))
    assert all(hi > lo for lo, hi in bounds)
    assert p.n_tiles * scan_plan.TILE >= D * N > (p.n_tiles - 1) * \
        scan_plan.TILE
    if p.n_chunks > 1:
        assert scan_plan.CHUNK_MIN <= p.chunk <= scan_plan.CHUNK_MAX
        assert p.chunk % scan_plan.CHUNK_MIN == 0
        assert p.ws_floats == 3 * B * p.n_chunks * D * N
        assert p.n_flags == B * p.n_chunks * p.n_tiles + 1
    else:
        assert (p.chunk, p.ws_floats, p.n_flags) == (S, 0, 0)


def test_plan_keeps_the_single_walk_where_it_fills_the_card():
    """The Mamba serve's admit shapes keep one chunk: today's single walk
    (131,072, 65,536 and 32,768 threads)."""
    smoke = _smoke()
    assert smoke._mamba_admits() == [(4, 512), (1, 1000), (2, 256),
                                     (1, 100)]
    for B, S in smoke._mamba_admits():
        assert scan_plan.split_plan(B, S, 8192, 16).n_chunks == 1, (B, S)
    # the measured crossover: the single walk from 16,384 threads up
    assert scan_plan.split_plan(1, 512, 65536, 1).n_chunks == 1
    assert scan_plan.split_plan(1, 512, 65532, 1).n_chunks > 1


def test_plan_splits_the_rglru_recurrence_over_hundreds_of_ctas():
    """recurrentgemma-2b's admit at N = 1: 640 threads of the single walk
    become hundreds of CTAs, four an SM at least at S 2,200."""
    long = scan_plan.split_plan(1, 2200, 2560, 1)
    assert (long.chunk, long.n_chunks, long.n_tiles) == (96, 23, 20)
    assert long.n_chunks * long.n_tiles >= scan_plan.TARGET_CTAS
    short = scan_plan.split_plan(1, 512, 2560, 1)
    assert (short.chunk, short.n_chunks) == (48, 11)
    assert short.n_chunks * short.n_tiles >= scan_plan.SMS
    assert scan_plan.split_plan(1, scan_plan.CHUNK_MIN, 2560, 1).n_chunks \
        == 1


def test_plan_takes_shapes_only():
    """A function of four integers: no tensor, no device, no data, the same
    answer each time (so a CUDA graph can capture the call)."""
    assert list(inspect.signature(scan_plan.split_plan).parameters) == \
        ["B", "S", "D", "N"]
    assert scan_plan.split_plan(1, 2200, 2560, 1) == \
        scan_plan.split_plan(1, 2200, 2560, 1)


def test_source_holds_the_plans_tile_and_chunk():
    """The chunked kernel's tile and largest chunk are the plan's, as the
    library reports on the card (scan_plan.check_library)."""
    text = (build.CSRC / "ssm_scan.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", text)[1])
    assert "constexpr int SCAN_TILE = THREADS;" in text
    chunk = re.search(r"constexpr int SCAN_CHUNK_MAX = (\d+);", text)
    assert threads == scan_plan.TILE
    assert int(chunk[1]) == scan_plan.CHUNK_MAX
    fused = (build.CSRC / "selective_scan.cu").read_text()
    spl = int(re.search(r"constexpr int SPL = (\d+);", fused)[1])
    lanes = int(re.search(r"constexpr int MAX_LANES = (\d+);", fused)[1])
    assert spl * lanes == ss.MAX_STATES


# ----------------------------------------------------------------------
# the chunk algebra of the chunked route, emulated in torch
def _scan_inputs(seed, B, S, D, N):
    """Stable dynamics as tests/test_kernels.py:189-194."""
    rng = np.random.RandomState(seed)
    a = 1.0 / (1.0 + np.exp(-rng.randn(B, S, D, N)))
    b = rng.randn(B, S, D, N) * 0.1
    h0 = rng.randn(B, D, N)
    return [x.astype(np.float32) for x in (a, b, h0)]


def chunked_scan(a, b, h0, chunk, prefix_ready):
    """The chunked kernel's arithmetic: each chunk's aggregate (A = prod a,
    H = h from 0), the carry by look-back (back to the nearest chunk j
    whose prefix is published, ``prefix_ready(j)``, then forward from P_j
    over the aggregates after it), the inclusive prefix ``A carry + H``,
    then the rescan from the carry.  Chunk 0's prefix is always
    published."""
    S = a.shape[1]
    bounds = [(lo, min(S, lo + chunk)) for lo in range(0, S, chunk)]
    aggs, prefixes, hs = [], [], torch.empty_like(b)
    for c, (lo, hi) in enumerate(bounds):
        A, H = torch.ones_like(h0), torch.zeros_like(h0)
        for t in range(lo, hi):
            H = a[:, t] * H + b[:, t]
            A = A * a[:, t]
        aggs.append((A, H))
        carry = h0
        if c:
            j = c - 1
            while j and not prefix_ready(j):
                j -= 1
            carry = prefixes[j]
            for k in range(j + 1, c):
                carry = aggs[k][0] * carry + aggs[k][1]
        prefixes.append(A * carry + H)
        h = carry
        for t in range(lo, hi):
            h = a[:, t] * h + b[:, t]
            hs[:, t] = h
    return hs, h


@pytest.mark.parametrize("S,chunk", [
    (1, 8), (7, 8), (8, 8), (9, 8),       # S 1, chunk - 1, chunk, chunk + 1
    (37, 8), (130, 16), (33, 16)])        # ragged last chunks, many chunks
@pytest.mark.parametrize("N", [1, 16])
@pytest.mark.parametrize("ready", ["all", "none", "odd"])
def test_chunk_algebra_matches_the_plain_scan_and_jax(S, chunk, N, ready):
    B, D = 2, 8
    a, b, h0 = _scan_inputs(S + N, B, S, D, N)
    pick = {"all": lambda j: True, "none": lambda j: False,
            "odd": lambda j: j % 2 == 1}[ready]
    hs, hT = chunked_scan(_t(a), _t(b), _t(h0), chunk, pick)
    # the carry is the same bits however far a look-back walks
    first = chunked_scan(_t(a), _t(b), _t(h0), chunk, lambda j: True)
    assert torch.equal(hs, first[0]) and torch.equal(hT, first[1])
    ws, wT = ref.ssm_scan_ref(_t(a), _t(b), _t(h0))
    torch.testing.assert_close(hs, ws, **SCAN_TOL)
    torch.testing.assert_close(hT, wT, **SCAN_TOL)
    assert torch.equal(hT, hs[:, -1])
    for j_hs, j_hT in (
            _jpallas_scan(a, b, h0, chunk=chunk, block_d=D, interpret=True),
            _jref_scan(a, b, h0)):
        np.testing.assert_allclose(hs.numpy(), np.asarray(j_hs), **SCAN_TOL)
        np.testing.assert_allclose(hT.numpy(), np.asarray(j_hT), **SCAN_TOL)


def test_chunk_algebra_at_the_plans_chunk():
    """At a shape the plan splits (the RG-LRU's N = 1 over 600 channels),
    the emulation over the plan's chunks equals the plain scan."""
    B, S, D, N = 1, 41, 600, 1
    p = scan_plan.split_plan(B, S, D, N)
    assert p.n_chunks > 1
    a, b, h0 = map(_t, _scan_inputs(3, B, S, D, N))
    hs, hT = chunked_scan(a, b, h0, p.chunk, lambda j: j % 3 == 0)
    ws, wT = ref.ssm_scan_ref(a, b, h0)
    torch.testing.assert_close(hs, ws, **SCAN_TOL)
    torch.testing.assert_close(hT, wT, **SCAN_TOL)


# ----------------------------------------------------------------------
# the fused selective scan: its plain version and the op's CPU route
def _op_inputs(seed, B, S, di, N, dt_rank=5):
    """tests/test_kernels.py:205-213's op inputs, with Bc and Cc cut from
    one projection as ``models.ssm._ssm_params`` cuts them."""
    rng = np.random.RandomState(seed)
    softplus = lambda x: np.log1p(np.exp(x))  # noqa: E731
    xc = rng.randn(B, S, di)
    dt = softplus(rng.randn(B, S, di))
    proj = rng.randn(B, S, dt_rank + 2 * N)
    A = -np.exp(rng.randn(di, N))
    Dd = rng.randn(di)
    return [x.astype(np.float32) for x in (xc, dt, proj, A, Dd)]


def _split(proj, N):
    _, Bc, Cc = torch.split(_t(proj), [proj.shape[-1] - 2 * N, N, N], dim=-1)
    return Bc, Cc


@pytest.mark.parametrize("N", [3, 8, 16])
@pytest.mark.parametrize("S", [1, 37, 130])
@pytest.mark.parametrize("with_h0", [False, True])
def test_fused_plain_version_matches_jax(N, S, with_h0):
    """ref.selective_scan_ref and ops.ssm_scan on the CPU (Bc and Cc as
    strided torch.split views) against JAX's op over the Pallas kernel in
    interpret mode and its model's selective_scan."""
    B, di = 2, 32
    xc, dt, proj, A, Dd = _op_inputs(S * N, B, S, di, N)
    Bc, Cc = _split(proj, N)
    assert not Bc.is_contiguous() and Bc.stride(-1) == 1
    h0 = np.random.RandomState(N).randn(B, di, N).astype(np.float32) \
        if with_h0 else None
    th0 = None if h0 is None else _t(h0)
    args = (_t(xc), _t(dt), Bc, Cc, _t(A), _t(Dd))
    y, hT = ref.selective_scan_ref(*args, th0)
    ops.reset_counts()
    y_op, h_op = ops.ssm_scan(*args, h0=th0)
    assert ops.PLAIN_CALLS["ssm_scan"] == 1 and \
        sum(ops.PLAIN_CALLS.values()) == 1 and \
        set(kernels.LAUNCHES.values()) == {0}
    assert torch.equal(y_op, y) and torch.equal(h_op, hT)
    y_m, h_m = ssm.selective_scan(*args, h0=th0)
    assert torch.equal(y_m, y) and torch.equal(h_m, hT)
    jargs = (xc, dt, Bc.numpy().copy(), Cc.numpy().copy(), A, Dd)
    y_k, h_k = jops.ssm_scan(*jargs, h0=h0, chunk=32, block_d=32,
                             interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), **SCAN_TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_k), **SCAN_TOL)
    y_r, h_r = jssm.selective_scan(*jargs, h0=h0, chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **MODEL_TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_r), **MODEL_TOL)


def lanes(N):
    """The fused kernel's lanes a channel: the smallest power of two G with
    4 G >= N (``lanes_for`` in csrc/selective_scan.cu)."""
    G = 1
    while 4 * G < N:
        G *= 2
    return G


def fused_emulation(xc, dt, Bc, Cc, A, D, h0):
    """The fused kernel's arithmetic in numpy fp32: N padded to 4 G states
    (A = 0, B = C = 0, h = 0), a = 2^(dt (A log2 e)), h = fma(a, h, (dt x)
    B), each lane's partial sum over its 4 states, the G partials merged as
    __shfl_xor_sync does (offsets 1, 2, 4, ...), then D x added."""
    f32 = np.float32
    B_, S, di = xc.shape
    N = A.shape[1]
    G = lanes(N)
    NP = 4 * G
    pad = lambda x: np.concatenate(  # noqa: E731
        [x, np.zeros(x.shape[:-1] + (NP - N,), f32)], axis=-1)
    al2 = pad(A) * f32(1.4426950408889634)
    Bp, Cp = pad(Bc), pad(Cc)
    h = np.zeros((B_, di, NP), f32) if h0 is None else pad(h0)
    y = np.empty_like(xc)
    for t in range(S):
        dv, xv = dt[:, t, :, None], xc[:, t, :, None]
        a = np.exp2(dv * al2).astype(f32)
        h = (a * h + (dv * xv) * Bp[:, t, None, :]).astype(f32)
        part = np.zeros((B_, di, G), f32)
        for k in range(4):
            part = part + Cp[:, t, None, k::4] * h[..., k::4]
        sh = 1
        while sh < G:
            part = part + part[..., np.arange(G) ^ sh]
            sh *= 2
        y[:, t] = part[..., 0] + D * xc[:, t]
    return y, h[..., :N]


@pytest.mark.parametrize("N", [1, 3, 8, 16, 40])
@pytest.mark.parametrize("with_h0", [False, True])
def test_fused_kernel_arithmetic_matches_the_plain_version(N, with_h0):
    B, S, di = 2, 37, 12
    xc, dt, proj, A, Dd = _op_inputs(N, B, S, di, N)
    Bc, Cc = _split(proj, N)
    h0 = np.random.RandomState(N + 1).randn(B, di, N).astype(np.float32) \
        if with_h0 else None
    y, hT = fused_emulation(xc, dt, Bc.numpy(), Cc.numpy(), A, Dd, h0)
    wy, wT = ref.selective_scan_ref(_t(xc), _t(dt), Bc, Cc, _t(A), _t(Dd),
                                    None if h0 is None else _t(h0))
    np.testing.assert_allclose(y, wy.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(hT, wT.numpy(), **SCAN_TOL)
    assert lanes(N) * 4 >= N and (lanes(N) == 1 or lanes(N) * 2 < N)


# ----------------------------------------------------------------------
# the wrappers
def _fused_args(B=2, S=5, di=8, N=4):
    xc, dt, proj, A, Dd = _op_inputs(0, B, S, di, N)
    Bc, Cc = _split(proj, N)
    return [_t(xc), _t(dt), Bc, Cc, _t(A), _t(Dd),
            torch.zeros(B, di, N)]


@pytest.mark.parametrize("bad", [
    dict(xc=(2, 5, 9)), dict(A=(8, 4, 1)), dict(A=(7, 4)), dict(D=(9,)),
    dict(h0=(2, 8, 3)), dict(Bc=(2, 5, 3)), dict(S=0),
    dict(N=ss.MAX_STATES + 1), dict(dtype=("xc", torch.bfloat16)),
    dict(dtype=("Cc", torch.float64)), dict(dtype=("h0", torch.float16)),
    dict(transposed="Bc"), dict(transposed="xc")])
def test_fused_wrapper_rejects_what_it_should(bad):
    """Bad shapes, non-fp32 inputs, B or C without unit stride over N and
    non-contiguous dense inputs raise a ValueError naming ssm_scan on both
    routes; nothing launches."""
    args = _fused_args(S=bad.get("S", 5), N=bad.get("N", 4))
    keys = ["xc", "dt", "Bc", "Cc", "A", "D", "h0"]
    for key in ("xc", "A", "D", "h0", "Bc"):
        if key in bad:
            args[keys.index(key)] = torch.zeros(bad[key])
    if "dtype" in bad:
        key, dtype = bad["dtype"]
        args[keys.index(key)] = args[keys.index(key)].to(dtype)
    if "transposed" in bad:
        i = keys.index(bad["transposed"])
        args[i] = args[i].transpose(1, 2).contiguous().transpose(1, 2)
    ops.reset_counts()
    with pytest.raises(ValueError, match="ssm_scan"):
        ss.check_fused_args(*args)
    with pytest.raises(ValueError, match="ssm_scan"):
        ops.ssm_scan(*args[:6], h0=args[6])
    with pytest.raises(ValueError, match="ssm_scan"):
        ss.selective_scan_fused(*args)
    assert set(kernels.LAUNCHES.values()) == {0}


def test_wrappers_take_cuda_tensors_only():
    ops.reset_counts()
    with pytest.raises(ValueError, match="ssm_scan: the kernel takes CUDA"):
        ss.selective_scan_fused(*_fused_args())
    a, b, h0 = map(_t, _scan_inputs(0, 1, 20, 600, 1))
    with pytest.raises(ValueError, match="ssm_scan: the kernel takes CUDA"):
        ss.ssm_scan_blocked(a, b, h0)
    assert set(kernels.LAUNCHES.values()) == {0}


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' path on a card, with the CUDA calls stubbed: every
    tensor passes as a CUDA tensor, and the libraries record their
    calls."""
    calls = []

    class Lib:
        def repro_ssm_scan(self, *args):
            calls.append(("scan", args))
            return 0

        def repro_selective_scan_fused(self, *args):
            calls.append(("fused", args))
            return 0

    monkeypatch.setattr(ss, "_library", lambda: Lib())
    monkeypatch.setattr(ss, "_fused_library", lambda: Lib())
    monkeypatch.setattr(ss, "_cuda_only", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("B,S,D,N", [(1, 2200, 2560, 1), (2, 17, 600, 1),
                                     (1, 100, 8192, 16)])
def test_scan_wrapper_passes_the_plan_and_counts_one_launch(fake_card, B, S,
                                                            D, N):
    a = torch.zeros(B, S, D, N)
    h0 = torch.zeros(B, D, N)
    ops.reset_counts()
    hs, hT = ss.ssm_scan_blocked(a, a, h0)
    assert hs.shape == a.shape and hT.shape == h0.shape
    assert kernels.LAUNCHES["ssm_scan"] == 1
    (route, args), = fake_card
    p = scan_plan.split_plan(B, S, D, N)
    assert route == "scan" and args[5:11] == (B, S, D, N, p.chunk,
                                             p.n_chunks)
    if p.n_chunks > 1:
        assert args[11] and args[12]           # the scratch's pointers
    else:
        assert args[11:13] == (None, None)


def test_fused_wrapper_passes_the_views_strides_and_counts_one_launch(
        fake_card):
    args = _fused_args(B=2, S=5, di=8, N=4)
    ops.reset_counts()
    y, hT = ss.selective_scan_fused(*args[:6])
    assert y.shape == (2, 5, 8) and hT.shape == (2, 8, 4)
    assert kernels.LAUNCHES["ssm_scan"] == 1
    (route, got), = fake_card
    Bc, Cc = args[2], args[3]
    assert route == "fused" and got[6] is None         # no h0: zeros
    assert got[9:17] == (2, 5, 8, 4, Bc.stride(0), Bc.stride(1),
                         Cc.stride(0), Cc.stride(1))
    assert Bc.stride(1) == 5 + 2 * 4


@pytest.mark.parametrize("fused", [False, True])
def test_wrappers_raise_on_a_failed_launch(fake_card, monkeypatch, fused):
    lib = types.SimpleNamespace(repro_ssm_scan=lambda *a: 700,
                                repro_selective_scan_fused=lambda *a: 700)
    monkeypatch.setattr(ss, "_library", lambda: lib)
    monkeypatch.setattr(ss, "_fused_library", lambda: lib)
    ops.reset_counts()
    with pytest.raises(RuntimeError, match="ssm_scan.*CUDA error 700"):
        if fused:
            ss.selective_scan_fused(*_fused_args())
        else:
            ss.ssm_scan_blocked(torch.zeros(1, 9, 8, 1),
                                torch.zeros(1, 9, 8, 1), torch.zeros(1, 8, 1))
    assert kernels.LAUNCHES["ssm_scan"] == 0


# ----------------------------------------------------------------------
# the build
def test_build_compiles_both_scan_sources():
    assert {"ssm_scan.cu", "selective_scan.cu"} <= set(build.SOURCES)
    for source in ("ssm_scan.cu", "selective_scan.cu"):
        assert {"scan_common.cuh", "common.cuh", "sm90_ptx.cuh"} <= \
            set(build.local_includes(source))
    fused = (build.CSRC / "selective_scan.cu").read_text()
    # the profile's kinds count the kernel as the scan by its symbol
    assert "ssm_scan_fused_kernel" in fused and "ex2(" in fused
    assert "repro_selective_scan_fused" in fused
    assert "ssm_scan_chunked_kernel" in (build.CSRC / "ssm_scan.cu"
                                         ).read_text()


def test_scan_ab_script_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("runs on a card")
    script = build.CSRC.parents[3] / "scripts" / "scan_ab.py"
    done = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120)
    assert done.returncode != 0
    assert "scan_ab: no CUDA card" in done.stderr
    assert "[ab]" not in done.stdout


# ----------------------------------------------------------------------
# the shapes chip_smoke.py checks
def _smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only)."""
    path = build.CSRC.parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_mamba_admits_are_the_engines():
    """Phase 2 checks the scan kernels at ``_mamba_admits()`` and phase 4
    holds the Mamba serve's recorded admits to them: on the CPU the
    reduced falcon-mamba-7b engine admits prompts of the same pattern of
    lengths as those runs, in order."""
    from repro_torch.cluster.backends import make_engine
    from repro_torch.cluster.tracing import current_recorder
    lengths = (6, 6, 6, 6, 11, 4, 4, 3)
    eng = make_engine("falcon-mamba-7b", max_len=32, slots=8, seed=0,
                      device="cpu")
    rng = np.random.RandomState(1)
    seq0 = current_recorder().last_seq
    for n in lengths:
        eng.submit(rng.randint(0, eng.cfg.vocab, n).astype(np.int32),
                   max_new=2)
    eng.run_until_drained()
    admits = [(e["n"], e["bucket"]) for e in current_recorder().events()
              if e["seq"] > seq0 and e["kind"] == "admit"]
    assert admits == _smoke()._mamba_admits(lengths) == \
        [(4, 6), (1, 11), (2, 4), (1, 3)]
