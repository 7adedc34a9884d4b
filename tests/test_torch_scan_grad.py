"""The scans' gradients (the RG-LRU's recurrence, ``ops.linear_scan``, and
Mamba's selective scan, ``ops.ssm_scan``) on the CPU: the plain
backward against ``jax.grad`` of the JAX functions, the adjoints written
out in ``kernels/ref.py``, the backward kernels' algebra emulated in
torch (the chunked reverse scan's look-back over ``scan_plan.bwd_plan``'s
chunks; the fused backward's checkpoints, reverse walk and fixed-order
partial sums), the autograd binding of both kernels with the library
stubbed (the CUDA kernels run only on the card, in ``chip_smoke.py``),
the work formulas and the dry run's count of a reduced train step of
each family.

Tolerances: against JAX, atol = rtol = 1e-4, the repo's scan tolerance
(``tests/test_kernels.py:199-200``): JAX runs the recurrence as a chunked
``associative_scan``, which multiplies the a's in another order, and its
gradient goes back through that order too.  The explicit adjoints and the
emulations run in fp64 against autograd in fp64 at 1e-10 relative: the
same sums, in another order.
"""
import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import base, get_config, reduced  # noqa: E402
from repro_torch.kernels import build, ops, ref, scan_plan, work  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.launch import dryrun_lib  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _linear_inputs(seed, B, S, w):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    a = 1.0 / (1.0 + np.exp(-f(B, S, w)))
    return a, 0.1 * f(B, S, w), f(B, w), f(B, S, w), f(B, w)


def _selective_inputs(seed, B, S, di, N, dt_rank=5):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    xc = f(B, S, di)
    dt = np.log1p(np.exp(f(B, S, di))).astype(np.float32)
    proj = f(B, S, dt_rank + 2 * N)
    A = -np.exp(f(di, N))
    return dict(xc=xc, dt=dt, proj=proj, A=A, D=f(di), h0=f(B, di, N),
                gy=f(B, S, di), gT=f(B, di, N), dt_rank=dt_rank, N=N)


# ----------------------------------------------------------------------
# the plain backwards against jax.grad
@pytest.mark.parametrize("S", [1, 37, 130])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_grads_match_jax(S, with_h0):
    """``ops.linear_scan``'s CPU route under autograd (through the port's
    ``rglru.diag_scan``) against ``jax.grad`` of JAX's ``diag_scan``, with
    upstream gradients on h_seq and h_final."""
    a, b, h0, gy, gT = _linear_inputs(S, 2, S, 24)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, b, h0)]
    hs, hT = rglru.diag_scan(ts[0], ts[1], ts[2] if with_h0 else None)
    ((hs * torch.from_numpy(gy)).sum() +
     (hT * torch.from_numpy(gT)).sum()).backward()

    def loss(a, b, h0):
        h_seq, h_fin = jrglru.diag_scan(a, b, h0 if with_h0 else None)
        return jnp.sum(h_seq * gy) + jnp.sum(h_fin * gT)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(a, b, h0)
    for t, w, name in zip(ts[:3 if with_h0 else 2], want, ("a", "b", "h0")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **TOL)
    assert kernels.LAUNCHES["linear_scan_bwd"] == 0


@pytest.mark.parametrize("N,S", [(3, 1), (8, 37), (16, 70)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_grads_match_jax(N, S, with_h0):
    """``ops.ssm_scan``'s CPU route under autograd (through the port's
    ``ssm.selective_scan``, Bc and Cc as ``torch.split`` views of one
    projection) against ``jax.grad`` of JAX's ``selective_scan``, every
    input's gradient, with upstream gradients on y and h_final."""
    d = _selective_inputs(S * N, 2, S, 12, N)
    r = d["dt_rank"]
    ts = {k: torch.from_numpy(d[k]).requires_grad_(True)
          for k in ("xc", "dt", "proj", "A", "D", "h0")}
    _, Bc, Cc = torch.split(ts["proj"], [r, N, N], dim=-1)
    y, hT = ssm.selective_scan(ts["xc"], ts["dt"], Bc, Cc, ts["A"], ts["D"],
                               ts["h0"] if with_h0 else None)
    ((y * torch.from_numpy(d["gy"])).sum() +
     (hT * torch.from_numpy(d["gT"])).sum()).backward()

    def loss(xc, dt, Bc, Cc, A, D, h0):
        y, h_fin = jssm.selective_scan(xc, dt, Bc, Cc, A, D,
                                       h0 if with_h0 else None, chunk=16)
        return jnp.sum(y * d["gy"]) + jnp.sum(h_fin * d["gT"])
    jargs = (d["xc"], d["dt"], d["proj"][..., r:r + N],
             d["proj"][..., r + N:], d["A"], d["D"], d["h0"])
    want = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*jargs)
    got = [ts["xc"].grad, ts["dt"].grad, ts["proj"].grad[..., r:r + N],
           ts["proj"].grad[..., r + N:], ts["A"].grad, ts["D"].grad,
           ts["h0"].grad]
    names = ("xc", "dt", "Bc", "Cc", "A", "D", "h0")
    for g, w, name in list(zip(got, want, names))[:7 if with_h0 else 6]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    assert not ts["proj"].grad[..., :r].any()
    assert kernels.LAUNCHES["selective_scan_bwd"] == 0


def _f64(*xs):
    return [torch.from_numpy(np.asarray(x, dtype=np.float64)) for x in xs]


def test_explicit_adjoints_equal_autograd():
    """``ref.linear_scan_bwd_ref`` and ``ref.selective_scan_bwd_ref``, the
    adjoints written out step by step, equal autograd through the plain
    forwards in fp64 (1e-10 of each gradient's largest magnitude)."""
    a, b, h0, gy, gT = _f64(*_linear_inputs(3, 2, 45, 7))
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    hs, hT = ref.ssm_scan_ref(*leaves)
    want = torch.autograd.grad((hs * gy).sum() + (hT * gT).sum(), leaves)
    got = ref.linear_scan_bwd_ref(a, hs.detach(), h0, gy, gT)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-10 * w.abs().max()
    d = _selective_inputs(4, 2, 45, 9, 6)
    xc, dt, A, D, h0, gy, gT = _f64(*(d[k] for k in ("xc", "dt", "A", "D",
                                                     "h0", "gy", "gT")))
    Bc, Cc = _f64(d["proj"][..., 5:11], d["proj"][..., 11:])
    for h in (h0, None):
        leaves = [t.clone().requires_grad_(True) for t in
                  (xc, dt, Bc, Cc, A, D)] + \
            ([h.clone().requires_grad_(True)] if h is not None else [])
        y, hT = ref.selective_scan_ref(*leaves[:6],
                                       leaves[6] if h is not None else None)
        want = torch.autograd.grad((y * gy).sum() + (hT * gT).sum(), leaves)
        got = ref.selective_scan_bwd_ref(xc, dt, Bc, Cc, A, D, h, gy, gT)
        for g, w in zip(got, want):
            assert (g - w).abs().max() <= 1e-10 * w.abs().max()


# ----------------------------------------------------------------------
# the chunked reverse scan (linear_scan_bwd_kernel) emulated
def chunked_bwd(a, g, gT, hs, h0, chunk, prefix_ready):
    """The N = 1 backward kernel's algebra over chunks of ``chunk`` steps,
    in reversed chunk order rc (rc 0 the last chunk): each chunk's
    aggregate (the product A of its a, and H, the carry m = a lam at its
    start from m = 0 at its end), the look-back to the nearest later
    chunk whose prefix is published (``prefix_ready(rc)``; rc 0 always),
    folding the aggregates between with the fixed chain P_k = A_k P_{k-1}
    + H_k, then the rescan from the carry.  Returns (da, db, dh0)."""
    S = a.shape[1]
    n = -(-S // chunk)
    agg, pref = {}, {}
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None
    for rc in range(n):
        t0 = (n - 1 - rc) * chunk
        t1 = min(t0 + chunk, S)
        A, H = torch.ones_like(gT), torch.zeros_like(gT)
        for t in range(t1 - 1, t0 - 1, -1):
            H = a[:, t] * (H + g[:, t])
            A = A * a[:, t]
        agg[rc] = (A, H)
        if rc == 0:
            carry = gT
        else:
            j = max(k for k in range(rc) if k == 0 or prefix_ready(k))
            carry = pref[j]
            for k in range(j + 1, rc):
                carry = agg[k][0] * carry + agg[k][1]
        pref[rc] = A * carry + H
        for t in range(t1 - 1, t0 - 1, -1):
            lam = carry + g[:, t]
            db[:, t] = lam
            da[:, t] = lam * (hs[:, t - 1] if t else h0)
            carry = a[:, t] * lam
        dh0 = carry
    return da, db, dh0


@pytest.mark.parametrize("S,chunk", [(1, 16), (16, 16), (17, 16),
                                     (95, 32), (200, 48), (300, 96)])
@pytest.mark.parametrize("ready", ["all", "none", "every third"])
def test_reverse_chunk_algebra_matches_the_adjoint(S, chunk, ready):
    """However far each chunk's look-back walks, the emulated kernel gives
    the written-out adjoint (fp64, 1e-10 relative); the control, each
    chunk's carry dropped (as a kernel that lost it would give), does
    not."""
    a, b, h0, gy, gT = _f64(*_linear_inputs(S, 2, S, 5))
    hs, _ = ref.ssm_scan_ref(a, b, h0)
    want = ref.linear_scan_bwd_ref(a, hs, h0, gy, gT)
    pick = {"all": lambda k: True, "none": lambda k: False,
            "every third": lambda k: k % 3 == 0}[ready]
    got = chunked_bwd(a, gy, gT, hs, h0, chunk, pick)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-10 * w.abs().max()
    if S > chunk:
        lost = [chunked_bwd(a[:, t0:t0 + chunk], gy[:, t0:t0 + chunk],
                            gT if t0 + chunk >= S else torch.zeros_like(gT),
                            hs[:, t0:t0 + chunk],
                            hs[:, t0 - 1] if t0 else h0, chunk, pick)
                for t0 in range(0, S, chunk)]
        db = torch.cat([x[1] for x in lost], dim=1)
        assert (db - want[1]).abs().max() > 1e-3 * want[1].abs().max()


@pytest.mark.parametrize("B,S,w", [(1, 1, 2560), (2, 1024, 2560),
                                   (1, 2200, 2560), (4, 1024, 64),
                                   (8, 512, 65536)])
def test_bwd_plan_covers_s_in_chunks_the_kernel_takes(B, S, w):
    """The backward's plan is always the chunked design: chunks of
    CHUNK_MIN to CHUNK_MAX steps that cover S with a ragged last one, one
    chunk where S fits it, the forward's chunk sizing, its scratch one
    status a (row, chunk, tile) and the ticket; from shapes alone."""
    p = scan_plan.bwd_plan(B, S, w, 1)
    assert scan_plan.CHUNK_MIN <= p.chunk <= scan_plan.CHUNK_MAX
    assert p.chunk * (p.n_chunks - 1) < S <= p.chunk * p.n_chunks
    assert p.n_tiles == -(-w // scan_plan.TILE)
    assert p.n_flags == B * p.n_chunks * p.n_tiles + 1
    assert p.ws_floats == 3 * B * p.n_chunks * w
    fwd = scan_plan.split_plan(B, S, w, 1)
    if fwd.n_chunks > 1:
        assert fwd == p
    text = (build.CSRC / "ssm_scan.cu").read_text()
    assert "linear_scan_bwd_kernel" in text and \
        "extern \"C\" int repro_linear_scan_bwd(" in text


# ----------------------------------------------------------------------
# the fused backward (selective_scan_bwd_kernel) emulated
def fused_bwd(xc, dt, Bc, Cc, A, D, h0, gy, gT, chunk=ss.CHUNK):
    """The fused backward kernel's algebra: the forward's checkpoints (h
    at each chunk's start), then the chunks from the last, each
    recomputing its h from its checkpoint and walking its steps in
    reverse with the carry m = a lam; the channel sums of dB and dC as
    per-CTA partials over blocks of 128 / G channels summed in order, dA
    and dD as per-row partials summed in order."""
    Bsz, S, di = xc.shape
    N = A.shape[1]
    G = ss.lanes(N)
    dc_ = ss.CTA_THREADS // G
    if h0 is None:
        h0 = torch.zeros(Bsz, di, N, dtype=xc.dtype)
    a_bar = torch.exp(dt[..., None] * A)
    b_bar = (dt * xc)[..., None] * Bc[:, :, None, :]
    hs, _ = ref.ssm_scan_ref(a_bar, b_bar, h0)
    n_ck = -(-S // chunk)
    hck = [h0] + [hs[:, c * chunk - 1] for c in range(1, n_ck)]
    dx, ddt = torch.zeros_like(xc), torch.zeros_like(xc)
    dBs, dCs = [], []
    dA_rows, dD_rows = torch.zeros(Bsz, di, N, dtype=xc.dtype), \
        torch.zeros(Bsz, di, dtype=xc.dtype)
    m = gT.clone()
    for c in range(n_ck - 1, -1, -1):
        s0, s1 = c * chunk, min(c * chunk + chunk, S)
        h, hbuf = hck[c], []
        for t in range(s0, s1):                # the recompute
            h = a_bar[:, t] * h + b_bar[:, t]
            hbuf.append(h)
        part_b = torch.zeros(Bsz, s1 - s0, di, N, dtype=xc.dtype)
        part_c = torch.zeros_like(part_b)
        for t in range(s1 - 1, s0 - 1, -1):
            a = a_bar[:, t]
            hp = hbuf[t - s0 - 1] if t > s0 else hck[c]
            lam = gy[:, t, :, None] * Cc[:, t, None, :] + m
            part_c[:, t - s0] = gy[:, t, :, None] * hbuf[t - s0]
            part_b[:, t - s0] = lam * (dt[:, t] * xc[:, t])[..., None]
            sx = (lam * Bc[:, t, None, :]).sum(-1)
            dx[:, t] = gy[:, t] * D + dt[:, t] * sx
            ddt[:, t] = (lam * (xc[:, t, :, None] * Bc[:, t, None, :] +
                                A * a * hp)).sum(-1)
            dA_rows += lam * dt[:, t, :, None] * a * hp
            dD_rows += gy[:, t] * xc[:, t]
            m = a * lam
        dBs.insert(0, part_b)
        dCs.insert(0, part_c)
    pb, pc = torch.cat(dBs, 1), torch.cat(dCs, 1)     # (B, S, di, N)
    dB, dC = torch.zeros(Bsz, S, N, dtype=xc.dtype), \
        torch.zeros(Bsz, S, N, dtype=xc.dtype)
    for k in range(0, di, dc_):                       # the CTAs, in order
        dB = dB + pb[:, :, k:k + dc_].sum(2)
        dC = dC + pc[:, :, k:k + dc_].sum(2)
    dA, dD = torch.zeros_like(A), torch.zeros_like(D)
    for r in range(Bsz):                              # the rows, in order
        dA, dD = dA + dA_rows[r], dD + dD_rows[r]
    return dx, ddt, dB, dC, dA, dD, m


@pytest.mark.parametrize("B,S,di,N", [(2, 1, 7, 3), (1, 32, 40, 8),
                                      (2, 33, 70, 16), (1, 100, 9, 32),
                                      (2, 70, 300, 4)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_fused_backward_algebra_matches_the_adjoint(B, S, di, N, with_h0):
    """The emulated fused backward (checkpoints every 32 steps, the
    reverse walk, the per-CTA channel partials) equals the written-out
    adjoint in fp64 (1e-10 of each gradient's largest magnitude); S at and
    past the 32-step chunk's edges, N 3 to 32 (1 to 8 lanes a channel),
    di not a multiple of a CTA's channels."""
    d = _selective_inputs(S + N, B, S, di, N)
    xc, dt, A, D, h0, gy, gT = _f64(*(d[k] for k in ("xc", "dt", "A", "D",
                                                     "h0", "gy", "gT")))
    Bc, Cc = _f64(d["proj"][..., 5:5 + N], d["proj"][..., 5 + N:])
    h = h0 if with_h0 else None
    want = ref.selective_scan_bwd_ref(xc, dt, Bc, Cc, A, D, h, gy, gT)
    got = fused_bwd(xc, dt, Bc, Cc, A, D, h, gy, gT)
    for g, w, name in zip(got, want, ("x", "dt", "B", "C", "A", "D", "h0")):
        assert (g - w).abs().max() <= 1e-10 * w.abs().max(), name


def test_fused_backward_source_holds_the_mirror_constants():
    """The chunk the forward keeps h at, the CTA's threads, the states a
    lane and the backward's largest lane count are the wrapper's."""
    import re
    text = (build.CSRC / "selective_scan.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["FCHUNK"]) == ss.CHUNK
    assert int(consts["FT"]) == ss.CTA_THREADS
    assert int(consts["SPL"]) * int(consts["MAX_BWD_LANES"]) == \
        ss.MAX_BWD_STATES
    assert "selective_scan_bwd_kernel" in text and \
        "selective_scan_bwd_reduce_kernel" in text
    assert [ss.lanes(n) for n in (1, 4, 5, 8, 16, 17, 32, 128)] == \
        [1, 1, 2, 2, 4, 8, 8, 32]


# ----------------------------------------------------------------------
# the kernel route with the CUDA calls stubbed
@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor passes as a CUDA tensor and takes the kernel route;
    the scan libraries record their calls."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, args))
                return 0
            return call

    monkeypatch.setattr(ss, "_library", lambda: Lib())
    monkeypatch.setattr(ss, "_fused_library", lambda: Lib())
    monkeypatch.setattr(ss, "_cuda_only", lambda t: None)
    monkeypatch.setattr(ops, "_route", lambda name, q: "cuda")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("B,S,w", [(2, 300, 600), (1, 17, 64),
                                   (1, 2200, 2560)])
def test_linear_scan_binds_forward_and_backward(fake_card, B, S, w):
    """``ops.linear_scan`` under grad: the scan kernel's forward, then
    the backward kernel on the forward's h_seq with the upstream
    gradients made fp32 and contiguous, B, S, w, N = 1 and bwd_plan's
    chunks and scratch; one launch of each counted, none plain; without
    grad the forward alone, as before."""
    ops.reset_counts()
    a, b, h0 = (torch.zeros(B, S, w, requires_grad=True),
                torch.zeros(B, S, w, requires_grad=True),
                torch.zeros(B, w, requires_grad=True))
    hs, hT = ops.linear_scan(a, b, h0)
    assert hs.grad_fn is not None and hs.shape == (B, S, w)
    (hs.sum() + hT.sum()).backward()
    (fname, fwd), (bname, bwd) = fake_card
    assert (fname, bname) == ("repro_ssm_scan", "repro_linear_scan_bwd")
    p = scan_plan.bwd_plan(B, S, w, 1)
    assert bwd[8:14] == (B, S, w, 1, p.chunk, p.n_chunks)
    assert bwd[3] == fwd[3]                     # the forward's h_seq
    assert bwd[14] and bwd[15]                  # the scratch
    assert a.grad.shape == a.shape and h0.grad.shape == h0.shape
    assert a.grad.dtype == torch.float32
    assert kernels.LAUNCHES["ssm_scan"] == 1
    assert kernels.LAUNCHES["linear_scan_bwd"] == 1
    assert not any(ops.PLAIN_CALLS.values())
    with torch.no_grad():
        assert ops.linear_scan(a, b, h0)[0].grad_fn is None
    assert kernels.LAUNCHES["ssm_scan"] == 2
    assert len(fake_card) == 3


@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_binds_forward_and_backward(fake_card, with_h0):
    """``ops.ssm_scan`` under grad: the fused forward keeps its
    checkpoints (B, ceil(S / 32), di, N), and the backward reads them with
    the op's inputs at Bc's and Cc's strides; one launch of each counted;
    dh0 only where h0 was given; without grad no checkpoints."""
    B, S, di, N, r = 2, 70, 40, 8, 5
    ops.reset_counts()
    proj = torch.zeros(B, S, r + 2 * N, requires_grad=True)
    _, Bc, Cc = torch.split(proj, [r, N, N], dim=-1)
    xc, dt = (torch.zeros(B, S, di, requires_grad=True) for _ in range(2))
    A, D = torch.zeros(di, N, requires_grad=True), \
        torch.zeros(di, requires_grad=True)
    h0 = torch.zeros(B, di, N, requires_grad=True) if with_h0 else None
    y, hT = ops.ssm_scan(xc, dt, Bc, Cc, A, D, h0)
    assert y.grad_fn is not None and hT.shape == (B, di, N)
    (y.sum() + hT.sum()).backward()
    (fname, fwd), (bname, bwd) = fake_card
    assert (fname, bname) == ("repro_selective_scan_fused",
                              "repro_selective_scan_bwd")
    assert fwd[17] is not None and fwd[17] == bwd[8]   # the checkpoints
    assert (fwd[6] is not None) == with_h0
    assert bwd[17:25] == (B, S, di, N, Bc.stride(0), Bc.stride(1),
                          Cc.stride(0), Cc.stride(1))
    assert bwd[16]                                      # the partials
    assert proj.grad.shape == proj.shape and A.grad.shape == A.shape
    assert D.grad.shape == D.shape and xc.grad.shape == xc.shape
    if with_h0:
        assert h0.grad.shape == h0.shape
    assert kernels.LAUNCHES["ssm_scan"] == 1
    assert kernels.LAUNCHES["selective_scan_bwd"] == 1
    assert not any(ops.PLAIN_CALLS.values())
    with torch.no_grad():
        ops.ssm_scan(xc, dt, Bc, Cc, A, D, h0)
    assert fake_card[-1][1][17] is None


def test_backward_workspace_and_refusals(fake_card):
    """The fused backward's partials are 2 B n_dblk S N + B di N + B di
    floats (n_dblk: CTAs of 128 / G channels a row); it takes N <= 32 and
    refuses more before it launches, under grad only (the forward takes
    N <= 128)."""
    assert ss.bwd_workspace(4, 1024, 8192, 16) == \
        2 * 4 * 256 * 1024 * 16 + 4 * 8192 * 16 + 4 * 8192
    assert ss.bwd_workspace(2, 5, 33, 3) == 2 * 2 * 1 * 5 * 3 + 2 * 33 * 3 + \
        2 * 33
    ops.reset_counts()
    N = ss.MAX_BWD_STATES + 1
    args = [torch.zeros(1, 4, 8, requires_grad=True),
            torch.zeros(1, 4, 8), torch.zeros(1, 4, N), torch.zeros(1, 4, N),
            torch.zeros(8, N), torch.zeros(8)]
    with pytest.raises(ValueError, match="selective_scan_bwd: N = 33"):
        ops.ssm_scan(*args)
    assert not fake_card and not any(kernels.LAUNCHES.values())
    with torch.no_grad():
        ops.ssm_scan(*args)
    assert kernels.LAUNCHES["ssm_scan"] == 1
    with pytest.raises(ValueError, match="gradient of shape"):
        ss.linear_scan_bwd(torch.zeros(1, 3, 4, 1), torch.zeros(1, 3, 4),
                           torch.zeros(1, 4, 1), torch.zeros(1, 3, 4, 1),
                           torch.zeros(1, 4, 1))


def test_backward_wrappers_take_cuda_tensors_only():
    ops.reset_counts()
    z = torch.zeros(1, 3, 4, 1)
    with pytest.raises(ValueError, match="ssm_scan: the kernel takes CUDA"):
        ss.linear_scan_bwd(z, z, z[:, 0], z, z[:, 0])
    x = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match="ssm_scan: the kernel takes CUDA"):
        ss.selective_scan_bwd(x, x, torch.zeros(1, 3, 2),
                              torch.zeros(1, 3, 2), torch.zeros(4, 2),
                              torch.zeros(4), x, torch.zeros(1, 4, 2),
                              torch.zeros(1, 1, 4, 2))
    assert not any(kernels.LAUNCHES.values())


# ----------------------------------------------------------------------
# the work formulas and the dry run
def test_backward_work_formulas():
    """The backwards' least bytes (each input read once, each output
    written once) and operations, by hand."""
    w = work.linear_scan_bwd(2, 5, 3, 1)
    assert (w.flops, w.bytes, w.dtype) == (90, 4 * (5 * 30 + 3 * 6),
                                           "float32")
    B, S, di, N = 2, 33, 4, 3
    w = work.selective_scan_bwd(B, S, di, N)
    n_el = B * S * di * N
    assert w.exps == n_el and w.flops == 16 * n_el + 4 * B * S * di
    assert w.bytes == 4 * (5 * B * S * di + 4 * B * S * N + B * 2 * di * N +
                           2 * di * N + 2 * B * di * N + 2 * di)
    pairs = work.visible_pairs(20, 20, True, 0)
    w = work.flash_attention_bwd(2, 20, 20, 4, 2, 24, hd_v=16,
                                 dtype="float32")
    assert w.flops == 2 * (3 * 24 + 2 * 16) * pairs * 2 * 4
    assert w.bytes == 4 * (2 * 2 * 20 * 4 * 40 + 2 * 2 * 20 * 2 * 40) + \
        4 * 2 * 20 * 4
    same = work.flash_attention_bwd(2, 20, 20, 4, 2, 24, dtype="float32")
    assert same == work.flash_attention_bwd(2, 20, 20, 4, 2, 24, hd_v=24,
                                            dtype="float32")
    assert same.flops == 10 * 24 * pairs * 2 * 4


def _kinds(cfg, kind):
    return sum(g.repeats * g.pattern.count(kind) for g in cfg.groups)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b",
                                  "deepseek-v2-lite-16b"])
def test_dry_run_counts_the_backward_kernels(arch, monkeypatch):
    """A reduced train step of each family on fake tensors (the dry run,
    nothing built or launched): each kind's backward kernel counted once a
    layer (the selective scan's a Mamba layer, the N = 1 scan's an RG-LRU
    layer, flash's an attention or MLA layer at its (q/k, v) widths), with
    ``kernels/work.py``'s work, and ``kernels.LAUNCHES`` left at 0."""
    monkeypatch.setattr(build, "load", lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("the dry run built a kernel")))
    cfg = reduced(get_config(arch)).replace(remat="none")
    ops.reset_counts()
    got = dryrun_lib.count_cell(cfg, base.ShapeCase("s", 64, 2, "train"),
                                abstract_mesh((1, 1), ("data", "model"),
                                              rank0=True),
                                "broadcast")["launches"]
    want = {"selective_scan_bwd": _kinds(cfg, "S"),
            "linear_scan_bwd": _kinds(cfg, "R"),
            "flash_attention_bwd": _kinds(cfg, "L") + _kinds(cfg, "D") +
            _kinds(cfg, "M") + _kinds(cfg, "A")}
    assert {k: got.get(k, 0) for k in want} == want, got
    assert got.get("ssm_scan", 0) == want["selective_scan_bwd"] + \
        want["linear_scan_bwd"]
    assert not any(kernels.LAUNCHES.values())
