"""The flash attention gradient of the port: the CPU route's gradients
against JAX's, the backward kernel's tile walk emulated in torch, and the
autograd binding and refusals on the kernel route (with the library
stubbed: the CUDA kernels run only on the card, in ``chip_smoke.py``).

On the CPU, ``ops.flash_attention`` is the plain version under autograd.
Its gradients are held against ``jax.grad`` of both JAX oracles,
``repro.kernels.ref.flash_attention_ref`` and the chunked
``models.attention.flash_attention_jnp`` (the path JAX trains through at
S >= 1024, here with small chunks), at ``atol = rtol = 1e-5`` (fp32, sums
in another order).
"""
import contextlib
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_bwd_plan as fbp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# (B, S, H, KV, hd, causal, window): causal, window and bidirectional
# masks at G 1 and 2, hd 64 and 128
CASES = [(2, 24, 2, 2, 64, True, 0), (1, 37, 4, 2, 128, True, 0),
         (2, 20, 4, 2, 64, True, 6), (1, 19, 2, 2, 128, False, 0),
         (1, 33, 4, 4, 64, False, 7), (2, 17, 2, 1, 128, True, 5)]


def _inputs(B, S, H, KV, hd, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return f(B, S, H, hd), f(B, S, KV, hd), f(B, S, KV, hd), f(B, S, H, hd)


def _torch_grads(q, k, v, dout, causal, window):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*ts, causal=causal, window=window)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, q, k, v, dout):
    f = lambda q, k, v: jnp.sum(fn(q, k, v) * dout)  # noqa: E731
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", CASES)
def test_cpu_gradients_match_jax_oracles(B, S, H, KV, hd, causal, window):
    q, k, v, dout = _inputs(B, S, H, KV, hd)
    out, grads = _torch_grads(q, k, v, dout, causal, window)
    oracles = [lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=causal, window=window)]
    if causal:                  # the chunked path masks causally
        oracles.append(lambda q, k, v: flash_attention_jnp(
            q, k, v, causal=True, window=window, q_chunk=8, kv_chunk=8))
    for fn in oracles:
        np.testing.assert_allclose(out, np.asarray(jax.jit(fn)(q, k, v)),
                                   **TOL)
        for got, want, name in zip(grads, _jax_grads(fn, q, k, v, dout),
                                   "qkv"):
            np.testing.assert_allclose(got, np.asarray(want), err_msg=name,
                                       **TOL)


def test_cpu_route_builds_a_graph_only_under_grad():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 9, 2, 1, 64))
    assert ops.flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert ops.flash_attention(qg, k, v).grad_fn is None
    out = ops.flash_attention(qg, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())
    assert kernels.LAUNCHES["flash_attention_bwd"] == 0


# ----------------------------------------------------------------------
# The bf16 backward kernels' arithmetic and tile walk
# (csrc/flash_attention_bwd.cu, mirrored in kernels/flash_bwd_plan.py)
# emulated in torch: the dK / dV kernel's key tiles and the row tiles of
# whole queries each walks, the dQ kernel's row tiles and the 64-key tiles
# each walks, the masks only on tiles where some pair is not visible, P
# from the forward's lse in the log2 domain (the dK / dV kernel's S^T
# accumulator starts at -lse / scale), D from the output, and P and
# dS split into bf16 hi + lo (as split_bf2 rounds them) before their
# products.  With ``lo=False`` P and dS are rounded once to bf16: the
# control that shows what the lo half buys.
def _rows(q, b, kvh, G, r0, r1):
    """Rows r0 .. r1 - 1 of (b, kv head): (query s, head kvh * G + g)."""
    r = torch.arange(r0, r1)
    return q[b, r // G, kvh * G + r % G]


def _visible(r, t, S, G, causal, window):
    s = (r // G)[:, None]
    ok = (t[None, :] < S) & (t[None, :] >= 0)
    if causal:
        ok = ok & (t[None, :] <= s)
    if window:
        ok = ok & (t[None, :] > s - window)
    return ok


def _split(x, lo=True):
    """x as bf16 hi and lo (zero without ``lo``), each back in fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, ((x - hi).to(torch.bfloat16).float() if lo
                else torch.zeros_like(x))


def _emulated_bwd(q, k, v, out, dout, lse, causal, window, lo=True):
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, 1.0 / math.sqrt(hd)
    log2e = math.log2(math.e)
    delta = (dout * out).sum(-1)                       # flash_bwd_delta
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for b in range(B):
        for kvh in range(KV):
            Q, dO = (_rows(x, b, kvh, G, 0, S * G) for x in (q, dout))
            L = _rows(lse[..., None], b, kvh, G, 0, S * G)[:, 0]
            D = _rows(delta[..., None], b, kvh, G, 0, S * G)[:, 0]
            K, V = k[b, :, kvh], v[b, :, kvh]

            def tile(kw0, rt, dkdv):
                rows, keys, ok = (torch.from_numpy(a) for a in fbp.tile_pairs(
                    "dkdv" if dkdv else "dq", kw0, rt, S, G, causal,
                    window, T))
                s = Q[rows] @ K[keys].T
                if dkdv:    # S^T's accumulator starts at -lse / scale
                    p = torch.exp2((s - L[rows, None] / scale) *
                                   (scale * log2e))
                else:       # 2^(s scale log2e - lse log2e)
                    p = torch.exp2(s * (scale * log2e) -
                                   L[rows, None] * log2e)
                p = torch.where(ok, p, 0.0)
                ds = p * (dO[rows] @ V[keys].T - D[rows, None])
                return rows, keys, p, ds
            dkb, dvb, dqb = (torch.zeros_like(x) for x in (K, V, Q))
            # dK / dV: grid over key tiles, each walking its row tiles
            for kw0, rt in fbp.walk("dkdv", S, G, hd, causal, window, T):
                rows, keys, p, ds = tile(kw0, rt, True)
                for x, y, acc in ((p, dO, dvb), (ds, Q, dkb)):
                    hi, low = _split(x, lo)
                    acc[keys] += hi.T @ y[rows] + low.T @ y[rows]
            # dQ: grid over row tiles, each walking its key tiles
            for t0, rt in fbp.walk("dq", S, G, hd, causal, window, T):
                rows, keys, p, ds = tile(t0, rt, False)
                hi, low = _split(ds, lo)
                dqb[rows] += hi @ K[keys] + low @ K[keys]
            dk[b, :, kvh] = dkb * scale
            dv[b, :, kvh] = dvb
            dq[b, :, kvh * G:(kvh + 1) * G] = (dqb * scale).reshape(S, G, hd)
    return dq, dk, dv


def _lse_as_the_kernels_write_it(q, k, causal, window):
    """m * scale + ln(l), m the raw max and l the sum of exp((s - m) *
    scale), as the bf16 kernel's epilogue writes it."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G, scale = H // KV, 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, S, KV, G, hd), k)
    ok = _visible(torch.arange(S) * G, torch.arange(S), S, G, causal, window)
    s = torch.where(ok, s, ref.NEG_INF)
    m = s.amax(-1, keepdim=True)
    lse = m[..., 0] * scale + torch.log(torch.exp((s - m) * scale).sum(-1))
    return lse.permute(0, 3, 1, 2).reshape(B, S, H)


@pytest.mark.parametrize("B,S,H,KV,causal,window", [
    (1, 1, 2, 2, True, 0), (1, 33, 2, 1, True, 0), (2, 70, 6, 2, True, 0),
    (1, 65, 4, 4, False, 0), (1, 70, 3, 1, True, 20), (1, 45, 4, 2, False,
                                                       9)])
def test_emulated_kernel_tiles_match_autograd(B, S, H, KV, causal, window):
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(B, S, H, KV, 16, seed=S))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.flash_attention_ref(*qkv, causal=causal, window=window)
    out.backward(dout)
    lse = _lse_as_the_kernels_write_it(q, k, causal, window)
    scale = 1.0 / math.sqrt(16)
    sc = torch.einsum("bqkgh,bskh->bkgqs",
                      q.reshape(B, S, KV, H // KV, 16), k) * scale
    ok = _visible(torch.arange(S) * (H // KV), torch.arange(S), S, H // KV,
                  causal, window)
    want = torch.logsumexp(torch.where(ok, sc, -torch.inf), -1)
    torch.testing.assert_close(lse, want.permute(0, 3, 1, 2).reshape(
        B, S, H), **TOL)
    got = _emulated_bwd(q, k, v, out.detach(), dout, lse, causal, window)
    for g, t in zip(got, qkv):
        torch.testing.assert_close(g, t.grad, **TOL)


def _emulation_case(B, S, H, KV, hd, causal, window):
    """Inputs, autograd's gradients through the plain version, and the
    emulation with and without P's and dS's lo halves."""
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(B, S, H, KV, hd, seed=S + H))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.flash_attention_ref(*qkv, causal=causal, window=window)
    out.backward(dout)
    lse = _lse_as_the_kernels_write_it(q, k, causal, window)
    args = (q, k, v, out.detach(), dout, lse, causal, window)
    return ([t.grad for t in qkv], _emulated_bwd(*args),
            _emulated_bwd(*args, lo=False))


def _rel(got, want):
    """max |got - want| over the largest |want| of each gradient."""
    return [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]


# (B, S, H, KV, hd, causal, window): G 7, 10, 12 and 80 (two head blocks
# of a row tile), S at and next to the 128-key tile's edges at hd 16 and
# the 64-key tile's at hd 256, a window, bidirectional
WALK_CASES = [(1, 130, 7, 1, 16, True, 0), (1, 65, 20, 2, 16, True, 0),
              (1, 129, 12, 1, 16, True, 40), (1, 20, 80, 1, 16, True, 0),
              (1, 127, 2, 2, 16, True, 0), (1, 128, 2, 2, 16, True, 0),
              (1, 129, 2, 1, 16, False, 0), (1, 65, 4, 2, 256, True, 0),
              (1, 64, 2, 2, 256, False, 0), (1, 200, 10, 1, 256, True, 48)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", WALK_CASES)
def test_emulated_walk_matches_autograd_at_the_new_tiles(B, S, H, KV, hd,
                                                         causal, window):
    """P and dS as hi + lo keep the kernels' gradients within 2e-5 of each
    one's largest magnitude (the split leaves at most 2^-17 of each
    element; the emulation reads 1e-6 to 6e-6)."""
    want, got, _ = _emulation_case(B, S, H, KV, hd, causal, window)
    rel = _rel(got, want)
    assert max(rel) <= 2e-5, rel


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window",
                         [(2, 70, 6, 2, 16, True, 0),
                          (1, 130, 7, 1, 16, True, 0),
                          (1, 65, 4, 2, 256, False, 0)])
def test_rounding_p_and_ds_once_lands_farther(B, S, H, KV, hd, causal,
                                              window):
    """The control: P and dS rounded once to bf16, with no lo half, land
    at least 100x farther from the fp32 gradients than hi + lo does in
    each of dq, dk and dv, and beyond 2e-4 of each one's largest magnitude
    (they read 8e-4 to 3e-3, hi + lo 1e-6 to 6e-6)."""
    want, got, once = _emulation_case(B, S, H, KV, hd, causal, window)
    for r_hilo, r_once in zip(_rel(got, want), _rel(once, want)):
        assert r_once > max(100 * r_hilo, 2e-4), (r_hilo, r_once)


# ----------------------------------------------------------------------
# MLA's (q/k, v) pairs: v narrower than q and k
def _inputs_qv(B, S, H, KV, hd, hd_v, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return (f(B, S, H, hd), f(B, S, KV, hd), f(B, S, KV, hd_v),
            f(B, S, H, hd_v))


@pytest.mark.parametrize("B,S,H,KV,hd,hd_v,causal,window", [
    (2, 19, 4, 4, 24, 16, True, 0), (1, 33, 2, 1, 24, 16, True, 5),
    (1, 21, 4, 2, 24, 16, False, 0), (1, 40, 2, 2, 192, 128, True, 0),
    (2, 17, 2, 1, 192, 128, False, 0)])
def test_cpu_gradients_match_jax_at_mla_pairs(B, S, H, KV, hd, hd_v, causal,
                                              window):
    """The plain flash backward at MLA's (q/k, v) pairs, (24, 16) (the
    reduced deepseek's) and (192, 128): the CPU route's gradients against
    ``jax.grad`` of ``flash_attention_jnp`` (small chunks) at atol = rtol
    = 1e-5 (fp32, sums in another order)."""
    q, k, v, dout = _inputs_qv(B, S, H, KV, hd, hd_v, seed=S + hd)
    out, grads = _torch_grads(q, k, v, dout, causal, window)
    assert out.shape == (B, S, H, hd_v)
    fn = lambda q, k, v: flash_attention_jnp(  # noqa: E731
        q, k, v, causal=causal, window=window, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(out, np.asarray(jax.jit(fn)(q, k, v)), **TOL)
    for got, want, name in zip(grads, _jax_grads(fn, q, k, v, dout), "qkv"):
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **TOL)


@pytest.mark.parametrize("B,S,H,KV,causal,window", [
    (1, 63, 2, 2, True, 0), (1, 65, 4, 4, True, 0), (1, 129, 2, 1, True, 0),
    (1, 70, 2, 2, False, 0), (1, 90, 2, 2, True, 30)])
def test_emulated_walk_matches_autograd_at_192_128(B, S, H, KV, causal,
                                                   window):
    """The bf16 kernels' walk at q/k 192, v 128 (64-key dK / dV tiles, as
    at hd 256; dP and dV over v's width): the emulation with P and dS as
    hi + lo within 2e-5 of each gradient's largest magnitude, and P and dS
    rounded once beyond 2e-4 (the control)."""
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs_qv(B, S, H, KV, 192, 128, seed=S))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.flash_attention_ref(*qkv, causal=causal, window=window)
    out.backward(dout)
    lse = _lse_as_the_kernels_write_it(q, k, causal, window)
    args = (q, k, v, out.detach(), dout, lse, causal, window)
    want = [t.grad for t in qkv]
    got = _emulated_bwd(*args)
    assert [tuple(g.shape) for g in got] == [tuple(t.shape) for t in qkv]
    assert max(_rel(got, want)) <= 2e-5, _rel(got, want)
    assert min(_rel(_emulated_bwd(*args, lo=False), want)) > 2e-4


@pytest.mark.parametrize("hd,hd_v", [(16, 16), (32, 32), (64, 64),
                                     (128, 128), (256, 256), (192, 128)])
def test_column_split_gives_each_block_to_one_owner(hd, hd_v):
    """The dK / dV kernel's two consumer warpgroups: at hd <= 128 each owns
    every column block of its own 64 keys; past it they share 64 keys and
    each of dK's and dV's column blocks has exactly one owner, warpgroup 0
    the first half rounded up (at (192, 128): dK 0-1 and dV 0, then dK 2
    and dV 1); the shared memory of both kernels fits an SM's 227 KiB."""
    nk, nv = fbp.column_blocks(hd), fbp.column_blocks(hd_v)
    parts = [fbp.column_split(hd, hd_v, w) for w in (0, 1)]
    if fbp.key_tile(hd) == fbp.KEY_TILE:
        assert parts == [(0, nk, 0, nv)] * 2
    else:
        for first, n, total in ((0, 1, nk), (2, 3, nv)):
            owned = [c for part in parts
                     for c in range(part[first], part[first] + part[n])]
            assert owned == list(range(total))
            assert parts[0][n] == -(-total // 2) and parts[1][n] >= 1
    if (hd, hd_v) == (192, 128):
        assert parts == [(0, 2, 0, 1), (2, 1, 1, 1)]
    assert max(fbp.dkdv_smem(hd, hd_v), fbp.dq_smem(hd, hd_v)) <= 232448


def test_kernel_source_builds_the_mla_pairs():
    """The backward's C entry point dispatches MLA's pairs, (192, 128) on
    both routes and (24, 16) on the CUDA cores, and its plans are the
    mirror's (``KvPlan`` / ``DqPlan`` over both widths)."""
    from repro_torch.kernels import build
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "return launch_dtype<192, 128>(dtype, p, B, st);" in text
    assert "return launch_dtype<24, 16>(dtype, p, B, st);" in text
    assert "KvPlan<192, 128>::SMEM" in text
    assert "DqPlan<192, 128>::SMEM" in text
    assert "if constexpr (HD % 16 == 0 && DV % 16 == 0)" in text
    assert "NK0 = SPLIT_COLS ? (T::NCB + 1) / 2 : T::NCB;" in text
    assert kernels.FLASH_QK_V_DIMS == {(192, 128): (torch.float32,
                                                    torch.bfloat16),
                                       (24, 16): (torch.float32,)}


@pytest.mark.parametrize("kernel", ["dkdv", "dq"])
@pytest.mark.parametrize("S,G,hd,causal,window", [
    (1, 1, 128, True, 0), (64, 2, 128, True, 0), (129, 2, 128, True, 0),
    (257, 1, 128, True, 0), (200, 12, 128, True, 0), (129, 7, 64, True, 0),
    (200, 10, 256, True, 48), (65, 2, 256, False, 0), (200, 2, 128, False,
                                                       64),
    (130, 80, 32, True, 0), (100, 3, 16, True, 1)])
def test_tile_plan_lets_each_visible_pair_in_once(kernel, S, G, hd, causal,
                                                  window):
    """Every (row, key) pair a mask lets through enters each kernel's sums
    exactly once over its grid, and no masked pair does: the walks cover
    the visible pairs, and the unmasked-tile shortcut lets nothing past a
    mask."""
    got = fbp.coverage(kernel, S, G, hd, causal, window)
    np.testing.assert_array_equal(got, fbp.visible(S, G, causal, window))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3),
                                           (False, 0), (False, 48)])
@pytest.mark.parametrize("G", [1, 2, 7, 12, 80])
def test_key_rows_are_the_visible_rows(G, causal, window):
    """The dK / dV kernel's mask of a masked pair, two row thresholds a
    key (no division by G per element), lets a key into exactly the rows
    whose query sees it, for every key near a row tile, keys >= S too."""
    S = 70
    gt, nq, _, _ = fbp.row_tiles(S, G)
    for s0 in range(0, S, nq):
        for key in range(max(0, s0 - 70), min(S + 70, s0 + 140)):
            start, end = fbp.key_rows(key, s0, gt, S, causal, window)
            for n in range(min(nq, S - s0) * gt):
                lo, hi = fbp.bounds(s0 + n // gt, S, causal, window)
                assert (start <= n < end) == (lo <= key <= hi < S), \
                    (s0, key, n)


# (S, T, G, hd, causal, window): queries at the last S of T key positions
# (the sequence-sharded training's gathered and halo routes), shifts
# across the 128- and 64-key tiles and the 64-row row tiles, and a
# window whose first keys no query sees
OFFSET_PLAN_CASES = [(1, 2, 1, 128, True, 0), (63, 64, 2, 128, True, 0),
                     (65, 129, 2, 128, True, 0), (64, 200, 7, 64, True, 0),
                     (130, 260, 1, 256, True, 0), (70, 140, 2, 128, True, 16),
                     (50, 180, 12, 128, True, 40), (40, 80, 2, 256, False,
                                                    16),
                     (33, 100, 80, 32, True, 0), (100, 101, 3, 16, True, 1)]


@pytest.mark.parametrize("kernel", ["dkdv", "dq"])
@pytest.mark.parametrize("S,T,G,hd,causal,window", OFFSET_PLAN_CASES)
def test_tile_plan_at_a_query_offset_lets_each_visible_pair_in_once(
        kernel, S, T, G, hd, causal, window):
    """At a query offset (query s at key position s + T - S) every pair
    the masks let through enters each kernel's sums exactly once and no
    other does; a key tile that no query sees walks no row tile (its dK
    and dV are zeros)."""
    got = fbp.coverage(kernel, S, G, hd, causal, window, T)
    want = fbp.visible(S, G, causal, window, T)
    np.testing.assert_array_equal(got, want)
    assert want.any(1).all()
    for k0 in range(0, T, fbp.key_tile(hd)):
        seen = want[:, k0:k0 + fbp.key_tile(hd)].any()
        assert bool(fbp.dkdv_row_tiles(k0, S, G, hd, causal, window, T)) \
            == bool(seen)


@pytest.mark.parametrize("shift", [1, 63, 64, 700])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3),
                                           (False, 48)])
@pytest.mark.parametrize("G", [1, 7, 12])
def test_key_rows_at_a_query_offset_are_the_visible_rows(G, causal, window,
                                                         shift):
    """The dK / dV kernel's two row thresholds a key, shifted by T - S,
    let a key into exactly the rows whose query sees it."""
    S = 70
    T = S + shift
    gt, nq, _, _ = fbp.row_tiles(S, G)
    for s0 in range(0, S, nq):
        a0 = s0 + shift
        for key in range(max(0, a0 - 70), min(T + 10, a0 + 140)):
            start, end = fbp.key_rows(key, s0, gt, T, causal, window, shift)
            for n in range(min(nq, S - s0) * gt):
                lo, hi = fbp.bounds(s0 + n // gt, T, causal, window, shift)
                assert (start <= n < end) == (lo <= key <= hi < T), \
                    (s0, key, n)


def _offset_lse(q, k, keep):
    """The lse the kernels write (m * scale + ln l) under ``keep`` (S, T)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G, scale = H // KV, 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, S, KV, G, hd), k)
    s = torch.where(keep, s, ref.NEG_INF)
    m = s.amax(-1, keepdim=True)
    lse = m[..., 0] * scale + torch.log(torch.exp((s - m) * scale).sum(-1))
    return lse.permute(0, 3, 1, 2).reshape(B, S, H)


@pytest.mark.parametrize("S,T,H,KV,hd,causal,window", [
    (40, 170, 4, 2, 16, True, 0), (65, 130, 6, 2, 16, True, 20),
    (33, 97, 2, 2, 256, True, 0), (50, 120, 4, 1, 16, False, 30),
    (1, 64, 2, 1, 16, True, 0)])
def test_emulated_walk_at_a_query_offset_matches_autograd(S, T, H, KV, hd,
                                                          causal, window):
    """The bf16 kernels' walk at a query offset, P and dS as hi + lo,
    lands within 2e-5 of each of autograd's gradients through the plain
    version at the same offset (dk and dv zero where no query sees a
    key)."""
    rng = np.random.RandomState(S + T)
    f = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.randn(*sh).astype(np.float32))
    q, k, v, dout = f(1, S, H, hd), f(1, T, KV, hd), f(1, T, KV, hd), \
        f(1, S, H, hd)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.flash_attention_ref(*qkv, causal=causal, window=window)
    out.backward(dout)
    keep = torch.from_numpy(fbp.visible(S, 1, causal, window, T))
    got = _emulated_bwd(q, k, v, out.detach(), dout, _offset_lse(q, k, keep),
                        causal, window)
    rel = _rel(got, [t.grad for t in qkv])
    assert max(rel) <= 2e-5, rel


@pytest.mark.parametrize("G", [1, 2, 7, 8, 10, 12, 16, 64, 65, 80])
def test_row_tiles_hold_whole_queries(G):
    """A row tile is floor(64 / G) whole queries of G heads up to G 64
    (the stage rows past them stay zero), and past it one query of 64
    heads a block."""
    gt, nq, ngb, n = fbp.row_tiles(100, G)
    assert gt * nq <= fbp.ROW_TILE and gt * ngb >= G > gt * (ngb - 1)
    if G <= fbp.ROW_TILE:
        assert (gt, nq, ngb) == (G, fbp.ROW_TILE // G, 1)
    else:
        assert (gt, nq) == (fbp.ROW_TILE, 1)
    assert n == -(-100 // nq) * ngb
    s0, s1, g0, g1 = fbp.row_tile(n - 1, 100, G)
    assert s1 == 100 and g1 == G


def test_kernel_source_holds_the_plan_constants():
    """The mirror's row tile and key tiles are the kernel's constants, and
    ``chip_smoke.py`` takes the edges of the same key tile."""
    import re

    from repro_torch.kernels import build
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    for const, want in (("BWD_ROW_TILE", fbp.ROW_TILE),
                        ("BWD_KEY_TILE", fbp.KEY_TILE),
                        ("BWD_KEY_TILE_HD256", fbp.KEY_TILE_HD256)):
        assert re.findall(rf"constexpr int {const} = (\d+);", text) == \
            [str(want)], const
    assert "HD <= 128 ? BWD_KEY_TILE : BWD_KEY_TILE_HD256" in text
    # the dK / dV kernel's mask is fbp.key_rows
    assert "from[h] = (p.causal ? d * p.gt" in text
    assert "key < p.T ? 0 : TILE) - 2 * tq" in text
    assert "min(d + p.window, TILE) * p.gt : TILE * TILE" in text
    assert [fbp.key_tile(hd) for hd in kernels.HEAD_DIMS] == [128] * 4 + [64]
    smoke = (build.CSRC.parents[3] / "chip_smoke.py").read_text()
    assert re.findall(r"^BWD_KEY_TILE = (\d+)$", smoke, re.M) == \
        [str(fbp.KEY_TILE)]


# ----------------------------------------------------------------------
# the kernel route with the CUDA calls stubbed
@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor passes as a CUDA tensor and takes the kernel route;
    the two libraries record their calls."""
    calls = {"fwd": [], "bwd": []}

    class Lib:
        def repro_flash_attention(self, *args):
            calls["fwd"].append(args)
            return 0

        def repro_flash_attention_bwd(self, *args):
            calls["bwd"].append(args)
            return 0

    monkeypatch.setattr(fa, "_library", lambda: Lib())
    monkeypatch.setattr(fa, "_bwd_library", lambda: Lib())
    monkeypatch.setattr(fa, "check_cuda", lambda *a: None)
    monkeypatch.setattr(ops, "_route", lambda name, q: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128),
                                      (torch.bfloat16, 128),
                                      (torch.float32, 16)])
def test_kernel_route_binds_forward_and_backward(fake_card, dtype, hd):
    B, S, H, KV = 2, 40, 8, 2
    q, k, v, _ = (torch.from_numpy(a).to(dtype) for a in
                  _inputs(B, S, H, KV, hd))
    ops.reset_counts()
    out = ops.flash_attention(q, k, v, causal=True, window=7)
    assert out.grad_fn is None and fake_card["fwd"][0][7] is None
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(qg, kg, vg, causal=True, window=7)
    assert out.grad_fn is not None and fake_card["fwd"][1][7] is not None
    out.backward(torch.ones_like(out))
    (args,) = fake_card["bwd"]
    assert args[:3] == (kernels.DTYPE_CODE[dtype], hd, hd)
    assert args[13:20] == (B, S, S, KV, H // KV, 1, 7)
    assert args[20] == pytest.approx(1.0 / math.sqrt(hd))
    assert qg.grad.shape == q.shape and kg.grad.shape == k.shape
    assert vg.grad.dtype == dtype
    assert kernels.LAUNCHES["flash_attention"] == 2
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1


def test_backward_refuses_dims_it_has_no_kernel_for(fake_card):
    """MLA's (q/k, v) pairs take the backward kernel in each dtype their
    forward is built for (the C entry point gets both widths, dq and dk
    are q/k's width and dv v's); a pair in a dtype with no kernel ((24,
    16) in bf16) still raises before anything launches, and a masked
    call at a query offset (Queue 2 item 12) takes the kernels too, the
    backward told both lengths."""
    ops.reset_counts()
    cases = [(192, 128, torch.float32), (192, 128, torch.bfloat16),
             (24, 16, torch.float32)]
    for hq, hv, dtype in cases:
        q = torch.zeros(1, 4, 2, hq, dtype=dtype, requires_grad=True)
        k = torch.zeros(1, 4, 2, hq, dtype=dtype, requires_grad=True)
        v = torch.zeros(1, 4, 2, hv, dtype=dtype, requires_grad=True)
        out = ops.flash_attention(q, k, v)
        assert out.shape == (1, 4, 2, hv) and out.grad_fn is not None
        out.backward(torch.ones_like(out))
        assert q.grad.shape == q.shape and k.grad.shape == k.shape
        assert v.grad.shape == v.shape and v.grad.dtype == dtype
        assert fake_card["bwd"][-1][:3] == (kernels.DTYPE_CODE[dtype], hq,
                                            hv)
        assert fake_card["fwd"][-1][:3] == (kernels.DTYPE_CODE[dtype], hq,
                                            hv)
    assert kernels.LAUNCHES["flash_attention"] == len(cases)
    assert kernels.LAUNCHES["flash_attention_bwd"] == len(cases)
    ops.reset_counts()
    q = torch.zeros(1, 4, 2, 24, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match=r"\(24, 16\) in torch.bfloat16"):
        ops.flash_attention(q, q.detach(), torch.zeros(1, 4, 2, 16,
                                                       dtype=torch.bfloat16))
    assert set(kernels.LAUNCHES.values()) == {0}
    q = torch.zeros(1, 4, 2, 192, requires_grad=True)
    out = ops.flash_attention(q, torch.zeros(1, 8, 2, 192),
                              torch.zeros(1, 8, 2, 128))
    out.backward(torch.ones_like(out))
    assert q.grad.shape == q.shape
    # (dtype, hd, hd_v, ..., B, S, T, KV, G, causal, window, scale, stream)
    assert fake_card["bwd"][-1][13:20] == (1, 4, 8, 2, 1, 1, 0)
    assert kernels.LAUNCHES["flash_attention"] == 1
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1


def test_backward_wrapper_takes_cuda_tensors_only():
    q = torch.zeros(1, 4, 2, 64)
    lse = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_bshd(q, q, q, q, q, lse, causal=True,
                                    window=0)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_bshd(q, q, q, q, q, lse[..., :1],
                                    causal=True, window=0)


def test_other_kernel_ops_refuse_inputs_that_require_grad(fake_card):
    """No op returns a CUDA tensor without a grad_fn: the serving-only ops,
    which have no backward kernel, raise on the kernel route, naming their
    item, before they launch anything (the scans' backward kernels are
    tests/test_torch_scan_grad.py's)."""
    g = lambda *s: torch.zeros(*s, requires_grad=True)  # noqa: E731
    lengths = torch.ones(2, dtype=torch.int32)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    cases = [
        (11, lambda: ops.decode_attention(g(2, 4, 16), g(2, 8, 2, 16),
                                          g(2, 8, 2, 16), lengths)),
        (11, lambda: ops.paged_decode_attention(g(2, 4, 16), g(5, 4, 2, 16),
                                                g(5, 4, 2, 16), bt, lengths)),
        (11, lambda: ops.paged_extend_attention(
            g(2, 3, 4, 16), g(5, 4, 2, 16), g(5, 4, 2, 16), bt, lengths)),
        (11, lambda: ops.mla_decode_attention(
            g(2, 4, 32), g(2, 4, 8), g(2, 5, 32), g(2, 5, 8), lengths, 0.2)),
        (11, lambda: ops.pair_score({"W": g(8, 8), "w": g(16),
                                     "bias": torch.zeros(())},
                                    g(3, 8), g(4, 8))),
    ]
    ops.reset_counts()
    for item, call in cases:
        with pytest.raises(NotImplementedError,
                           match=f"Queue 2, item {item}$"):
            call()
    with torch.no_grad():            # no grad: the kernel route as before
        with pytest.raises(ValueError, match="CUDA"):
            ops.decode_attention(g(2, 4, 16), g(2, 8, 2, 16), g(2, 8, 2, 16),
                                 lengths)
    assert set(kernels.LAUNCHES.values()) == {0}
