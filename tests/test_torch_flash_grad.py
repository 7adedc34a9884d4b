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
# The backward kernel's arithmetic and tile walk (csrc/flash_attention_bwd.cu)
# emulated in torch: the same key range per row tile, row range per key
# tile, masks, P from the forward's lse, and D from the output.
BT = 32


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


def _emulated_bwd(q, k, v, out, dout, lse, causal, window):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G, scale = H // KV, 1.0 / math.sqrt(hd)
    delta = (dout * out).sum(-1)                       # flash_bwd_delta
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for b in range(B):
        for kvh in range(KV):
            def tile(r0, r_end, t0):
                r = torch.arange(r0, min(r0 + BT, r_end))
                t = torch.arange(t0, t0 + BT)
                ok = _visible(r, t, S, G, causal, window)
                tc = t.clamp(max=S - 1)
                qs, dos = (_rows(x, b, kvh, G, r[0], r[-1] + 1)
                           for x in (q, dout))
                ks = torch.where((t < S)[:, None], k[b, tc, kvh], 0.0)
                vs = torch.where((t < S)[:, None], v[b, tc, kvh], 0.0)
                rs = _rows(lse[..., None], b, kvh, G, r[0], r[-1] + 1)[:, 0]
                ds_ = _rows(delta[..., None], b, kvh, G, r[0],
                            r[-1] + 1)[:, 0]
                p = torch.where(ok, torch.exp(qs @ ks.T * scale -
                                              rs[:, None]), 0.0)
                ds = p * (dos @ vs.T - ds_[:, None])
                return r, t, qs, dos, ks, p, ds
            # dK / dV: grid over key tiles
            for t0 in range(0, S, BT):
                t_end = min(t0 + BT, S)
                s_lo = t0 if causal else 0
                s_hi = min(S - 1, t_end - 1 + window - 1) if window else S - 1
                r_end = (s_hi + 1) * G
                for r0 in range(s_lo * G, r_end, BT):
                    r, t, qs, dos, ks, p, ds = tile(r0, r_end, t0)
                    n = t_end - t0
                    dv[b, t0:t_end, kvh] += (p.T @ dos)[:n]
                    dk[b, t0:t_end, kvh] += (ds.T @ qs)[:n] * scale
            # dQ: grid over row tiles
            for r0 in range(0, S * G, BT):
                r_end = min(r0 + BT, S * G)
                s0, s1 = r0 // G, (r_end - 1) // G
                k_lo = max(s0 - window + 1, 0) if window else 0
                k_hi = s1 if causal else S - 1
                for t0 in range(k_lo, k_hi + 1, BT):
                    r, t, qs, dos, ks, p, ds = tile(r0, r_end, t0)
                    g = (ds @ ks) * scale
                    dq[b, r // G, kvh * G + r % G] += g
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
    assert args[:2] == (kernels.DTYPE_CODE[dtype], hd)
    assert args[12:18] == (B, S, KV, H // KV, 1, 7)
    assert args[18] == pytest.approx(1.0 / math.sqrt(hd))
    assert qg.grad.shape == q.shape and kg.grad.shape == k.shape
    assert vg.grad.dtype == dtype
    assert kernels.LAUNCHES["flash_attention"] == 2
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1


def test_backward_refuses_dims_it_has_no_kernel_for(fake_card):
    ops.reset_counts()
    for hq, hv in ((192, 128), (24, 16)):           # MLA's pairs
        q = torch.zeros(1, 4, 2, hq, requires_grad=True)
        k = torch.zeros(1, 4, 2, hq)
        v = torch.zeros(1, 4, 2, hv)
        with pytest.raises(NotImplementedError, match="Queue 2, item 10"):
            ops.flash_attention(q, k, v)
    assert set(kernels.LAUNCHES.values()) == {0}


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
    """No op returns a CUDA tensor without a grad_fn: the ops with no
    backward kernel raise on the kernel route, naming their item, before
    they launch anything."""
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
        (9, lambda: ops.ssm_scan(g(1, 3, 4), g(1, 3, 4), g(1, 3, 2),
                                 g(1, 3, 2), g(4, 2), g(4))),
        (9, lambda: ops.linear_scan(g(1, 3, 4), g(1, 3, 4), g(1, 4))),
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
