"""Flash attention at a kv length T of its own (whisper-base's cross
attention, decoder queries over encoder states): the plain version and
its gradients against JAX's oracles, the refusals of causal and windowed
calls at T != S on both routes, the backward kernels' tile plan and
arithmetic at T != S emulated in torch, and the kernel route's binding
with the CUDA libraries stubbed (the kernels run only on the card, in
``chip_smoke.py``).

Tolerance: ``atol = rtol = 1e-5`` against JAX (fp32, sums in another
order); the emulated bf16 backward within ``2e-5`` of each gradient's
largest magnitude, as ``tests/test_torch_flash_grad.py`` holds it at T =
S.
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

from repro.models.attention import flash_attention_jnp, mha  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_bwd_plan as fbp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# (B, S, T, H, KV, hd): the serve's prompt of 4 against a longer encoder,
# one query, T on either side of the 64- and 128-key tiles, fewer keys
# than queries, G 1, 2 and 4
CASES = [(2, 4, 150, 4, 4, 16), (1, 1, 65, 2, 1, 32), (2, 33, 129, 4, 2, 16),
         (1, 70, 63, 8, 2, 64), (1, 20, 128, 4, 1, 16)]


def _inputs(B, S, T, H, KV, hd, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return f(B, S, H, hd), f(B, T, KV, hd), f(B, T, KV, hd), f(B, S, H, hd)


@pytest.mark.parametrize("B,S,T,H,KV,hd", CASES)
def test_plain_cross_attention_and_gradients_match_jax(B, S, T, H, KV, hd):
    """``ops.flash_attention(causal=False)`` on the CPU route against JAX's
    ``mha`` with no mask and ``flash_attention_jnp(causal=False)`` (small
    chunks), forward and ``jax.grad`` of q, k and v."""
    q, k, v, dout = _inputs(B, S, T, H, KV, hd)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*ts, causal=False)
    out.backward(torch.from_numpy(dout))
    assert out.shape == (B, S, H, hd) and ts[1].grad.shape == (B, T, KV, hd)
    for fn in (lambda q, k, v: mha(q, k, v, None),
               lambda q, k, v: flash_attention_jnp(
                   q, k, v, causal=False, q_chunk=8, kv_chunk=16)):
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(jax.jit(fn)(q, k, v)), **TOL)
        loss = lambda q, k, v: jnp.sum(fn(q, k, v) * dout)  # noqa: E731,B023
        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
        for t, w, name in zip(ts, want, "qkv"):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       err_msg=name, **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8),
                                           (True, 8)])
def test_causal_or_windowed_calls_at_another_kv_length_raise(causal, window):
    """A masked call's S queries are the last S of T key positions, so
    fewer keys than queries (T < S) takes no mask: the plain route, the
    kernel wrappers (before any CUDA check) and the autograd route raise
    ``ValueError``.  More keys (T > S, a sequence shard's queries) pass
    the forward's check and the backward kernel's (the wrapper reaches
    its CUDA check: no refusal), and the CPU route's gradients there are
    autograd's through the masked softmax; at T = S the same masks
    pass."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 9, 5, 2, 2, 16))
    calls = [
        lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
        lambda: ops.flash_attention(q.requires_grad_(True), k, v,
                                    causal=causal, window=window),
        lambda: fa.flash_attention_bshd(q, k, v, causal=causal,
                                        window=window),
        lambda: fa.flash_attention_bwd_bshd(
            q, k, v, q, q, torch.zeros(1, 9, 2), causal=causal,
            window=window)]
    for call in calls:
        with pytest.raises(ValueError, match="neither a causal mask nor a "
                                             "window"):
            call()
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 5, 9, 2, 2, 16))
    fa.check_args(q, k, v, window, causal)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_bshd(q, k, v, q, q, torch.zeros(1, 5, 2),
                                    causal=causal, window=window)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*qkv, causal=causal, window=window).sum().backward()
    at = torch.arange(5)[:, None] + 4
    t = torch.arange(9)[None, :]
    keep = (t <= at if causal else torch.ones(5, 9, dtype=torch.bool)) & \
        ((t > at - window) if window else True)
    ref_qkv = [t_.clone().requires_grad_(True) for t_ in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", *ref_qkv[:2]) / 4.0
    p_ = s.masked_fill(~keep, -2e38).softmax(-1)
    torch.einsum("bhqk,bkhd->bqhd", p_, ref_qkv[2]).sum().backward()
    for a, b in zip(qkv, ref_qkv):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)
    fa.check_args(q, k[:, :5], v[:, :5], window, causal)
    with pytest.raises(ValueError, match=r"k must be \(B=1, T, KV, hd=16\)"):
        fa.check_args(q, k[:, :, :, :8].contiguous(), v, 0, False)


@pytest.mark.parametrize("kernel", ["dkdv", "dq"])
@pytest.mark.parametrize("S,T,G,hd", [
    (4, 1500, 1, 64), (224, 1500, 1, 64), (1, 63, 1, 64), (65, 64, 2, 128),
    (63, 65, 8, 64), (3, 129, 7, 64), (130, 127, 2, 256), (2, 65, 80, 32)])
def test_tile_plan_covers_cross_pairs_once(kernel, S, T, G, hd):
    """At T != S each kernel's grid lets every (row, key) pair into its
    sums exactly once: the dK / dV grid over the T keys walks every row
    tile of the S queries, the dQ grid over the row tiles walks every
    64-key tile of the T keys, keys past T never."""
    got = fbp.coverage(kernel, S, G, hd, False, 0, T)
    assert got.shape == (S * G, T)
    np.testing.assert_array_equal(got, fbp.visible(S, G, False, 0, T))


def test_plan_defaults_to_t_equal_s():
    """Without T, every function of the mirror is its T = S self."""
    for kernel in ("dkdv", "dq"):
        assert list(fbp.walk(kernel, 70, 2, 128, True, 0)) == \
            list(fbp.walk(kernel, 70, 2, 128, True, 0, 70))
    assert fbp.dkdv_row_tiles(128, 300, 1, 64, False, 0, 1500) == \
        list(range(fbp.row_tiles(300, 1).n))


# ----------------------------------------------------------------------
# The bf16 backward kernels' walk and arithmetic at T != S, emulated in
# torch as tests/test_torch_flash_grad.py does at T = S: the dK / dV
# kernel's key tiles over T, the dQ kernel's row tiles over S, P from the
# forward's lse and P and dS as bf16 hi + lo before their products.
def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulated_cross_bwd(q, k, v, out, dout, lse):
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, 1.0 / math.sqrt(hd)
    delta = (dout * out).sum(-1)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    r = torch.arange(S * G)
    for b in range(B):
        for kvh in range(KV):
            heads = kvh * G + r % G
            Q, dO = q[b, r // G, heads], dout[b, r // G, heads]
            L, D = lse[b, r // G, heads], delta[b, r // G, heads]
            K, V = k[b, :, kvh], v[b, :, kvh]
            dqb, dkb, dvb = (torch.zeros_like(x) for x in (Q, K, V))
            for kernel in ("dkdv", "dq"):
                for kw0, rt in fbp.walk(kernel, S, G, hd, False, 0, T):
                    rows, keys, ok = (torch.from_numpy(a) for a in
                                      fbp.tile_pairs(kernel, kw0, rt, S, G,
                                                     False, 0, T))
                    p = torch.exp(Q[rows] @ K[keys].T * scale -
                                  L[rows, None])
                    p = torch.where(ok, p, 0.0)
                    ds = p * (dO[rows] @ V[keys].T - D[rows, None])
                    if kernel == "dkdv":
                        for x, y, acc in ((p, dO, dvb), (ds, Q, dkb)):
                            hi, lo = _split(x)
                            acc[keys] += hi.T @ y[rows] + lo.T @ y[rows]
                    else:
                        hi, lo = _split(ds)
                        dqb[rows] += hi @ K[keys] + lo @ K[keys]
            dq[b, r // G, heads] = dqb * scale
            dk[b, :, kvh] = dkb * scale
            dv[b, :, kvh] = dvb
    return dq, dk, dv


@pytest.mark.parametrize("B,S,T,H,KV,hd", [(1, 4, 150, 2, 2, 16),
                                           (1, 70, 65, 4, 2, 16),
                                           (1, 9, 130, 7, 1, 16)])
def test_emulated_cross_backward_matches_autograd(B, S, T, H, KV, hd):
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(B, S, T, H, KV, hd, seed=T))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.flash_attention_ref(*qkv, causal=False)
    out.backward(dout)
    G = H // KV
    sc = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, S, KV, G, hd),
                      k) / math.sqrt(hd)
    lse = torch.logsumexp(sc, -1).permute(0, 3, 1, 2).reshape(B, S, H)
    got = _emulated_cross_bwd(q, k, v, out.detach(), dout, lse)
    for g, t in zip(got, qkv):
        rel = ((g - t.grad).abs().max() / t.grad.abs().max()).item()
        assert rel <= 2e-5, rel


# ----------------------------------------------------------------------
@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor takes the kernel route; the libraries record their
    calls."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_route_passes_the_kv_length(fake_card, dtype):
    """Both C entry points get S and T; dk and dv come back (B, T, KV,
    hd), lse (B, S, H)."""
    B, S, T, H, KV, hd = 2, 4, 150, 8, 8, 64
    q, k, v = (torch.zeros(sh, dtype=dtype) for sh in
               ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
    ops.reset_counts()
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(qg, kg, vg, causal=False)
    out.backward(torch.ones_like(out))
    (fwd,), (bwd,) = fake_card["fwd"], fake_card["bwd"]
    assert fwd[8:15] == (B, S, T, KV, H // KV, 0, 0)
    assert bwd[1:3] == (hd, hd)                 # q/k's and v's widths
    assert bwd[13:20] == (B, S, T, KV, H // KV, 0, 0)
    assert kg.grad.shape == (B, T, KV, hd) and qg.grad.shape == q.shape
    assert kernels.LAUNCHES["flash_attention"] == 1
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1
