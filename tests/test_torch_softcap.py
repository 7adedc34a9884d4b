"""Attention logit soft-capping in the port against the JAX package: the
kernel ops' plain versions, the flash gradient, the layer routes that ran
uncapped before (the paged decode and extend, the encoder-decoder's decode
step), the refusals, and JAX's kernel path that drops the cap.

JAX caps every non-MLA attention score as ``c * tanh(s / c)`` on its
``jnp`` path (``use_kernels=False``), before the mask; the port follows
that path.  Every case uses a cap that bites: inputs spread so that at
least a quarter of the live scaled scores pass ``c / 2``, and each test
asserts that the port's uncapped result differs from JAX's capped one by
more than the tolerance, so a route that ignored the cap would fail.
Tolerances (fp32, sums in another order): ops ``atol = rtol = 1e-5``,
gradients ``1e-5`` of each one's largest magnitude, layer outputs
``1e-5``.  On the CPU every op is its plain version; ``chip_smoke.py``
holds the kernels to those on the card.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes: one thread is faster and leaves
                           # the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import _flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ScanGroup as JScanGroup  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import api, encdec, weights  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL = 1e-5
#: the caps of the op cases: 5 over scores spread to about +-15, and
#: Gemma 2's 50 over scores spread to about +-100
CAPS = (5.0, 50.0)
#: the models' cap: their reduced widths give scores of about +-4
MODEL_CAP = 1.0
B, H, KV, HD = 2, 4, 2, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _inputs(seed, cap, q_shape, kv_shape):
    """q, k, v (fp32 numpy) whose scaled scores spread to about 3 * cap,
    so that the cap bites."""
    rng = np.random.RandomState(seed)
    spread = math.sqrt(3 * cap)     # |s| ~ spread^2 * sqrt(hd) / sqrt(hd)
    q = (rng.standard_normal(q_shape) * spread).astype(np.float32)
    k = (rng.standard_normal(kv_shape) * spread).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    return q, k, v


def _share_biting(q, k, cap, live=None):
    """The share of live scaled scores with |s| > cap / 2."""
    G = q.shape[-2] // k.shape[-2]
    kk = np.repeat(k, G, axis=-2)
    if q.ndim == 3:                                    # decode: (B, H, hd)
        s = np.einsum("bhd,bthd->bht", q, kk)
    else:
        s = np.einsum("bshd,bthd->bhst", q, kk)
    s = np.abs(s / math.sqrt(q.shape[-1]))
    if live is not None:
        s = s[np.broadcast_to(live, s.shape)]
    return float((s > cap / 2).mean())


def _assert_capped(got, want, uncapped, share):
    """``got`` equals JAX's capped ``want``; the uncapped port result does
    not; and the cap bites on at least a quarter of the live scores."""
    assert share >= 0.25, share
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(uncapped - want).max() > 10 * TOL["atol"] + \
        TOL["rtol"] * np.abs(want).max()


# ----------------------------------------------------------------------
# the plain ops against JAX's flash_attention_jnp and mha
#: name -> (S, T, causal, window): flash's masks, cross attention at T !=
#: S, and a sequence shard's queries at a query offset T - S
FLASH_CASES = {"causal": (40, 40, True, 0), "window": (40, 40, True, 7),
               "bidir": (40, 40, False, 0), "cross": (12, 40, False, 0),
               "offset": (12, 40, True, 0),
               "offset_window": (12, 40, True, 9)}


def _jax_flash(q, k, v, S, T, causal, window, cap):
    off = T - S if T != S and causal else None
    return jattn.flash_attention_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=16,
        kv_chunk=16, softcap=cap, q_offset_dynamic=off)


def _flash_live(S, T, causal, window):
    a = np.arange(S)[:, None] + T - S
    t = np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= t <= a
    if window:
        ok &= t > a - window
    return ok


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_capped_equals_jax(case, cap):
    S, T, causal, window = FLASH_CASES[case]
    q, k, v = _inputs(1, cap, (B, S, H, HD), (B, T, KV, HD))
    want = np.asarray(_jax_flash(q, k, v, S, T, causal, window, cap))
    run = lambda c: ops.flash_attention(  # noqa: E731
        _t(q), _t(k), _t(v), causal=causal, window=window,
        softcap=c).numpy()
    _assert_capped(run(cap), want, run(0.0),
                   _share_biting(q, k, cap, _flash_live(S, T, causal,
                                                        window)))


def _decode_mask(lengths, L):
    return np.arange(L)[None, :] < np.asarray(lengths)[:, None]


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", ["dense", "ring"])
def test_decode_capped_equals_jax(case, cap):
    """The split-K decode's plain version against JAX's ``mha`` over the
    cache: a dense stripe with a row of length 0 (the mean of V on both
    sides), or a ring whose rows are all live past its length."""
    L = 24 if case == "dense" else 8
    lengths = [13, 0] if case == "dense" else [8, 8]
    q, k, v = _inputs(2, cap, (B, H, HD), (B, L, KV, HD))
    mask = _decode_mask(lengths, L)
    want = np.asarray(jattn.mha(_j(q[:, None]), _j(k), _j(v),
                                _j(mask[:, None, None, :]), cap))[:, 0]
    run = lambda c: ops.decode_attention(  # noqa: E731
        _t(q), _t(k), _t(v), torch.tensor(lengths, dtype=torch.int32),
        softcap=c).numpy()
    live = np.broadcast_to(mask[:, None, :], (B, H, L))
    _assert_capped(run(cap), want, run(0.0), _share_biting(q, k, cap, live))


def _pool(seed, cap, nb_pool=7, bs=4):
    rng = np.random.RandomState(seed)
    spread = math.sqrt(3 * cap)
    kp = (rng.standard_normal((nb_pool, bs, KV, HD)) * spread).astype(
        np.float32)
    vp = rng.standard_normal((nb_pool, bs, KV, HD)).astype(np.float32)
    bt = np.array([[3, 1, 5], [2, 6, 0]], np.int32)
    return kp, vp, bt


def _gathered(pool, bt):
    return pool[bt].reshape(bt.shape[0], -1, *pool.shape[2:])


@pytest.mark.parametrize("cap", CAPS)
def test_paged_decode_capped_equals_jax(cap):
    kp, vp, bt = _pool(3, cap)
    q = _inputs(4, cap, (B, H, HD), (1, 1, 1, 1))[0]
    lengths = np.array([11, 5], np.int32)
    kg, vg = _gathered(kp, bt), _gathered(vp, bt)
    mask = _decode_mask(lengths, kg.shape[1])
    want = np.asarray(jattn.mha(_j(q[:, None]), _j(kg), _j(vg),
                                _j(mask[:, None, None, :]), cap))[:, 0]
    run = lambda c: ops.paged_decode_attention(  # noqa: E731
        _t(q), _t(kp), _t(vp), _t(bt), _t(lengths), softcap=c).numpy()
    live = np.broadcast_to(mask[:, None, :], (B, H, kg.shape[1]))
    _assert_capped(run(cap), want, run(0.0), _share_biting(q, kg, cap, live))


@pytest.mark.parametrize("cap", CAPS)
def test_paged_extend_capped_equals_jax(cap):
    """S = 4 queries at pos0 (a verify window and a suffix admit) over the
    cached prefix and the causal suffix."""
    kp, vp, bt = _pool(5, cap)
    S = 4
    q = _inputs(6, cap, (B, S, H, HD), (1, 1, 1, 1))[0]
    pos0 = np.array([5, 0], np.int32)
    kg, vg = _gathered(kp, bt), _gathered(vp, bt)
    L = kg.shape[1]
    positions = pos0[:, None] + np.arange(S)[None, :]
    mask = np.arange(L)[None, None, :] <= positions[:, :, None]
    want = np.asarray(jattn.mha(_j(q), _j(kg), _j(vg), _j(mask[:, None]),
                                cap))
    run = lambda c: ops.paged_extend_attention(  # noqa: E731
        _t(q), _t(kp), _t(vp), _t(bt), _t(pos0), softcap=c).numpy()
    live = np.broadcast_to(mask[:, None], (B, H, S, L))
    _assert_capped(run(cap), want, run(0.0), _share_biting(q, kg, cap, live))


# ----------------------------------------------------------------------
# the flash gradient against jax.grad of flash_attention_jnp(softcap=)
@pytest.mark.parametrize("case", ["causal", "window", "cross", "offset"])
def test_flash_capped_gradient_equals_jax(case):
    """dq, dk, dv of ``sum(out * dout)``: autograd through the capped
    plain version (the backward kernel's plain version) against
    ``jax.grad``; the uncapped gradients miss by far more."""
    cap = CAPS[0]
    S, T, causal, window = FLASH_CASES[case]
    q, k, v = _inputs(7, cap, (B, S, H, HD), (B, T, KV, HD))
    dout = np.random.RandomState(8).standard_normal((B, S, H, HD)).astype(
        np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(
        _jax_flash(a, b, c, S, T, causal, window, cap) * _j(dout)),
        argnums=(0, 1, 2))(_j(q), _j(k), _j(v))

    def grads(c):
        leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=causal, window=window,
                                  softcap=c)
        return torch.autograd.grad((out * _t(dout)).sum(), leaves)

    got, plain = grads(cap), grads(0.0)
    for name, g, u, w in zip("qkv", got, plain, want):
        w = np.asarray(w)
        top = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_REL,
                                   atol=GRAD_REL * top, err_msg=name)
        assert np.abs(u.numpy() - w).max() > 100 * GRAD_REL * top, name


# ----------------------------------------------------------------------
# the repair: routes that ran without the cap
def _lm_model(arch="internlm2-1.8b", **over):
    """fp32 reduced ``arch`` two layers deep on both sides, ``over``
    replaced, the JAX weights carried over."""
    j = jax_reduced(jax_get_config(arch)).replace(
        n_layers=2, groups=(JScanGroup(("A",), 2),), **over)
    t = reduced(get_config(arch)).replace(
        n_layers=2, groups=(ScanGroup(("A",), 2),), **over)
    jp = jax.jit(lambda key: japi.init(key, j)[0])(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jp)[0].items()}
    return j, t, jp, weights.params_from_numpy(flat, t, device="cpu")


@pytest.fixture(scope="module")
def lm():
    return _lm_model(attn_softcap=MODEL_CAP)


def _layer0(jp, tp):
    """Layer 0's attention weights on both sides."""
    jm = jax.tree_util.tree_map(lambda a: a[0],
                                jp["groups"][0][0]["mixer"])
    tm = {k: v[0] for k, v in tp["groups"][0][0]["mixer"].items()}
    return jm, tm


def _paged_cache(seed, cfg, n_blocks=8, bs=4):
    rng = np.random.RandomState(seed)
    shape = (n_blocks + 1, bs, cfg.n_kv_heads, cfg.head_dim)
    return {"kp": rng.standard_normal(shape).astype(np.float32),
            "vp": rng.standard_normal(shape).astype(np.float32)}


@pytest.mark.parametrize("route", ["paged_decode", "paged_extend"])
def test_paged_routes_apply_the_cap(lm, route):
    """The repair: ``paged_attn_decode`` and ``paged_attn_extend`` (the
    paged admit and the speculative verify) ran without the cap and
    raised nothing; they now equal JAX's ``jnp`` path with it, and the
    port's uncapped config does not."""
    jcfg, tcfg, jp, tp = lm
    jm, tm = _layer0(jp, tp)
    rng = np.random.RandomState(11)
    bt = np.array([[1, 3, 5, 7], [2, 4, 6, 8]], np.int32)
    S = 1 if route == "paged_decode" else 5
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    pos = np.array([9, 4], np.int32)
    cache = _paged_cache(12, tcfg)
    jfn = getattr(jattn, route.replace("paged_", "paged_attn_"))
    tfn = getattr(tattn, route.replace("paged_", "paged_attn_"))
    want, _ = jfn(jm, _j(x), {k: _j(v) for k, v in cache.items()}, _j(pos),
                  _j(bt), jcfg, kind="causal")

    def run(cfg):
        out, _ = tfn(tm, _t(x), {k: _t(v) for k, v in cache.items()},
                     _t(pos), _t(bt), cfg, kind="causal")
        return out.numpy()

    want = np.asarray(want)
    got, uncapped = run(tcfg), run(tcfg.replace(attn_softcap=0.0))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(uncapped - want).max() > 100 * TOL["atol"]


@pytest.fixture(scope="module")
def whisper():
    over = dict(enc_layers=2, dec_layers=2, n_layers=4,
                attn_softcap=MODEL_CAP)
    j = jax_reduced(jax_get_config("whisper-base")).replace(**over)
    t = reduced(get_config("whisper-base")).replace(**over)
    jp = jax.jit(lambda key: japi.init(key, j)[0])(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jp)[0].items()}
    return j, t, jp, weights.params_from_numpy(flat, t, "cpu")


def test_encdec_decode_step_applies_the_cap(whisper):
    """The repair: the encoder-decoder's ``decode_step`` (its self and
    cross decodes) ran uncapped; from JAX's capped prefill caches one
    step's logits now equal JAX's, and the uncapped config's do not."""
    jcfg, tcfg, jp, tp = whisper
    rng = np.random.RandomState(13)
    Bw, S_enc, S, L = 2, 24, 5, 16
    frames = rng.standard_normal((Bw, S_enc, 64)).astype(np.float32)
    tok = rng.randint(0, tcfg.vocab, (Bw, S)).astype(np.int32)
    caches = japi.init_caches(jcfg, Bw, L, S_enc)
    _, caches = jax.jit(lambda p, t, f, c: jenc.prefill(p, t, f, jcfg, c))(
        jp, _j(tok), _j(frames), caches)
    nxt = rng.randint(0, tcfg.vocab, (Bw, 1)).astype(np.int32)
    pos = np.full((Bw,), S, np.int32)
    want, _ = jax.jit(lambda p, t, c, q: jenc.decode_step(p, t, c, q, jcfg))(
        jp, _j(nxt), caches, _j(pos))
    want = np.asarray(want)

    def run(cfg):
        tc = {k: _t(v) for k, v in caches.items()}
        with torch.no_grad():
            out, _ = encdec.decode_step(tp, _t(nxt), tc, _t(pos), cfg)
        return out.numpy()

    got, uncapped = run(tcfg), run(tcfg.replace(attn_softcap=0.0))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(uncapped - want).max() > 1e-2


# ----------------------------------------------------------------------
# JAX's kernel path drops the cap; the port follows the jnp path
def test_jax_kernel_path_drops_the_cap_and_the_port_follows_jnp(lm):
    """With ``use_kernels`` JAX's paged decode runs its Pallas kernel (in
    interpret mode here), which takes no cap: its result differs from
    JAX's ``jnp`` path, and the port's equals the ``jnp`` path
    (ROADMAP.md, Standing divergences)."""
    jcfg, tcfg, jp, tp = lm
    jm, tm = _layer0(jp, tp)
    rng = np.random.RandomState(14)
    bt = np.array([[1, 3, 5, 7], [2, 4, 6, 8]], np.int32)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([9, 4], np.int32)
    cache = _paged_cache(15, tcfg)
    jc = {k: _j(v) for k, v in cache.items()}
    outs = {}
    for kern in (False, True):
        out, _ = jattn.paged_attn_decode(
            jm, _j(x), jc, _j(pos), _j(bt), jcfg.replace(use_kernels=kern),
            kind="causal")
        outs[kern] = np.asarray(out)
    got, _ = tattn.paged_attn_decode(tm, _t(x), {k: _t(v) for k, v in
                                                 cache.items()}, _t(pos),
                                     _t(bt), tcfg, kind="causal")
    np.testing.assert_allclose(got.numpy(), outs[False], **TOL)
    assert np.abs(outs[True] - outs[False]).max() > 100 * TOL["atol"]
    # without the cap the kernel path and the jnp path agree
    plain = {}
    for kern in (False, True):
        out, _ = jattn.paged_attn_decode(
            jm, _j(x), jc, _j(pos), _j(bt),
            jcfg.replace(use_kernels=kern, attn_softcap=0.0), kind="causal")
        plain[kern] = np.asarray(out)
    np.testing.assert_allclose(plain[True], plain[False], atol=1e-5,
                               rtol=1e-5)


# ----------------------------------------------------------------------
# refusals and the count route
def test_softcap_refusals():
    """Both routes refuse a negative or non-finite cap, and a cap at MLA's
    (q/k, v) pairs, which JAX never caps; the kernel and count routes
    refuse one at a head dim without a capped kernel, which the plain
    version computes."""
    q, k, v = (torch.zeros(1, 4, 2, 16) for _ in range(3))
    for bad in (-1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="softcap"):
            ops.flash_attention(q, k, v, softcap=bad)
        with pytest.raises(ValueError, match="softcap"):
            ops.decode_attention(q[:, 0], k, v,
                                 torch.ones(1, dtype=torch.int32),
                                 softcap=bad)
    qm, km = torch.zeros(1, 4, 2, 192), torch.zeros(1, 4, 2, 192)
    vm = torch.zeros(1, 4, 2, 128)
    with pytest.raises(ValueError, match="MLA"):
        ops.flash_attention(qm, km, vm, softcap=5.0)
    assert ops.flash_attention(q, k, v, softcap=5.0).shape == q.shape
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        with pytest.raises(ValueError, match="no soft-capped kernel"):
            ops.flash_attention(fq, fk, fv, softcap=5.0)
        with pytest.raises(ValueError, match="no soft-capped kernel"):
            ops.decode_attention(fq[:, 0], fk, fv,
                                 torch.ones(1, dtype=torch.int32),
                                 softcap=5.0)
    q64 = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.FlashAttention.apply(q64, q64, q64, True, 0, 5.0)


def test_mla_layers_stay_uncapped_as_jax():
    """MLA's prefill and absorbed decode take no cap, on both sides: with
    ``attn_softcap`` set the MLA layer's output is the uncapped one."""
    j = jax_reduced(jax_get_config("deepseek-v2-lite-16b"))
    t = reduced(get_config("deepseek-v2-lite-16b"))
    jp = jax.jit(lambda key: japi.init(key, j)[0])(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jp)[0].items()}
    tp = weights.params_from_numpy(flat, t, device="cpu")
    x = np.random.RandomState(16).standard_normal(
        (2, 9, t.d_model)).astype(np.float32)
    g = [i for i, gr in enumerate(t.groups) if gr.pattern[0] == "M"][0]
    tm = {k: v[0] for k, v in tp["groups"][g][0]["mixer"].items()}
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["groups"][g][0]["mixer"])
    want, _ = jattn.mla_forward(jm, _j(x), j.replace(attn_softcap=MODEL_CAP))
    with torch.no_grad():
        capped, _ = tattn.mla_forward(tm, _t(x),
                                      t.replace(attn_softcap=MODEL_CAP))
        plain, _ = tattn.mla_forward(tm, _t(x), t)
    np.testing.assert_allclose(capped.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(capped.numpy(), plain.numpy())


def test_api_forward_takes_the_cap(lm):
    """``api.forward_fn`` with the cap equals JAX's forward logits."""
    jcfg, tcfg, jp, tp = lm
    toks = np.random.RandomState(17).randint(0, tcfg.vocab, (2, 11)).astype(
        np.int32)
    want = np.asarray(japi.forward_fn(jp, jcfg, {"tokens": _j(toks)}))
    with torch.no_grad():
        got = api.forward_fn(tp, tcfg, {"tokens": _t(toks)}).numpy()
        uncapped = api.forward_fn(tp, tcfg.replace(attn_softcap=0.0),
                                  {"tokens": _t(toks)}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(uncapped - want).max() > 1e-2
