"""PyTorch port vs the JAX package: layers, dense and paged attention.

Inputs come from a seeded numpy generator and go through both sides as
numpy arrays.  Everything here is fp32; tolerances follow
tests/test_kernels.py:16 (fp32 ``atol = rtol = 2e-5``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes: one thread is faster and leaves
                           # the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)      # fp32, as tests/test_kernels.py:16


def _cfgs(**kw):
    return (jax_reduced(jax_get_config("internlm2-1.8b")).replace(**kw),
            reduced(get_config("internlm2-1.8b")).replace(**kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jit_attn(fn, jcfg):
    """A JAX paged attention layer jitted whole: one compile, not one per
    operation."""
    return jax.jit(functools.partial(fn, cfg=jcfg, kind="causal"))


def _close(port, jax_out, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(jax_out),
                               **(tol or TOL))


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    _close(tlayers.rms_norm(_t(x), _t(w), 1e-6, plus_one=plus_one),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                            plus_one=plus_one))


@pytest.mark.parametrize("base", [10_000.0, 1_000_000.0])
def test_apply_rope(base):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    pos = rng.randint(0, 500, size=(2, 7)).astype(np.int32)
    _close(tlayers.apply_rope(_t(x), _t(pos), base),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), base))


def test_apply_mlp_swiglu():
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 64).astype(np.float32)
    p = {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                      ("w_down", (128, 64)))}
    _close(tlayers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), tcfg),
           jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jcfg))


@pytest.mark.parametrize("vocab", [256, 250])   # 250 pads to 256: masked tail
def test_embed_unembed(vocab):
    jcfg, tcfg = _cfgs(vocab=vocab)
    rng = np.random.RandomState(3)
    table = rng.randn(tcfg.padded_vocab, 64).astype(np.float32)
    tokens = rng.randint(0, vocab, size=(2, 6)).astype(np.int32)
    x_t = tlayers.embed({"table": _t(table)}, _t(tokens), tcfg)
    x_j = jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens),
                        jcfg)
    _close(x_t, x_j)
    _close(tlayers.unembed({"table": _t(table)}, x_t, tcfg),
           jlayers.unembed({"table": jnp.asarray(table)}, x_j, jcfg),
           atol=1e-4, rtol=1e-4)


def _attn_params(rng, cfg):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
              "wo": (H * hd, d)}
    return {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


def test_project_qkv_and_mha():
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(4)
    p = _attn_params(rng, tcfg)
    x = rng.randn(2, 9, 64).astype(np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    qt, kt, vt = tattn._project_qkv({k: _t(v) for k, v in p.items()}, _t(x),
                                    _t(x), tcfg, _t(pos), _t(pos),
                                    tcfg.rope_base)
    qj, kj, vj = jax.jit(lambda p, x, pos: jattn._project_qkv(
        p, x, x, jcfg, pos, pos, jcfg.rope_base))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            jnp.asarray(pos))
    for a, b in ((qt, qj), (kt, kj), (vt, vj)):
        _close(a, b, atol=1e-5, rtol=1e-5)
    mask = np.tril(np.ones((9, 9), bool))[None, None]
    _close(tattn.mha(qt, kt, vt, _t(mask)),
           jattn.mha(qj, kj, vj, jnp.asarray(mask)), atol=1e-5, rtol=1e-5)


def _pool_setup(rng, cfg, B, nb, bs):
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    n_blocks = B * nb
    kp = rng.randn(n_blocks + 1, bs, KV, hd).astype(np.float32)
    vp = rng.randn(n_blocks + 1, bs, KV, hd).astype(np.float32)
    bt = (rng.permutation(n_blocks) + 1).reshape(B, nb).astype(np.int32)
    return kp, vp, bt


def test_paged_scatter_gather():
    """Writes land through the table; positions past the table go to the
    null block 0 (kvpool.py:43, attention.py:491-493)."""
    _, tcfg = _cfgs()
    rng = np.random.RandomState(5)
    B, nb, bs = 2, 3, 4
    kp, vp, bt = _pool_setup(rng, tcfg, B, nb, bs)
    k = rng.randn(B, 4, 2, 16).astype(np.float32)
    v = rng.randn(B, 4, 2, 16).astype(np.float32)
    vpos = np.array([[0, 5, 11, 12], [3, 4, 13, 20]], np.int32)  # 12+ past
    tc = tattn._paged_scatter({"kp": _t(kp.copy()), "vp": _t(vp.copy())},
                              _t(k), _t(v), _t(vpos), _t(bt))
    jc = jattn._paged_scatter({"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)},
                              jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(vpos), jnp.asarray(bt))
    # the null block's contents after colliding pad writes are unspecified
    # on both sides; every real block must agree exactly
    for key in ("kp", "vp"):
        np.testing.assert_array_equal(tc[key][1:].numpy(),
                                      np.asarray(jc[key])[1:])
    for a, b in zip(tattn._paged_gather(tc, _t(bt)),
                    jattn._paged_gather(jc, jnp.asarray(bt))):
        np.testing.assert_array_equal(a.numpy()[:, :bs * nb],
                                      np.asarray(b))


def test_paged_attn_decode():
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(6)
    B, nb, bs = 3, 4, 8
    kp, vp, bt = _pool_setup(rng, tcfg, B, nb, bs)
    p = _attn_params(rng, tcfg)
    x = rng.randn(B, 1, 64).astype(np.float32)
    pos = np.array([0, 13, 31], np.int32)
    before = dict(ops.PLAIN_CALLS)
    out_t, c_t = tattn.paged_attn_decode(
        {k: _t(v) for k, v in p.items()}, _t(x),
        {"kp": _t(kp.copy()), "vp": _t(vp.copy())}, _t(pos), _t(bt), tcfg,
        kind="causal")
    out_j, c_j = _jit_attn(jattn.paged_attn_decode, jcfg)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)}, jnp.asarray(pos),
        jnp.asarray(bt))
    _close(out_t, out_j, atol=1e-5, rtol=1e-5)
    _close(c_t["kp"], c_j["kp"], atol=1e-5, rtol=1e-5)
    # on the CPU the op took its plain version
    assert ops.PLAIN_CALLS["paged_decode_attention"] == \
        before["paged_decode_attention"] + 1


@pytest.mark.parametrize("pos0", [[0, 0], [5, 16]])
def test_paged_attn_extend(pos0):
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(7)
    B, S, nb, bs = 2, 6, 4, 8
    kp, vp, bt = _pool_setup(rng, tcfg, B, nb, bs)
    p = _attn_params(rng, tcfg)
    x = rng.randn(B, S, 64).astype(np.float32)
    pos0 = np.asarray(pos0, np.int32)
    out_t, c_t = tattn.paged_attn_extend(
        {k: _t(v) for k, v in p.items()}, _t(x),
        {"kp": _t(kp.copy()), "vp": _t(vp.copy())}, _t(pos0), _t(bt), tcfg,
        kind="causal")
    out_j, c_j = _jit_attn(jattn.paged_attn_extend, jcfg)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)}, jnp.asarray(pos0),
        jnp.asarray(bt))
    _close(out_t, out_j, atol=1e-5, rtol=1e-5)
    _close(c_t["vp"], c_j["vp"], atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------------
# dense attention: prefill (flash) and decode (split-K) paths
def test_causal_mask():
    for sq, skv, off in ((4, 4, 0), (3, 7, 4), (5, 2, 0)):
        np.testing.assert_array_equal(
            tattn.causal_mask(sq, skv, off).numpy(),
            np.asarray(jattn.causal_mask(sq, skv, off)))


@pytest.mark.parametrize("S", [20, 128])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_attn_forward(S, use_kernels):
    """The port routes every S through flash attention; the JAX side runs
    mha (use_kernels off, or S < 128) or the Pallas flash kernel in
    interpret mode (use_kernels on, S >= 128)."""
    jcfg, tcfg = _cfgs()
    jcfg = jcfg.replace(use_kernels=use_kernels)
    rng = np.random.RandomState(8)
    p = _attn_params(rng, tcfg)
    x = rng.randn(2, S, 64).astype(np.float32)
    before = ops.PLAIN_CALLS["flash_attention"]
    out_t = tattn.attn_forward({k: _t(v) for k, v in p.items()}, _t(x), tcfg,
                               kind="causal")
    out_j = jax.jit(functools.partial(jattn.attn_forward, cfg=jcfg,
                                      kind="causal"))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    _close(out_t, out_j, atol=1e-5, rtol=1e-5)
    assert ops.PLAIN_CALLS["flash_attention"] == before + 1


def _dense_cache(rng, cfg, B, L):
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return (rng.randn(B, L, KV, hd).astype(np.float32),
            rng.randn(B, L, KV, hd).astype(np.float32))


def test_attn_decode():
    """Dense decode: the write at pos and the attention over keys <= pos
    (the port's split-K decode with lengths = pos + 1, the JAX side's
    masked mha); pos L - 1 is the last row."""
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(9)
    B, L = 3, 24
    k, v = _dense_cache(rng, tcfg, B, L)
    p = _attn_params(rng, tcfg)
    x = rng.randn(B, 1, 64).astype(np.float32)
    pos = np.array([0, 13, L - 1], np.int32)
    before = ops.PLAIN_CALLS["decode_attention"]
    out_t, c_t = tattn.attn_decode(
        {k_: _t(v_) for k_, v_ in p.items()}, _t(x),
        {"k": _t(k.copy()), "v": _t(v.copy())}, _t(pos), tcfg, kind="causal")
    out_j, c_j = _jit_attn(jattn.attn_decode, jcfg)(
        {k_: jnp.asarray(v_) for k_, v_ in p.items()}, jnp.asarray(x),
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(pos))
    _close(out_t, out_j, atol=1e-5, rtol=1e-5)
    for key in ("k", "v"):
        _close(c_t[key], c_j[key], atol=1e-5, rtol=1e-5)
    assert ops.PLAIN_CALLS["decode_attention"] == before + 1


def test_batched_cache_update_clamps_like_dynamic_update_slice():
    """A start past the end clamps to the last row, as
    ``dynamic_update_slice`` does; the write is in place."""
    rng = np.random.RandomState(10)
    cache = rng.randn(3, 5, 2).astype(np.float32)
    row = rng.randn(3, 2).astype(np.float32)
    slot = np.array([0, 4, 9], np.int32)
    t_cache = _t(cache.copy())
    out = tattn.batched_cache_update(t_cache, _t(row), _t(slot))
    assert out is t_cache
    _close(out, jattn.batched_cache_update(jnp.asarray(cache),
                                           jnp.asarray(row),
                                           jnp.asarray(slot)))


def test_prefill_into_cache():
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(11)
    B, L, S = 2, 16, 6
    ck, cv = _dense_cache(rng, tcfg, B, L)
    k, v = (a[:, :S] for a in _dense_cache(rng, tcfg, B, L))
    c_t = tattn.prefill_into_cache(None, _t(k), _t(v),
                                   {"k": _t(ck.copy()), "v": _t(cv.copy())},
                                   tcfg, kind="causal")
    c_j = jattn.prefill_into_cache(None, jnp.asarray(k), jnp.asarray(v),
                                   {"k": jnp.asarray(ck),
                                    "v": jnp.asarray(cv)}, jcfg,
                                   kind="causal")
    for key in ("k", "v"):
        np.testing.assert_array_equal(c_t[key].numpy(), np.asarray(c_j[key]))


@pytest.mark.parametrize("kind", ["local", "bidir", "cross"])
def test_dense_attention_outside_slice_raises(kind):
    """Kinds local (gemma3-4b), bidir and cross (whisper-base) with an
    attention softcap, which the port refused until item 6 was done: they
    now compute JAX's capped attention (its ``mha`` under 1,024 tokens,
    ``_local_attention`` past the window), and the cap bites (the
    uncapped result is off by far more than the tolerance).  The name is
    kept from the refusal it replaced."""
    cap = 1.0
    jcfg, tcfg = _cfgs(attn_softcap=cap,
                       **({"window": 4} if kind == "local" else {}))
    rng = np.random.RandomState(12)
    p = _attn_params(rng, tcfg)
    x = rng.randn(2, 9, 64).astype(np.float32)
    enc = rng.randn(2, 13, 64).astype(np.float32)
    kv = {"encoder_kv": enc} if kind == "cross" else {}
    out_j = jattn.attn_forward({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), jcfg, kind=kind,
                               **{k: jnp.asarray(v) for k, v in kv.items()})
    tp = {k: _t(v) for k, v in p.items()}
    tkv = {k: _t(v) for k, v in kv.items()}
    out_t = tattn.attn_forward(tp, _t(x), tcfg, kind=kind, **tkv)
    _close(out_t, out_j, atol=1e-5, rtol=1e-5)
    plain = tattn.attn_forward(tp, _t(x), tcfg.replace(attn_softcap=0.0),
                               kind=kind, **tkv)
    assert np.abs(plain.numpy() - np.asarray(out_j)).max() > 1e-3
