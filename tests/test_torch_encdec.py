"""PyTorch port vs the JAX package: the encoder-decoder family
(whisper-base, ``repro_torch.models.encdec``) on its fp32 reduced config
two layers deep on each side, with the JAX weights carried over by
``params_from_numpy`` and the same numpy frames and tokens on both sides.

Tolerances (fp32, sums in another order): the encoder states at ``atol =
rtol = 1e-5``; logits at ``1e-4``; greedy tokens exact; caches at
``1e-5``; the loss at ``rtol = 1e-5`` and each gradient within ``1e-5``
of its leaf's largest magnitude; the train step as
``tests/test_torch_train.py`` holds it.  The sinusoids are computed as
JAX computes them, in fp32, but XLA's and PyTorch's fp32 ``exp``,
``sin`` and ``cos`` differ in the last bit (PyTorch 2.13 and jax 0.9.0
on the CPU: 1.9e-6 at positions below 37, 2.4e-5 at 500), so they are
held to 4 fp32 ulps of the angle, ``4 * 2^-23 * (pos + 1)``.  On the CPU
every attention is the kernels' plain version, P in fp32; JAX's ``mha``
rounds P to the activation dtype, which in bf16 moves one layer's logits
by up to ``BF16_REL`` of their largest magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro.checkpoint.checkpointer import _flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api, encdec, weights  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCH = "whisper-base"
ENC = dict(atol=1e-5, rtol=1e-5)
LOGIT = dict(atol=1e-4, rtol=1e-4)
RTOL = 1e-5
BF16_REL = 2e-2
B, S_ENC, S, MAX_LEN = 2, 24, 5, 16
LR, WARMUP, TOTAL = 1e-2, 1, 10


def _cfgs(layers=2, **kw):
    over = dict(enc_layers=layers, dec_layers=layers, n_layers=2 * layers,
                **kw)
    return (jax_reduced(jax_get_config(ARCH)).replace(**over),
            reduced(get_config(ARCH)).replace(**over))


def _flat_numpy(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree)[0].items()}


def _numpy(tree):
    return {k: v.detach().float().numpy()
            for k, v in flatten_with_paths(tree).items()}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = jax.jit(lambda k: japi.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    flat = _flat_numpy(jparams)
    return jcfg, tcfg, jparams, flat, weights.params_from_numpy(flat, tcfg,
                                                                "cpu")


def _data(seed=0, b=B, s_enc=S_ENC, s=S, vocab=256):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s_enc, 64).astype(np.float32),
            rng.randint(0, vocab, (b, s)).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_param_specs_are_jaxs_tree_and_its_count(model):
    """The specs' keys and shapes are JAX's flattened tree; at full width
    the family holds 97,318,912 parameters (vocab 51,865 padded to
    51,968, an untied lm_head)."""
    _, tcfg, _, flat, _ = model
    specs = weights.param_specs(tcfg)
    assert sorted(specs) == sorted(flat)
    for k, spec in specs.items():
        assert weights._full_shape(spec) == flat[k].shape, k
    full = weights.param_specs(get_config(ARCH))
    assert sum(int(np.prod(weights._full_shape(s))) for s in
               full.values()) == 97_318_912
    assert full["enc/self/wq"][0] == 6 and full["lm_head"][0] == 0


def test_sinusoids_match_jax():
    pos = np.array([0, 1, 5, 36, 447, 500], np.int32)
    for d in (64, 512):
        want = np.asarray(jenc.sinusoid(40, d, jnp.float32))
        got = encdec.sinusoid(40, d, torch.float32).numpy()
        tol = 4 * 2.0 ** -23 * (np.arange(40)[:, None] + 1)
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
        want = np.asarray(jenc.sinusoid_at(jnp.asarray(pos), d, jnp.float32))
        got = encdec.sinusoid_at(_t(pos), d, torch.float32).numpy()
        assert np.all(np.abs(got - want) <= 4 * 2.0 ** -23 *
                      (pos[:, None] + 1)), np.abs(got - want).max()
    assert encdec.sinusoid(3, 64, torch.bfloat16).dtype == torch.bfloat16


def test_encode_and_decode_full_match_jax(model):
    jcfg, tcfg, jparams, _, tparams = model
    frames, tok = _data()
    jenc_states = jax.jit(lambda p, f: jenc.encode(p, f, jcfg))(jparams,
                                                                 frames)
    with torch.no_grad():
        got = encdec.encode(tparams, _t(frames), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(jenc_states),
                                   **ENC)
        logits = encdec.decode_full(tparams, _t(tok), got, tcfg)
    want = jax.jit(lambda p, t, e: jenc.decode_full(p, t, e, jcfg))(
        jparams, tok, jenc_states)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **LOGIT)


def _jax_serve(jcfg, jparams, frames, tok, n):
    """JAX's prefill and ``n`` greedy decode steps: (logits of each step,
    tokens, caches after the prefill)."""
    caches = japi.init_caches(jcfg, B, MAX_LEN, S_ENC)
    pre = jax.jit(lambda p, t, f, c: jenc.prefill(p, t, f, jcfg, c))
    dec = jax.jit(lambda p, t, c, pos: jenc.decode_step(p, t, c, pos, jcfg))
    logits, caches = pre(jparams, tok, frames, caches)
    filled = {k: np.asarray(v) for k, v in caches.items()}
    out, toks = [np.asarray(logits)], []
    for i in range(n):
        nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        toks.append(np.asarray(nxt))
        pos = jnp.full((B,), S + i, jnp.int32)
        logits, caches = dec(jparams, nxt[:, None], caches, pos)
        out.append(np.asarray(logits))
    return out, toks, filled


def test_prefill_and_greedy_decode_match_jax(model):
    """The prefill's logits and all four caches, then 8 greedy decode
    steps: the same tokens, logits at 1e-4."""
    jcfg, tcfg, jparams, _, tparams = model
    frames, tok = _data(1)
    want, want_toks, filled = _jax_serve(jcfg, jparams, frames, tok, 8)
    caches = api.init_caches(tcfg, B, MAX_LEN, S_ENC, device="cpu")
    with torch.no_grad():
        logits, caches = encdec.prefill(tparams, _t(tok), _t(frames), tcfg,
                                        caches)
        for k, w in filled.items():
            np.testing.assert_allclose(caches[k].numpy(), w, err_msg=k,
                                       **ENC)
        got = [logits.numpy()]
        for i in range(8):
            nxt = logits[:, -1].argmax(-1).to(torch.int32)
            assert np.array_equal(nxt.numpy(), want_toks[i]), i
            logits, caches = encdec.decode_step(
                tparams, nxt[:, None], caches,
                torch.full((B,), S + i, dtype=torch.int32), tcfg)
            got.append(logits.numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **LOGIT)


def test_decode_past_max_len_clamps_as_jax(model):
    """A write at pos >= max_len lands on the last row (JAX's
    ``dynamic_update_slice`` clamps) and the step sees every row."""
    jcfg, tcfg, jparams, _, tparams = model
    frames, tok = _data(2)
    L = 8
    jc = japi.init_caches(jcfg, B, L, S_ENC)
    _, jc = jax.jit(lambda p, t, f, c: jenc.prefill(p, t, f, jcfg, c))(
        jparams, tok, frames, jc)
    pos = np.array([L + 3, L - 1], np.int32)
    nxt = tok[:, :1]
    want, jc = jax.jit(lambda p, t, c, q: jenc.decode_step(p, t, c, q, jcfg))(
        jparams, nxt, jc, pos)
    tc = api.init_caches(tcfg, B, L, S_ENC, device="cpu")
    with torch.no_grad():
        _, tc = encdec.prefill(tparams, _t(tok), _t(frames), tcfg, tc)
        got, tc = encdec.decode_step(tparams, _t(nxt), tc, _t(pos), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT)
    for k in ("self_k", "self_v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **ENC)


def test_loss_and_every_gradient_match_jax(model):
    jcfg, tcfg, jparams, flat, _ = model
    frames, tok = _data(3, s=9)
    (jl, (jce, jaux)), jg = jax.jit(
        jax.value_and_grad(japi.loss_fn, has_aux=True), static_argnums=1)(
        jparams, jcfg, {"frames": jnp.asarray(frames),
                        "tokens": jnp.asarray(tok)})
    params = weights.params_from_numpy(flat, tcfg, "cpu")
    (loss, (ce, aux)), grads = steps.value_and_grad(
        params, tcfg, {"frames": _t(frames), "tokens": _t(tok)})
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(ce), float(jce), rtol=RTOL)
    assert float(aux) == float(jaux) == 0.0
    want = _flat_numpy(jg)
    got = _numpy(grads)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()))
        assert np.abs(w).max() > 0, k


def test_train_steps_match_jax(model):
    """Three AdamW steps of ``steps.make_train_step`` on {frames, tokens}
    against JAX's jitted ``make_train_step``: metrics at rtol 1e-5, m and
    v within 1e-5 of each leaf's largest magnitude, parameters within
    1e-3 * lr (``tests/test_torch_train.py``'s tolerances)."""
    jcfg, tcfg, jparams, flat, _ = model
    batches = [_data(10 + i, s=9) for i in range(3)]
    jfn = jax.jit(jsteps.make_train_step(jcfg, lr=LR, warmup=WARMUP,
                                         total=TOTAL))
    fn = steps.make_train_step(tcfg, lr=LR, warmup=WARMUP, total=TOTAL)
    jp, jopt = jparams, jadamw_init(jparams)
    params = weights.params_from_numpy(flat, tcfg, "cpu")
    opt = adamw_init(params)
    for i, (frames, tok) in enumerate(batches):
        jp, jopt, jm = jfn(jp, jopt, {"frames": jnp.asarray(frames),
                                      "tokens": jnp.asarray(tok)})
        params, opt, m = fn(params, opt, {"frames": _t(frames),
                                          "tokens": _t(tok)})
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=f"{key} step {i}", rtol=RTOL)
        for got, want, atol in (
                (_numpy(params), _flat_numpy(jp), lambda w: 1e-3 * LR),
                (_numpy(opt.m), _flat_numpy(jopt.m),
                 lambda w: RTOL * float(np.abs(w).max())),
                (_numpy(opt.v), _flat_numpy(jopt.v),
                 lambda w: RTOL * float(np.abs(w).max()))):
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                np.testing.assert_allclose(got[k], w, err_msg=k, rtol=RTOL,
                                           atol=atol(w))
    assert int(opt.step) == 3 and float(m["lr"]) > 0


def test_api_entry_points_run_the_family(model):
    """Every ``api`` function and the step builders on the family: the
    seeded init's tree, ``input_batch``'s shapes and dtypes, the forward,
    loss, caches, prefill and decode, each prefill and decode against
    JAX's ``api`` on the same weights, and every attention on the plain
    versions (the kernels' CPU route)."""
    jcfg, tcfg, jparams, flat, tparams = model
    gen = torch.Generator().manual_seed(0)
    params = api.init(gen, tcfg, "cpu")
    assert {k: tuple(v.shape) for k, v in
            flatten_with_paths(params).items()} == \
        {k: a.shape for k, a in flat.items()}
    train = api.input_batch(tcfg, "train", B, 12, gen, device="cpu")
    assert train["frames"].shape == (B, 12, 64) and \
        train["frames"].dtype == torch.float32
    assert train["tokens"].shape == (B, 12) and \
        train["tokens"].dtype == torch.int32
    dec = api.input_batch(tcfg, "decode", B, 12, gen, device="cpu")
    assert dec["tokens"].shape == (B, 1) and dec["pos"].tolist() == [11] * B
    frames, tok = _data(4)
    batch = {"frames": _t(frames), "tokens": _t(tok)}
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tok)}
    ops.reset_counts()
    with torch.no_grad():
        logits = api.forward_fn(tparams, tcfg, batch)
        loss, (ce, _) = api.loss_fn(tparams, tcfg, batch)
        caches = api.init_caches(tcfg, B, MAX_LEN, S_ENC, device="cpu")
        last, caches = steps.make_prefill_step(tcfg, MAX_LEN)(
            tparams, batch, caches)
        pos = torch.full((B,), S, dtype=torch.int32)
        nxt, caches = steps.make_decode_step(tcfg)(
            tparams, {"tokens": batch["tokens"][:, -1:], "pos": pos}, caches)
    # 2 encoder + 2 x 2 decoder flash calls in each of the three passes,
    # then 2 x 2 split-K decode calls in the decode step
    assert ops.PLAIN_CALLS["flash_attention"] == 3 * 6
    assert ops.PLAIN_CALLS["decode_attention"] == 4
    torch.testing.assert_close(last[:, 0], logits[:, -1])
    assert float(loss) == float(ce)
    np.testing.assert_allclose(logits.numpy(), np.asarray(
        japi.forward_fn(jparams, jcfg, jbatch)), **LOGIT)
    jc = japi.init_caches(jcfg, B, MAX_LEN, S_ENC)
    jlast, jc = japi.prefill_fn(jparams, jcfg, jbatch, jc)
    jnxt, _ = japi.decode_fn(jparams, jcfg, {
        "tokens": jbatch["tokens"][:, -1:], "pos": jnp.asarray(pos)}, jc)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **LOGIT)
    np.testing.assert_allclose(nxt.numpy(), np.asarray(jnxt), **LOGIT)
    assert api.init_caches(tcfg, 1, 8, device="cpu")["cross_k"].shape == \
        (2, 1, 8, tcfg.n_kv_heads, tcfg.head_dim)


def test_prefill_replaces_cross_caches_of_another_length(model):
    """JAX's prefill replaces the cross caches; the port writes them in
    place when their length is the encoder's, and replaces them otherwise
    (``api.init_caches`` without ``enc_len`` sizes them to max_len)."""
    _, tcfg, _, _, tparams = model
    frames, tok = _data(5)
    with torch.no_grad():
        same = api.init_caches(tcfg, B, MAX_LEN, S_ENC, device="cpu")
        buf = same["cross_k"]
        _, same = encdec.prefill(tparams, _t(tok), _t(frames), tcfg, same)
        other = api.init_caches(tcfg, B, MAX_LEN, device="cpu")
        _, other = encdec.prefill(tparams, _t(tok), _t(frames), tcfg, other)
    assert same["cross_k"] is buf
    assert other["cross_k"].shape == buf.shape
    torch.testing.assert_close(other["cross_k"], buf, rtol=0, atol=0)


def test_bf16_layer_stays_near_jax(model):
    """One layer a side in bf16: the port's logits within BF16_REL of the
    largest JAX logit.  JAX's mha rounds P to bf16, the port keeps it in
    fp32, so they differ by more than the fp32 runs do."""
    jcfg, tcfg = _cfgs(1, dtype="bfloat16", param_dtype="bfloat16")
    jparams = jax.jit(lambda k: japi.init(k, jcfg)[0])(jax.random.PRNGKey(1))
    tparams = weights.params_from_numpy(_flat_numpy(jparams), tcfg, "cpu")
    frames, tok = _data(6)
    want = np.asarray(jax.jit(lambda p, b: japi.forward_fn(p, jcfg, b))(
        jparams, {"frames": jnp.asarray(frames),
                  "tokens": jnp.asarray(tok)})).astype(np.float32)
    with torch.no_grad():
        got = api.forward_fn(tparams, tcfg, {"frames": _t(frames),
                                             "tokens": _t(tok)})
    assert got.dtype == torch.bfloat16
    keep = np.arange(want.shape[-1]) < tcfg.vocab
    err = np.abs(got.float().numpy() - want)[..., keep].max()
    assert err <= BF16_REL * np.abs(want[..., keep]).max(), err


def test_load_checkpoint_reads_a_jax_step(model, tmp_path):
    _, tcfg, jparams, flat, _ = model
    Checkpointer(str(tmp_path)).save(3, jparams)
    port = weights.load_checkpoint(str(tmp_path / "step_3"), tcfg, "cpu")
    got = _numpy(port)
    assert sorted(got) == sorted(flat)
    for k, w in flat.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
