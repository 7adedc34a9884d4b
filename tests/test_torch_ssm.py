"""PyTorch port vs the JAX package: the Mamba-1 family (falcon-mamba-7b),
from the selective-scan kernel's plain version up to the engines.

Inputs are made from a seed with numpy and fed to both sides; JAX weights
are carried over with ``params_from_numpy``.  The port runs on the CPU,
where its scan takes the plain sequential recurrence
(``repro_torch.kernels.ref.ssm_scan_ref``); the JAX side runs its Pallas
kernel in interpret mode, its ``ref.ssm_scan_ref``, or its model's chunked
``associative_scan`` (``cfg.use_kernels`` off, as its serving tests do).
One engine case turns ``use_kernels`` on, so that the JAX engine's
prompt of 130 tokens crosses its kernel gate (``ssm.py:123``).

Tolerances: the scan ``atol = rtol = 1e-4`` and the op against the
model's scan ``1e-3``, both as tests/test_kernels.py:199-218; the conv
``1e-6`` (the same products summed in the same order); the SSM block and
whole-model logits ``1e-4`` (fp32; the chunked scan sums in another order
than the sequential one); tokens and finish reasons exactly.
"""
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_blocked  # noqa: E402
from repro.models import api  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro.serving import make_engine_fns  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

ARCH = "falcon-mamba-7b"
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)

_jpallas_scan = jax.jit(ssm_scan_blocked,
                        static_argnames=("chunk", "block_d", "interpret"))
_jref_scan = jax.jit(jref.ssm_scan_ref)
_jpre = jax.jit(jtfm.prefill, static_argnums=1)
_jdec = jax.jit(jtfm.decode_step, static_argnums=1)
_JFNS = {}                                  # JAX engine fns per config


def _cfgs(**kw):
    j = jax_reduced(jax_get_config(ARCH)).replace(
        n_layers=2, groups=(JScanGroup(("S",), 2),), **kw)
    t = reduced(get_config(ARCH)).replace(
        n_layers=2, groups=(ScanGroup(("S",), 2),), **kw)
    return j, t


def _flat_numpy(params):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(params)[0].items()}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = jax.jit(lambda k: api.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    tparams = weights.params_from_numpy(_flat_numpy(jparams), tcfg,
                                        device="cpu")
    return jcfg, tcfg, jparams, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


# ----------------------------------------------------------------------
# the scan: plain version and op against the Pallas kernel and oracles
def _scan_inputs(seed, B, S, D, N):
    """Stable dynamics as tests/test_kernels.py:189-194: a in (0, 1), b
    small, h0 nonzero."""
    rng = np.random.RandomState(seed)
    a = 1.0 / (1.0 + np.exp(-rng.randn(B, S, D, N)))
    b = rng.randn(B, S, D, N) * 0.1
    h0 = rng.randn(B, D, N)
    return [x.astype(np.float32) for x in (a, b, h0)]


@pytest.mark.parametrize("B,S,D,N,chunk", [
    (1, 128, 64, 8, 32),
    (2, 100, 128, 16, 64),   # ragged S: the TPU kernel's pad path
    (1, 256, 512, 16, 64),
])
def test_ssm_scan_ref(B, S, D, N, chunk):
    a, b, h0 = _scan_inputs(11, B, S, D, N)
    hs, hT = ref.ssm_scan_ref(_t(a), _t(b), _t(h0))
    assert hs.shape == (B, S, D, N) and hT.shape == (B, D, N)
    for j_hs, j_hT in (
            _jpallas_scan(a, b, h0, chunk=chunk, block_d=min(64, D),
                          interpret=True),
            _jref_scan(a, b, h0)):
        np.testing.assert_allclose(hs.numpy(), _np(j_hs), **SCAN_TOL)
        np.testing.assert_allclose(hT.numpy(), _np(j_hT), **SCAN_TOL)


def _op_inputs(seed, B, S, D, N):
    """tests/test_kernels.py:205-213's op inputs."""
    rng = np.random.RandomState(seed)
    softplus = lambda x: np.log1p(np.exp(x))  # noqa: E731
    xc = rng.randn(B, S, D)
    dt = softplus(rng.randn(B, S, D))
    Bc, Cc = rng.randn(B, S, N), rng.randn(B, S, N)
    A = -np.exp(rng.randn(D, N))
    Dd = rng.randn(D)
    return [x.astype(np.float32) for x in (xc, dt, Bc, Cc, A, Dd)]


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan_op(with_h0):
    """ops.ssm_scan (plain route) against the JAX op over the Pallas kernel
    and the model's chunked scan, at tests/test_kernels.py:205's shape."""
    B, S, D, N = 2, 96, 64, 8
    args = _op_inputs(5, B, S, D, N)
    h0 = np.random.RandomState(6).randn(B, D, N).astype(np.float32) \
        if with_h0 else None
    ops.reset_counts()
    y, hT = ops.ssm_scan(*map(_t, args), h0=None if h0 is None else _t(h0))
    assert ops.PLAIN_CALLS["ssm_scan"] == 1 and \
        set(kernels.LAUNCHES.values()) == {0}
    y_k, h_k = jops.ssm_scan(*args, h0=h0, chunk=32, block_d=32,
                             interpret=True)
    np.testing.assert_allclose(y.numpy(), _np(y_k), **SCAN_TOL)
    np.testing.assert_allclose(hT.numpy(), _np(h_k), **SCAN_TOL)
    y_r, h_r = jssm.selective_scan(*args, h0=h0, chunk=16)
    np.testing.assert_allclose(y.numpy(), _np(y_r), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(hT.numpy(), _np(h_r), atol=1e-3, rtol=1e-3)
    y_m, h_m = ssm.selective_scan(*map(_t, args),
                                  h0=None if h0 is None else _t(h0))
    assert torch.equal(y_m, y) and torch.equal(h_m, hT)


@pytest.mark.parametrize("bad", [
    dict(a=(2, 5, 8, 4), b=(2, 5, 8, 3)),
    dict(h0=(2, 8, 3)),
    dict(S=0),
    dict(dtype=torch.bfloat16),
    dict(h0_dtype=torch.float64),
    dict(transposed=True),
])
def test_ssm_scan_rejects(bad):
    shape = bad.get("a", (2, bad.get("S", 5), 8, 4))
    a = torch.rand(shape, dtype=bad.get("dtype", torch.float32))
    b = torch.rand(bad.get("b", shape), dtype=a.dtype)
    h0 = torch.zeros(bad.get("h0", (2, 8, 4)),
                     dtype=bad.get("h0_dtype", torch.float32))
    if bad.get("transposed"):
        a = a.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="ssm_scan"):
        ss.check_args(a, b, h0)


def test_ssm_scan_kernel_takes_cuda_tensors_only():
    a, b, h0 = map(_t, _scan_inputs(0, 1, 3, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan_blocked(a, b, h0)
    assert kernels.LAUNCHES["ssm_scan"] == 0


# ----------------------------------------------------------------------
# the SSM block on the reduced config
def _layer(model):
    jcfg, tcfg, jparams, tparams = model
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["groups"][0][0])
    tp = ttfm._unstack(tparams["groups"][0][0], tcfg.groups[0].repeats)[1]
    return jcfg, tcfg, jp["mixer"], tp["mixer"]


def test_conv1d_causal(model):
    _, tcfg, jp, tp = _layer(model)
    x = np.random.RandomState(1).randn(2, 9, tcfg.d_inner).astype(np.float32)
    want = jssm._conv1d_causal(x, jp["conv_w"], jp["conv_b"])
    got = ssm._conv1d_causal(_t(x), tp["conv_w"], tp["conv_b"])
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=1e-6)


def _state(rng, B, tcfg):
    return {"conv": rng.randn(B, tcfg.conv_k - 1, tcfg.d_inner)
            .astype(np.float32),
            "h": rng.randn(B, tcfg.d_inner, tcfg.ssm_state)
            .astype(np.float32) * 0.5}


def _close_state(got, want):
    for key in ("conv", "h"):
        np.testing.assert_allclose(got[key].numpy(), _np(want[key]),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("S", [1, 2, 3, 11])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_forward(model, S, with_state):
    """Every branch of the new conv state (``ssm.py:132-136``): S below,
    at and above K - 1, with and without a carried state."""
    jcfg, tcfg, jp, tp = _layer(model)
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, tcfg.d_model).astype(np.float32)
    st = _state(rng, 2, tcfg) if with_state else None
    want, wstate = jssm.ssm_forward(jp, jnp.asarray(x), jcfg, state=st)
    got, gstate = ssm.ssm_forward(
        tp, _t(x), tcfg, state=None if st is None else
        {k: _t(v) for k, v in st.items()})
    np.testing.assert_allclose(got.numpy(), _np(want), **LOGIT_TOL)
    _close_state(gstate, wstate)


def test_ssm_decode(model):
    jcfg, tcfg, jp, tp = _layer(model)
    rng = np.random.RandomState(4)
    st = _state(rng, 3, tcfg)
    for _ in range(3):
        x = rng.randn(3, 1, tcfg.d_model).astype(np.float32)
        want, wstate = jssm.ssm_decode(jp, jnp.asarray(x), st, jcfg)
        got, gstate = ssm.ssm_decode(tp, _t(x),
                                     {k: _t(v) for k, v in st.items()}, tcfg)
        np.testing.assert_allclose(got.numpy(), _np(want), **LOGIT_TOL)
        _close_state(gstate, wstate)
        st = {k: _np(v) for k, v in wstate.items()}


def test_init_ssm_state_and_caches(model):
    _, tcfg, _, _ = model
    c = ttfm.init_caches(tcfg, 3, 64, "cpu")[0][0]
    assert c["conv"].shape == (2, 3, tcfg.conv_k - 1, tcfg.d_inner)
    assert c["h"].shape == (2, 3, tcfg.d_inner, tcfg.ssm_state)
    assert {t.dtype for t in c.values()} == {torch.float32}
    assert not any(t.any() for t in c.values())


# ----------------------------------------------------------------------
# whole model: prefill and decode logits, and the state they leave
def test_prefill_and_decode_logits(model):
    """Prefill (the state written into each repeat's views) then three
    decode steps from it: logits and states equal the JAX model's."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(3)
    B, S = 2, 10
    toks = rng.randint(0, tcfg.vocab, size=(B, S)).astype(np.int32)
    jc = api.init_caches(jcfg, B, 32)
    tc = ttfm.init_caches(tcfg, B, 32, "cpu")
    lj, jc = _jpre(jparams, jcfg, jnp.asarray(toks), jc)
    lt, tc = ttfm.prefill(tparams, tcfg, _t(toks), tc)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **LOGIT_TOL)
    for r in range(2):
        _close_state({k: v[r] for k, v in tc[0][0].items()},
                     {k: v[r] for k, v in jc[0][0].items()})
    for i in range(3):
        tok = rng.randint(0, tcfg.vocab, size=(B, 1)).astype(np.int32)
        pos = np.full(B, S + i, np.int32)
        lj, jc = _jdec(jparams, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos))
        lt, tc = ttfm.decode_step(tparams, tcfg, _t(tok), tc, _t(pos))
        np.testing.assert_allclose(lt.numpy(), _np(lj), **LOGIT_TOL)
    for r in range(2):
        _close_state({k: v[r] for k, v in tc[0][0].items()},
                     {k: v[r] for k, v in jc[0][0].items()})


# ----------------------------------------------------------------------
# engines: token-exact against the JAX engine, fused and reference
_KW = [dict(fused=True), dict(fused=False)]
_IDS = ["fused", "reference"]


def _serve_both(model, scfg_kw, prompts, max_new, use_kernels=False):
    jcfg, tcfg, jparams, tparams = model
    if use_kernels:
        jcfg, tcfg = (c.replace(use_kernels=True) for c in (jcfg, tcfg))
    key = (use_kernels,) + tuple(sorted(scfg_kw.items()))
    if key not in _JFNS:
        _JFNS[key] = make_engine_fns(jcfg, JServeConfig(**scfg_kw))
    jeng = JEngine(jparams, jcfg, JServeConfig(**scfg_kw),
                   shared_fns=_JFNS[key])
    teng = Engine(tparams, tcfg, ServeConfig(**scfg_kw), device="cpu")
    jreqs = [jeng.submit(p, max_new=max_new) for p in prompts]
    treqs = [teng.submit(p, max_new=max_new) for p in prompts]
    jeng.run_until_drained()
    teng.run_until_drained()
    assert len(teng.finished) == len(prompts)
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert b.out_tokens == a.out_tokens, i
        assert b.finish_reason == a.finish_reason, i
    assert _levels(teng.metrics.snapshot()) == \
        _levels(jeng.metrics.snapshot())
    return jeng, jreqs, teng, treqs


def _levels(snap):
    hist = (".count", ".mean", ".p50", ".p95", ".p99")
    return {k: v for k, v in snap.items()
            if not k.endswith(hist) and ".le" not in k}


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=n).astype(np.int32) for n in lengths]


_SCFG = dict(max_len=160, slots=3, sync_every=4)


@pytest.mark.parametrize("kw", _KW, ids=_IDS)
def test_engine_refill_parity(model, kw):
    """5 requests through 3 slots: completions mid-K-loop and refills of
    the freed slots, whose state rows are replaced whole."""
    _, jreqs, _, _ = _serve_both(model, dict(_SCFG, **kw),
                                 _prompts(0, (5, 9, 7, 9, 5)), max_new=6)
    assert {r.finish_reason for r in jreqs} == {"max_new"}


@pytest.mark.parametrize("kw", _KW, ids=_IDS)
def test_engine_truncation_parity(model, kw):
    """tests/test_serving_fused.py:93-110: max_len truncation that lands
    mid-K-loop on the fused engine."""
    _, jreqs, _, _ = _serve_both(
        model, dict(max_len=16, slots=2, sync_every=8, **kw),
        _prompts(3, (4, 9)), max_new=100)
    assert {r.finish_reason for r in jreqs} == {"max_len"}


@pytest.mark.parametrize("kw", _KW, ids=_IDS)
def test_engine_same_length_prompts_share_one_admit(model, kw):
    """tests/test_serving_fused.py:177-189: three prompts of one length
    admit as one exact-length batch on the fused engine."""
    jeng, _, teng, _ = _serve_both(model, dict(_SCFG, **kw),
                                   _prompts(5, (7, 7, 7)), max_new=4)
    batches = teng.metrics.counter("engine.prefill_batches").value
    assert batches == jeng.metrics.counter("engine.prefill_batches").value
    assert batches == (1 if kw["fused"] else 0)


@pytest.mark.parametrize("kw", _KW, ids=_IDS)
def test_engine_long_prompt_crosses_the_kernel_gate(model, kw):
    """A prompt of 130 tokens with ``use_kernels`` on: the JAX engine runs
    its Pallas scan (interpret mode) there and its jnp scan for the
    5-token prompt; the port runs one op for both."""
    _serve_both(model, dict(_SCFG, **kw), _prompts(6, (130, 5)), max_new=5,
                use_kernels=True)


def test_paged_falls_back_to_dense(model):
    """``paged=True`` serves dense, as in JAX: ``engine.paged`` is False
    and ``engine.paged_fallback_dense`` counts it on both sides."""
    jeng, _, teng, _ = _serve_both(
        model, dict(_SCFG, paged=True, block_size=8),
        _prompts(0, (5, 9, 7, 9, 5)), max_new=6)
    assert teng.paged is False and jeng.paged is False
    assert teng.metrics.counter("engine.paged_fallback_dense").value == \
        jeng.metrics.counter("engine.paged_fallback_dense").value == 1


def test_serve_driver_mamba_on_cpu():
    """``--arch falcon-mamba-7b`` serves the reduced config; ``--paged``
    serves dense, printing ``kv=dense``, with the same tokens."""
    import io
    from contextlib import redirect_stdout
    lines = []
    for extra in ([], ["--paged", "--block-size", "8"]):
        out = io.StringIO()
        with redirect_stdout(out):
            serve.main(["--arch", ARCH, "--device", "cpu", "--reduce",
                        "--requests", "3", "--max-new", "4", "--slots", "2",
                        "--max-len", "32", *extra])
        lines.append(out.getvalue().strip().splitlines()[-1])
    assert all(f"arch={ARCH}" in ln and "kv=dense" in ln and
               "tokens=15" in ln for ln in lines)


# ----------------------------------------------------------------------
# weights
def test_params_from_numpy_keeps_a_log_fp32(model):
    """Under a bf16 config every leaf is bf16 except A_log, fp32 as the
    JAX init leaves it; the values carry over exactly."""
    jcfg, tcfg = _cfgs(param_dtype="bfloat16")
    jparams = jax.jit(lambda k: api.init(k, jcfg)[0])(jax.random.PRNGKey(1))
    flat = _flat_numpy(jparams)
    assert flat["groups/0/0/mixer/A_log"].dtype == np.float32
    port = weights.params_from_numpy(flat, tcfg, "cpu")
    mixer = port["groups"][0][0]["mixer"]
    assert mixer["A_log"].dtype == torch.float32
    assert {v.dtype for k, v in mixer.items() if k != "A_log"} == \
        {torch.bfloat16}
    np.testing.assert_array_equal(mixer["A_log"].numpy(),
                                  flat["groups/0/0/mixer/A_log"])
    np.testing.assert_array_equal(
        mixer["in_proj"].float().numpy(),
        flat["groups/0/0/mixer/in_proj"].astype(np.float32))


def test_param_specs_match_the_jax_tree_at_full_width():
    """Shapes and dtypes of every leaf of the full-width tree, checked
    without allocating it."""
    abstract = jax.eval_shape(lambda k: api.init(k, jax_get_config(ARCH))[0],
                              jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flatten_with_paths(abstract)[0].items()}
    cfg = get_config(ARCH)
    got = {k: (weights._full_shape(s),
               str(weights.spec_dtype(s, cfg)).split(".")[1])
           for k, s in weights.param_specs(cfg).items()}
    assert got == want
    assert got["groups/0/0/mixer/in_proj"][0] == (64, 4096, 16384)


def test_init_params_distributions():
    """The seeded init draws the JAX init's distributions: in_proj
    N(0, 1/d), conv_w N(0, 0.5^2) (dense_init's scale is the std), the
    rest constants; one seed gives one set of weights."""
    _, tcfg = _cfgs()
    p = [weights.init_params(tcfg, torch.Generator().manual_seed(7), "cpu")
         for _ in range(2)]
    m = p[0]["groups"][0][0]["mixer"]
    assert torch.equal(m["in_proj"], p[1]["groups"][0][0]["mixer"]["in_proj"])
    assert abs(m["in_proj"].std().item() * np.sqrt(tcfg.d_model) - 1) < 0.05
    assert abs(m["x_proj"].std().item() * np.sqrt(tcfg.d_inner) - 1) < 0.05
    assert abs(m["conv_w"].std().item() / 0.5 - 1) < 0.1
    assert not torch.equal(m["in_proj"][0], m["in_proj"][1])
    # JAX's A_log, within one fp32 ulp: torch.log and jnp.log round
    # log(7) to neighbouring floats
    want_a = jnp.log(jnp.tile(jnp.arange(1, tcfg.ssm_state + 1,
                                         dtype=jnp.float32),
                              (2, tcfg.d_inner, 1)))
    assert m["A_log"].dtype == torch.float32
    np.testing.assert_allclose(m["A_log"].numpy(), _np(want_a), atol=0,
                               rtol=1.2e-7)
    assert torch.equal(m["D"], torch.ones(2, tcfg.d_inner))
    assert not m["conv_b"].any() and not m["dt_bias"].any()
    assert torch.equal(p[0]["groups"][0][0]["ln1"]["w"],
                       torch.ones(2, tcfg.d_model))
