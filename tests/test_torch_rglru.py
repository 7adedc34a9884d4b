"""recurrentgemma-2b in the port against the JAX package: the RG-LRU block
(``models/rglru.py``: conv, gates, the diagonal scan on the scan kernel's
route, prefill and decode), its weight tree, the hybrid model's logits over
RG-LRU state and local attention rings, and greedy decode through the dense
fused, reference and (falling back) paged engines.

Both sides run ``reduced()`` recurrentgemma-2b in fp32 with its first scan
group at 2 repeats, ``(R, R, L) x 2 + (R, R) x 1``: 8 layers, so both kinds
have R > 1 in the stacked layout (MQA: 4 query heads over 1 kv head, hd
16, window 16, lru_width 64, conv 4, GeGLU, ``(1 + w)`` RMSNorm, scaled and
tied embeddings).  Inputs are made from a seed with numpy; the JAX weights
are carried over with ``params_from_numpy``, norm weights perturbed so that
``1 + w`` differs from 1; the JAX side runs its plain path.  On the CPU the
port's scan takes the plain sequential recurrence
(``repro_torch.kernels.ref.ssm_scan_ref`` at N = 1); JAX scans in
associative chunks of 256, so S = 300 crosses one chunk boundary.

Tolerances: the conv ``1e-6`` (the same products summed in the same
order); the block, its state and the scan ``atol = rtol = 1e-5`` in fp32
(the chunked scan sums in another order); in bf16 the block's output
within ``atol = rtol = 2e-2`` (the bf16 projections round to 2^-8 of a
value; a rounding step apart anywhere upstream moves the output by a few
such steps) and its fp32 state within ``1e-2``; whole-model logits
``1e-4`` (fp32, tests/test_kernels.py:16); ``lambda`` within one fp32 ulp
of 1.0 (JAX's eager and jitted inits differ from each other by up to
6e-8); tokens and finish reasons exactly.
"""
import dataclasses
import io
from contextlib import redirect_stdout

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
from repro.models import api  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import rglru, weights  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402
from repro_torch.serving.engine import EngineFns  # noqa: E402

ARCH = "recurrentgemma-2b"
CONV_TOL = dict(atol=1e-6, rtol=1e-6)      # the same sums in the same order
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)     # fp32 block, state and scan
BF16_TOL = dict(atol=2e-2, rtol=2e-2)      # bf16 block output
BF16_STATE_TOL = dict(atol=1e-2, rtol=1e-2)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)     # fp32 whole-model logits

_jpre = jax.jit(jtfm.prefill, static_argnums=1)
_jdec = jax.jit(jtfm.decode_step, static_argnums=1)
_jfwd = jax.jit(jrglru.rglru_forward, static_argnums=2)
_jstep = jax.jit(jrglru.rglru_decode, static_argnums=3)
_jscan = jax.jit(jrglru.diag_scan)


def _cfgs(**kw):
    """The 8-layer reduced configs, JAX's and the port's."""
    groups = (("R", "R", "L"), 2), (("R", "R"), 1)
    j = jax_reduced(jax_get_config(ARCH)).replace(
        n_layers=8, groups=tuple(JScanGroup(p, r) for p, r in groups), **kw)
    t = reduced(get_config(ARCH)).replace(
        n_layers=8, groups=tuple(ScanGroup(p, r) for p, r in groups), **kw)
    return j, t


def _flat_numpy(params):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(params)[0].items()}


_MODELS = {}


def _model(dtype="float32"):
    """JAX and port configs and weights (norm weights perturbed), made
    once a module per dtype."""
    if dtype not in _MODELS:
        jcfg, tcfg = _cfgs(dtype=dtype, param_dtype=dtype)
        assert not jcfg.use_kernels and tcfg.rms_plus_one
        jparams = jax.jit(lambda k: api.init(k, jcfg)[0])(
            jax.random.PRNGKey(0))
        flat = _flat_numpy(jparams)
        rng = np.random.RandomState(9)
        for k in flat:
            if "norm" in k or "/ln" in k or k.endswith("_b") or \
                    k.endswith("b_a") or k.endswith("b_i"):
                flat[k] = (flat[k].astype(np.float32) + 0.1 *
                           rng.standard_normal(flat[k].shape)
                           ).astype(flat[k].dtype)
        jparams = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jparams),
            [jnp.asarray(flat[k]) for k in _flatten_with_paths(jparams)[0]])
        tparams = weights.params_from_numpy(flat, tcfg, device="cpu")
        _MODELS[dtype] = (jcfg, tcfg, jparams, tparams, flat)
    return _MODELS[dtype]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _mixers(dtype="float32", r=1):
    """Repeat ``r`` of the first RG-LRU layer's mixer, JAX's and the
    port's."""
    jcfg, tcfg, jparams, tparams, _ = _model(dtype)
    jp = jax.tree_util.tree_map(lambda a: a[r], jparams["groups"][0][0])
    tp = ttfm._unstack(tparams["groups"][0][0], tcfg.groups[0].repeats)[r]
    return jcfg, tcfg, jp["mixer"], tp["mixer"]


def test_config_matches_jax():
    """The port's config is the JAX package's, field for field, at full
    width and reduced."""
    full = (jax_get_config(ARCH), get_config(ARCH))
    for j, t in (full, (jax_reduced(full[0]), reduced(full[1]))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    cfg = get_config(ARCH)
    assert cfg.family == "hybrid" and cfg.n_heads // cfg.n_kv_heads == 10
    assert sum(k == "R" for g in cfg.groups for k in g.pattern * g.repeats) \
        == 18


# ----------------------------------------------------------------------
# the recurrence on the scan kernel's route
def _scan_inputs(seed, B, S, w):
    """a in (0, 1) as the gates give it, b small, h0 nonzero; fp32."""
    rng = np.random.RandomState(seed)
    a = 1.0 / (1.0 + np.exp(-rng.randn(B, S, w)))
    b = rng.randn(B, S, w) * 0.1
    h0 = rng.randn(B, w)
    return [x.astype(np.float32) for x in (a, b, h0)]


@pytest.mark.parametrize("S", [1, 3, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_diag_scan_matches_jax(S, with_h0):
    """rglru.diag_scan (the plain route of ops.linear_scan) against JAX's
    chunked associative scan; one plain call counted under ``ssm_scan``,
    no kernel launched."""
    a, b, h0 = _scan_inputs(S, 2, S, 24)
    h0 = h0 if with_h0 else None
    ops.reset_counts()
    hs, hT = rglru.diag_scan(_t(a), _t(b), None if h0 is None else _t(h0))
    assert ops.PLAIN_CALLS["ssm_scan"] == 1 and \
        sum(ops.PLAIN_CALLS.values()) == 1 and \
        set(kernels.LAUNCHES.values()) == {0}
    js, jT = _jscan(a, b, h0)
    assert hs.shape == (2, S, 24) and hT.shape == (2, 24)
    np.testing.assert_allclose(hs.numpy(), _np(js), **BLOCK_TOL)
    np.testing.assert_allclose(hT.numpy(), _np(jT), **BLOCK_TOL)


def test_linear_scan_routes_by_device():
    """The op takes the (B, S, w) recurrence as the scan's (B, S, w, 1):
    a non-contiguous input is made contiguous, the plain route is the
    N = 1 scan exactly, and a device with no route raises."""
    a, b, h0 = map(_t, _scan_inputs(1, 2, 5, 8))
    at = a.transpose(0, 1).contiguous().transpose(0, 1)    # strided view
    hs, hT = ops.linear_scan(at, b, h0)
    ws, wT = kernels.ref.ssm_scan_ref(a[..., None], b[..., None],
                                      h0[..., None])
    assert torch.equal(hs, ws[..., 0]) and torch.equal(hT, wT[..., 0])
    with pytest.raises(ValueError, match="no route for device meta"):
        ops.linear_scan(*(t.to("meta") for t in (a, b, h0)))
    with pytest.raises(ValueError, match="ssm_scan"):
        ops.linear_scan(a.double(), b.double(), h0.double())


# ----------------------------------------------------------------------
# the RG-LRU block
@pytest.mark.parametrize("with_prev", [False, True])
def test_conv1d_causal(with_prev):
    _, tcfg, jp, tp = _mixers()
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, tcfg.lru_width).astype(np.float32)
    prev = rng.randn(2, 3, tcfg.lru_width).astype(np.float32) \
        if with_prev else None
    want = jrglru._conv1d_causal(x, jp["conv_w"], jp["conv_b"], prev=prev)
    got = rglru._conv1d_causal(_t(x), tp["conv_w"], tp["conv_b"],
                               prev=None if prev is None else _t(prev))
    np.testing.assert_allclose(got.numpy(), _np(want), **CONV_TOL)


def test_gates():
    _, tcfg, jp, tp = _mixers()
    xc = np.random.RandomState(2).randn(2, 7, tcfg.lru_width).astype(
        np.float32)
    ja, jg = jrglru._gates(jp, xc)
    ta, tg = rglru._gates(tp, _t(xc))
    assert ta.dtype == tg.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), _np(ja), **BLOCK_TOL)
    np.testing.assert_allclose(tg.numpy(), _np(jg), **BLOCK_TOL)


def _state(seed, tcfg, B):
    rng = np.random.RandomState(seed)
    return {"conv": rng.randn(B, tcfg.conv_k_rg - 1, tcfg.lru_width)
            .astype(np.float32),
            "h": rng.randn(B, tcfg.lru_width).astype(np.float32)}


def _check_block(jout, tout, tol, state_tol):
    (jy, js), (ty, ts) = jout, tout
    assert ts["conv"].dtype == ts["h"].dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)
    for k in ("conv", "h"):
        assert tuple(ts[k].shape) == tuple(js[k].shape)
        np.testing.assert_allclose(ts[k].numpy(), _np(js[k]), **state_tol)


@pytest.mark.parametrize("S", [1, 2, 3, 17, 300])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_forward(S, with_state, dtype):
    """The block's output, conv state and h against JAX's: S < K-1 takes
    the padded or state-extended conv state, S = 300 crosses JAX's
    256-step scan chunk."""
    jcfg, tcfg, jp, tp = _mixers(dtype)
    x = np.random.RandomState(S).randn(2, S, tcfg.d_model).astype(
        np.float32)
    st = _state(S + 1, tcfg, 2) if with_state else None
    xj = jnp.asarray(x).astype(jcfg.act_dtype)
    xt = _t(x).to(tcfg.act_dtype)
    jout = _jfwd(jp, xj, jcfg, st)
    tout = rglru.rglru_forward(tp, xt, tcfg,
                               None if st is None else
                               {k: _t(v) for k, v in st.items()})
    assert tout[0].dtype == tcfg.act_dtype
    if dtype == "float32":
        _check_block(jout, tout, BLOCK_TOL, BLOCK_TOL)
    else:
        _check_block(jout, tout, BF16_TOL, BF16_STATE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_steps(dtype):
    """Five decode steps chained from a prefill's state, against JAX's;
    the step runs no scan (no kernel, no plain call)."""
    jcfg, tcfg, jp, tp = _mixers(dtype)
    rng = np.random.RandomState(4)
    x = rng.randn(3, 6, tcfg.d_model).astype(np.float32)
    cast_j = lambda a: jnp.asarray(a).astype(jcfg.act_dtype)  # noqa: E731
    cast_t = lambda a: _t(a).to(tcfg.act_dtype)               # noqa: E731
    _, js = _jfwd(jp, cast_j(x), jcfg, None)
    _, ts = rglru.rglru_forward(tp, cast_t(x), tcfg)
    tol, stol = (BLOCK_TOL, BLOCK_TOL) if dtype == "float32" else \
        (BF16_TOL, BF16_STATE_TOL)
    for _ in range(5):
        step = rng.randn(3, 1, tcfg.d_model).astype(np.float32)
        ops.reset_counts()
        jout = _jstep(jp, cast_j(step), js, jcfg)
        tout = rglru.rglru_decode(tp, cast_t(step), ts, tcfg)
        assert not any(ops.PLAIN_CALLS.values())
        _check_block(jout, tout, tol, stol)
        js, ts = jout[1], tout[1]


def test_init_rglru_state():
    _, tcfg, _, _, _ = _model()
    st = rglru.init_rglru_state(tcfg, 3, "cpu")
    assert st["conv"].shape == (3, tcfg.conv_k_rg - 1, tcfg.lru_width)
    assert st["h"].shape == (3, tcfg.lru_width)
    assert st["conv"].dtype == st["h"].dtype == torch.float32
    assert not st["conv"].any() and not st["h"].any()
    bf = tcfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    assert {t.dtype for t in rglru.init_rglru_state(bf, 1, "cpu").values()} \
        == {torch.float32}


# ----------------------------------------------------------------------
# weights
def _abstract(cfg):
    abstract = jax.eval_shape(lambda k: api.init(k, cfg)[0],
                              jax.random.PRNGKey(0))
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flatten_with_paths(abstract)[0].items()}


def _spec_shapes(cfg):
    return {k: (weights._full_shape(s),
                str(weights.spec_dtype(s, cfg)).split(".")[1])
            for k, s in weights.param_specs(cfg).items()}


def test_param_specs_match_the_jax_tree_at_full_width():
    """Keys, shapes and dtypes of every leaf of the full-width bf16 tree,
    ``lambda`` fp32 among bf16 leaves, checked without allocating it."""
    got = _spec_shapes(get_config(ARCH))
    assert got == _abstract(jax_get_config(ARCH))
    assert got["groups/0/0/mixer/lambda"] == ((8, 2560), "float32")
    assert got["groups/1/1/mixer/w_a"] == ((1, 2560, 2560), "bfloat16")
    assert got["groups/0/2/mixer/wk"] == ((8, 2560, 256), "bfloat16")
    assert "lm_head" not in got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_draws_the_jax_tree(dtype):
    """The seeded init: JAX's keys, shapes and dtypes; ``lambda`` fp32 in
    a bf16 tree and equal to JAX's; the weights N(0, 1/fan_in), conv_w at
    std 0.5, the biases and the ``(1 + w)`` norms zero."""
    jcfg, tcfg = _cfgs(dtype=dtype, param_dtype=dtype)
    p = weights.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    flat = {}

    def walk(node, pre):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{pre}/{k}" if pre else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{pre}/{i}")
        else:
            flat[pre] = (tuple(node.shape), str(node.dtype).split(".")[1])
    walk(p, "")
    assert flat == _abstract(jcfg)
    mixer = p["groups"][0][0]["mixer"]
    jlam = _model()[4]["groups/0/0/mixer/lambda"]
    assert mixer["lambda"].dtype == torch.float32
    np.testing.assert_allclose(mixer["lambda"].numpy(), jlam, atol=1.2e-7,
                               rtol=0)
    w = mixer["w_a"].float()
    assert abs(w.std().item() * np.sqrt(tcfg.lru_width) - 1.0) < 0.05
    assert abs(mixer["conv_w"].float().std().item() / 0.5 - 1.0) < 0.15
    for k in ("conv_b", "b_a", "b_i"):
        assert not mixer[k].any()
    layer = p["groups"][1][1]
    assert not layer["ln1"]["w"].any() and not layer["ln2"]["w"].any()


def test_params_from_numpy_and_checkpoint_keep_lambda_fp32(tmp_path):
    """Under a bf16 config every mixer leaf is bf16 except ``lambda``,
    fp32 as the JAX init leaves it; a Checkpointer-style ``arrays.npz``
    reads back the same, bit for bit."""
    _, tcfg, _, _, flat = _model("bfloat16")
    assert flat["groups/0/0/mixer/lambda"].dtype == np.float32
    np.savez(tmp_path / "arrays.npz", **flat)
    for port in (weights.params_from_numpy(flat, tcfg, "cpu"),
                 weights.load_checkpoint(str(tmp_path), tcfg, "cpu")):
        mixer = port["groups"][0][0]["mixer"]
        assert mixer["lambda"].dtype == torch.float32
        assert {v.dtype for k, v in mixer.items() if k != "lambda"} == \
            {torch.bfloat16}
        np.testing.assert_array_equal(mixer["lambda"].numpy(),
                                      flat["groups/0/0/mixer/lambda"])
        np.testing.assert_array_equal(
            mixer["w_i"].float().numpy(),
            flat["groups/0/0/mixer/w_i"].astype(np.float32))


# ----------------------------------------------------------------------
# the hybrid model: layers, caches and logits
def test_caches_and_layer_kinds():
    """RG-LRU state for kind R, rings for kind L at max_len 40 (window
    16), none at max_len 16; the family cannot page, and kind R refuses
    the extend mode."""
    _, tcfg, _, tparams, _ = _model()
    caches = ttfm.init_caches(tcfg, 2, 40, "cpu")
    for g, group in zip(tcfg.groups, caches):
        for kind, c in zip(g.pattern, group):
            if kind == "R":
                assert set(c) == {"conv", "h"}
                assert c["conv"].shape == (g.repeats, 2, 3, tcfg.lru_width)
                assert c["h"].shape == (g.repeats, 2, tcfg.lru_width)
            else:
                assert set(c) == {"k", "v", "pos"}
                assert c["k"].shape == (g.repeats, 2, 16, 1, 16)
    plain = ttfm.init_caches(tcfg, 2, 16, "cpu")
    assert "pos" not in plain[0][2]
    assert not ttfm.paged_supported(tcfg, 16)
    layer = ttfm._unstack(tparams["groups"][0][0], tcfg.groups[0].repeats)[0]
    with pytest.raises(NotImplementedError, match="RG-LRU"):
        ttfm.apply_layer(layer, torch.zeros(1, 2, tcfg.d_model), tcfg, "R",
                         "extend", rglru.init_rglru_state(tcfg, 1, "cpu"),
                         torch.zeros(1, dtype=torch.int32))


def test_r_layer_runs_its_mlp():
    """Unlike kind S, a kind-R layer adds the MLP after the mixer: the
    layer's output equals x + mix + mlp(ln2(x + mix))."""
    _, tcfg, _, tparams, _ = _model()
    layer = ttfm._unstack(tparams["groups"][0][0], tcfg.groups[0].repeats)[0]
    x = _t(np.random.RandomState(3).randn(1, 5, tcfg.d_model).astype(
        np.float32))
    out, _, _ = ttfm.apply_layer(layer, x, tcfg, "R", "prefill",
                                 rglru.init_rglru_state(tcfg, 1, "cpu"),
                                 None)
    mix, _ = rglru.rglru_forward(layer["mixer"],
                                 ttfm.apply_norm(layer["ln1"], x, tcfg), tcfg)
    x1 = x + mix
    from repro_torch.models.layers import apply_mlp
    want = x1 + apply_mlp(layer["ffn"], ttfm.apply_norm(layer["ln2"], x1,
                                                        tcfg), tcfg)
    assert torch.equal(out, want)


def _jax_row(jcfg, jparams, prompt, steps, L):
    """One sequence through JAX on a fresh cache of ``L`` rows: the
    prefill's logits and cache, then each decode step's."""
    jc = api.init_caches(jcfg, 1, L)
    lj, jc = _jpre(jparams, jcfg, jnp.asarray(prompt[None]), jc)
    out = [(np.asarray(lj)[0], jc)]
    for i, tok in enumerate(steps):
        pos = jnp.asarray([len(prompt) + i], jnp.int32)
        lj, jc = _jdec(jparams, jcfg, jnp.asarray([[tok]], jnp.int32), jc,
                       pos)
        out.append((np.asarray(lj)[0], jc))
    return out


def _leaves_at(caches, row):
    """Every leaf of a cache tree at batch ``row``, in tree order, as
    numpy copies: the port's (repeats, B, ...) or JAX's."""
    return [(k, np.array(c[k])[:, row]) for group in caches for c in group
            for k in sorted(c)]


def _assert_caches_equal(got, jax_caches):
    want = _leaves_at(jax_caches, 0)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, t), (_, j) in zip(got, want):
        if k == "pos":
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, **BLOCK_TOL)


def test_logits_through_a_ring_wrap_and_a_reused_slot():
    """Two slots over ``max_len`` 40 (the rings keep 16 rows): slot 0
    admits a 30-token prompt (the rings wrap in the prefill, the scan runs
    30 steps) and decodes 6 steps; slot 1 a 9-token prompt.  Then slot 0
    is admitted a 2-token prompt (shorter than the conv's K-1 = 3: its
    conv state is padded on the left), as the engine reuses a slot, and
    both decode 14 steps, slot 1 past its window.  Each step's logits
    equal JAX's for the same sequence on a fresh cache, and so does every
    cache leaf (RG-LRU state, ring K/V and positions) right after the
    reused slot's admit and at the end."""
    jcfg, tcfg, jparams, tparams, _ = _model()
    L, rng = 40, np.random.RandomState(4)
    fns = EngineFns(tcfg, ServeConfig(max_len=L))
    caches = ttfm.init_caches(tcfg, 2, L, "cpu")

    def admit(slot, prompt):
        small = ttfm.init_caches(tcfg, 1, len(prompt), "cpu")
        logits, small = ttfm.prefill(tparams, tcfg, _t(prompt[None]), small)
        fns.insert_rows(caches, small, [slot])
        return logits.numpy()[0]

    def decode(seqs, pos, n):
        got = [[], []]
        for _ in range(n):
            tok = rng.randint(0, tcfg.vocab, size=(2, 1)).astype(np.int32)
            lt, _ = ttfm.decode_step(tparams, tcfg, _t(tok), caches, _t(pos))
            for r in range(2):
                seqs[r].append(int(tok[r, 0]))
                got[r].append(lt.numpy()[r])
            pos += 1
        return got

    long_p, mid_p, short_p = (rng.randint(0, tcfg.vocab, n).astype(np.int32)
                              for n in (30, 9, 2))
    first = [admit(0, long_p), admit(1, mid_p)]
    seqs = [[], []]
    got = decode(seqs, np.array([30, 9], np.int32), 6)
    want = _jax_row(jcfg, jparams, long_p, seqs[0], L)
    np.testing.assert_allclose(first[0], want[0][0], **LOGIT_TOL)
    for i, lg in enumerate(got[0]):
        np.testing.assert_allclose(lg, want[i + 1][0], **LOGIT_TOL)
    again = admit(0, short_p)
    admitted = _leaves_at(caches, 0)            # before any decode step
    seqs = [[], seqs[1]]
    got_b = decode(seqs, np.array([2, 15], np.int32), 14)
    want0 = _jax_row(jcfg, jparams, short_p, seqs[0], L)
    want1 = _jax_row(jcfg, jparams, mid_p, seqs[1], L)
    np.testing.assert_allclose(again, want0[0][0], **LOGIT_TOL)
    _assert_caches_equal(admitted, want0[0][1])
    for i, lg in enumerate(got_b[0]):
        np.testing.assert_allclose(lg, want0[i + 1][0], **LOGIT_TOL)
    for i, lg in enumerate(got[1] + got_b[1]):
        np.testing.assert_allclose(lg, want1[i + 1][0], **LOGIT_TOL)
    for r, jc in ((0, want0[-1][1]), (1, want1[-1][1])):
        _assert_caches_equal(_leaves_at(caches, r), jc)


# ----------------------------------------------------------------------
# engines: greedy decode token-exact against the JAX engine
_ENGINES = {
    "dense-fused": dict(fused=True),
    "reference": dict(fused=False),
    "paged": dict(fused=True, paged=True, block_size=8),
}


@pytest.mark.parametrize("kind", list(_ENGINES))
def test_engine_greedy_tokens_exact(kind):
    """Prompts of 1, 2, 3 and past the 16-key window (same lengths
    adjacent, so the exact-length admits batch them), 10 new tokens each,
    through 2 slots at max_len 48: later requests reuse the slots of
    longer ones.  Tokens and finish reasons equal the JAX engine's, and
    so do the admit batches; asked for the paged engine, both serve
    dense and count the fallback once."""
    jcfg, tcfg, jparams, tparams, _ = _model()
    kw = dict(max_len=48, slots=2, sync_every=4, **_ENGINES[kind])
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, tcfg.vocab, n).astype(np.int32)
               for n in (20, 20, 1, 2, 3, 3, 25, 1)]
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
    teng = Engine(tparams, tcfg, ServeConfig(**kw), device="cpu")
    jreqs = [jeng.submit(p, max_new=10) for p in prompts]
    treqs = [teng.submit(p, max_new=10) for p in prompts]
    jeng.run_until_drained()
    teng.run_until_drained()
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert b.out_tokens == a.out_tokens, i
        assert b.finish_reason == a.finish_reason, i
    assert {r.finish_reason for r in treqs} == {"max_new"}
    batches = "engine.prefill_batches"
    assert teng.metrics.counter(batches).value == \
        jeng.metrics.counter(batches).value
    fb = "engine.paged_fallback_dense"
    assert not teng.paged and not jeng.paged
    assert teng.metrics.counter(fb).value == jeng.metrics.counter(fb).value \
        == (1 if kind == "paged" else 0)


def test_engine_speculative_falls_back_like_gemma3():
    """``speculative=True`` on a family that cannot page: the engine
    serves dense, counts the paged fallback and the speculative one, and
    gives the dense engine's tokens."""
    _, tcfg, _, tparams, _ = _model()
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, tcfg.vocab, n).astype(np.int32)
               for n in (5, 5, 18)]
    out = []
    for extra in ({}, dict(paged=True, block_size=8, speculative=True)):
        eng = Engine(tparams, tcfg, ServeConfig(max_len=48, slots=2,
                                                sync_every=4, **extra),
                     device="cpu")
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run_until_drained()
        out.append([r.out_tokens for r in reqs])
    assert out[0] == out[1]
    assert not eng.paged and not eng.speculative
    assert eng.metrics.counter("engine.paged_fallback_dense").value == 1
    assert eng.metrics.counter("engine.spec_fallback").value == 1


@pytest.mark.parametrize("extra", [
    [], ["--paged"],
    ["--replicas", "2", "--transport", "process"],   # Router replicas
])
def test_serve_driver_serves_recurrentgemma(extra):
    out = io.StringIO()
    with redirect_stdout(out):
        serve.main(["--device", "cpu", "--reduce", "--arch", ARCH,
                    "--requests", "3", "--max-new", "4", "--slots", "2",
                    "--max-len", "32", *extra])
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith(f"[serve] arch={ARCH}") and "kv=dense" in line
    assert "tokens=15" in line
