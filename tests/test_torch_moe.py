"""The MoE family in the port against the JAX package: ``apply_moe``, the
kind-``M`` layer's weights, the model's logits and greedy decode through
the reference, dense fused and paged engines of qwen3-moe-30b-a3b; and
internvl2-1b's token path through the dense and paged engines.

Both sides run ``reduced()`` configs made two layers deep (``R = 2``
exercises the stacked ``(repeats, ...)`` layout) in fp32; reduced qwen3 has
8 experts, top-2, expert d_ff 32 and qk-norm.  The JAX weights are carried
over with ``params_from_numpy``; the port runs on the CPU, where its
attention takes the plain versions, and the JAX side runs its plain path
(``use_kernels=False``).  Tolerances: ``apply_moe`` ``atol = rtol = 1e-5``
in fp32 (the same arithmetic in another library; only the order of the
combine's k-term sums differs) and tests/test_kernels.py:16's bf16 rule
(``atol = rtol = 3e-2``) in bf16, the absolute limit raised to one bf16
ulp of the largest output where that is larger (the k-term sums round
once in the port, after each add in JAX); whole-model logits ``atol = rtol =
1e-4`` (fp32, tests/test_kernels.py:16); tokens and finish reasons must
be equal.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes: one thread is faster and leaves
                           # the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import (Checkpointer,  # noqa: E402
                                           _flatten_with_paths)
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ScanGroup as JScanGroup  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.cluster import tracing  # noqa: E402
from repro_torch.cluster.backends import checkpoint_step_dir  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, moe, weights  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
MOE_TOL = dict(atol=1e-5, rtol=1e-5)        # fp32 apply_moe
BF16_TOL = dict(atol=3e-2, rtol=3e-2)       # tests/test_kernels.py:16
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)      # fp32 whole-model logits

_jext = jax.jit(jtfm.extend_paged, static_argnums=1)
_jdec = jax.jit(jtfm.decode_step, static_argnums=1)
_jpre = jax.jit(jtfm.prefill, static_argnums=1)
_jmoe = jax.jit(jmoe.apply_moe, static_argnums=2)


def _cfgs(arch=ARCH):
    kind = jax_get_config(arch).groups[0].pattern
    j = jax_reduced(jax_get_config(arch)).replace(
        n_layers=2, groups=(JScanGroup(kind, 2),))
    t = reduced(get_config(arch)).replace(
        n_layers=2, groups=(ScanGroup(kind, 2),))
    return j, t


def _flat_numpy(params):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(params)[0].items()}


def _build(arch):
    jcfg, tcfg = _cfgs(arch)
    assert not jcfg.use_kernels
    jparams = jax.jit(lambda k: api.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    # the JAX init draws unit norm weights: perturb them, so the parity
    # below sees every norm, the q/k norms included
    flat = _flat_numpy(jparams)
    rng = np.random.RandomState(9)
    for k in flat:
        if "norm" in k or "/ln" in k:
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(flat[k].dtype)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams),
        [jnp.asarray(flat[k]) for k in _flatten_with_paths(jparams)[0]])
    tparams = weights.params_from_numpy(flat, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def model():
    return _build(ARCH)


@pytest.fixture(scope="module")
def vlm_model():
    return _build("internvl2-1b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _node(tree, key):
    for part in key.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


# ----------------------------------------------------------------------
# apply_moe against the JAX function on carried-over weights
def _ffn(model, r=0):
    jcfg, tcfg, jparams, tparams = model
    jffn = jax.tree_util.tree_map(lambda a: a[r],
                                  jparams["groups"][0][0]["ffn"])
    tffn = {k: v[r] for k, v in tparams["groups"][0][0]["ffn"].items()}
    return jcfg, tcfg, jffn, tffn


def _collision(jffn, tffn):
    """A router that sends every token's first pick to expert 3 (column 3
    of the router reads feature 0, which every row holds large)."""
    router = np.array(jffn["router"])
    router[:, 3] = 0.0
    router[0, 3] = 1.0
    jffn = dict(jffn, router=jnp.asarray(router))
    tffn = dict(tffn, router=_t(router))
    return jffn, tffn


_MOE_CASES = {
    # (B, S), forced collision, capacity; reduced qwen3 has E 8, k 2
    "T1": ((1, 1), False, 1),
    "T8-cap2": ((2, 4), False, 2),       # T*k = 16 = 2E: int(2 * 1.25)
    "collision-cap1": ((1, 3), True, 1),  # three tokens on expert 3
    "T13-ragged": ((1, 13), False, 3),   # T*k = 26, not a multiple of E
}


@pytest.mark.parametrize("case", list(_MOE_CASES))
def test_apply_moe_matches_jax(model, case):
    (B, S), collide, cap = _MOE_CASES[case]
    jcfg, tcfg, jffn, tffn = _ffn(model, r=1)
    rng = np.random.RandomState(len(case))
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    if collide:
        x[..., 0] = 8.0 + rng.standard_normal((B, S))
        jffn, tffn = _collision(jffn, tffn)
    want, want_aux = _jmoe(jffn, jnp.asarray(x), jcfg)
    got, aux = moe.apply_moe(tffn, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **MOE_TOL)
    T = B * S
    assert moe.capacity(T, tcfg) == cap
    # an independent loop over tokens: an expert takes picks in token
    # order until it holds cap of them
    xf, got = _t(x).reshape(T, -1), got.reshape(T, -1)
    np.testing.assert_allclose(
        got.numpy(), _loop_moe(tffn, xf, tcfg.top_k, cap).numpy(), **MOE_TOL)
    if collide:
        # every token's first pick is expert 3, which keeps the first
        # token's alone, so the capacity changes the other two's output
        top_e = torch.topk(xf @ tffn["router"], tcfg.top_k, dim=-1).indices
        assert (top_e[:, 0] == 3).all()
        full = _loop_moe(tffn, xf, tcfg.top_k, T)
        np.testing.assert_allclose(got[0].numpy(), full[0].numpy(),
                                   **MOE_TOL)
        assert ((full[1:] - got[1:]).abs().amax(-1) > 1e-3).all()


def _loop_moe(ffn, xf, k, cap):
    """Each token's k picks, weighted by their renormalised probabilities,
    an expert taking picks in token order until it holds ``cap``."""
    probs = torch.softmax(xf @ ffn["router"], -1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    held = {}
    for t in range(xf.shape[0]):
        for j in range(k):
            e = int(top_e[t, j])
            held[e] = held.get(e, 0) + 1
            if held[e] > cap:
                continue
            h = torch.nn.functional.silu(xf[t] @ ffn["w_gate"][e]) * \
                (xf[t] @ ffn["w_up"][e])
            out[t] += top_p[t, j] * (h @ ffn["w_down"][e])
    return out


def test_apply_moe_bf16_matches_jax(model):
    """bf16 weights and activations on both sides: the router runs in
    fp32 after a bf16 product, the experts' products in bf16."""
    jcfg, tcfg, jffn, tffn = _ffn(model)
    jcfg = jcfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    tcfg = tcfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 4, tcfg.d_model)).astype(np.float32)
    jffn = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jffn)
    tffn = {k: v.to(torch.bfloat16) for k, v in tffn.items()}
    want, want_aux = _jmoe(jffn, jnp.asarray(x, jnp.bfloat16), jcfg)
    got, aux = moe.apply_moe(tffn, _t(x).to(torch.bfloat16), tcfg)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    # the combine rounds differently: JAX rounds after each of a token's k
    # bf16 adds, the port once after an fp32 sum, so an element that
    # cancels keeps up to one bf16 ulp of the largest output
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=max(BF16_TOL["atol"], ulp),
                               rtol=BF16_TOL["rtol"])
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **BF16_TOL)


def test_qk_norm_over_heads_matches_jax():
    """qk-norm is ``rms_norm`` over the last axis of (B, S, H, hd), with
    no ``plus_one`` (``layers.py:31-39``)."""
    rng = np.random.RandomState(4)
    x = (rng.standard_normal((2, 5, 4, 16)) * 3).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = layers.rms_norm(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


# ----------------------------------------------------------------------
# weights
def test_params_from_numpy_carries_the_moe_tree(model):
    """Every leaf of the JAX tree is in the port's specs and the reverse:
    the router, the stacked experts and the q/k norms."""
    jcfg, tcfg, jparams, tparams = model
    flat = _flat_numpy(jparams)
    specs = weights.param_specs(tcfg)
    assert sorted(flat) == sorted(specs)
    E, d, f = tcfg.n_experts, tcfg.d_model, tcfg.expert_d_ff
    shapes = {"mixer/q_norm": (2, 16), "mixer/k_norm": (2, 16),
              "ffn/router": (2, d, E), "ffn/w_gate": (2, E, d, f),
              "ffn/w_up": (2, E, d, f), "ffn/w_down": (2, E, f, d)}
    for leaf, shape in shapes.items():
        assert weights._full_shape(specs[f"groups/0/0/{leaf}"]) == shape
    for key, arr in flat.items():
        np.testing.assert_array_equal(_node(tparams, key).numpy(), arr)


def test_full_width_specs_match_jax():
    """The full-width qwen3 tree, shapes checked without allocating: 30.53
    B parameters."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    abstract = jax.eval_shape(lambda k: api.init(k, jcfg)[0],
                              jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in _flatten_with_paths(abstract)[0].items()}
    specs = weights.param_specs(tcfg)
    got = {k: weights._full_shape(s) for k, s in specs.items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 30_532_122_624


def test_init_params_draws_router_experts_and_norms_as_jax(model):
    """The router N(0, 0.02^2); an expert leaf N(0, 1/E), since JAX's
    ``dense_init`` takes its first axis, E, as the fan-in; norms ones."""
    _, tcfg, _, _ = model
    p = weights.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    layer = p["groups"][0][0]
    assert abs(layer["ffn"]["router"].std().item() / 0.02 - 1.0) < 0.05
    E = tcfg.n_experts
    for key in ("w_gate", "w_up", "w_down"):
        w = layer["ffn"][key]
        assert abs(w.std().item() * np.sqrt(E) - 1.0) < 0.05, key
    for key in ("q_norm", "k_norm"):
        assert torch.equal(layer["mixer"][key],
                           torch.ones(2, tcfg.head_dim))
    for norm in (p["final_norm"], layer["ln1"], layer["ln2"]):
        assert torch.equal(norm["w"], torch.ones_like(norm["w"]))


def test_load_checkpoint_is_exact(model, tmp_path):
    jcfg, tcfg, jparams, tparams = model
    Checkpointer(str(tmp_path)).save(3, jparams)
    got = weights.load_checkpoint(checkpoint_step_dir(str(tmp_path)), tcfg,
                                  "cpu")
    for key in _flat_numpy(jparams):
        assert torch.equal(_node(got, key), _node(tparams, key)), key


def test_mla_and_shared_experts_still_raise():
    """MLA and shared experts are in the port since deepseek-v2-lite
    (tests/test_torch_mla.py), and the encoder-decoder family since
    whisper-base (tests/test_torch_encdec.py); what still raises is the
    Engine on the encoder-decoder family, with JAX's reason (the
    family's weights are in the port).  The encoder's and decoder's
    ``bidir`` and ``cross`` attention kinds with an attention softcap,
    which raised until item 6 was done, now compute JAX's capped
    attention (its ``mha``), which the uncapped result misses."""
    from repro_torch.configs import ArchConfig
    from repro_torch.models import attention as attn
    whisper = ArchConfig(
        name="whisper-base", family="encdec", n_layers=2, enc_layers=1,
        dec_layers=1, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, rope_base=0.0, mlp="gelu_mlp",
        norm="layernorm", norm_eps=1e-5, dtype="float32",
        param_dtype="float32")
    assert "dec/cross/wq" in weights.param_specs(whisper)
    with pytest.raises(NotImplementedError,
                       match="^Engine serves decoder-LM families$"):
        Engine({}, whisper, ServeConfig(max_len=8), device="cpu")
    from repro.models import attention as jattn
    cfg = reduced(get_config(ARCH)).replace(attn_softcap=1.0)
    jcfg = jax_reduced(jax_get_config(ARCH)).replace(attn_softcap=1.0)
    rng = np.random.RandomState(21)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (d, H * hd)), ("wk", (d, KV * hd)),
                      ("wv", (d, KV * hd)), ("wo", (H * hd, d)))}
    if cfg.qk_norm:
        p.update({k: (1 + 0.1 * rng.randn(hd)).astype(np.float32)
                  for k in ("q_norm", "k_norm")})
    x = rng.randn(1, 4, d).astype(np.float32)
    enc = rng.randn(1, 6, d).astype(np.float32)
    for kind in ("bidir", "cross"):
        want = np.asarray(jattn.attn_forward(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
            kind=kind, encoder_kv=jnp.asarray(enc)))
        got, uncapped = (attn.attn_forward(
            {k: _t(v) for k, v in p.items()}, _t(x), c, kind=kind,
            encoder_kv=_t(enc)).numpy()
            for c in (cfg, cfg.replace(attn_softcap=0.0)))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        assert np.abs(uncapped - want).max() > 1e-3


# ----------------------------------------------------------------------
# model logits
@pytest.mark.parametrize("arch", [ARCH, "internvl2-1b"])
def test_prefill_and_dense_decode_logits(model, vlm_model, arch):
    jcfg, tcfg, jparams, tparams = model if arch == ARCH else vlm_model
    rng = np.random.RandomState(3)
    B, S, L = 2, 8, 16
    toks = rng.randint(0, tcfg.vocab, size=(B, S)).astype(np.int32)
    last = np.array([7, 4], np.int32)
    jc = api.init_caches(jcfg, B, L)
    tc = ttfm.init_caches(tcfg, B, L, "cpu")
    lj, jc = _jpre(jparams, jcfg, jnp.asarray(toks), jc,
                   last_index=jnp.asarray(last))
    lt, tc = ttfm.prefill(tparams, tcfg, _t(toks), tc, last_index=_t(last))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for pos in ([8, 5], [9, 6]):
        tok = rng.randint(0, tcfg.vocab, size=(B, 1)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        lj, jc = _jdec(jparams, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos))
        lt, tc = ttfm.decode_step(tparams, tcfg, _t(tok), tc, _t(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)


@pytest.mark.parametrize("arch", [ARCH, "internvl2-1b"])
def test_extend_and_paged_decode_logits(model, vlm_model, arch):
    jcfg, tcfg, jparams, tparams = model if arch == ARCH else vlm_model
    rng = np.random.RandomState(0)
    n_blocks, bs = 8, 8
    bt = np.array([[1, 3, 5, 7], [2, 4, 6, 8]], np.int32)
    jc = jtfm.init_paged_caches(jcfg, n_blocks, bs)
    tc = ttfm.init_paged_caches(tcfg, n_blocks, bs, "cpu")
    toks = rng.randint(0, tcfg.vocab, size=(2, 8)).astype(np.int32)
    pos0, last = np.array([0, 0], np.int32), np.array([7, 4], np.int32)
    lj, jc = _jext(jparams, jcfg, jnp.asarray(toks), jc, jnp.asarray(pos0),
                   jnp.asarray(bt), jnp.asarray(last))
    lt, tc = ttfm.extend_paged(tparams, tcfg, _t(toks), tc, _t(pos0), _t(bt),
                               _t(last))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for pos in ([8, 5], [9, 6]):
        tok = rng.randint(0, tcfg.vocab, size=(2, 1)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        lj, jc = _jdec(jparams, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos),
                       bt=jnp.asarray(bt))
        lt, tc = ttfm.decode_step(tparams, tcfg, _t(tok), tc, _t(pos),
                                  _t(bt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)


# ----------------------------------------------------------------------
# engines: greedy decode token-exact against the JAX engine
_ENGINES = {
    "reference": dict(fused=False),
    "dense-fused": dict(fused=True),
    "paged": dict(fused=True, paged=True, block_size=8),
}


def _serve_both(model, kw, waves, max_new):
    """The same waves of prompts through the JAX engine and the port's,
    each wave drained before the next; returns both request lists, the
    port engine and the ``n`` of every admit it logged."""
    jcfg, tcfg, jparams, tparams = model
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
    teng = Engine(tparams, tcfg, ServeConfig(**kw), device="cpu")
    seq0 = tracing.current_recorder().last_seq
    jreqs, treqs = [], []
    for wave in waves:
        jreqs += [jeng.submit(p, max_new=max_new) for p in wave]
        treqs += [teng.submit(p, max_new=max_new) for p in wave]
        jeng.run_until_drained()
        teng.run_until_drained()
    admits = [e["n"] for e in tracing.current_recorder().events()
              if e["seq"] > seq0 and e["kind"] == "admit"]
    return jreqs, treqs, teng, admits


@pytest.mark.parametrize("sync_every", [4, 1])
@pytest.mark.parametrize("kind", list(_ENGINES))
def test_engine_greedy_tokens_exact(model, kind, sync_every):
    """JAX's ``test_fused_matches_reference_moe`` and
    ``test_paged_matches_dense_with_refill`` settings: 2 slots, 5 prompts
    (slots finish mid-K-loop and refill), then a wave sharing a 16-token
    prefix with the first (prefix hits on the paged engine); tokens,
    finish reasons and prefix hits equal the JAX engine's, and every admit
    is batch-1."""
    kw = dict(max_len=64, slots=2, sync_every=sync_every, **_ENGINES[kind])
    rng = np.random.RandomState(5)
    vocab = model[1].vocab
    common = rng.randint(0, vocab, 16).astype(np.int32)
    waves = [[rng.randint(0, vocab, n).astype(np.int32)
              for n in (5, 9, 7, 12, 6)],
             [np.concatenate([common, rng.randint(0, vocab, n)])
              .astype(np.int32) for n in (3, 9)]]
    waves[0][1] = np.concatenate([common, waves[0][1]])
    jreqs, treqs, teng, admits = _serve_both(model, kw, waves, 6)
    assert teng.paged == (kind == "paged") and teng.fns.row_coupled
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert b.out_tokens == a.out_tokens, i
        assert b.finish_reason == a.finish_reason, i
    assert {r.finish_reason for r in treqs} == {"max_new"}
    if kind != "reference":
        assert admits == [1] * len(treqs)
    hits = teng.metrics.counter("engine.prefix_hit_blocks").value
    assert (hits > 0) == (kind == "paged")


def test_paged_inactive_rows_follow_the_jax_kernel_path(model):
    """A finished slot keeps stepping on token 0 and its row still takes
    expert capacity.  The port's paged engine reads that row's keys
    through the slot's nulled table row, as the JAX paged engine does on
    its kernel path (``use_kernels=True``); the JAX plain path reads the
    finished sequence's stale rows from its resident dense view instead.
    Here request 4 decodes beside a finished slot 0, and the two JAX paths
    part from its fourth token; the port follows the kernel path."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(110)
    prompts = [rng.randint(0, tcfg.vocab, rng.randint(3, 20)).astype(
        np.int32) for _ in range(5)]
    max_new = [int(rng.randint(2, 12)) for _ in prompts]
    kw = dict(max_len=64, slots=2, sync_every=1, paged=True, block_size=8)

    def drain(eng):
        reqs = [eng.submit(p, max_new=m) for p, m in zip(prompts, max_new)]
        eng.run_until_drained()
        return [r.out_tokens for r in reqs]

    port = drain(Engine(tparams, tcfg, ServeConfig(**kw), device="cpu"))
    kernel_path = drain(JEngine(jparams, jcfg.replace(use_kernels=True),
                                JServeConfig(**kw)))
    plain_path = drain(JEngine(jparams, jcfg, JServeConfig(**kw)))
    assert port == kernel_path
    assert port[:4] == plain_path[:4]
    assert port[4][:3] == plain_path[4][:3] and port[4] != plain_path[4]


def test_speculative_falls_back_on_moe(model):
    """JAX's ``test_spec_moe_family_falls_back``: expert capacity couples
    rows, so ``speculative=True`` serves plain paged decode, counted once,
    with the same tokens."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, model[1].vocab, size=6).astype(np.int32)
               for _ in range(2)]
    base = dict(max_len=32, slots=2, sync_every=4, paged=True, block_size=8)
    jplain, plain, _, _ = _serve_both(model, base, [prompts], 5)
    jspec, spec, seng, _ = _serve_both(model, dict(base, speculative=True),
                                       [prompts], 5)
    assert seng.paged and not seng.speculative
    assert seng.metrics.counter("engine.spec_fallback").value == 1
    assert seng.metrics.counter("engine.spec_proposed").value == 0
    for a, b, c in zip(jspec, plain, spec):
        assert c.out_tokens == b.out_tokens == a.out_tokens


@pytest.mark.parametrize("kind", ["dense-fused", "paged"])
def test_internvl2_engine_greedy_tokens_exact(vlm_model, kind):
    """internvl2-1b's decoder on token prompts (G 2 at reduced width, tied,
    padded vocab): batched admits, as for any plain decoder."""
    kw = dict(max_len=64, slots=2, sync_every=4, **_ENGINES[kind])
    rng = np.random.RandomState(6)
    vocab = vlm_model[1].vocab
    prompts = [rng.randint(0, vocab, n).astype(np.int32)
               for n in (5, 9, 7, 12, 6)]
    jreqs, treqs, teng, _ = _serve_both(vlm_model, kw, [prompts], 6)
    assert teng.paged == (kind == "paged") and not teng.fns.row_coupled
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert b.out_tokens == a.out_tokens, i
        assert b.finish_reason == a.finish_reason == "max_new", i


@pytest.mark.parametrize("arch,paged", [(ARCH, True), (ARCH, False),
                                        ("internvl2-1b", True)])
def test_serve_driver_serves(arch, paged):
    out = io.StringIO()
    argv = ["--device", "cpu", "--reduce", "--arch", arch, "--requests", "3",
            "--max-new", "4", "--slots", "2", "--max-len", "32"]
    with redirect_stdout(out):
        serve.main(argv + (["--paged", "--block-size", "8"] if paged else []))
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith(f"[serve] arch={arch}")
    assert f"kv={'paged' if paged else 'dense'}" in line
    assert "tokens=15" in line


def test_build_engine_builds_the_moe_engine():
    """A replica's backend builder takes the arch id like the driver."""
    from repro_torch.cluster.backends import build_engine
    backend = build_engine(arch=ARCH, max_len=32, slots=2, device="cpu")
    eng = backend.engine
    assert eng.cfg.family == "moe" and eng.fns.row_coupled
    assert eng.params["groups"][0][0]["ffn"]["w_gate"].shape == (1, 8, 64, 32)
