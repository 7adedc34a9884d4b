"""gemma-7b and gemma3-4b in the port against the JAX package: the GeGLU
MLP, the weight trees, the models' logits at head dim 16 and 256, gemma3's
local layers' ring caches, and greedy decode through the dense fused,
reference and paged engines.

Both sides run ``reduced()`` configs in fp32: gemma-7b made two layers
deep (``R = 2`` exercises the stacked layout; MHA, GeGLU, ``(1 + w)``
RMSNorm, scaled and tied embeddings), gemma3-4b as reduced() leaves it:
ten layers in two scan groups, ``(L, L, L, L, L, G)`` and ``(L, L, L,
L)``, with window 16, RoPE bases 10k (local) and 1M (global) and qk-norm.
``head_dim=256`` keeps the full models' head dim, so the attention ops run
at hd 256 (on the CPU their plain versions; the kernels are held to those
on the card by ``chip_smoke.py``).  The JAX weights are carried over with
``params_from_numpy``, norm weights perturbed so that ``1 + w`` differs
from 1; the JAX side runs its plain path (``use_kernels=False``).
Tolerances: the MLP ``atol = rtol = 1e-6`` (fp32, the same arithmetic in
another library); whole-model logits ``atol = rtol = 1e-4`` (fp32,
tests/test_kernels.py:16); the ring's cached K/V ``atol = rtol = 1e-5``
and its positions exactly; tokens and finish reasons must be equal.
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

from repro.checkpoint.checkpointer import _flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ScanGroup as JScanGroup  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers, weights  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402
from repro_torch.serving.engine import EngineFns  # noqa: E402

LAYER_TOL = dict(atol=1e-6, rtol=1e-6)     # fp32 layers
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)     # fp32 whole-model logits
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)     # fp32 cached K/V

_jdec = jax.jit(jtfm.decode_step, static_argnums=1)
_jpre = jax.jit(jtfm.prefill, static_argnums=1)
_jext = jax.jit(jtfm.extend_paged, static_argnums=1)


def _cfgs(arch, head_dim=16):
    j, t = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    if arch == "gemma-7b":
        j = j.replace(n_layers=2, groups=(JScanGroup(("A",), 2),))
        t = t.replace(n_layers=2, groups=(ScanGroup(("A",), 2),))
    return j.replace(head_dim=head_dim), t.replace(head_dim=head_dim)


def _flat_numpy(params):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(params)[0].items()}


_MODELS = {}


def _model(arch, head_dim=16):
    """The JAX and port configs and weights of ``arch`` (norm weights,
    zero at init under ``rms_plus_one``, perturbed), made once a module."""
    key = (arch, head_dim)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, head_dim)
        assert not jcfg.use_kernels and tcfg.rms_plus_one
        jparams = jax.jit(lambda k: api.init(k, jcfg)[0])(
            jax.random.PRNGKey(0))
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
        _MODELS[key] = (jcfg, tcfg, jparams, tparams, flat)
    return _MODELS[key]


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# GeGLU and the weight trees
def test_geglu_matches_jax():
    """The gate through the tanh GELU times the up projection; the exact
    erf GELU would be ~1e-4 off or more, past the limit."""
    jcfg, tcfg, jparams, tparams, _ = _model("gemma-7b")
    assert tcfg.mlp == "geglu"
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    jffn = jax.tree_util.tree_map(lambda a: a[0],
                                  jparams["groups"][0][0]["ffn"])
    tffn = {k: v[0] for k, v in tparams["groups"][0][0]["ffn"].items()}
    assert sorted(tffn) == ["w_down", "w_gate", "w_up"]
    want = np.asarray(jlayers.apply_mlp(jffn, jnp.asarray(x), jcfg))
    got = layers.apply_mlp(tffn, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)
    xt = _t(x)
    erf = (torch.nn.functional.gelu(xt @ tffn["w_gate"]) *
           (xt @ tffn["w_up"])) @ tffn["w_down"]
    assert np.abs(erf.numpy() - want).max() > 1e-5
    silu = layers.apply_mlp(tffn, xt, tcfg.replace(mlp="swiglu"))
    assert np.abs(silu.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("arch", ["gemma-7b", "gemma3-4b"])
def test_params_from_numpy_carries_the_jax_tree(arch):
    """Every leaf of the JAX tree is in the port's specs and the reverse,
    in the stacked layout; gemma3's kinds L and G carry qk-norm."""
    jcfg, tcfg, jparams, tparams, flat = _model(arch)
    specs = weights.param_specs(tcfg)
    assert sorted(flat) == sorted(specs)
    assert "lm_head" not in specs                  # tied embeddings
    if arch == "gemma3-4b":
        assert "groups/0/5/mixer/q_norm" in specs          # a G layer
        assert "groups/1/3/mixer/k_norm" in specs          # an L layer
    for key, arr in flat.items():
        node = tparams
        for part in key.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        assert tuple(node.shape) == arr.shape
        np.testing.assert_array_equal(node.numpy(), arr)


@pytest.mark.parametrize("arch", ["gemma-7b", "gemma3-4b"])
def test_init_params_draws_the_gemma_trees(arch):
    """The port's seeded init: the ``(1 + w)`` norms zero, qk-norm ones,
    as the JAX init draws them; the weights N(0, 1/fan_in)."""
    _, tcfg, _, _, _ = _model(arch)
    p = weights.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    layer = p["groups"][0][0]
    for norm in (p["final_norm"], layer["ln1"], layer["ln2"]):
        assert torch.equal(norm["w"], torch.zeros_like(norm["w"]))
    if tcfg.qk_norm:
        for k in ("q_norm", "k_norm"):
            assert torch.equal(layer["mixer"][k],
                               torch.ones_like(layer["mixer"][k]))
    w = layer["ffn"]["w_gate"]
    assert w.shape[-2:] == (tcfg.d_model, tcfg.d_ff)
    assert abs(w.std().item() * np.sqrt(tcfg.d_model) - 1.0) < 0.05


# ----------------------------------------------------------------------
# model logits
@pytest.mark.parametrize("head_dim", [16, 256])
@pytest.mark.parametrize("arch", ["gemma-7b", "gemma3-4b"])
def test_prefill_and_dense_decode_logits(arch, head_dim):
    """A right-padded prefill, then decode steps; for gemma3 the prompt
    (23 tokens) passes the window and the decode wraps the rings again."""
    jcfg, tcfg, jparams, tparams, _ = _model(arch, head_dim)
    rng = np.random.RandomState(3)
    B, S, L = 2, 23, 48
    toks = rng.randint(0, tcfg.vocab, size=(B, S)).astype(np.int32)
    jc = api.init_caches(jcfg, B, L)
    tc = ttfm.init_caches(tcfg, B, L, "cpu")
    lj, jc = _jpre(jparams, jcfg, jnp.asarray(toks), jc)
    lt, tc = ttfm.prefill(tparams, tcfg, _t(toks), tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    pos = np.full(B, S, np.int32)
    for _ in range(6 if head_dim == 256 else 12):
        tok = rng.randint(0, tcfg.vocab, size=(B, 1)).astype(np.int32)
        lj, jc = _jdec(jparams, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos))
        lt, tc = ttfm.decode_step(tparams, tcfg, _t(tok), tc, _t(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        pos += 1


def test_gemma7b_extend_and_paged_decode_logits():
    jcfg, tcfg, jparams, tparams, _ = _model("gemma-7b", 256)
    rng = np.random.RandomState(0)
    bt = np.array([[1, 3, 5, 7], [2, 4, 6, 8]], np.int32)
    jc = jtfm.init_paged_caches(jcfg, 8, 8)
    tc = ttfm.init_paged_caches(tcfg, 8, 8, "cpu")
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
# gemma3's rings
def test_rings_are_made_where_the_window_is_shorter():
    _, tcfg, _, _, _ = _model("gemma3-4b")
    caches = ttfm.init_caches(tcfg, 2, 48, "cpu")
    for g, group in zip(tcfg.groups, caches):
        for kind, c in zip(g.pattern, group):
            assert ("pos" in c) == (kind == "L")
            L = 16 if kind == "L" else 48
            assert c["k"].shape == (g.repeats, 2, L, tcfg.n_kv_heads,
                                    tcfg.head_dim)
            if kind == "L":
                assert c["pos"].shape == (g.repeats, 2, 16)
                assert bool((c["pos"] == -1).all())
    # a window at least the cache's length needs no ring, as in JAX
    plain = ttfm.init_caches(tcfg, 2, 16, "cpu")
    assert not any("pos" in c for group in plain for c in group)
    assert not ttfm.paged_supported(tcfg, 48) and \
        ttfm.paged_supported(tcfg, 16)


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


def _ring_leaves(caches, row):
    """(k, v, pos) of every ring layer of a cache tree at batch ``row``:
    the port's (repeats, B, L, ...) or JAX's, as numpy copies."""
    got = []
    for group in caches:
        for c in group:
            if "pos" in c:
                got.append(tuple(np.array(c[k])[:, row]
                                 for k in ("k", "v", "pos")))
    return got


def _assert_rings_equal(got, jax_caches):
    """The port's ring leaves ``got`` (from :func:`_ring_leaves`) against
    row 0 of a JAX cache tree's: positions exactly, K/V to CACHE_TOL."""
    want = _ring_leaves(jax_caches, 0)
    assert len(got) == len(want) > 0
    for (tk, tv, tp), (jk, jv, jp) in zip(got, want):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_allclose(tk, jk, **CACHE_TOL)
        np.testing.assert_allclose(tv, jv, **CACHE_TOL)


@pytest.mark.parametrize("head_dim", [16, 256])
def test_ring_wraps_and_a_reused_slot_matches_jax(head_dim):
    """Two slots over ``L = 40`` rows: slot 0 admits a 30-token prompt
    (the rings wrap in the prefill) and decodes 6 steps (they wrap again);
    slot 1 a 9-token prompt.  Then slot 0 is admitted a 5-token prompt,
    as the engine reuses a slot, and both decode 14 steps, slot 0 past
    its window.  Each step's logits equal JAX's for the same sequence on
    a fresh cache (JAX's ring mask: ``pos >= 0``, ``> pos - window``,
    ``<= pos``), and so do the rings' K/V and positions, right after the
    reused slot's admit and at the end."""
    jcfg, tcfg, jparams, tparams, _ = _model("gemma3-4b", head_dim)
    L, rng = 40, np.random.RandomState(4)
    fns = EngineFns(tcfg, ServeConfig(max_len=L))
    caches = ttfm.init_caches(tcfg, 2, L, "cpu")

    def admit(slot, prompt):
        small = ttfm.init_caches(tcfg, 1, len(prompt), "cpu")
        logits, small = ttfm.prefill(tparams, tcfg, _t(prompt[None]), small)
        fns.insert_rows(caches, small, [slot])
        return logits.numpy()[0]

    def decode(seqs, pos, n):
        """n steps of both rows; returns each row's logits per step."""
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
                              for n in (30, 9, 5))
    first = [admit(0, long_p), admit(1, mid_p)]
    seqs = [[], []]
    got = decode(seqs, np.array([30, 9], np.int32), 6)
    want = _jax_row(jcfg, jparams, long_p, seqs[0], L)
    np.testing.assert_allclose(first[0], want[0][0], **LOGIT_TOL)
    for i, lg in enumerate(got[0]):
        np.testing.assert_allclose(lg, want[i + 1][0], **LOGIT_TOL)
    # the reused slot: a shorter prompt where a longer sequence wrapped
    again = admit(0, short_p)
    admitted = _ring_leaves(caches, 0)          # before any decode step
    seqs = [[], seqs[1]]
    got_b = decode(seqs, np.array([5, 15], np.int32), 14)
    want0 = _jax_row(jcfg, jparams, short_p, seqs[0], L)
    want1 = _jax_row(jcfg, jparams, mid_p, seqs[1], L)
    np.testing.assert_allclose(again, want0[0][0], **LOGIT_TOL)
    _assert_rings_equal(admitted, want0[0][1])
    for i, lg in enumerate(got_b[0]):
        np.testing.assert_allclose(lg, want0[i + 1][0], **LOGIT_TOL)
    for i, lg in enumerate(got[1] + got_b[1]):
        np.testing.assert_allclose(lg, want1[i + 1][0], **LOGIT_TOL)
    for r, jc in ((0, want0[-1][1]), (1, want1[-1][1])):
        _assert_rings_equal(_ring_leaves(caches, r), jc)
    # slot 0 wrapped: 5 + 14 = 19 positions in 16 rows
    assert sorted(_ring_leaves(caches, 0)[0][2][0]) == list(range(3, 19))


def test_ring_decode_reads_the_first_min_pos_plus_one_rows(monkeypatch):
    """The decode over a ring passes ``lengths = min(pos + 1, L)`` to the
    split-K decode op, which reads rows ``0 .. lengths - 1``: the rows
    JAX's ring mask lets through, as the test above shows on the logits."""
    _, tcfg, _, tparams, _ = _model("gemma3-4b")
    seen = []
    real = tattn.kops.decode_attention

    def spy(q, k, v, lengths, **kw):
        seen.append((k.shape[1], lengths.tolist()))
        return real(q, k, v, lengths, **kw)

    monkeypatch.setattr(tattn.kops, "decode_attention", spy)
    caches = ttfm.init_caches(tcfg, 2, 48, "cpu")
    ttfm.decode_step(tparams, tcfg, torch.zeros(2, 1, dtype=torch.int32),
                     caches, torch.tensor([3, 30], dtype=torch.int32))
    assert (16, [4, 16]) in seen and (48, [4, 31]) in seen
    assert {L for L, _ in seen} == {16, 48}


def test_local_layers_without_a_ring_decode():
    """At ``max_len`` 16, the window, no ring is made (as in JAX) and the
    local layers decode over a plain stripe: the logits equal JAX's for
    the same sequence over rings (``max_len`` 40).  JAX's own decode at
    ``max_len`` 16 keys its ring on ``L <= window`` and asks for the
    ``"pos"`` leaf its init did not make (ROADMAP.md, Queue 3); the
    port keys it on the leaf."""
    jcfg, tcfg, jparams, tparams, _ = _model("gemma3-4b")
    rng = np.random.RandomState(8)
    prompt = rng.randint(0, tcfg.vocab, 6).astype(np.int32)
    steps = [int(t) for t in rng.randint(0, tcfg.vocab, 9)]
    want = _jax_row(jcfg, jparams, prompt, steps, 40)
    tc = ttfm.init_caches(tcfg, 1, 16, "cpu")
    assert not any("pos" in c for group in tc for c in group)
    lt, tc = ttfm.prefill(tparams, tcfg, _t(prompt[None]), tc)
    np.testing.assert_allclose(lt.numpy()[0], want[0][0], **LOGIT_TOL)
    for i, tok in enumerate(steps):
        lt, tc = ttfm.decode_step(tparams, tcfg, _t([[tok]]), tc,
                                  _t(np.asarray([6 + i], np.int32)))
        np.testing.assert_allclose(lt.numpy()[0], want[i + 1][0],
                                   **LOGIT_TOL)


# ----------------------------------------------------------------------
# engines: greedy decode token-exact against the JAX engines
_ENGINES = {
    "dense-fused": dict(fused=True),
    "reference": dict(fused=False),
    "paged": dict(fused=True, paged=True, block_size=8),
}


def _prompts(vocab, lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("kind", list(_ENGINES))
def test_gemma7b_engine_greedy_tokens_exact(kind):
    """5 requests through 2 slots (completions mid-K-loop, refills), the
    last two sharing a 16-token prefix: tokens and finish reasons equal
    the JAX engine's, and so do the paged engine's prefix hits."""
    jcfg, tcfg, jparams, tparams, _ = _model("gemma-7b")
    kw = dict(max_len=64, slots=2, sync_every=4, **_ENGINES[kind])
    prompts = _prompts(tcfg.vocab, (5, 9, 7, 18, 21), 5)
    prompts[4][:16] = prompts[3][:16]
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
    teng = Engine(tparams, tcfg, ServeConfig(**kw), device="cpu")
    jreqs = [jeng.submit(p, max_new=6) for p in prompts]
    treqs = [teng.submit(p, max_new=6) for p in prompts]
    jeng.run_until_drained()
    teng.run_until_drained()
    assert teng.paged == (kind == "paged")
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert b.out_tokens == a.out_tokens, i
        assert b.finish_reason == a.finish_reason, i
    hits = "engine.prefix_hit_blocks"
    assert teng.metrics.counter(hits).value == \
        jeng.metrics.counter(hits).value
    if kind == "paged":
        assert teng.metrics.counter(hits).value > 0


@pytest.mark.parametrize("kind", list(_ENGINES))
def test_gemma3_engine_greedy_tokens_exact(kind):
    """gemma3 at window 16, max_len 48: prompts of 5 to 30 tokens (three
    past the window), 12 new tokens each (every ring wraps in the decode),
    through 2 slots, so later requests reuse the slots of longer ones.
    Tokens and finish reasons equal the JAX engine's; asked for the paged
    engine, both serve dense and count the fallback once."""
    jcfg, tcfg, jparams, tparams, _ = _model("gemma3-4b")
    kw = dict(max_len=48, slots=2, sync_every=4, **_ENGINES[kind])
    prompts = _prompts(tcfg.vocab, (30, 5, 20, 9, 5, 17), 6)
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
    teng = Engine(tparams, tcfg, ServeConfig(**kw), device="cpu")
    jreqs = [jeng.submit(p, max_new=12) for p in prompts]
    treqs = [teng.submit(p, max_new=12) for p in prompts]
    jeng.run_until_drained()
    teng.run_until_drained()
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert b.out_tokens == a.out_tokens, i
        assert b.finish_reason == a.finish_reason, i
    assert {r.finish_reason for r in treqs} == {"max_new"}
    fb = "engine.paged_fallback_dense"
    assert not teng.paged and not jeng.paged
    assert teng.metrics.counter(fb).value == jeng.metrics.counter(fb).value \
        == (1 if kind == "paged" else 0)


@pytest.mark.parametrize("arch,extra,kv", [
    ("gemma-7b", ["--paged", "--block-size", "8"], "kv=paged"),
    ("gemma3-4b", [], "kv=dense"),
    ("gemma3-4b", ["--paged"], "kv=dense"),
])
def test_serve_driver_serves_gemma(arch, extra, kv):
    out = io.StringIO()
    with redirect_stdout(out):
        serve.main(["--device", "cpu", "--reduce", "--arch", arch,
                    "--requests", "3", "--max-new", "4", "--slots", "2",
                    "--max-len", "32", *extra])
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith(f"[serve] arch={arch}") and kv in line
    assert "tokens=15" in line
