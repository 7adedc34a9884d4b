"""starcoder2-3b in the port against the JAX package: LayerNorm and the
plain GELU MLP, the weight tree, the model's logits and greedy decode
through the dense fused, reference and paged engines.

Both sides run ``reduced()`` starcoder2-3b made two layers deep (``R = 2``
exercises the stacked ``(repeats, ...)`` layout) in fp32: LayerNorm with
biases, the tanh-GELU MLP with biases, tied embeddings, GQA.  The JAX
weights are carried over with ``params_from_numpy``; the port runs on the
CPU, where its attention takes the plain versions, and the JAX side runs
its plain path (``use_kernels=False``).  Tolerances: the layers
``atol = rtol = 1e-6`` (fp32, the same arithmetic in another library);
whole-model logits ``atol = rtol = 1e-4`` (fp32, tests/test_kernels.py:16);
tokens and finish reasons must be equal.
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
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.cluster.backends import checkpoint_step_dir  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, weights  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

ARCH = "starcoder2-3b"
LAYER_TOL = dict(atol=1e-6, rtol=1e-6)     # fp32 layers
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)     # fp32 whole-model logits

_jext = jax.jit(jtfm.extend_paged, static_argnums=1)
_jdec = jax.jit(jtfm.decode_step, static_argnums=1)
_jpre = jax.jit(jtfm.prefill, static_argnums=1)


def _cfgs():
    j = jax_reduced(jax_get_config(ARCH)).replace(
        n_layers=2, groups=(JScanGroup(("A",), 2),))
    t = reduced(get_config(ARCH)).replace(
        n_layers=2, groups=(ScanGroup(("A",), 2),))
    return j, t


def _flat_numpy(params):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(params)[0].items()}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    assert not jcfg.use_kernels
    jparams = jax.jit(lambda k: api.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    # the JAX init draws zero biases and unit norm weights: perturb them,
    # so the parity below sees every bias and norm weight
    flat = _flat_numpy(jparams)
    rng = np.random.RandomState(9)
    for k in flat:
        if k.endswith(("/b", "/b_up", "/b_down")) or "norm" in k or \
                "/ln" in k:
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(flat[k].dtype)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams),
        [jnp.asarray(flat[k]) for k in _flatten_with_paths(jparams)[0]])
    tparams = weights.params_from_numpy(flat, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# layers
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 3072)])
def test_layer_norm_matches_jax(shape):
    """fp32 statistics with the population variance, on rows whose mean is
    far from 0 (a one-pass variance would lose digits there)."""
    rng = np.random.RandomState(0)
    x = (rng.standard_normal(shape) * 3 + 5).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), 1e-5))
    got = layers.layer_norm(_t(x), _t(w), _t(b), 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


def test_layer_norm_keeps_bf16_inputs_bf16():
    x = torch.randn(4, 64, dtype=torch.bfloat16)
    out = layers.layer_norm(x, torch.ones(64), torch.zeros(64))
    assert out.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(x.float(), (64,), eps=1e-5)
    assert torch.equal(out, ref.to(torch.bfloat16))


def test_gelu_mlp_matches_jax(model):
    """The plain MLP with biases and the tanh GELU; the exact-erf GELU
    would be ~1e-3 off, far past the limit."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    jffn = jax.tree_util.tree_map(lambda a: a[0],
                                  jparams["groups"][0][0]["ffn"])
    tffn = {k: v[0] for k, v in tparams["groups"][0][0]["ffn"].items()}
    assert sorted(tffn) == ["b_down", "b_up", "w_down", "w_up"]
    want = np.asarray(jlayers.apply_mlp(jffn, jnp.asarray(x), jcfg))
    got = layers.apply_mlp(tffn, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)
    erf = (torch.nn.functional.gelu(_t(x) @ tffn["w_up"] + tffn["b_up"])
           @ tffn["w_down"] + tffn["b_down"])
    assert np.abs(erf.numpy() - want).max() > 1e-4


def test_other_mlp_kinds_still_raise():
    """Every MLP kind of the JAX package is in the port: GeGLU takes
    SwiGLU's leaves (gate, up, down) and its gate through the tanh GELU;
    a kind the JAX package does not have raises."""
    cfg = reduced(get_config(ARCH)).replace(mlp="geglu")
    specs = weights.param_specs(cfg)
    assert {k.rsplit("/", 1)[1] for k in specs if "/ffn/" in k} == \
        {"w_gate", "w_up", "w_down"}
    rng = np.random.RandomState(2)
    ffn = {k.rsplit("/", 1)[1]: _t(rng.standard_normal(shape)
                                   .astype(np.float32))
           for k, (_, (shape, _)) in specs.items()
           if k.startswith("groups/0/0/ffn/")}
    x = _t(rng.standard_normal((3, 64)).astype(np.float32))
    want = (torch.nn.functional.gelu(x @ ffn["w_gate"], approximate="tanh")
            * (x @ ffn["w_up"])) @ ffn["w_down"]
    assert torch.allclose(layers.apply_mlp(ffn, x, cfg), want, **LAYER_TOL)
    with pytest.raises(ValueError, match="reglu"):
        layers.apply_mlp(ffn, x, cfg.replace(mlp="reglu"))
    with pytest.raises(NotImplementedError, match="item 6"):
        weights.param_specs(cfg.replace(mlp="reglu"))


# ----------------------------------------------------------------------
# weights
def test_params_from_numpy_carries_the_jax_tree(model):
    """Every leaf of the JAX tree is in the port's specs and the reverse,
    in the stacked layout, the biases and LayerNorm weights included."""
    jcfg, tcfg, jparams, tparams = model
    flat = _flat_numpy(jparams)
    specs = weights.param_specs(tcfg)
    assert sorted(flat) == sorted(specs)
    for key in ("final_norm/b", "groups/0/0/ln1/b", "groups/0/0/ln2/b",
                "groups/0/0/ffn/b_up", "groups/0/0/ffn/b_down"):
        assert key in specs
    assert "lm_head" not in specs                  # tied embeddings
    for key, arr in flat.items():
        node = tparams
        for part in key.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        assert tuple(node.shape) == arr.shape
        np.testing.assert_array_equal(node.numpy(), arr)


def test_init_params_draws_norms_and_biases_as_jax(model):
    """The port's seeded init: LayerNorm weights one, every bias zero, as
    ``init_norm`` and ``init_mlp`` give; the weights N(0, 1/fan_in)."""
    _, tcfg, _, _ = model
    p = weights.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    layer = p["groups"][0][0]
    for norm in (p["final_norm"], layer["ln1"], layer["ln2"]):
        assert torch.equal(norm["w"], torch.ones_like(norm["w"]))
        assert torch.equal(norm["b"], torch.zeros_like(norm["b"]))
    for b in ("b_up", "b_down"):
        assert torch.equal(layer["ffn"][b], torch.zeros_like(layer["ffn"][b]))
    assert layer["ffn"]["b_up"].shape == (2, tcfg.d_ff)
    w = layer["ffn"]["w_up"]
    assert abs(w.std().item() * np.sqrt(tcfg.d_model) - 1.0) < 0.05


def test_load_checkpoint_is_exact(model, tmp_path):
    jcfg, tcfg, jparams, tparams = model
    Checkpointer(str(tmp_path)).save(3, jparams)
    got = weights.load_checkpoint(checkpoint_step_dir(str(tmp_path)), tcfg,
                                  "cpu")
    for key in _flat_numpy(jparams):
        a, b = got, tparams
        for part in key.split("/"):
            idx = int(part) if isinstance(a, list) else part
            a, b = a[idx], b[idx]
        assert torch.equal(a, b), key


# ----------------------------------------------------------------------
# model logits
def test_prefill_and_dense_decode_logits(model):
    jcfg, tcfg, jparams, tparams = model
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


def test_extend_and_paged_decode_logits(model):
    jcfg, tcfg, jparams, tparams = model
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
    "dense-fused": dict(fused=True),
    "reference": dict(fused=False),
    "paged": dict(fused=True, paged=True, block_size=8),
}


@pytest.mark.parametrize("kind", list(_ENGINES))
def test_engine_greedy_tokens_exact(model, kind):
    """5 requests through 2 slots (completions mid-K-loop and refills),
    then a second wave sharing a 16-token prefix with the first: tokens
    and finish reasons equal the JAX engine's, and the paged engine's
    prefix hits too."""
    jcfg, tcfg, jparams, tparams = model
    kw = dict(max_len=64, slots=2, sync_every=4, **_ENGINES[kind])
    rng = np.random.RandomState(5)
    common = rng.randint(0, tcfg.vocab, 16).astype(np.int32)
    waves = [[rng.randint(0, tcfg.vocab, n).astype(np.int32)
              for n in (5, 9, 7, 12, 6)],
             [np.concatenate([common, rng.randint(0, tcfg.vocab, n)])
              .astype(np.int32) for n in (3, 9)]]
    waves[0][1] = np.concatenate([common, waves[0][1]])
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
    teng = Engine(tparams, tcfg, ServeConfig(**kw), device="cpu")
    jreqs, treqs = [], []
    for wave in waves:
        jreqs += [jeng.submit(p, max_new=6) for p in wave]
        treqs += [teng.submit(p, max_new=6) for p in wave]
        jeng.run_until_drained()
        teng.run_until_drained()
    assert teng.paged == (kind == "paged")
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert b.out_tokens == a.out_tokens, i
        assert b.finish_reason == a.finish_reason, i
    assert {r.finish_reason for r in treqs} == {"max_new"}
    hits = "engine.prefix_hit_blocks"
    assert teng.metrics.counter(hits).value == \
        jeng.metrics.counter(hits).value
    if kind == "paged":
        assert teng.metrics.counter(hits).value > 0


def test_serve_driver_serves_starcoder2():
    out = io.StringIO()
    with redirect_stdout(out):
        serve.main(["--device", "cpu", "--reduce", "--arch", ARCH,
                    "--requests", "3", "--max-new", "4", "--slots", "2",
                    "--max-len", "32", "--paged", "--block-size", "8"])
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith(f"[serve] arch={ARCH}") and "kv=paged" in line
    assert "tokens=15" in line


def test_serve_driver_loads_weights_dir(tmp_path, monkeypatch):
    """``--weights-dir`` serves the JAX package's checkpoint: the driver's
    engine reads its ``LATEST`` step."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    Checkpointer(str(tmp_path)).save(
        4, api.init(jax.random.PRNGKey(1), jcfg)[0])
    read = []
    load = weights.load_checkpoint
    monkeypatch.setattr(weights, "load_checkpoint",
                        lambda d, *a: (read.append(d), load(d, *a))[1])
    out = io.StringIO()
    with redirect_stdout(out):
        serve.main(["--device", "cpu", "--reduce", "--arch", ARCH,
                    "--requests", "2", "--max-new", "3", "--slots", "2",
                    "--max-len", "32", "--weights-dir", str(tmp_path)])
    assert read == [str(tmp_path / "step_4")]
    assert "tokens=8" in out.getvalue().strip().splitlines()[-1]
