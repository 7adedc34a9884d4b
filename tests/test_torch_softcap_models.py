"""Attention logit soft-capping through the port's models against the JAX
package's ``jnp`` path (``use_kernels=False``): greedy tokens through the
engines (internlm2-1.8b paged, dense and speculative; gemma-7b; gemma3-4b
over its rings), whisper-base's prefill and decode steps, the logits and
every gradient of one training step, deepseek-v2-lite-16b (its dense
layer capped, its MLA layers not, as in JAX), and two ranks over gloo
under ``tp`` and ``seqtp``.

Every model is reduced(), fp32, its JAX weights carried over with
``params_from_numpy``, with ``attn_softcap`` 1.0: the reduced widths give
scaled scores up to ~4, so a cap of 50 would change nothing and prove
nothing.  Each test also asserts that the port's uncapped logits miss
JAX's capped ones by far more than the tolerance.  Tolerances (fp32, sums
in another order): logits ``atol = rtol = 1e-4``; the loss ``rtol =
1e-5`` and each gradient within ``1e-5`` of its leaf's largest magnitude;
tokens exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes: one thread is faster and leaves
                           # the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_softcap_ranks as ranks  # noqa: E402
from repro.checkpoint.checkpointer import _flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ScanGroup as JScanGroup  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api, encdec, weights  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

CAP = ranks.CAP
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
RTOL = 1e-5
#: arch -> the layer pattern of its two-layer config (None: reduced()'s)
PATTERNS = {"internlm2-1.8b": ("A",), "gemma-7b": ("A",),
            "gemma3-4b": None, "deepseek-v2-lite-16b": None}
_MODELS = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree)[0].items()}


def _model(arch, **over):
    """fp32 reduced ``arch`` (two layers where it has one layer kind),
    capped at CAP, on both sides: (jcfg, tcfg, jparams, tparams), made
    once a module."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        j, t = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
        if PATTERNS.get(arch):
            j = j.replace(n_layers=2, groups=(JScanGroup(PATTERNS[arch], 2),))
            t = t.replace(n_layers=2, groups=(ScanGroup(PATTERNS[arch], 2),))
        j, t = (c.replace(attn_softcap=CAP, **over) for c in (j, t))
        jp = jax.jit(lambda k: japi.init(k, j)[0])(jax.random.PRNGKey(0))
        _MODELS[key] = (j, t, jp, weights.params_from_numpy(
            _flat(jp), t, device="cpu"))
    return _MODELS[key]


def _uncapped_misses(tparams, tcfg, toks, want):
    """The port's uncapped forward misses JAX's capped logits ``want``."""
    with torch.no_grad():
        plain = ttfm.forward(tparams, tcfg.replace(attn_softcap=0.0),
                             tokens=_t(toks))[0]
    assert np.abs(plain.numpy() - want).max() > 100 * LOGIT_TOL["atol"]


# ----------------------------------------------------------------------
# logits
@pytest.mark.parametrize("arch", sorted(PATTERNS))
def test_capped_forward_logits_equal_jax(arch):
    """The full-sequence forward (flash on every attention layer; for
    deepseek-v2-lite-16b its dense layer capped and its MLA layers not,
    on both sides)."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = np.random.RandomState(1).randint(0, tcfg.vocab, (2, 21)).astype(
        np.int32)
    want = np.asarray(jax.jit(lambda p, t: jtfm.forward(p, jcfg, tokens=t)[0])(
        jp, jnp.asarray(toks)))
    with torch.no_grad():
        got = ttfm.forward(tp, tcfg, tokens=_t(toks))[0]
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    _uncapped_misses(tp, tcfg, toks, want)


# ----------------------------------------------------------------------
# engines: greedy tokens exact
_ENGINES = {"paged": dict(paged=True, block_size=8),
            "dense": dict(),
            "speculative": dict(paged=True, block_size=8, speculative=True)}


@pytest.mark.parametrize("arch,kind", [
    ("internlm2-1.8b", "paged"), ("internlm2-1.8b", "dense"),
    ("internlm2-1.8b", "speculative"), ("gemma-7b", "paged"),
    ("gemma3-4b", "dense")])
def test_capped_engine_greedy_tokens_exact(arch, kind):
    """5 requests through 2 slots, the last two sharing a 16-token prefix
    (gemma3-4b's prompts pass its window of 16, so its rings wrap): the
    tokens and finish reasons of JAX's engine."""
    jcfg, tcfg, jp, tp = _model(arch)
    kw = dict(max_len=48, slots=2, sync_every=4, **_ENGINES[kind])
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, tcfg.vocab, n).astype(np.int32)
               for n in (5, 9, 7, 18, 21)]
    prompts[4][:16] = prompts[3][:16]
    jeng = JEngine(jp, jcfg, JServeConfig(**kw))
    teng = Engine(tp, tcfg, ServeConfig(**kw), device="cpu")
    jreqs = [jeng.submit(p.copy(), max_new=8) for p in prompts]
    treqs = [teng.submit(p.copy(), max_new=8) for p in prompts]
    jeng.run_until_drained()
    teng.run_until_drained()
    assert teng.paged == ("paged" in _ENGINES[kind])
    assert teng.speculative == (kind == "speculative")
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert b.out_tokens == a.out_tokens, i
        assert b.finish_reason == a.finish_reason, i


# ----------------------------------------------------------------------
# whisper-base: the prefill and the decode steps
@pytest.fixture(scope="module")
def whisper():
    over = dict(enc_layers=2, dec_layers=2, n_layers=4, attn_softcap=CAP)
    j = jax_reduced(jax_get_config("whisper-base")).replace(**over)
    t = reduced(get_config("whisper-base")).replace(**over)
    jp = jax.jit(lambda k: japi.init(k, j)[0])(jax.random.PRNGKey(0))
    return j, t, jp, weights.params_from_numpy(_flat(jp), t, "cpu")


def test_capped_whisper_prefill_and_greedy_decode_equal_jax(whisper):
    """The capped encoder (bidir), decoder (causal) and cross attention in
    the prefill, then 6 greedy decode steps through the capped self and
    cross decodes: the same tokens, logits at 1e-4; the uncapped prefill
    misses."""
    jcfg, tcfg, jp, tp = whisper
    B, S_enc, S, L = 2, 24, 5, 16
    rng = np.random.RandomState(2)
    frames = rng.standard_normal((B, S_enc, 64)).astype(np.float32)
    tok = rng.randint(0, tcfg.vocab, (B, S)).astype(np.int32)
    pre = jax.jit(lambda p, t, f, c: jenc.prefill(p, t, f, jcfg, c))
    dec = jax.jit(lambda p, t, c, pos: jenc.decode_step(p, t, c, pos, jcfg))
    jl, jc = pre(jp, jnp.asarray(tok), jnp.asarray(frames),
                 japi.init_caches(jcfg, B, L, S_enc))

    def port(cfg):
        caches = api.init_caches(cfg, B, L, S_enc, device="cpu")
        with torch.no_grad():
            return encdec.prefill(tp, _t(tok), _t(frames), cfg, caches)

    tl, tc = port(tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    plain, _ = port(tcfg.replace(attn_softcap=0.0))
    assert np.abs(plain.numpy() - np.asarray(jl)).max() > 1e-2
    for i in range(6):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt), i
        pos = np.full((B,), S + i, np.int32)
        jl, jc = dec(jp, jnp.asarray(nxt[:, None]), jc, jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = encdec.decode_step(tp, _t(nxt[:, None]), tc, _t(pos),
                                        tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **LOGIT_TOL)


# ----------------------------------------------------------------------
# training: the loss and every gradient of one step
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b"])
def test_capped_lm_loss_and_every_gradient_equal_jax(arch):
    """``lm_loss`` and its gradients through the capped flash (on the CPU
    autograd through the capped plain version, the backward kernel's
    plain version) against ``jax.value_and_grad`` of JAX's loss."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = np.random.RandomState(3).randint(0, tcfg.vocab, (2, 19)).astype(
        np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(japi.loss_fn, has_aux=True),
                          static_argnums=1)(jp, jcfg,
                                            {"tokens": jnp.asarray(toks)})
    (loss, _), grads = steps.value_and_grad(
        weights.params_from_numpy(_flat(jp), tcfg, "cpu"), tcfg,
        {"tokens": _t(toks)})
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    want = _flat(jg)
    got = {k: v.detach().numpy() for k, v in flatten_with_paths(grads).items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()))
    (plain, _), _ = steps.value_and_grad(
        tp, tcfg.replace(attn_softcap=0.0), {"tokens": _t(toks)})
    assert abs(float(plain) - float(jl)) > 100 * RTOL * abs(float(jl))


# ----------------------------------------------------------------------
# two ranks over gloo: tp and seqtp
def test_capped_tp_and_seqtp_on_two_ranks_equal_jax(tmp_path):
    """internlm2-1.8b under ``tp`` (each rank its head block, the cap on
    its heads) and gemma3-4b under ``seqtp`` at S 1,024 (the local layer
    on the halo, the global one gathered, flash at a query offset), each
    on a (1, 2) mesh: every rank's logits equal JAX's one-device capped
    forward and the port's one-rank run."""
    data, want = {}, {}
    for case in ranks.CASES:
        arch, pattern, _ = ranks.CASES[case]
        jcfg = jax_reduced(jax_get_config(arch)).replace(
            n_layers=len(pattern), groups=(JScanGroup(pattern, 1),),
            attn_softcap=CAP)
        jp = jax.jit(lambda k: japi.init(k, jcfg)[0])(jax.random.PRNGKey(4))
        toks = np.random.RandomState(6).randint(
            0, jcfg.vocab, ranks.SHAPES[case]).astype(np.int32)
        data.update({f"{case}/p/{k}": v for k, v in _flat(jp).items()})
        data[case + "/tokens"] = toks
        want[case] = np.asarray(jax.jit(
            lambda p, t: jtfm.forward(p, jcfg, tokens=t)[0])(
            jp, jnp.asarray(toks)))
    path = str(tmp_path / "capped.npz")
    np.savez(path, **data)
    got = collectives.spawn(ranks.capped_rank, 2, backend="gloo",
                            device="cpu", timeout_s=240, args=(path,),
                            threads=1)
    for case in ranks.CASES:
        cfg, params, toks = ranks.inputs(path, case)
        with torch.no_grad():
            one = ttfm.forward(params, cfg, tokens=toks)[0].numpy()
        np.testing.assert_allclose(one, want[case], **LOGIT_TOL)
        _uncapped_misses(params, cfg, toks.numpy(), want[case])
        for rank, out in enumerate(got):
            np.testing.assert_allclose(out[case]["logits"], want[case],
                                       err_msg=f"{case} rank {rank}",
                                       **LOGIT_TOL)
            np.testing.assert_allclose(out[case]["logits"], one,
                                       err_msg=f"{case} rank {rank}",
                                       **LOGIT_TOL)
    assert got[0]["seqtp"]["routes"]["halo"] == 1 and \
        got[0]["seqtp"]["routes"]["gather"] == 1
