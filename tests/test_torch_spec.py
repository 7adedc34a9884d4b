"""PyTorch port vs the JAX package: speculative multi-token decode.

Both sides run the two-layer variant of the reduced internlm2-1.8b config
in fp32, the JAX weights carried over with ``params_from_numpy``; the port
runs on the CPU, where its attention takes the plain versions, and the
JAX engine its own plain path.  The JAX verify runs its dense extend on a
gathered copy of the pool; the port's verify runs the paged extend on the
pool itself.  Tolerance: logits ``atol = rtol = 1e-4`` (fp32,
tests/test_kernels.py:16); tokens, finish reasons and counters are equal.
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
from repro.models import api  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro.serving import make_engine_fns  # noqa: E402
from repro_torch.cluster import EngineBackend  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402
from repro_torch.serving.kvpool import padded_table  # noqa: E402

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)     # fp32 whole-model logits
_JFNS = {}                                  # JAX engine fns per ServeConfig


def _cfgs():
    j = jax_reduced(jax_get_config("internlm2-1.8b")).replace(
        n_layers=2, groups=(JScanGroup(("A",), 2),))
    t = reduced(get_config("internlm2-1.8b")).replace(
        n_layers=2, groups=(ScanGroup(("A",), 2),))
    return j, t


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = jax.jit(lambda k: api.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v)
            for k, v in _flatten_with_paths(jparams)[0].items()}
    return jcfg, tcfg, jparams, weights.params_from_numpy(flat, tcfg,
                                                          device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_engine(model, **kw):
    jcfg, _, jparams, _ = model
    key = tuple(sorted(kw.items()))
    if key not in _JFNS:
        _JFNS[key] = make_engine_fns(jcfg, JServeConfig(**kw))
    return JEngine(jparams, jcfg, JServeConfig(**kw), shared_fns=_JFNS[key])


def _drain(eng, prompts, max_new):
    reqs = [eng.submit(p.copy(), max_new=max_new) for p in prompts]
    eng.run_until_drained()
    return reqs


def _levels(snap):
    hist = (".count", ".mean", ".p50", ".p95", ".p99")
    return {k: v for k, v in snap.items()
            if not k.endswith(hist) and ".le" not in k}


# ----------------------------------------------------------------------
# the draft and the verify window
@pytest.mark.parametrize("seed,d", [(0, 1), (1, 3), (2, 5), (3, 3)])
def test_ngram_draft_equals_jax(seed, d):
    """Histories over a 6-token vocabulary (so bigrams recur), positions
    from 0 to the row's end, every row's last token drawn too."""
    rng = np.random.RandomState(seed)
    B, L = 6, 40
    hist = rng.randint(0, 6, size=(B, L)).astype(np.int32)
    pos = np.array([0, 1, 2, 17, L - 2, L - 1], np.int32)
    last = rng.randint(0, 6, size=B).astype(np.int32)
    want = jtfm.ngram_draft(jnp.asarray(hist), jnp.asarray(pos),
                            jnp.asarray(last), d)
    got = ttfm.ngram_draft(_t(hist), _t(pos), _t(last), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pools(rng, like):
    """Random K/V in every pool of ``like`` (JAX caches), null row 0
    included; returns the numpy pools keyed (group, position, key)."""
    out = {}
    for gi, group in enumerate(like):
        for pi, c in enumerate(group):
            for key, leaf in c.items():
                out[gi, pi, key] = rng.randn(*leaf.shape).astype(np.float32)
    return out


def test_verify_extend_on_the_pool_equals_jax_on_the_gathered_pool(model):
    """The verify window S = 4 at ragged pos0 that straddle blocks of 8,
    one window running past the table's span: the port's targets equal
    JAX's, its logits agree, and the K/V it wrote equal the rows JAX's
    window wrote into the gathered copy (JAX drops the rows past the
    span; the port sends them to the null block)."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(7)
    n_blocks, bs, nb, S = 16, 8, 4, 4
    bt = (rng.permutation(n_blocks)[:12] + 1).reshape(3, nb).astype(np.int32)
    pos0 = np.array([5, 14, nb * bs - 2], np.int32)
    tokens = rng.randint(0, tcfg.vocab, size=(3, S)).astype(np.int32)
    jc = jtfm.init_paged_caches(jcfg, n_blocks, bs)
    pools = _pools(rng, jc)
    jc = [[{k: jnp.asarray(pools[gi, pi, k]) for k in c}
           for pi, c in enumerate(g)] for gi, g in enumerate(jc)]
    tc = [[{k: _t(pools[gi, pi, k]) for k in c} for pi, c in enumerate(g)]
          for gi, g in enumerate(jc)]
    virt = jtfm.gather_paged_virtual(jc, jnp.asarray(bt))
    jtargets, virt = jtfm.verify_extend(jparams, jcfg, jnp.asarray(tokens),
                                        virt, jnp.asarray(pos0))
    ttargets, tc = ttfm.verify_extend(tparams, tcfg, _t(tokens), tc,
                                      _t(pos0), _t(bt))
    np.testing.assert_array_equal(ttargets.numpy(), np.asarray(jtargets))
    # the logits behind the targets, each side's backbone run again
    jx = jtfm.embed(jparams["embedding"], jnp.asarray(tokens), jcfg)
    jx, _, _ = jtfm.run_backbone(
        jparams, jx, jcfg, "extend",
        jtfm.gather_paged_virtual(jc, jnp.asarray(bt)),
        pos=jnp.asarray(pos0), bt=None)
    jlogits = jtfm._head(jparams, jtfm.apply_norm(jparams["final_norm"], jx,
                                                  jcfg), jcfg)
    tc2 = [[{k: _t(pools[gi, pi, k]) for k in c} for pi, c in enumerate(g)]
           for gi, g in enumerate(jc)]
    tx = ttfm.embed(tparams["embedding"], _t(tokens), tcfg)
    tx, _, _ = ttfm.run_backbone(tparams, tx, tcfg, "extend", tc2,
                                 _t(pos0), _t(bt))
    tlogits = ttfm._head(tparams, ttfm.apply_norm(tparams["final_norm"], tx,
                                                  tcfg), tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    # the window's K/V: the port's pool read through the table against
    # the JAX gathered copy, at every position inside the span
    for gi, group in enumerate(tc):
        for pi, c in enumerate(group):
            for key, vkey in (("kp", "k"), ("vp", "v")):
                mine = c[key][:, _t(bt).long()].reshape(
                    c[key].shape[0], 3, nb * bs, *c[key].shape[3:])
                np.testing.assert_allclose(
                    mine.numpy(), np.asarray(virt[gi][pi][vkey]),
                    atol=1e-5, rtol=1e-5)
    # the rows past the span went to the null block only
    for gi, group in enumerate(tc):
        for pi, c in enumerate(group):
            real = c["kp"][:, 1:].numpy()
            seen = pools[gi, pi, "kp"][:, 1:]
            untouched = np.ones(n_blocks, bool)
            untouched[bt.ravel() - 1] = False
            np.testing.assert_array_equal(real[:, untouched],
                                          seen[:, untouched])


# ----------------------------------------------------------------------
# engines: the port's speculative engine against JAX's, and against the
# port's non-speculative paged engine
def _spec_both(model, kw, batches, max_new):
    """Run JAX's and the port's speculative engines and the port's plain
    paged engine over ``batches`` (each drained before the next); every
    request's tokens and finish reason, and every counter and gauge of
    the two speculative engines, must agree."""
    _, tcfg, _, tparams = model
    spec = dict(kw, speculative=True)
    jeng = _jax_engine(model, **spec)
    teng = Engine(tparams, tcfg, ServeConfig(**spec), device="cpu")
    plain = Engine(tparams, tcfg, ServeConfig(**kw), device="cpu")
    got = {id(e): [] for e in (jeng, teng, plain)}
    for prompts in batches:
        for eng in (jeng, teng, plain):
            got[id(eng)] += _drain(eng, prompts, max_new)
    assert jeng.speculative and teng.speculative
    for i, (a, b, c) in enumerate(zip(got[id(jeng)], got[id(teng)],
                                      got[id(plain)])):
        assert b.out_tokens == a.out_tokens == c.out_tokens, i
        assert b.finish_reason == a.finish_reason == c.finish_reason, i
    assert teng.alloc.free_blocks + teng.alloc.cached_blocks == \
        teng.alloc.num_blocks
    assert _levels(teng.metrics.snapshot()) == \
        _levels(jeng.metrics.snapshot())
    assert teng.metrics.counter("engine.spec_proposed").value > 0
    return teng, got[id(teng)]


def test_spec_engine_refill_parity(model):
    """tests/test_serving_spec.py::test_spec_matches_paged_with_refill: 5
    requests through 2 slots, completions mid-loop and refills."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32)
               for n in (5, 9, 7, 12, 6)]
    _, reqs = _spec_both(model, dict(max_len=64, slots=2, sync_every=4,
                                     paged=True, block_size=8),
                         [prompts], max_new=6)
    assert {r.finish_reason for r in reqs} == {"max_new"}


def test_spec_engine_truncation_parity(model):
    """max_len truncation inside a verify window (the emission cap), with
    windows hanging past max_len whose rows are dropped."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32) for n in (4, 9)]
    _, reqs = _spec_both(model, dict(max_len=32, slots=2, sync_every=8,
                                     paged=True, block_size=8),
                         [prompts], max_new=100)
    assert {r.finish_reason for r in reqs} == {"max_len"}


def test_spec_engine_prefix_hit_parity(model):
    """Admits through prefix-cache hits backfill the draft history from
    the cached prompt tokens; hits, acceptance and tokens equal JAX's."""
    rng = np.random.RandomState(3)
    common = rng.randint(0, 256, size=16).astype(np.int32)
    tail = lambda n: rng.randint(0, 256, n).astype(np.int32)  # noqa: E731
    first = [np.concatenate([common, tail(4)]), tail(6)]
    second = [np.concatenate([common, tail(3)]),
              np.concatenate([common, tail(9)])]
    teng, _ = _spec_both(model, dict(max_len=64, slots=2, sync_every=4,
                                     paged=True, block_size=8),
                         [first, second], max_new=6)
    assert teng.metrics.counter("engine.prefix_hit_blocks").value == 4


def test_spec_engine_repetitive_stream_accepts_drafts(model):
    """A prompt that repeats one short phrase: the bigram draft finds it,
    so verify windows accept drafts (the acceptance counters equal JAX's
    and are > 0) and the tokens stay exact."""
    phrase = np.array([11, 42, 7, 99, 3], np.int32)
    prompts = [np.tile(phrase, 4), np.tile(phrase[::-1], 3)]
    teng, _ = _spec_both(model, dict(max_len=64, slots=2, sync_every=4,
                                     paged=True, block_size=8),
                         [prompts], max_new=20)
    assert teng.metrics.counter("engine.spec_accepted").value > 0


def test_spec_config_validation_and_fallback():
    """The ServeConfig gates of speculation, and the Mamba family, which
    serves dense, falling back to plain decode, observably."""
    with pytest.raises(ValueError, match="paged"):
        ServeConfig(speculative=True)
    with pytest.raises(ValueError, match="greedy"):
        ServeConfig(speculative=True, paged=True, max_len=64, block_size=8,
                    temperature=0.7)
    with pytest.raises(ValueError, match="spec_draft"):
        ServeConfig(speculative=True, paged=True, max_len=64, block_size=8,
                    spec_draft=0)
    cfg = reduced(get_config("falcon-mamba-7b")).replace(
        n_layers=1, groups=(ScanGroup(("S",), 1),))
    params = weights.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    prompts = [np.arange(3, 9, dtype=np.int32), np.arange(5, dtype=np.int32)]
    kw = dict(max_len=32, slots=2, sync_every=4, paged=True, block_size=8)
    eng = Engine(params, cfg, ServeConfig(speculative=True, **kw),
                 device="cpu")
    assert not eng.paged and not eng.speculative
    assert eng.metrics.counter("engine.spec_fallback").value == 1
    plain = Engine(params, cfg, ServeConfig(**kw), device="cpu")
    assert [r.out_tokens for r in _drain(eng, prompts, 5)] == \
        [r.out_tokens for r in _drain(plain, prompts, 5)]


# ----------------------------------------------------------------------
# acceptance semantics at the loop, with injected drafts
# (tests/test_serving_spec.py:166, :202)
def _loop_state(model, prompt, max_new):
    """A port speculative engine advanced one sync, slot 0's table grown
    to max_len so a direct loop call writes through real blocks only, and
    the JAX engine's greedy stream (prompt ++ continuation)."""
    _, tcfg, _, tparams = model
    base = dict(max_len=64, slots=1, sync_every=4, paged=True, block_size=8)
    (ref,) = _drain(_jax_engine(model, **base), [prompt], max_new)
    stream = np.zeros(base["max_len"], np.int32)
    n_stream = len(prompt) + len(ref.out_tokens)
    stream[:n_stream] = np.concatenate([prompt, ref.out_tokens])
    scfg = ServeConfig(speculative=True, **base)
    eng = Engine(tparams, tcfg, scfg, device="cpu")
    req = eng.submit(prompt.copy(), max_new=max_new)
    eng.step()
    assert not req.done
    sid = eng._seq_of_slot[0]
    eng.alloc.extend_to(sid, scfg.max_len)
    eng._bt[0] = padded_table(eng.alloc.table(sid), eng.nb_max)
    pos0 = int(eng._pos[0])
    assert req.out_tokens == list(stream[len(prompt):pos0 + 1])
    return eng, scfg, _t(eng._bt), stream, n_stream, pos0


@pytest.mark.parametrize("draft", ["oracle", "adversarial"])
def test_spec_loop_injected_drafts(model, draft):
    """A draft proposing the true greedy continuation is accepted whole
    (d+1 tokens a verify); one proposing impossible tokens is rejected
    whole (one corrected token a verify).  Either way the emitted tokens
    are the greedy stream's."""
    _, tcfg, _, tparams = model
    seed = 1 if draft == "oracle" else 5
    prompt = np.random.RandomState(seed).randint(
        0, tcfg.vocab, size=6).astype(np.int32)
    eng, scfg, bt, stream, n_stream, pos0 = _loop_state(model, prompt, 40)
    k, d = 3, scfg.spec_draft

    def oracle(hist, pos, last, dd):
        idx = (pos.long()[:, None] + 1 +
               torch.arange(dd)[None, :]).clamp(0, scfg.max_len - 1)
        return _t(stream)[idx]

    def adversarial(hist, pos, last, dd):
        return torch.full((pos.shape[0], dd), -1, dtype=torch.int32)

    out, emitted, stats, *_ = ttfm.spec_decode_loop(
        tparams, tcfg, eng.caches, eng._hist, eng._pos, eng._last,
        eng._active, eng._remaining, k=k, d=d, max_len=scfg.max_len, bt=bt,
        draft_fn=oracle if draft == "oracle" else adversarial)
    acc, prop = stats.tolist()
    em = int(emitted[0])
    assert prop == k * d
    if draft == "oracle":
        assert acc == k * d and em == k * (d + 1)
    else:
        assert acc == 0 and em == k
    assert pos0 + 1 + em <= n_stream
    np.testing.assert_array_equal(out[0, :em].numpy(),
                                  stream[pos0 + 1:pos0 + 1 + em])


# ----------------------------------------------------------------------
def test_spec_toggled_off_and_on_mid_serve(model):
    """Brownout L1 switches speculation off between syncs and L0 back on,
    with admits in between (the JAX engine raises at such an admit:
    ROADMAP.md, Queue 3): the tokens stay the non-speculative ones, and
    the spec counters stop while it is off."""
    _, tcfg, _, tparams = model
    kw = dict(max_len=64, slots=2, sync_every=4, paged=True, block_size=8)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32)
               for n in (7, 11, 5, 9)]
    plain = Engine(tparams, tcfg, ServeConfig(**kw), device="cpu")
    want = [r.out_tokens for r in _drain(plain, prompts, 10)]
    eng = Engine(tparams, tcfg, ServeConfig(speculative=True, **kw),
                 device="cpu")
    be = EngineBackend(eng)
    reqs = [eng.submit(p.copy(), max_new=10) for p in prompts[:2]]
    eng.step()
    be.set_brownout(1)
    assert not eng.speculative
    prop = eng.metrics.counter("engine.spec_proposed").value
    reqs += [eng.submit(p.copy(), max_new=10) for p in prompts[2:]]
    for _ in range(3):
        eng.step()
    assert eng.metrics.counter("engine.spec_proposed").value == prop
    be.set_brownout(0)
    assert eng.speculative
    eng.run_until_drained()
    assert eng.metrics.counter("engine.spec_proposed").value > prop
    assert [r.out_tokens for r in reqs] == want
