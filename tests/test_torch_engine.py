"""PyTorch port vs the JAX package: the model and the dense fused,
reference and paged engines.

Both sides run the two-layer variant of the reduced internlm2-1.8b config
(``R = 2`` exercises the stacked ``(repeats, ...)`` layout).  The JAX
weights are carried over with ``params_from_numpy``; the port runs on the
CPU, where its attention takes the plain versions.  The JAX side runs its
own plain path (``cfg.use_kernels`` off), as its serving tests do.  Tolerance: whole-model logits ``atol = rtol = 1e-4`` (fp32,
tests/test_kernels.py:16); tokens and finish reasons must be equal.
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
import ml_dtypes  # noqa: E402

from repro.checkpoint.checkpointer import (Checkpointer,  # noqa: E402
                                           _flatten_with_paths)
from repro.cluster import tracing as jtracing  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ScanGroup as JScanGroup  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro.serving import make_engine_fns  # noqa: E402
from repro_torch.cluster import tracing  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)     # fp32 whole-model logits

# the JAX side jitted whole: one compile per shape, not one per operation
_jext = jax.jit(jtfm.extend_paged, static_argnums=1)
_jdec = jax.jit(jtfm.decode_step, static_argnums=1)
_jpre = jax.jit(jtfm.prefill, static_argnums=1)
_JFNS = {}                                  # JAX engine fns per ServeConfig


def _cfgs(**kw):
    j = jax_reduced(jax_get_config("internlm2-1.8b")).replace(
        n_layers=2, groups=(JScanGroup(("A",), 2),), **kw)
    t = reduced(get_config("internlm2-1.8b")).replace(
        n_layers=2, groups=(ScanGroup(("A",), 2),), **kw)
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


# ----------------------------------------------------------------------
# model: extend / decode logits and the K-step decode loop
def test_extend_and_decode_logits(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(0)
    n_blocks, bs = 8, 8
    bt = np.array([[1, 3, 5, 7], [2, 4, 6, 8]], np.int32)
    jc = jtfm.init_paged_caches(jcfg, n_blocks, bs)
    tc = ttfm.init_paged_caches(tcfg, n_blocks, bs, "cpu")

    def both(j_fn, t_fn):
        nonlocal jc, tc
        lj, jc = j_fn(jc)
        lt, tc = t_fn(tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)

    # full prefill of row 0, a right-padded prefill of row 1 (5 real tokens)
    toks = rng.randint(0, tcfg.vocab, size=(2, 8)).astype(np.int32)
    pos0, last = np.zeros(2, np.int32), np.array([7, 4], np.int32)
    both(lambda c: _jext(jparams, jcfg, jnp.asarray(toks), c,
                         jnp.asarray(pos0), jnp.asarray(bt),
                         jnp.asarray(last)),
         lambda c: ttfm.extend_paged(tparams, tcfg, _t(toks), c, _t(pos0),
                                     _t(bt), _t(last)))
    # suffix extend after a cached prefix (pos0 > 0), over the pad rows
    toks = rng.randint(0, tcfg.vocab, size=(2, 4)).astype(np.int32)
    pos0, last = np.array([8, 5], np.int32), np.array([3, 2], np.int32)
    both(lambda c: _jext(jparams, jcfg, jnp.asarray(toks), c,
                         jnp.asarray(pos0), jnp.asarray(bt),
                         jnp.asarray(last)),
         lambda c: ttfm.extend_paged(tparams, tcfg, _t(toks), c, _t(pos0),
                                     _t(bt), _t(last)))
    # two decode steps through the block table
    for pos in ([12, 8], [13, 9]):
        tok = rng.randint(0, tcfg.vocab, size=(2, 1)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        both(lambda c: _jdec(jparams, jcfg, jnp.asarray(tok), c,
                             jnp.asarray(pos), bt=jnp.asarray(bt)),
             lambda c: ttfm.decode_step(tparams, tcfg, _t(tok), c, _t(pos),
                                        _t(bt)))
    # every real pool block holds the same K/V on both sides
    for key in ("kp", "vp"):
        np.testing.assert_allclose(tc[0][0][key][:, 1:].numpy(),
                                   np.asarray(jc[0][0][key])[:, 1:],
                                   atol=1e-5, rtol=1e-5)


def test_decode_loop_tokens_exact(model):
    """K steps with a per-slot stop by budget (slot 1) and by max_len
    (slot 0) inside the loop: tokens, counts and loop state are equal."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(1)
    n_blocks, bs, max_len, k = 8, 8, 16, 6
    bt = np.array([[2, 5], [7, 1]], np.int32)
    toks = rng.randint(0, tcfg.vocab, size=(2, 12)).astype(np.int32)
    pos0 = np.zeros(2, np.int32)
    last_idx = np.array([11, 6], np.int32)
    jc = jtfm.init_paged_caches(jcfg, n_blocks, bs)
    tc = ttfm.init_paged_caches(tcfg, n_blocks, bs, "cpu")
    lj, jc = _jext(jparams, jcfg, jnp.asarray(toks), jc, jnp.asarray(pos0),
                   jnp.asarray(bt), jnp.asarray(last_idx))
    lt, tc = ttfm.extend_paged(tparams, tcfg, _t(toks), tc, _t(pos0), _t(bt),
                               _t(last_idx))
    first = np.asarray(jtfm.sample_tokens(lj[:, 0]))
    np.testing.assert_array_equal(ttfm.sample_tokens(lt[:, 0]).numpy(), first)
    pos = last_idx + 1
    rem = np.array([6, 3], np.int32)
    active = np.ones(2, bool)
    jout = jtfm.decode_loop(jparams, jcfg, jc, jnp.asarray(pos),
                            jnp.asarray(first), jnp.asarray(active),
                            jnp.asarray(rem), jax.random.PRNGKey(0), k=k,
                            max_len=max_len, bt=jnp.asarray(bt))
    tout = ttfm.decode_loop(tparams, tcfg, tc, _t(pos), _t(first),
                            _t(active), _t(rem), k=k, max_len=max_len,
                            bt=_t(bt))
    # (out, emitted) then (pos, last, active, remaining); caches skipped
    for j_arr, t_arr in zip(jout[:2] + jout[3:7], tout[:2] + tout[3:7]):
        np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
    assert tout[1].tolist() == [3, 3]        # max_len (0), budget (1)


def test_prefill_and_dense_decode_logits(model):
    """Dense prefill of right-padded rows with per-row last_index, then
    dense decode steps: logits and caches equal the JAX model's."""
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
    # decode over the pad rows of row 1 (positions 5.. overwrite them)
    for pos in ([8, 5], [9, 6]):
        tok = rng.randint(0, tcfg.vocab, size=(B, 1)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        lj, jc = _jdec(jparams, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos))
        lt, tc = ttfm.decode_step(tparams, tcfg, _t(tok), tc, _t(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[0][0][key].numpy(),
                                   np.asarray(jc[0][0][key]),
                                   atol=1e-5, rtol=1e-5)


def test_dense_decode_loop_tokens_exact(model):
    """The K-step loop over dense caches, with a stop by max_len (slot 0)
    and by budget (slot 1) inside the loop."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(4)
    max_len, k = 16, 6
    toks = rng.randint(0, tcfg.vocab, size=(2, 12)).astype(np.int32)
    last_idx = np.array([11, 6], np.int32)
    jc = api.init_caches(jcfg, 2, max_len)
    tc = ttfm.init_caches(tcfg, 2, max_len, "cpu")
    lj, jc = _jpre(jparams, jcfg, jnp.asarray(toks), jc,
                   last_index=jnp.asarray(last_idx))
    lt, tc = ttfm.prefill(tparams, tcfg, _t(toks), tc,
                          last_index=_t(last_idx))
    first = np.asarray(jtfm.sample_tokens(lj[:, 0]))
    np.testing.assert_array_equal(ttfm.sample_tokens(lt[:, 0]).numpy(), first)
    pos, rem = last_idx + 1, np.array([6, 3], np.int32)
    active = np.ones(2, bool)
    jout = jtfm.decode_loop(jparams, jcfg, jc, jnp.asarray(pos),
                            jnp.asarray(first), jnp.asarray(active),
                            jnp.asarray(rem), jax.random.PRNGKey(0), k=k,
                            max_len=max_len)
    tout = ttfm.decode_loop(tparams, tcfg, tc, _t(pos), _t(first),
                            _t(active), _t(rem), k=k, max_len=max_len)
    for j_arr, t_arr in zip(jout[:2] + jout[3:7], tout[:2] + tout[3:7]):
        np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
    assert tout[1].tolist() == [3, 3]        # max_len (0), budget (1)


def test_sample_tokens_greedy_takes_first_max():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert ttfm.sample_tokens(logits).tolist() == \
        np.asarray(jtfm.sample_tokens(jnp.asarray(logits.numpy()))).tolist() \
        == [1, 0]


# ----------------------------------------------------------------------
# engine: token-exact against the JAX paged engine
def _serve_both(model, scfg_kw, batches, max_new, submit_kw=None):
    """Run both engines over ``batches`` (lists of prompts, each drained
    before the next is submitted); ``submit_kw(i)`` gives request i's extra
    ``submit`` arguments, one call per engine.  Returns (jax_engine,
    jax_reqs, port_engine, port_reqs)."""
    jcfg, tcfg, jparams, tparams = model
    jscfg = JServeConfig(**scfg_kw)
    key = tuple(sorted(scfg_kw.items()))
    if key not in _JFNS:
        _JFNS[key] = make_engine_fns(jcfg, jscfg)
    jeng = JEngine(jparams, jcfg, jscfg, shared_fns=_JFNS[key])
    teng = Engine(tparams, tcfg, ServeConfig(**scfg_kw), device="cpu")
    extra = submit_kw or (lambda i: {})
    jreqs, treqs = [], []
    for prompts in batches:
        n = len(jreqs)
        jreqs += [jeng.submit(p, max_new=max_new, **extra(n + i))
                  for i, p in enumerate(prompts)]
        treqs += [teng.submit(p, max_new=max_new, **extra(n + i))
                  for i, p in enumerate(prompts)]
        jeng.run_until_drained()
        teng.run_until_drained()
    assert jeng.paged == teng.paged == scfg_kw.get("paged", False)
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert b.out_tokens == a.out_tokens, i
        assert b.finish_reason == a.finish_reason, i
    if teng.paged:
        # every request's blocks were released at finish
        assert teng.alloc.free_blocks + teng.alloc.cached_blocks == \
            teng.alloc.num_blocks
    # counters and gauges agree; histograms hold wall times
    assert _levels(teng.metrics.snapshot()) == \
        _levels(jeng.metrics.snapshot())
    return jeng, jreqs, teng, treqs


def _levels(snap):
    hist = (".count", ".mean", ".p50", ".p95", ".p99")
    return {k: v for k, v in snap.items()
            if not k.endswith(hist) and ".le" not in k}


def test_engine_refill_parity(model):
    """tests/test_serving_paged.py::test_paged_matches_dense_with_refill:
    5 requests through 2 slots, completions mid-K-loop and refills."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32)
               for n in (5, 9, 7, 12, 6)]
    _, jreqs, _, _ = _serve_both(
        model, dict(max_len=64, slots=2, fused=True, sync_every=4,
                    paged=True, block_size=8), [prompts], max_new=6)
    assert {r.finish_reason for r in jreqs} == {"max_new"}


def test_engine_truncation_parity(model):
    """tests/test_serving_paged.py::test_paged_truncation_parity: max_len
    truncation mid-K-loop."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32) for n in (4, 9)]
    _, jreqs, _, _ = _serve_both(
        model, dict(max_len=32, slots=2, fused=True, sync_every=8,
                    paged=True, block_size=8), [prompts], max_new=100)
    assert {r.finish_reason for r in jreqs} == {"max_len"}


def test_engine_shared_prefix_parity(model):
    """A second wave whose prompts share a two-block prefix with the first
    admits only the suffix; hits and tokens equal the JAX engine's."""
    rng = np.random.RandomState(5)
    common = rng.randint(0, 256, size=16).astype(np.int32)
    tail = lambda n: rng.randint(0, 256, n).astype(np.int32)  # noqa: E731
    first = [np.concatenate([common, tail(4)]), tail(6)]
    second = [np.concatenate([common, tail(3)]),
              np.concatenate([common, tail(9)])]
    jeng, _, teng, _ = _serve_both(
        model, dict(max_len=64, slots=2, fused=True, sync_every=4,
                    paged=True, block_size=8), [first, second], max_new=5)
    hits = teng.metrics.counter("engine.prefix_hit_blocks").value
    assert hits == jeng.metrics.counter("engine.prefix_hit_blocks").value == 4
    assert teng.metrics.counter("engine.prefill_tokens_saved").value == \
        jeng.metrics.counter("engine.prefill_tokens_saved").value


_DENSE_KW = [dict(fused=True), dict(fused=False)]
_DENSE_IDS = ["fused", "reference"]


@pytest.mark.parametrize("kw", _DENSE_KW, ids=_DENSE_IDS)
def test_dense_engine_refill_parity(model, kw):
    """tests/test_serving_fused.py's refill case on the dense engines: 5
    requests through 2 slots, completions mid-K-loop and refills.  The
    port's dense tokens also equal its paged tokens."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32)
               for n in (5, 9, 7, 12, 6)]
    _, jreqs, _, treqs = _serve_both(
        model, dict(max_len=64, slots=2, sync_every=4, **kw), [prompts],
        max_new=6)
    assert {r.finish_reason for r in jreqs} == {"max_new"}
    _, tcfg, _, tparams = model
    paged = Engine(tparams, tcfg, ServeConfig(max_len=64, slots=2,
                                              sync_every=4, paged=True,
                                              block_size=8), device="cpu")
    preqs = [paged.submit(p, max_new=6) for p in prompts]
    paged.run_until_drained()
    assert [r.out_tokens for r in preqs] == [r.out_tokens for r in treqs]


@pytest.mark.parametrize("kw", _DENSE_KW, ids=_DENSE_IDS)
def test_dense_engine_truncation_parity(model, kw):
    """max_len truncation (mid-K-loop on the fused engine), and a prompt
    that fills the cache finishes at its admit."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32)
               for n in (4, 9, 31)]
    _, jreqs, _, _ = _serve_both(
        model, dict(max_len=32, slots=2, sync_every=8, **kw), [prompts],
        max_new=100)
    assert {r.finish_reason for r in jreqs} == {"max_len"}
    assert len(jreqs[2].out_tokens) == 1


def test_dense_engine_bucketed_multi_admit_parity(model):
    """Four queued prompts of one bucket (9-16 tokens) admit as one padded
    batch into four free slots, then a second bucket; the batch-1 exact-
    length reference engine gives the same tokens."""
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32)
               for n in (9, 16, 12, 10, 3, 5)]
    kw = dict(max_len=48, slots=4, sync_every=4)
    jeng, jreqs, teng, treqs = _serve_both(model, dict(fused=True, **kw),
                                           [prompts], max_new=5)
    assert teng.metrics.counter("engine.prefill_batches").value == \
        jeng.metrics.counter("engine.prefill_batches").value == 2
    # whole-row slot inserts and every decode write, junk rows included,
    # leave the same caches on both sides
    for key in ("k", "v"):
        np.testing.assert_allclose(teng.caches[0][0][key].numpy(),
                                   np.asarray(jeng.caches[0][0][key]),
                                   atol=1e-5, rtol=1e-5)
    _, _, _, rreqs = _serve_both(model, dict(fused=False, **kw), [prompts],
                                 max_new=5)
    assert [r.out_tokens for r in rreqs] == [r.out_tokens for r in treqs]


@pytest.mark.parametrize("kw", _DENSE_KW, ids=_DENSE_IDS)
def test_dense_engine_cancel_and_deadline_parity(model, kw):
    """A request cancelled after its third poll and one whose deadline
    has passed end early with their partial tokens; the slot refills and
    the rest decode on, on both sides alike."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32)
               for n in (6, 8, 5, 7)]

    def extra(i):
        if i == 0:
            polls = iter(range(100))
            return dict(cancel_cb=lambda: next(polls) >= 2)
        if i == 2:
            return dict(deadline_s=0.0)      # expires in the queue
        return {}

    _, jreqs, _, _ = _serve_both(
        model, dict(max_len=48, slots=2, sync_every=4, **kw), [prompts],
        max_new=12, submit_kw=extra)
    assert [r.finish_reason for r in jreqs] == \
        ["cancelled", "max_new", "deadline", "max_new"]
    assert 1 < len(jreqs[0].out_tokens) < 13 and jreqs[2].out_tokens == []


def test_engine_temperature_is_seeded(model):
    """Temperature sampling matches JAX only in distribution; the port's
    own draws repeat for one seed."""
    _, tcfg, _, tparams = model
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, 256, size=n).astype(np.int32) for n in (5, 8)]
    runs = []
    for _ in range(2):
        eng = Engine(tparams, tcfg,
                     ServeConfig(max_len=32, slots=2, sync_every=4,
                                 temperature=1.0, seed=3, paged=True,
                                 block_size=8), device="cpu")
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run_until_drained()
        runs.append([r.out_tokens for r in reqs])
    assert runs[0] == runs[1]
    assert all(len(t) == 7 and all(0 <= x < 256 for x in t) for t in runs[0])


def test_engine_spans_and_flight_recorder(model):
    """With a tracer installed the engine records the JAX engine's span
    tree; the flight recorder logs every admit."""
    _, tcfg, _, tparams = model
    tracer = tracing.Tracer()
    tracing.set_tracer(tracer)
    try:
        eng = Engine(tparams, tcfg, ServeConfig(max_len=32, slots=2,
                                                sync_every=4, paged=True,
                                                block_size=8), device="cpu")
        seq0 = tracing.current_recorder().last_seq
        reqs = [eng.submit(np.arange(n, dtype=np.int32), max_new=5)
                for n in (3, 6, 9)]
        eng.run_until_drained()
    finally:
        tracing.set_tracer(None)
    spans = tracer.spans()
    names = {sp["name"] for sp in spans}
    assert {"engine.request", "engine.admit", "engine.prefill",
            "engine.decode_sync", "engine.host_sync"} <= names
    done = [sp for sp in spans if sp["name"] == "engine.request"]
    assert sorted(sp["tags"]["rid"] for sp in done) == \
        sorted(r.rid for r in reqs)
    assert {sp["tags"]["finish"] for sp in done} == {"max_new"}
    admits = [e for e in tracing.current_recorder().events()
              if e["seq"] > seq0 and e["kind"] == "admit"]
    assert sorted(rid for e in admits for rid in e["rids"]) == \
        sorted(r.rid for r in reqs)


@pytest.mark.parametrize("kw", _DENSE_KW, ids=_DENSE_IDS)
def test_dense_engine_spans_equal_the_jax_engine(model, kw):
    """The dense engines record the JAX engine's spans (names, and the
    parent of each by name) and flight-recorder admits."""
    jcfg, tcfg, jparams, tparams = model
    scfg_kw = dict(max_len=32, slots=2, sync_every=4, **kw)
    key = tuple(sorted(scfg_kw.items()))
    if key not in _JFNS:
        _JFNS[key] = make_engine_fns(jcfg, JServeConfig(**scfg_kw))
    trees = []
    for trc, make in (
            (jtracing, lambda: JEngine(jparams, jcfg, JServeConfig(**scfg_kw),
                                       shared_fns=_JFNS[key])),
            (tracing, lambda: Engine(tparams, tcfg, ServeConfig(**scfg_kw),
                                     device="cpu"))):
        tracer = trc.Tracer()
        trc.set_tracer(tracer)
        try:
            eng = make()
            seq0 = trc.current_recorder().last_seq
            for n in (3, 6, 9):
                eng.submit(np.arange(n, dtype=np.int32), max_new=5)
            eng.run_until_drained()
        finally:
            trc.set_tracer(None)
        spans = tracer.spans()
        by_id = {sp["span"]: sp["name"] for sp in spans}
        admits = [e["n"] for e in trc.current_recorder().events()
                  if e["seq"] > seq0 and e["kind"] == "admit"]
        trees.append((sorted({(sp["name"], by_id.get(sp["parent"]))
                              for sp in spans}, key=str), admits))
    assert trees[1] == trees[0]
    if kw["fused"]:
        assert {"engine.admit", "engine.prefill", "engine.decode_sync",
                "engine.host_sync"} <= {name for name, _ in trees[0][0]}


@pytest.mark.parametrize("kw,what", [
    (dict(paged=False, family="encdec"), "Engine serves decoder-LM families"),
])
def test_engine_outside_slice_raises(model, kw, what):
    """The Engine refuses the encoder-decoder family with the JAX
    Engine's reason (``engine.py:551-552``): a refusal that stands, not a
    part of the port still to come."""
    _, tcfg, _, tparams = model
    kw = dict(kw)
    cfg = tcfg.replace(family=kw.pop("family", tcfg.family))
    with pytest.raises(NotImplementedError) as e:
        Engine(tparams, cfg, ServeConfig(max_len=32, block_size=8, **kw),
               device="cpu")
    assert str(e.value) == what


# ----------------------------------------------------------------------
# weights: checkpoint read, seeded init
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_checkpoint_is_exact(model, tmp_path, dtype):
    _, tcfg = _cfgs(param_dtype=dtype)
    jparams = jax.jit(lambda t: jax.tree_util.tree_map(
        lambda x: x.astype(dtype), t))(model[2])
    Checkpointer(str(tmp_path)).save(3, jparams)
    port = weights.load_checkpoint(str(tmp_path / "step_3"), tcfg, "cpu")
    flat = _flat_numpy(jparams)
    assert port["groups"][0][0]["mixer"]["wq"].shape == (2, 64, 64)
    for key, want in flat.items():
        node = port
        for part in key.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        assert node.dtype == tcfg.p_dtype, key
        got = node.float().numpy()
        np.testing.assert_array_equal(got, want.astype(np.float32), key)
        if dtype == "bfloat16":
            assert want.dtype == ml_dtypes.bfloat16


def test_params_from_numpy_rejects_bad_trees(model):
    jcfg, tcfg, jparams, _ = model
    flat = _flat_numpy(jparams)
    with pytest.raises(KeyError, match="lm_head"):
        weights.params_from_numpy({k: v for k, v in flat.items()
                                   if k != "lm_head"}, tcfg, "cpu")
    flat["final_norm/w"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="final_norm/w"):
        weights.params_from_numpy(flat, tcfg, "cpu")


def test_init_params_full_width_shapes_and_scale():
    """The seeded init builds the JAX package's tree at full width (shapes
    checked without allocating JAX arrays) with its distributions; one
    seed gives one set of weights."""
    jcfg = jax_get_config("internlm2-1.8b")
    tcfg = get_config("internlm2-1.8b")
    abstract = jax.eval_shape(lambda k: api.init(k, jcfg)[0],
                              jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in _flatten_with_paths(abstract)[0].items()}
    specs = weights.param_specs(tcfg)
    assert {k: weights._full_shape(s) for k, s in specs.items()} == want
    # the distributions, on the two-layer reduced config
    _, small = _cfgs()
    p = [weights.init_params(small, torch.Generator().manual_seed(7), "cpu")
         for _ in range(2)]
    assert torch.equal(p[0]["lm_head"], p[1]["lm_head"])
    wq = p[0]["groups"][0][0]["mixer"]["wq"]
    assert abs(wq.std().item() * np.sqrt(64) - 1.0) < 0.05
    assert abs(p[0]["embedding"]["table"].std().item() - 1.0) < 0.05
    assert torch.equal(p[0]["final_norm"]["w"], torch.ones(64))


def test_serve_driver_paged_flag():
    """``--paged`` serves the block pool, the default the dense engine;
    greedy tokens are the same."""
    lines = []
    for extra in ([], ["--paged", "--block-size", "8"]):
        out = io.StringIO()
        with redirect_stdout(out):
            serve.main(["--device", "cpu", "--reduce", "--requests", "2",
                        "--max-new", "3", "--slots", "2", "--max-len", "32",
                        *extra])
        lines.append(out.getvalue().strip().splitlines()[-1])
    assert "kv=dense" in lines[0] and "kv=paged" in lines[1]
    assert all("tokens=8" in ln for ln in lines)
    assert not serve.build_engine(reduce=True, device="cpu").paged


def test_serve_driver_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        serve.main(["--device", "cpu", "--reduce", "--requests", "3",
                    "--max-new", "4", "--slots", "2", "--max-len", "32",
                    "--block-size", "8"])
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith("[serve]") and "tok/s=" in line
    assert "tokens=15" in line                   # 3 x (1 prefill + 4)
