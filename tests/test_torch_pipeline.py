"""PyTorch port vs the JAX package: the paper's two-phase pipeline (text
substrate, SVM models, filter, joins, the batch step and its driver).

The same inputs, made with numpy from a seed, go through both packages
on the CPU; the JAX models are carried over with
``repro_torch.models.svm.models_from_numpy``.  Integer outputs (indices,
keys, masks, drop counts, link sets) must be equal.  Float outputs are
held at ``atol = rtol = 1e-5``: scores are sums of at most d products of
O(1) values in fp32, and the two packages differ only in summation order
(the pair score's own tolerance is at tests/test_torch_kernels.py).
"""
import dataclasses
import functools
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import filtering as jfilt  # noqa: E402
from repro.core import joins as jjoins  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.sharding import split_params  # noqa: E402
from repro.data import text as jtext  # noqa: E402
from repro.models import svm as jsvm  # noqa: E402
from repro_torch.configs import margot_svm  # noqa: E402
from repro_torch.core import fault, filtering, joins, pipeline  # noqa: E402
from repro_torch.data import text  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
from repro_torch.launch import argmining  # noqa: E402
from repro_torch.models import svm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# the corpus and config of tests/test_pipeline.py:19-44
PCFG_J = jpipe.PipelineConfig(feat_dim=256, claim_capacity=96,
                              evid_capacity=192)
PCFG_T = pipeline.PipelineConfig(feat_dim=256, claim_capacity=96,
                                 evid_capacity=192)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _jax_models(pcfg, kind="margot", rank=0, n_sv=64):
    """The JAX package's model tree (values only) and its numpy copy."""
    if kind == "margot":
        tree, _ = jtext.margot_models(pcfg)
    else:
        k = jax.random.split(jax.random.PRNGKey(5), 3)
        tree, _ = split_params({
            "claim": jsvm.init_svm(k[0], n_sv, pcfg.feat_dim),
            "evidence": jsvm.init_svm(k[1], n_sv, pcfg.feat_dim),
            "link": jsvm.init_link(k[2], pcfg.feat_dim, rank=rank)})
    return tree, jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def corpus():
    docs = jtext.synthetic_corpus(3, 40, seed=2)
    X, keys, _ = jtext.corpus_arrays(docs, dim=PCFG_J.feat_dim)
    jtree, ntree = _jax_models(PCFG_J)
    return X, keys, jtree, svm.models_from_numpy(ntree, "cpu")


# ---------------------------------------------------------------- text
def test_text_substrate_is_byte_identical():
    docs = text.synthetic_corpus(4, 25, seed=9)
    assert docs == jtext.synthetic_corpus(4, 25, seed=9)
    for dim in (64, 1024):
        X, keys, sents = text.corpus_arrays(docs, dim=dim)
        jX, jkeys, jsents = jtext.corpus_arrays(docs, dim=dim)
        assert X.dtype == jX.dtype and X.tobytes() == jX.tobytes()
        assert keys.dtype == jkeys.dtype and keys.tobytes() == jkeys.tobytes()
        assert sents == jsents
    para = "Claims must hold! Data shows it. Does it? yes...no"
    assert text.split_sentences(para) == jtext.split_sentences(para)
    assert text.featurize(["a b", ""], 32).tobytes() == \
        jtext.featurize(["a b", ""], 32).tobytes()
    got = list(text.stream_generator(docs[:2], rate=4.0, dim=32))
    want = list(jtext.stream_generator(docs[:2], rate=4.0, dim=32))
    assert [(t, d) for t, d, _ in got] == [(t, d) for t, d, _ in want]
    assert all(a.tobytes() == b.tobytes()
               for (_, _, a), (_, _, b) in zip(got, want))


def test_margot_models():
    """Claim/evidence SVMs equal the JAX package's; the link model is the
    port's seeded draw with the JAX distribution, the same on every call."""
    jtree, _ = jtext.margot_models(PCFG_J)
    m = text.margot_models(PCFG_T, device="cpu")
    for name in ("claim", "evidence"):
        for k in ("w", "bias"):
            np.testing.assert_array_equal(_np(m[name][k]),
                                          np.asarray(jtree[name][k]))
    m2 = text.margot_models(PCFG_T, device="cpu")
    assert all(torch.equal(m["link"][k], m2["link"][k]) for k in m["link"])
    d = PCFG_T.feat_dim
    assert m["link"]["W"].shape == (d, d) and m["link"]["w"].shape == (2 * d,)
    std = float(m["link"]["W"].std()) * np.sqrt(d)
    assert 0.95 < std < 1.05 and float(m["link"]["bias"]) == 0.0
    other = text.margot_models(PCFG_T, link_seed=8, device="cpu")
    assert not torch.equal(other["link"]["W"], m["link"]["W"])


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("kind,rank", [("margot", 0), ("poly", 0),
                                       ("poly", 8)])
def test_svm_and_link_scores(kind, rank):
    """svm_score (linear and polynomial) and link_score_matrix (full rank
    and U/V) on models carried over from the JAX package."""
    pcfg = PCFG_J
    jtree, ntree = _jax_models(pcfg, kind, rank)
    m = svm.models_from_numpy(ntree, "cpu")
    rng = np.random.RandomState(1)
    X = rng.rand(40, pcfg.feat_dim).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    kw = dict(gamma=0.1, coef0=1.0, degree=2)
    for name in ("claim", "evidence"):
        got = svm.svm_score(m[name], torch.from_numpy(X), **kw)
        want = jsvm.svm_score(jtree[name], jnp.asarray(X), **kw)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    got = svm.link_score_matrix(m["link"], torch.from_numpy(X[:24]),
                                torch.from_numpy(X[24:]))
    want = jsvm.link_score_matrix(jtree["link"], jnp.asarray(X[:24]),
                                  jnp.asarray(X[24:]))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_full_rank_link_goes_through_the_pair_score_op():
    _, ntree = _jax_models(PCFG_J)
    m = svm.models_from_numpy(ntree, "cpu")
    x = torch.rand(3, PCFG_J.feat_dim)
    ops.reset_counts()
    svm.link_score_matrix(m["link"], x, x)
    assert ops.PLAIN_CALLS["pair_score"] == 1
    _, low = _jax_models(PCFG_J, "poly", rank=4)
    svm.link_score_matrix(svm.models_from_numpy(low, "cpu")["link"], x, x)
    assert ops.PLAIN_CALLS["pair_score"] == 1


@pytest.mark.parametrize("bad", [
    {"claim": {}, "evidence": {}},                          # no link
    {"claim": {"w": 0}, "evidence": {"w": 0, "bias": 0},
     "link": {"W": 0, "w": 0, "bias": 0}},                  # no bias
    {"claim": {"w": 0, "bias": 0}, "evidence": {"w": 0, "bias": 0},
     "link": {"U": 0, "w": 0, "bias": 0}},                  # U without V
])
def test_models_from_numpy_rejects(bad):
    with pytest.raises(ValueError):
        svm.models_from_numpy(bad, "cpu")


def test_init_models_shapes_and_scales():
    pcfg = dataclasses.replace(PCFG_T, link_rank=0)
    m = pipeline.init_models(pcfg, torch.Generator().manual_seed(0),
                             n_sv=512, device="cpu")
    d = pcfg.feat_dim
    assert m["claim"]["sv"].shape == (512, d)
    assert m["claim"]["alpha"].shape == (512,)
    assert m["link"]["W"].shape == (d, d)
    assert 0.95 < float(m["claim"]["sv"].std()) * np.sqrt(d) < 1.05
    assert 0.9 < float(m["claim"]["alpha"].std()) * np.sqrt(512) < 1.1
    assert not torch.equal(m["claim"]["sv"], m["evidence"]["sv"])


# ---------------------------------------------------------------- filter
def _compare_compacted(got, want):
    for f in ("index", "valid", "keys", "n_dropped"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    for f in ("feats", "scores"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), **TOL)


@pytest.mark.parametrize("capacity", [8, 96, 500])
def test_compact_by_score_on_margot_ties(corpus, capacity):
    """MARGOT's linear scores tie often; the stable sort keeps the JAX
    order, including where the capacity overflows (8) and where it
    exceeds the rows (500)."""
    X, keys, jtree, m = corpus
    sc = _np(svm.svm_score(m["claim"], torch.from_numpy(X)))
    jsc = np.asarray(jsvm.svm_score(jtree["claim"], jnp.asarray(X)))
    np.testing.assert_array_equal(sc, jsc)        # identical sums: exact
    assert len(np.unique(sc[sc > 0])) < (sc > 0).sum() / 2   # ties
    got = filtering.compact_by_score(torch.from_numpy(X),
                                     torch.from_numpy(sc),
                                     torch.from_numpy(keys), capacity)
    want = jfilt.compact_by_score(jnp.asarray(X), jnp.asarray(jsc),
                                  jnp.asarray(keys), capacity)
    _compare_compacted(got, want)


def test_compact_by_score_random_and_concat():
    rng = np.random.RandomState(3)
    X = rng.randn(50, 16).astype(np.float32)
    keys = rng.randint(0, 5, 50).astype(np.int32)
    sc = rng.randn(50).astype(np.float32)
    t = [torch.from_numpy(a) for a in (X, sc, keys)]
    j = [jnp.asarray(a) for a in (X, sc, keys)]
    got = filtering.compact_by_score(*t, 16, threshold=0.2)
    want = jfilt.compact_by_score(*j, 16, threshold=0.2)
    _compare_compacted(got, want)
    got2 = filtering.concat_compacted(got, filtering.compact_by_score(*t, 4))
    want2 = jfilt.concat_compacted(want, jfilt.compact_by_score(*j, 4))
    _compare_compacted(got2, want2)


# ---------------------------------------------------------------- joins
def _compacted_pair(seed, n, cap, d=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    keys = rng.randint(0, 3, n).astype(np.int32)
    sc = rng.randn(n).astype(np.float32)
    return (filtering.compact_by_score(torch.from_numpy(X),
                                       torch.from_numpy(sc),
                                       torch.from_numpy(keys), cap),
            jfilt.compact_by_score(jnp.asarray(X), jnp.asarray(sc),
                                   jnp.asarray(keys), cap))


def test_join_masks():
    (c, jc), (e, je) = _compacted_pair(0, 30, 12), _compacted_pair(1, 40, 20)
    np.testing.assert_array_equal(_np(joins.pair_mask_batch(c, e)),
                                  np.asarray(jjoins.pair_mask_batch(jc, je)))
    rng = np.random.RandomState(2)
    cts = np.where(_np(c.valid), rng.rand(12) * 10, -np.inf).astype(np.float32)
    ets = np.where(_np(e.valid), rng.rand(20) * 10, -np.inf).astype(np.float32)
    got = joins.pair_mask_window(torch.from_numpy(cts), torch.from_numpy(ets),
                                 c.valid, e.valid, 2.5)
    want = jjoins.pair_mask_window(jnp.asarray(cts), jnp.asarray(ets),
                                   jc.valid, je.valid, 2.5)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert _np(got).any() and not _np(got).all()


def test_file_scope_wraps_and_drops_invalid_rows():
    """Ten updates of up to 12 valid rows (with invalid rows between them)
    through a ring of 16: the cursor wraps several times, no invalid row
    is written, and every field equals the JAX scatter with drop."""
    st = joins.init_file_scope(16, 8)
    jst = jjoins.init_file_scope(16, 8)
    n_valid = n_invalid = 0
    for i in range(10):
        new, jnew = _compacted_pair(10 + i, 16, 12)
        n_valid += int(new.valid.sum())
        n_invalid += int((~new.valid).sum())
        st = joins.update_file_scope(st, new)
        jst = jjoins.update_file_scope(jst, jnew)
        for f in FIELDS_FILE:
            np.testing.assert_allclose(_np(getattr(st, f)),
                                       np.asarray(getattr(jst, f)),
                                       err_msg=f"update {i}: {f}", **TOL)
        e, je = _compacted_pair(40 + i, 10, 6)
        np.testing.assert_array_equal(_np(joins.file_scope_mask(st, e)),
                                      np.asarray(jjoins.file_scope_mask(jst,
                                                                        je)))
    assert n_valid > 3 * 16 and n_invalid > 10


FIELDS_FILE = ("feats", "scores", "keys", "valid", "cursor")


def test_ring_writes_later_row_wins_when_more_rows_than_slots():
    valid = torch.tensor([True, False, True, True, True, True])
    src, cursor = joins.ring_writes(torch.tensor(1), valid, 3)
    # rows 0, 2, 3, 4, 5 go to slots 1, 2, 0, 1, 2: rows 3, 4, 5 remain
    assert src.tolist() == [3, 4, 5] and int(cursor) == 0


# ---------------------------------------------------------------- batch
_jstep = {flag: jax.jit(functools.partial(
    jpipe.batch_step_local,
    pcfg=dataclasses.replace(PCFG_J, use_pair_kernel=flag)))
    for flag in (False, True)}


@pytest.mark.parametrize("use_pair_kernel", [False, True])
def test_batch_step_matches_jax(corpus, use_pair_kernel):
    """Every PipelineOut field and the link set of the port's step against
    the JAX step with the Pallas pair kernel (interpret mode) on and off;
    the port's own route is the same either way."""
    X, keys, jtree, m = corpus
    want = _jstep[use_pair_kernel](jtree, jnp.asarray(X), jnp.asarray(keys))
    pcfg = dataclasses.replace(PCFG_T, use_pair_kernel=use_pair_kernel)
    ops.reset_counts()
    got = pipeline.make_batch_step(pcfg)(m, torch.from_numpy(X),
                                         torch.from_numpy(keys))
    assert ops.PLAIN_CALLS["pair_score"] == 1 and LAUNCHES["pair_score"] == 0
    assert int(got.n_dropped) == 0
    for f in ("pair_valid", "claim_index", "evid_index", "claim_keys",
              "evid_keys", "n_dropped"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(_np(got.link_scores),
                               np.asarray(want.link_scores), **TOL)
    links = pipeline.extract_links(got)
    jlinks = jpipe.extract_links(want)
    assert {(c, e) for c, e, _ in links} == {(c, e) for c, e, _ in jlinks}
    assert len(links) == len(jlinks) > 50
    np.testing.assert_allclose([s for *_, s in links],
                               [s for *_, s in jlinks], **TOL)


def test_sharded_batch_step_is_not_ported_yet():
    """The sharded step (its name kept from when it raised): on 2 ranks
    spawned over gloo, the gathered links and the global drop count of
    the claim shuffle equal the one-device step's where no shard's
    compaction overflows; a mesh without the ``data`` axis is refused.
    ``tests/test_torch_dist_pipeline.py`` holds it against JAX's."""
    import torch_dist_ranks as ranks
    from repro_torch.core import collectives
    got = collectives.spawn(ranks.sharded_vs_local_rank, 2, backend="gloo",
                            device="cpu", timeout_s=60, threads=1)
    for sharded, local, dropped in got:
        assert dropped == 0 and sharded == local and len(local) > 20
    from repro_torch.launch.mesh import abstract_mesh
    with pytest.raises(ValueError, match="not distinct axes"):
        pipeline.make_batch_step(PCFG_T, abstract_mesh((2,), ("model",)))


def test_speculative_map_keeps_order_and_retries():
    calls = {}

    def fn(x):
        calls[x] = calls.get(x, 0) + 1
        if x == 3 and calls[x] == 1:
            raise RuntimeError("first attempt fails")
        return x * x

    out, stats = fault.speculative_map(fn, list(range(8)), n_workers=3)
    assert out == [x * x for x in range(8)]
    assert stats.retried_failures == 1 and stats.launched >= 9


def test_speculative_map_does_not_count_queue_time():
    """Sixty 5 ms partitions on one worker: the last waits ~0.3 s in the
    pool's queue, past the 0.1 s cutoff, yet none has run long, so none
    is speculated (the JAX copy would re-run the queued ones)."""
    out, stats = fault.speculative_map(
        lambda x: (time.sleep(0.005), x)[1], list(range(60)), n_workers=1,
        straggler_factor=20.0)
    assert out == list(range(60))
    assert stats.launched == 60 and stats.speculated == 0


def test_speculative_map_runs_a_straggler_twice_at_most():
    def fn(x):
        time.sleep(1.0 if x == 5 else 0.005)
        return x

    out, stats = fault.speculative_map(fn, list(range(12)), n_workers=3,
                                       straggler_factor=20.0)
    assert out == list(range(12))
    assert stats.speculated == 1 and stats.launched == 13


# ---------------------------------------------------------------- driver
def test_config_copies_the_jax_presets():
    from repro.configs import margot_svm as jcfg
    assert dataclasses.asdict(margot_svm.PIPELINE) == \
        dataclasses.asdict(jcfg.PIPELINE)
    assert dataclasses.asdict(margot_svm.STREAM) == \
        dataclasses.asdict(jcfg.STREAM)
    for name in ("MODELS_SV", "MODELS_SV_SCALED", "DATASETS",
                 "STREAM_WINDOWS_S"):
        assert getattr(margot_svm, name) == getattr(jcfg, name), name
    assert margot_svm.CONFIG is margot_svm.PIPELINE


def test_partitions_hold_whole_documents():
    keys = np.repeat(np.arange(7), [3, 1, 4, 2, 5, 1, 2]).astype(np.int32)
    bounds = argmining.partition_bounds(keys, 3)
    assert bounds == [(0, 8), (8, 16), (16, 18)]
    assert argmining.partition_bounds(keys, 10) == [(0, 18)]


def test_batch_driver_matches_the_jax_pipeline():
    """The slice as a whole: the batch service's link set over
    document-aligned partitions equals the JAX pipeline's over the same
    partitions with the same models, for any worker count."""
    pcfg_j = dataclasses.replace(PCFG_J, feat_dim=128)
    pcfg_t = dataclasses.replace(PCFG_T, feat_dim=128)
    X, keys, _ = argmining.make_corpus(330, 128, seed=4)
    jtree, ntree = _jax_models(pcfg_j)
    m = svm.models_from_numpy(ntree, "cpu")
    want = set()
    jstep = jax.jit(functools.partial(jpipe.batch_step_local, pcfg=pcfg_j))
    for s, e in argmining.partition_bounds(keys, 3):
        out = jstep(jtree, jnp.asarray(X[s:e]), jnp.asarray(keys[s:e]))
        want |= {(c + s, v + s) for c, v, _ in jpipe.extract_links(out)}
    for workers in (1, 3):
        res = argmining.run_batch(m, X, keys, pcfg_t, 3, workers, "cpu")
        assert res.partitions == 3 and res.n_dropped == 0
        assert {(c, v) for c, v, _ in res.links} == want and len(want) > 50


def _run_cli(capsys, argv):
    result = argmining.main(argv)
    return result, capsys.readouterr().out


def test_batch_cli_on_the_cpu(capsys):
    ops.reset_counts()
    res, out = _run_cli(capsys, ["batch", "--device", "cpu", "--docs", "25",
                                 "--workers", "2"])
    line = re.search(r"\[argmining batch\] docs: 1000 sentences .* "
                     r"3 partitions .* links=(\d+) n_dropped=0 .* "
                     r"sentences/s=[\d.]+ launched=3 .* device=cpu", out)
    assert line and int(line.group(1)) == len(res.links) > 0
    assert ops.PLAIN_CALLS["pair_score"] == 3


def test_batch_cli_model_sv_raises_capacities(capsys, monkeypatch):
    monkeypatch.setitem(argmining.MODELS_SV, "M1", 64)
    res, out = _run_cli(capsys, ["batch", "--device", "cpu", "--docs", "2",
                                 "--model-sv", "M1"])
    assert "model=M1, capacities 256/512" in out and res.n_dropped == 0


def test_cli_requires_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["batch", "--docs", "1"], ["stream"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            argmining.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        text.margot_models(PCFG_T)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.init_models(PCFG_T, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        svm.models_from_numpy({}, )
