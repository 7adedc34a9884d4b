"""PyTorch port vs the JAX package: the micro-batch stream runtime
(``core/stream.py``), scope-window and scope-file, on the setup of
tests/test_stream.py:13-22.

Both runtimes get the same models (the JAX MARGOT models carried over
with ``models_from_numpy``) and the same micro-batches.  After every
micro-batch the two ring states and the returned ``(scores, ok)`` are
compared: integer and boolean fields and the links ``ok`` equal, floats at
``atol = rtol = 1e-5`` (fp32 sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import stream as jstream  # noqa: E402
from repro.data import text as jtext  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.cluster.metrics import MetricsRegistry  # noqa: E402
from repro_torch.core import pipeline, stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import argmining  # noqa: E402
from repro_torch.models import svm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
PCFG_J = jpipe.PipelineConfig(feat_dim=128, claim_capacity=32,
                              evid_capacity=32)
PCFG_T = pipeline.PipelineConfig(feat_dim=128, claim_capacity=32,
                                 evid_capacity=32)
RING_FIELDS = ("feats", "ts", "keys", "valid", "cursor")


@pytest.fixture(scope="module")
def setup():
    docs = jtext.synthetic_corpus(3, 30, seed=4)
    X, keys, _ = jtext.corpus_arrays(docs, dim=PCFG_J.feat_dim)
    jmodels, _ = jtext.margot_models(PCFG_J)
    ntree = {k: {n: np.asarray(v) for n, v in m.items()}
             for k, m in jmodels.items()}
    ts = np.arange(len(keys), dtype=np.float32) * 0.5       # 2 inst/s
    return X, keys, ts, jmodels, svm.models_from_numpy(ntree, "cpu")


def _compare_rings(got, want, where):
    for f in RING_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   err_msg=f"{where}: {f}", **TOL)


@pytest.mark.parametrize("scope,window", [("window", 8.0), ("window", 3.0),
                                          ("file", 10.0)])
def test_stream_matches_jax_every_microbatch(setup, scope, window):
    """Nine micro-batches of 10 through rings of 48 rows: the rings wrap,
    the window drops old rows, and every micro-batch's ring states,
    scores and links equal the JAX runtime's."""
    X, keys, ts, jmodels, models = setup
    kw = dict(period=5.0, capacity=16, scope=scope, window=window,
              ring_capacity=48)
    jrt = jstream.StreamRuntime(jmodels, PCFG_J, jstream.StreamConfig(**kw))
    rt = stream.StreamRuntime(models, PCFG_T, stream.StreamConfig(**kw))
    ops.reset_counts()
    n_mb = 0
    for start in range(0, len(keys), 10):
        sl = slice(start, start + 10)
        sc, ok = rt.process_microbatch(X[sl], keys[sl], ts[sl])
        jsc, jok = jrt.process_microbatch(X[sl], keys[sl], ts[sl])
        n_mb += 1
        _compare_rings(rt.state.claims, jrt.state.claims, f"mb {n_mb}")
        _compare_rings(rt.state.evidence, jrt.state.evidence, f"mb {n_mb}")
        np.testing.assert_allclose(sc, jsc, **TOL)
        np.testing.assert_array_equal(ok, jok)
        assert rt.stats[-1].n_links == jrt.stats[-1].n_links
        assert rt.stats[-1].mb_id == jrt.stats[-1].mb_id == n_mb
    assert n_mb == 9 and sum(s.n_links for s in rt.stats) > 5
    assert int(np.asarray(jrt.state.claims.valid).sum()) > 0
    assert ops.PLAIN_CALLS["pair_score"] == n_mb      # every scoring


def test_microbatch_beyond_capacity_runs_in_chunks(setup):
    X, keys, ts, jmodels, models = setup
    kw = dict(period=5.0, capacity=16, scope="window", window=8.0,
              ring_capacity=48)
    jrt = jstream.StreamRuntime(jmodels, PCFG_J, jstream.StreamConfig(**kw))
    metrics = MetricsRegistry()
    rt = stream.StreamRuntime(models, PCFG_T, stream.StreamConfig(**kw),
                              metrics=metrics)
    sc, ok = rt.process_microbatch(X[:40], keys[:40], ts[:40])
    jsc, jok = jrt.process_microbatch(X[:40], keys[:40], ts[:40])
    np.testing.assert_array_equal(ok, jok)
    _compare_rings(rt.state.claims, jrt.state.claims, "chunked")
    assert rt.stats[-1].n_links == jrt.stats[-1].n_links
    snap = metrics.snapshot()
    assert snap["stream.instances"] == 40 and snap["stream.microbatches"] == 1
    rt.process_microbatch(X[:0], keys[:0], ts[:0])       # an empty period
    assert rt.stats[-1].n_in == 0 and rt.state.microbatch_id == 4


def test_ring_append_matches_jax():
    rng = np.random.RandomState(0)
    st = stream.init_ring(8, 4)
    jst = jstream.init_ring(8, 4)
    for i in range(6):
        feats = rng.randn(5, 4).astype(np.float32)
        ts = rng.rand(5).astype(np.float32) + i
        keys = rng.randint(0, 3, 5).astype(np.int32)
        valid = rng.rand(5) < 0.7
        st = stream.ring_append(st, torch.from_numpy(feats),
                                torch.from_numpy(ts), torch.from_numpy(keys),
                                torch.from_numpy(valid))
        jst = jstream.ring_append(jst, jnp.asarray(feats), jnp.asarray(ts),
                                  jnp.asarray(keys), jnp.asarray(valid))
        _compare_rings(st, jst, f"append {i}")


def test_ring_append_more_rows_than_slots_matches_jax():
    """Five valid rows into a ring of 3 at cursor 1: the later rows win
    their slots, as the JAX scatter gives on the CPU."""
    feats = np.arange(6, dtype=np.float32)[:, None]
    valid = np.array([True, False, True, True, True, True])
    zeros = np.zeros(6, np.float32), np.zeros(6, np.int32)
    st = stream.init_ring(3, 1)._replace(cursor=torch.tensor(1))
    jst = jstream.init_ring(3, 1)._replace(cursor=jnp.asarray(1, jnp.int32))
    st = stream.ring_append(st, torch.from_numpy(feats),
                            *map(torch.from_numpy, zeros),
                            torch.from_numpy(valid))
    jst = jstream.ring_append(jst, jnp.asarray(feats),
                              *map(jnp.asarray, zeros), jnp.asarray(valid))
    _compare_rings(st, jst, "overfull")
    assert st.feats[:, 0].tolist() == [3.0, 4.0, 5.0]


def test_sustainable_rate_ramp(setup):
    """A period far above any busy time sustains the whole ramp; one far
    below it sustains nothing."""
    X, keys, ts, _, models = setup
    rng = np.random.RandomState(0)

    def gen(n, t0):
        idx = rng.randint(0, len(keys), n)
        return X[idx], keys[idx], (t0 + np.arange(n) * 1e-3).astype(np.float32)

    for period, rates, want in ((60.0, [0.2, 0.5], 0.5), (1e-9, [1e9], 0.0)):
        scfg = stream.StreamConfig(period=period, capacity=16,
                                   ring_capacity=32)
        rate = stream.find_sustainable_rate(
            lambda: stream.StreamRuntime(models, PCFG_T, scfg), gen,
            rates=rates, mb_per_rate=2)
        assert rate == want


def test_checkpointer_is_not_ported_yet(setup, tmp_path):
    """The name is from before the port had its checkpointer; the test is
    now the stream's checkpoint round trip.  Each runtime checkpoints
    ``{"state": ...}`` every 2 micro-batches under JAX's keys; a run
    restored from the other package's step 4 continues for 5 micro-batches
    exactly as an uninterrupted run of its own package does, rings,
    scores and links bit for bit, both ways."""
    X, keys, ts, jmodels, models = setup
    scfg = dict(period=5.0, capacity=16, scope="window", window=8.0,
                ring_capacity=48)
    mbs = [slice(s, s + 10) for s in range(0, 90, 10)]

    def run(rt, batches):
        out = []
        for sl in batches:
            sc, ok = rt.process_microbatch(X[sl], keys[sl], ts[sl])
            out.append((np.asarray(sc), np.asarray(ok),
                        [np.asarray(getattr(r, f)) for r in
                         (rt.state.claims, rt.state.evidence)
                         for f in RING_FIELDS]))
        return out

    def same(a, b):
        assert len(a) == len(b) == 5
        for (sa, oa, ra), (sb, ob, rb) in zip(a, b):
            np.testing.assert_array_equal(sa, sb)
            np.testing.assert_array_equal(oa, ob)
            for x, y in zip(ra, rb):
                np.testing.assert_array_equal(x, y)

    jck = JCheckpointer(str(tmp_path / "jax"))
    jrt = jstream.StreamRuntime(jmodels, PCFG_J, jstream.StreamConfig(**scfg),
                                checkpointer=jck, checkpoint_every=2)
    run(jrt, mbs[:4])
    ck = Checkpointer(str(tmp_path / "port"))
    rt = stream.StreamRuntime(models, PCFG_T, stream.StreamConfig(**scfg),
                              checkpointer=ck, checkpoint_every=2)
    whole = run(rt, mbs)
    assert ck.steps() == [4, 6, 8] and jck.steps() == [2, 4]
    with np.load(tmp_path / "port" / "step_4" / "arrays.npz") as d:
        files = {k: d[k] for k in d.files}
    with np.load(tmp_path / "jax" / "step_4" / "arrays.npz") as d:
        assert sorted(files) == sorted(d.files)
        assert files["state/.microbatch_id"].dtype == np.int32 == \
            d["state/.microbatch_id"].dtype
        assert int(files["state/.microbatch_id"]) == 4

    # JAX's step 4 -> the port
    resumed = stream.StreamRuntime(models, PCFG_T,
                                   stream.StreamConfig(**scfg),
                                   checkpointer=Checkpointer(
                                       str(tmp_path / "jax")))
    resumed.restore(4)
    assert resumed.state.microbatch_id == 4
    assert resumed.state.claims.cursor.dtype == torch.int64
    same(run(resumed, mbs[4:]), whole[4:])

    # the port's step 4 -> JAX
    jwhole = jstream.StreamRuntime(jmodels, PCFG_J,
                                   jstream.StreamConfig(**scfg))
    jwhole_out = run(jwhole, mbs)
    jres = jstream.StreamRuntime(jmodels, PCFG_J, jstream.StreamConfig(**scfg))
    jres.state = JCheckpointer(str(tmp_path / "port")).restore(
        {"state": jres.state}, 4)["state"]
    same(run(jres, mbs[4:]), jwhole_out[4:])


def test_stream_cli_on_the_cpu(capsys):
    ops.reset_counts()
    rt, rate = argmining.main(["stream", "--device", "cpu", "--rates",
                               "40,80"])
    out = capsys.readouterr().out
    assert out.count("[argmining stream] mb=") == 5
    assert f"max sustainable rate {rate:.0f} inst/s of ramp 40,80" in out
    assert rate in (0.0, 40.0, 80.0)     # a busy CPU may fall behind
    assert ops.PLAIN_CALLS["pair_score"] >= 8
