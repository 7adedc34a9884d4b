"""PyTorch port vs the JAX package: the paged engine's KV lifecycle.

Copy-on-write forks, preemption with KV swap on both tiers, and the
prefix cache's export / import as ``KVB1`` frames, each held against the
JAX ``Engine`` on the same weights (the two-layer reduced internlm2-1.8b
in fp32, carried over with ``params_from_numpy``; the port on the CPU,
its attention on the plain versions).  Tokens, finish reasons and the
lifecycle counters must be equal; a frame crosses between the two engines
in both directions and resumes token-exact, and a bf16 frame of the port
is byte-identical to JAX's for the same rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes: one thread is faster and leaves
                           # the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint.checkpointer import _flatten_with_paths  # noqa: E402
from repro.cluster import tracing as jtracing  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ScanGroup as JScanGroup  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro.serving import make_engine_fns  # noqa: E402
from repro_torch.cluster import tracing  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402
from repro_torch.serving.kvpool import unpack_block_arrays  # noqa: E402

_JFNS = {}                                  # JAX engine fns per ServeConfig


def _cfgs(**kw):
    j = jax_reduced(jax_get_config("internlm2-1.8b")).replace(
        n_layers=2, groups=(JScanGroup(("A",), 2),), **kw)
    t = reduced(get_config("internlm2-1.8b")).replace(
        n_layers=2, groups=(ScanGroup(("A",), 2),), **kw)
    return j, t


def _carry(jcfg, tcfg):
    jparams = jax.jit(lambda k: api.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v)
            for k, v in _flatten_with_paths(jparams)[0].items()}
    return jparams, weights.params_from_numpy(flat, tcfg, device="cpu")


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    return (jcfg, tcfg) + _carry(jcfg, tcfg)


def _engines(model, **kw):
    """A JAX and a port engine of one ServeConfig on the same weights."""
    jcfg, tcfg, jparams, tparams = model
    key = tuple(sorted(kw.items()))
    if key not in _JFNS:
        _JFNS[key] = make_engine_fns(jcfg, JServeConfig(**kw))
    return (JEngine(jparams, jcfg, JServeConfig(**kw), shared_fns=_JFNS[key]),
            Engine(tparams, tcfg, ServeConfig(**kw), device="cpu"))


def _drain(eng, prompts, max_new):
    reqs = [eng.submit(p.copy(), max_new=max_new) for p in prompts]
    eng.run_until_drained()
    return reqs


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=n).astype(np.int32) for n in lengths]


LIFECYCLE = ("engine.kv_swap_out", "engine.kv_swap_in",
             "engine.kv_swapped_blocks", "engine.kv_pool_exhausted",
             "engine.kv_cow_copies", "engine.forks",
             "engine.admit_deferred_kv", "engine.kv_export_blocks",
             "engine.kv_import_blocks", "engine.prefix_hit_blocks",
             "engine.spec_proposed", "engine.spec_accepted")


def _same_counters(jeng, teng):
    j, t = jeng.metrics.snapshot(), teng.metrics.snapshot()
    assert {k: t.get(k, 0) for k in LIFECYCLE} == \
        {k: j.get(k, 0) for k in LIFECYCLE}


# ----------------------------------------------------------------------
# copy-on-write forks (tests/test_serving_paged.py:210-260)
@pytest.mark.parametrize("speculative", [False, True],
                         ids=["plain", "speculative"])
def test_fork_greedy_identical_and_cow_isolated(model, speculative):
    """A greedy fork continues with exactly the parent's stream; the
    parent's tokens match an unforked run (the shared blocks were copied
    before either side wrote them), and both engines fork alike."""
    prompt = _prompts(9, (10,))[0]
    kw = dict(max_len=64, slots=2, sync_every=4, paged=True, block_size=8,
              speculative=speculative)
    _, solo_eng = _engines(model, **kw)
    (solo,) = _drain(solo_eng, [prompt], 12)
    runs = []
    for eng in _engines(model, **kw):
        parent = eng.submit(prompt.copy(), max_new=12)
        eng.step()                      # admit + one sync
        child = eng.fork(parent, max_new=parent.max_new - parent.decoded)
        eng.run_until_drained()
        assert eng.alloc.cow_copies > 0
        runs.append((parent.out_tokens, child.out_tokens, eng))
    (jp, jc, jeng), (tp, tc, teng) = runs
    assert tp == jp == solo.out_tokens
    assert tc == jc == solo.out_tokens[:len(tc)]
    _same_counters(jeng, teng)
    assert teng.alloc.free_blocks + teng.alloc.cached_blocks == \
        teng.alloc.num_blocks


def test_fork_temperature_diverges(model):
    """With temperature sampling the forked branch samples its own
    continuation while sharing the prompt's KV copy-on-write."""
    _, tcfg, _, tparams = model
    prompt = _prompts(10, (9,))[0]
    eng = Engine(tparams, tcfg, ServeConfig(
        max_len=64, slots=2, sync_every=4, paged=True, block_size=8,
        temperature=1.0, seed=3), device="cpu")
    parent = eng.submit(prompt, max_new=16)
    eng.step()
    fork_at = len(parent.out_tokens)
    child = eng.fork(parent, max_new=parent.max_new - parent.decoded)
    eng.run_until_drained()
    assert parent.out_tokens[:fork_at] == child.out_tokens[:fork_at]
    assert parent.out_tokens != child.out_tokens
    assert eng.metrics.counter("engine.forks").value == 1


def test_fork_errors(model):
    """A dense engine cannot fork; a queued request cannot be forked; a
    fork needs a free slot."""
    _, tcfg, _, tparams = model
    dense = Engine(tparams, tcfg, ServeConfig(max_len=32, slots=2),
                   device="cpu")
    req = dense.submit(np.arange(4, dtype=np.int32), max_new=2)
    with pytest.raises(RuntimeError, match="paged"):
        dense.fork(req, max_new=2)
    peng = Engine(tparams, tcfg, ServeConfig(max_len=32, slots=1, paged=True,
                                             block_size=8), device="cpu")
    queued = peng.submit(np.arange(4, dtype=np.int32), max_new=20)
    with pytest.raises(ValueError, match="not active"):
        peng.fork(queued, max_new=2)
    peng.step()
    with pytest.raises(RuntimeError, match="no free slot"):
        peng.fork(queued, max_new=2)


# ----------------------------------------------------------------------
# preemption and swap (tests/test_kv_lifecycle.py:51-168)
TIGHT = dict(max_len=32, sync_every=4, paged=True, block_size=8,
             prefix_cache=False)


@pytest.mark.parametrize("tier", ["host", "artifact"])
def test_preempt_swap_restores_token_exact(model, tier):
    """A tight pool forces preemption mid-decode; the swapped sessions
    resume block-exact on both tiers: the tokens of an ample-pool run and
    of the JAX engine, and the JAX engine's swap counts."""
    prompts = _prompts(3, (8,) * 6)
    _, ample = _engines(model, slots=2, kv_blocks=64, **TIGHT)
    oracle = _drain(ample, prompts, 12)
    jeng, teng = _engines(model, slots=4, kv_blocks=10, kv_swap=True,
                          swap_tier=tier, **TIGHT)
    jreqs, treqs = _drain(jeng, prompts, 12), _drain(teng, prompts, 12)
    for a, b, c in zip(oracle, jreqs, treqs):
        assert c.done and c.finish_reason == "max_new", c.finish_reason
        assert c.out_tokens == b.out_tokens == a.out_tokens
    snap = teng.metrics.snapshot()
    assert snap["engine.kv_swap_out"] > 0
    assert snap["engine.kv_swap_in"] == snap["engine.kv_swap_out"]
    assert snap.get("engine.kv_pool_exhausted", 0) == 0
    _same_counters(jeng, teng)
    assert teng.alloc.free_blocks + teng.alloc.cached_blocks == \
        teng.alloc.num_blocks


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["plain", "speculative"])
def test_oversubscribe_4x_completes_all(model, speculative):
    """Token demand ~4x the pool (8 sessions x 24 tokens on 6 blocks of
    8): everything completes through swaps, token-exact against the JAX
    engine; under speculation the restored sessions' draft history is
    rebuilt, so acceptance equals JAX's too."""
    prompts = _prompts(5, (8,) * 8)
    _, ample = _engines(model, slots=8, kv_blocks=64, **TIGHT)
    oracle = _drain(ample, prompts, 16)
    jeng, teng = _engines(model, slots=8, kv_blocks=6, kv_swap=True,
                          speculative=speculative, **TIGHT)
    jreqs, treqs = _drain(jeng, prompts, 16), _drain(teng, prompts, 16)
    for a, b, c in zip(oracle, jreqs, treqs):
        assert c.finish_reason == "max_new", c.finish_reason
        assert c.out_tokens == b.out_tokens == a.out_tokens
    assert teng.metrics.counter("engine.kv_swap_out").value > 0
    _same_counters(jeng, teng)


def test_swap_round_trips_rows_bit_for_bit(model):
    """The rows a swap-out serialized are what the restore writes back:
    re-serializing the restored blocks gives the same frame bytes."""
    _, tcfg, _, tparams = model
    eng = Engine(tparams, tcfg, ServeConfig(slots=4, kv_blocks=10,
                                            kv_swap=True, **TIGHT),
                 device="cpu")
    for p in _prompts(3, (8,) * 6):
        eng.submit(p, max_new=12)
    frames = []
    restore = eng._try_restore

    def spy(free):
        req = eng.queue[0]
        snap = req.kv_snapshot
        done = restore(free)
        slot = next((s for s, r in enumerate(eng.active) if r is req), None)
        if slot is not None and snap.n_blocks:
            table = eng.alloc.table(eng._seq_of_slot[slot])
            frames.append((snap.data,
                           eng._gather_block_rows(table[:snap.n_blocks])))
        return done

    eng._try_restore = spy
    eng.run_until_drained()
    assert frames and all(a == b for a, b in frames)


def test_kv_swap_requires_paged():
    with pytest.raises(ValueError):
        ServeConfig(kv_swap=True)
    with pytest.raises(ValueError):
        ServeConfig(paged=True, kv_swap=True, swap_tier="nvme")


def test_priority_orders_preemption_victims(model):
    """Lower ``Request.priority`` preempts first, on both engines."""
    prompts = _prompts(11, (8,) * 4)
    swapped = []
    for trc, eng in zip((jtracing, tracing),
                        _engines(model, slots=4, kv_blocks=10, kv_swap=True,
                                 **TIGHT)):
        prev = trc.current_recorder()
        trc.set_recorder(trc.FlightRecorder(replica="test"))
        try:
            low = eng.submit(prompts[0].copy(), max_new=12, priority=-1)
            rest = [eng.submit(p.copy(), max_new=12) for p in prompts[1:]]
            eng.run_until_drained()
            assert low.done and all(r.done for r in rest)
            swaps = [e["rid"] for e in trc.current_recorder().events()
                     if e["kind"] == "kv_swap_out"]
        finally:
            trc.set_recorder(prev)
        assert swaps and set(swaps) == {low.rid}
        swapped.append(len(swaps))
    assert swapped[0] == swapped[1]


# ----------------------------------------------------------------------
# export / import (tests/test_kv_lifecycle.py:170-222)
WARM = dict(max_len=48, slots=2, sync_every=4, paged=True, block_size=8,
            kv_blocks=24, prefix_cache=True)


def _served(eng, prompt, max_new):
    (r,) = _drain(eng, [prompt], max_new)
    return r


@pytest.mark.parametrize("direction", ["port_to_port", "jax_to_port",
                                       "port_to_jax"])
def test_export_import_resumes_warm(model, direction):
    """Engine A serves a prompt and exports its prefix cache; engine B
    adopts the frame (free blocks only, idempotently) and serves the
    continuation warm, with the tokens of a cold JAX engine.  The frame
    crosses between the packages in both directions."""
    prompt = _prompts(13, (17,))[0]
    pick = {"port_to_port": (1, 1), "jax_to_port": (0, 1),
            "port_to_jax": (1, 0)}[direction]
    a = _engines(model, **WARM)[pick[0]]
    ra = _served(a, prompt, 8)
    state = a.export_kv_state()
    assert state["kind"] == "kv_blocks" and state["block_size"] == 8
    assert len(state["hashes"]) == 2
    b = _engines(model, **WARM)[pick[1]]
    free_before = b.alloc.free_blocks
    n = b.import_kv_state(state)
    assert n == len(state["hashes"])
    assert b.alloc.cached_blocks == n
    assert b.alloc.free_blocks == free_before - n
    assert b.import_kv_state(state) == 0        # idempotent
    cont = np.concatenate([prompt, np.asarray(ra.out_tokens, np.int32)])
    rb = _served(b, cont, 6)
    assert b.metrics.snapshot().get("engine.prefix_hit_blocks", 0) == n
    cold = _served(_engines(model, **WARM)[0], cont, 6)
    assert rb.out_tokens == cold.out_tokens


def test_export_frame_equals_jax(model):
    """fp32: after the same serve both engines export the same hashes and
    byte-identical frames, up to the fp32 rounding of the rows (the
    frames' headers and shapes are equal and the rows allclose)."""
    prompt = _prompts(14, (25,))[0]
    jeng, teng = _engines(model, **WARM)
    for eng in (jeng, teng):
        _served(eng, prompt, 4)
    js, ts = jeng.export_kv_state(), teng.export_kv_state()
    assert ts["hashes"] == js["hashes"]
    ja, ta = unpack_block_arrays(js["data"]), unpack_block_arrays(ts["data"])
    assert [(a.dtype.str, a.shape) for a in ta] == \
        [(a.dtype.str, a.shape) for a in ja]
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_import_rejects_mismatched_state(model):
    _, teng = _engines(model, **WARM)
    assert teng.import_kv_state(None) == 0
    assert teng.import_kv_state({"kind": "other"}) == 0
    assert teng.import_kv_state({"kind": "kv_blocks", "block_size": 16,
                                 "hashes": [], "data": b""}) == 0
    dense = Engine(model[3], model[1], ServeConfig(max_len=32),
                   device="cpu")
    assert dense.export_kv_state() is None
    assert dense.import_kv_state({"kind": "kv_blocks", "block_size": 16,
                                  "hashes": [], "data": b""}) == 0
    assert teng.export_kv_state() is None       # nothing cached yet
    teng.flush_kv()                             # a no-op on the port


def test_bf16_frame_is_byte_identical_to_jax():
    """bf16 pools holding the same rows: the port's frame of three blocks
    is JAX's byte for byte (the rows as ``<V2``), and the port reads a
    JAX bf16 frame back into its pool bit for bit."""
    jcfg, tcfg = _cfgs(dtype="bfloat16", param_dtype="bfloat16")
    jparams, tparams = _carry(jcfg, tcfg)
    kw = dict(max_len=32, slots=2, sync_every=4, paged=True, block_size=8)
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
    teng = Engine(tparams, tcfg, ServeConfig(**kw), device="cpu")
    rng = np.random.RandomState(21)
    leaves = jax.tree_util.tree_leaves(jeng.caches)
    rows = [rng.randn(*leaf.shape).astype(ml_dtypes.bfloat16)
            for leaf in leaves]
    jeng.caches = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jeng.caches),
        [jnp.asarray(r) for r in rows])
    for pool, r in zip(teng.fns.pools(teng.caches), rows):
        pool.copy_(torch.from_numpy(r.view(np.int16)).view(torch.bfloat16))
    blocks = [3, 1, 6]
    frame = jeng._gather_block_rows(blocks)
    assert teng._gather_block_rows(blocks) == frame
    assert np.dtype(unpack_block_arrays(frame)[0].dtype).str == "|V2"
    other = Engine(tparams, tcfg, ServeConfig(**kw), device="cpu")
    other._scatter_block_rows([2, 4, 5], unpack_block_arrays(frame))
    assert other._gather_block_rows([2, 4, 5]) == frame


@pytest.mark.parametrize("tier", ["host", "artifact"])
def test_serve_driver_speculative_and_swap_flags(tmp_path, capsys, tier):
    """``launch/serve.py --paged --speculative --kv-swap`` on a tight pool:
    every request completes with all its tokens, sessions swap out and
    back in as often, and the verify windows ran."""
    from repro_torch.launch import serve
    prom = tmp_path / "metrics.txt"
    serve.main(["--device", "cpu", "--reduce", "--paged", "--block-size",
                "8", "--speculative", "--kv-swap", "--swap-tier", tier,
                "--kv-blocks", "6", "--requests", "8", "--slots", "8",
                "--max-len", "32", "--max-new", "12", "--prom-out",
                str(prom)])
    assert "kv=paged reqs=8 tokens=104 " in capsys.readouterr().out
    got = dict(line.split() for line in prom.read_text().splitlines()
               if line.startswith("repro_engine_"))
    assert int(got["repro_engine_kv_swap_out"]) > 0
    assert got["repro_engine_kv_swap_in"] == got["repro_engine_kv_swap_out"]
    assert "repro_engine_kv_pool_exhausted" not in got
    assert int(got["repro_engine_spec_proposed"]) > 0
