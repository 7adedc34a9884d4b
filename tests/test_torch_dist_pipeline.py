"""PyTorch port vs the JAX package on several ranks: the sharded MARGOT
batch step (the claim shuffle), ``ElasticRunner`` and the autoscaler's
resize protocol, ``compressed_psum`` and ``Checkpointer.restore(...,
shardings=)``.

JAX runs in a subprocess with ``--xla_force_host_platform_device_count=4``
(its own XLA flags must be set before it starts) and writes its inputs
and results to an ``.npz``; the port runs on 4 ranks spawned over gloo
on the CPU (``collectives.spawn``, each rank's body in
``torch_dist_ranks``), on the same inputs.  Scores within the pipeline
tests' ``TOL``; links, indices and counts exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks as ranks  # noqa: E402
from repro_torch.core import collectives  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL = dict(rtol=1e-4, atol=1e-4)
TIMEOUT_S = 120

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.fault import ElasticRunner
from repro.core.pipeline import PipelineConfig, make_batch_step, extract_links
from repro.core.sharding import shard_map_compat
from repro.data.text import synthetic_corpus, corpus_arrays, margot_models
from repro.optim.compression import quantize, compressed_psum

out_path = sys.argv[1]
devs = np.array(jax.devices())
res = {}
# the sharded step on 4 shards (as tests/test_pipeline.py, 4 not 8)
pcfg = PipelineConfig(feat_dim=256, claim_capacity=16, evid_capacity=32)
models, axes = margot_models(pcfg)
X, keys, _ = corpus_arrays(synthetic_corpus(4, 32, seed=5), dim=256)
mesh4 = Mesh(devs.reshape(4), ("data",))
o = make_batch_step(pcfg, mesh=mesh4)(models, jnp.asarray(X),
                                      jnp.asarray(keys))
for k, v in o._asdict().items():
    res["out/" + k] = np.asarray(v)
res["links"] = np.array([(c, e, s) for c, e, s in extract_links(o)])
for name, tree in models.items():
    for k, v in tree.items():
        res[f"{name}/{k}"] = np.asarray(v)
res.update(X=X, keys=keys, feat_dim=256, claim_capacity=16,
           evid_capacity=32)
# ElasticRunner 4 -> 2 (as tests/test_fault.py, 4 -> 2 not 8 -> 4, at
# capacities the 2-shard compaction does not overflow)
pcfg_e = PipelineConfig(feat_dim=128, claim_capacity=32, evid_capacity=32)
models_e, axes_e = margot_models(pcfg_e)
Xe, keys_e, _ = corpus_arrays(synthetic_corpus(2, 32, seed=6), dim=128)
runner = ElasticRunner(models_e, axes_e, mesh4, policy="broadcast")
o4 = make_batch_step(pcfg_e, mesh=mesh4)(runner.params, jnp.asarray(Xe),
                                         jnp.asarray(keys_e))
mesh2 = Mesh(devs[:2].reshape(2), ("data",))
runner.rescale(mesh2)
o2 = make_batch_step(pcfg_e, mesh=mesh2)(runner.params, jnp.asarray(Xe),
                                         jnp.asarray(keys_e))
res["e/links4"] = np.array(sorted((c, e) for c, e, _ in extract_links(o4)))
res["e/links2"] = np.array(sorted((c, e) for c, e, _ in extract_links(o2)))
res["e/dropped"] = np.array([int(o4.n_dropped), int(o2.n_dropped)])
res["e/gen"] = runner.generation
np.savez(out_path + ".elastic.npz", X=Xe, keys=keys_e, feat_dim=128,
         claim_capacity=32, evid_capacity=32,
         **{f"{n}/{k}": np.asarray(v) for n, t in models_e.items()
            for k, v in t.items()})
# compressed_psum over 4 shards (as tests/test_compression.py, 4 not 8)
G = jax.random.normal(jax.random.PRNGKey(0), (4, 512))
def reduce_fn(g):
    c, _ = quantize(g[0])
    val, raw = compressed_psum(c, "data")
    return val[None], raw[None]
val, raw = jax.jit(shard_map_compat(
    reduce_fn, mesh=mesh4, in_specs=(P("data", None),),
    out_specs=(P("data", None), P("data", None))))(G)
res.update(G=np.asarray(G), psum_val=np.asarray(val), psum_raw=np.asarray(raw))
np.savez(out_path, **res)
# a checkpoint of the reduced arch, restored on a (2, 2) mesh under tp:
# each device's shard of every leaf
from repro.checkpoint import Checkpointer
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config
from repro.configs.base import reduced
from repro.core.broadcast import placement_shardings
from repro.models import api
cfg = reduced(get_config(sys.argv[3]))
params, paxes = api.init(jax.random.PRNGKey(0), cfg)
ck = Checkpointer(sys.argv[2])
ck.save(1, params)
mesh22 = Mesh(devs.reshape(2, 2), ("data", "model"))
placed = ck.restore(params, shardings=placement_shardings(paxes, mesh22,
                                                          "tp"))
shards = {}
for k, v in _flatten_with_paths(placed)[0].items():
    for s in v.addressable_shards:
        shards[f"{s.device.id}|{k}"] = np.asarray(s.data, np.float32)
np.savez(out_path + ".restore.npz", **shards)
print("JAX-OK")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_pipeline")
    path = str(d / "jax.npz")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, path,
                        str(d / "ckpt"), "internlm2-1.8b"],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "JAX-OK" in r.stdout, r.stdout + r.stderr
    with np.load(path) as f:
        res = {k: f[k] for k in f.files}
    return path, str(d / "ckpt"), res


def _spawn(fn, *args):
    return collectives.spawn(fn, 4, backend="gloo", device="cpu",
                             timeout_s=TIMEOUT_S, args=args, threads=1)


def test_sharded_batch_step_equals_jax_on_four_shards(jax_run):
    """Each rank's (C_total, E_local) block, its claims (all-gathered, the
    shuffle) and its own evidence equal JAX's ``out_specs`` blocks of its
    4-shard step on the same corpus and models; the gathered links and
    their scores equal JAX's ``extract_links``."""
    path, _, want = jax_run
    got = _spawn(ranks.pipeline_rank, path)
    E = want["out/evid_index"].shape[0] // 4
    for r, g in enumerate(got):
        o = g["out"]
        cols = slice(r * E, (r + 1) * E)
        for f in ("claim_index", "claim_keys", "n_dropped"):
            np.testing.assert_array_equal(o[f], want["out/" + f], f)
        for f in ("evid_index", "evid_keys"):
            np.testing.assert_array_equal(o[f], want["out/" + f][cols], f)
        np.testing.assert_array_equal(o["pair_valid"],
                                      want["out/pair_valid"][:, cols])
        np.testing.assert_allclose(o["link_scores"],
                                   want["out/link_scores"][:, cols], **TOL)
        assert g["links"] == got[0]["links"]
    jl = {(int(c), int(e)): s for c, e, s in want["links"]}
    tl = {(c, e): s for c, e, s in got[0]["links"]}
    assert set(tl) == set(jl) and len(tl) > 20
    np.testing.assert_allclose([tl[k] for k in sorted(tl)],
                               [jl[k] for k in sorted(jl)], **TOL)


def test_elastic_rescale_and_autoscaler_protocol(jax_run):
    """``ElasticRunner`` 4 -> 2: rank 0's models shipped to every rank,
    the same links on both meshes as JAX's runner gives (nothing dropped
    on either), ranks 2 and 3 drop their weights; then the autoscaler on
    rank 0 scales 2 -> 3 -> 2 and the followers rescale with it: every
    rank of each new mesh holds rank 0's models, the others none; its
    ``start()`` refuses to tick on a thread of its own on several ranks."""
    path, _, want = jax_run
    got = _spawn(ranks.elastic_rank, path + ".elastic.npz")
    links4 = [tuple(x) for x in want["e/links4"].tolist()]
    assert list(want["e/dropped"]) == [0, 0] and int(want["e/gen"]) == 1
    assert want["e/links4"].tolist() == want["e/links2"].tolist()
    for r, g in enumerate(got):
        assert g["placed_equal"] and g["dropped4"] == 0
        assert sorted((c, e) for c, e, _ in g["links4"]) == links4
        assert g["gen"] == 1 and g["member2"] == (r < 2)
        assert g["dropped_weights"] == (r >= 2)
        assert g["shipped"] == (0 if r >= 2 else sum(
            v.nbytes for k, v in np.load(path + ".elastic.npz").items()
            if "/" in k))
        if r < 2:
            assert g["dropped2"] == 0
            assert sorted((c, e) for c, e, _ in g["links2"]) == \
                [tuple(x) for x in want["e/links2"].tolist()]
        assert g["gen_after"] == 3 and g["holds"] == (r < 2)
    assert got[0]["events"] == [("up", 3), ("down", 2)]
    assert got[0]["start_refused"]
    assert [g["followed"] for g in got[1:]] == [2, 2, 2]
    assert got[1]["sum"] == got[0]["sum"]


def test_compressed_psum_equals_jax_on_four_ranks(jax_run):
    """Each rank's int8 payload summed in int32, the scales maxed, the
    rescaled payloads summed: the same raw sum as JAX's ``shard_map``
    reduction, the value within fp32 rounding of it, and the mean within
    one quantisation step of the true mean (JAX's bound)."""
    path, _, want = jax_run
    got = _spawn(ranks.compressed_rank, path)
    G = want["G"]
    for r, (val, raw) in enumerate(got):
        np.testing.assert_array_equal(raw, want["psum_raw"][r])
        np.testing.assert_allclose(val, want["psum_val"][r], rtol=1e-6,
                                   atol=1e-6)
        err = np.max(np.abs(val / 4.0 - G.mean(0)))
        assert err <= np.max(np.abs(G)) / 127.0


def test_restore_with_shardings_across_meshes(jax_run):
    """A step JAX wrote, restored by the port on a (2, 2) mesh under
    ``tp``: each rank's slice of every leaf equals JAX's shard of it on
    the device at the same mesh position (``device_put`` on
    ``placement_shardings``), and the slices reassemble the whole tree."""
    path, ckpt, _ = jax_run
    got = _spawn(ranks.restore_rank, ckpt, "internlm2-1.8b")
    with np.load(path + ".restore.npz") as f:
        want = {k: f[k] for k in f.files}
    for r, (part, whole_ok, shapes) in enumerate(got):
        assert whole_ok
        for k, v in part.items():
            np.testing.assert_array_equal(v, want[f"{r}|{k}"], k)
        assert {k.split("|")[1] for k in want if k.startswith(f"{r}|")} \
            == set(part)
        split = [k for k in part if part[k].shape != shapes[k]]
        assert "groups/0/0/mixer/wq" in split and "embedding/table" in split
