"""PyTorch port vs the JAX package: the sharding specs of the multi-device
layer (``core/sharding.py``, ``core/broadcast.py``, ``launch/mesh.py``,
``launch/steps.py``), which need a mesh's names and sizes alone.

JAX builds its specs on an ``AbstractMesh`` in this process; the port on
``launch.mesh.abstract_mesh``.  For every arch's reduced config, every
policy and the mesh shapes (1, 2), (2, 2) and (2, 16, 16), the port's
parameter specs, logical axes, cache specs, batch specs, optimizer specs
and per-chip bytes equal JAX's.  A JAX ``PartitionSpec`` is compared as
the tuple it iterates as.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.core import broadcast as jbroadcast  # noqa: E402
from repro.core import sharding as jsharding  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import broadcast, collectives, sharding  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api, weights  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

POLICIES = ("broadcast", "tp", "fsdp_tp", "seqtp")
MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_flat(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def _jspecs(tree):
    return {k: tuple(s.spec) for k, s in _jax_flat(tree).items()}


def _specs(tree):
    return {k: s.spec for k, s in flatten_with_paths(tree).items()}


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), tmesh.abstract_mesh(shape, axes)


_ABSTRACT = {}


def _models(arch):
    if arch not in _ABSTRACT:
        jcfg = jax_reduced(jax_get_config(arch))
        tcfg = reduced(get_config(arch))
        jparams, jaxes = japi.abstract_params(jcfg)
        _ABSTRACT[arch] = (jcfg, tcfg, jparams, jaxes)
    return _ABSTRACT[arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_axes_and_per_chip_bytes_equal_jax(arch, mesh):
    """Under every policy: each leaf's spec, and the bytes a chip holds;
    the logical axes ``api.init(..., with_axes=True)`` returns."""
    jcfg, tcfg, jparams, jaxes = _models(arch)
    jm, tm = _meshes(mesh)
    params, axes = api.init(torch.Generator().manual_seed(0), tcfg, "cpu",
                            with_axes=True)
    is_axes = sharding.is_axes
    assert _jax_flat(jaxes, is_leaf=is_axes) == \
        flatten_with_paths(axes, is_leaf=is_axes)
    assert axes == weights.param_axes(tcfg)
    for policy in POLICIES:
        jsh = jbroadcast.placement_shardings(jaxes, jm, policy)
        tsh = broadcast.placement_shardings(axes, tm, policy)
        assert _specs(tsh) == _jspecs(jsh), policy
        assert broadcast.per_chip_bytes(params, tsh) == \
            jbroadcast.per_chip_bytes(jparams, jsh), policy
        jopt = jsteps.opt_shardings(jsh)
        assert _specs(steps.opt_shardings(tsh)) == _jspecs(jopt), policy
        ctx = sharding.ShardingCtx(tm, policy,
                                   sharding._rules(policy, tm.axis_names))
        jctx = jsharding.ShardingCtx(jm, policy,
                                     jsharding._rules(policy, jm.axis_names))
        assert _specs(steps.shardings_like(axes, ctx)) == \
            _jspecs(jsteps.shardings_like(jaxes, jctx))
        for extra in (0, 1, 3):
            assert sharding.batch_spec(ctx, extra) == \
                tuple(jsharding.batch_spec(jctx, extra))
    assert broadcast.broadcast_bytes(params) == \
        jbroadcast.broadcast_bytes(jparams)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_jax(arch, mesh):
    """``cache_specs`` at batches below, at and above the data axes, with
    and without ``shard_seq``, and ``batch_shardings`` of a train batch,
    under every policy."""
    jcfg, tcfg, _, _ = _models(arch)
    jm, tm = _meshes(mesh)
    shapes = {"tokens": (4, 16), "frames": (4, 16, 8)}
    jshapes = {k: jax.ShapeDtypeStruct(v, "float32")
               for k, v in shapes.items()}
    tshapes = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
    for policy in POLICIES:
        for batch in (1, 4, 64):
            for shard_seq in (False, True):
                try:
                    want = jsteps.cache_specs(jcfg, jm, 64, batch, policy,
                                              shard_seq)
                except Exception as e:  # noqa: BLE001 - JAX's own error
                    # JAX's own spec maps "model" twice (the batch axes of
                    # "broadcast" hold it already): both refuse it
                    assert type(e).__name__ == "DuplicateSpecError", e
                    with pytest.raises(ValueError, match="more than one"):
                        steps.cache_specs(tcfg, tm, 64, batch, policy,
                                          shard_seq)
                    continue
                got = steps.cache_specs(tcfg, tm, 64, batch, policy,
                                        shard_seq)
                assert _specs(got) == _jspecs(want), (policy, batch)
        assert flatten_with_paths(steps.cache_logical_axes(tcfg, 64),
                                  is_leaf=sharding.is_axes) == \
            _jax_flat(jsteps.cache_logical_axes(jcfg, 64),
                      is_leaf=sharding.is_axes)
        assert _specs(steps.batch_shardings(tcfg, tm, policy, tshapes)) == \
            _jspecs(jsteps.batch_shardings(jcfg, jm, policy, jshapes))


@pytest.mark.parametrize("policy", POLICIES)
def test_spec_for_equals_jax_on_every_logical_axis_tuple(policy):
    """``spec_for`` of each logical name alone, of pairs (a mesh axis is
    used once), and of unknown names, on every mesh shape."""
    names = ("batch", "seq", "embed", "ff", "heads", "kv_heads", "vocab",
             "experts", "inner", "lru", "layers", "sv", "feat", None)
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        jctx = jsharding.ShardingCtx(jm, policy,
                                     jsharding._rules(policy, jm.axis_names))
        ctx = sharding.ShardingCtx(tm, policy,
                                   sharding._rules(policy, tm.axis_names))
        for a in names:
            for b in names:
                assert ctx.spec_for((a, b)) == tuple(jctx.spec_for((a, b)))
        assert ctx.spec_for(()) == tuple(jctx.spec_for(()))


def test_abstract_mesh_and_local_slices():
    """Names and sizes without ranks; a spec cuts a leaf into row-major
    blocks of its axes, as ``jax.device_put`` lays them out."""
    m = tmesh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert m.axis_size(("model", "pod")) == 32
    assert m.axes_key(("model", "pod")) == ("pod", "model")
    with pytest.raises(ValueError, match="not distinct axes"):
        m.axes_key(("data", "data"))
    with pytest.raises(RuntimeError, match="abstract mesh"):
        m.group("data")
    x = torch.arange(4 * 6).reshape(4, 6)
    for rank in range(4):
        mm = tmesh.Mesh((2, 2), ("data", "model"), ranks=range(4), rank=rank)
        d, mo = divmod(rank, 2)
        s = sharding.NamedSharding(mm, ("data", "model"))
        assert torch.equal(s.local_slice(x),
                           x[2 * d:2 * d + 2, 3 * mo:3 * mo + 3])
        s2 = sharding.NamedSharding(mm, (("data", "model"), None))
        assert torch.equal(s2.local_slice(x), x[rank:rank + 1])
        assert s2.n_shards() == 4
    with pytest.raises(ValueError, match="does not split"):
        sharding.NamedSharding(mm, (None, ("data", "model"))).local_slice(
            torch.zeros(2, 5))


def test_production_mesh_raises_on_a_small_world():
    """(16, 16) needs 256 ranks and (2, 16, 16) 512, as ``jax.make_mesh``
    needs the devices; this process is a world of one."""
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_local_mesh(1, 2)


def test_nccl_with_more_ranks_than_cards_raises():
    """NCCL refuses two ranks on one card: asking for it raises before any
    process starts, and names gloo; nothing falls back unasked."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one "
                                         "card"):
        collectives.spawn(math.prod, n + 1, backend="nccl", device="cuda",
                          timeout_s=5)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        collectives.check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="backend must be"):
        collectives.check_backend("mpi", 1, "cpu")
    collectives.check_backend("gloo", 8, "cuda")


def test_shard_checks_rank_and_refuses_weight_sharded_policies():
    """``shard`` checks the rank under every policy and returns ``x``
    (each rank holds its own rows already); under ``tp`` / ``fsdp_tp`` it
    no longer refuses (item 14's tensor-parallel layers).  What a rank's
    ``heads`` block computes at the production mesh's 16-way ``model``
    axis: whole heads for internlm2-1.8b (one head, G_local 1), half a
    head for gemma3-4b, 1.5 heads for starcoder2-3b (the two heads it
    touches, both of one kv head), 160 of recurrentgemma-2b's 256
    (MQA: kv head 0)."""
    m = tmesh.abstract_mesh((1, 2), ("data", "model"))
    x = torch.zeros(2, 3)
    assert sharding.shard(x, "batch", "embed") is x
    for policy in ("broadcast", "seqtp", "tp", "fsdp_tp"):
        with sharding.use_sharding(m, policy):
            assert sharding.shard(x, "batch", "embed") is x
            with pytest.raises(ValueError, match="vs rank 2"):
                sharding.shard(x, "batch")
            assert (sharding.tp_mesh() is m) == (policy in ("tp",
                                                            "fsdp_tp"))
    prod = tmesh.abstract_mesh((16, 16), ("data", "model"), rank0=True)
    for arch, want in (("internlm2-1.8b", (0, 128, 0, 1, 0, 1, False)),
                       ("gemma3-4b", (0, 128, 0, 1, 0, 1, True)),
                       ("starcoder2-3b", (0, 192, 0, 2, 0, 1, True)),
                       ("recurrentgemma-2b", (0, 160, 0, 1, 0, 1, True))):
        c = get_config(arch)
        hb = sharding.head_block(c.n_heads, c.n_kv_heads, c.head_dim, prod)
        assert (hb.c0, hb.c1, hb.h0, hb.h1, hb.kv0, hb.kv1, hb.cuts) == \
            want, arch
    # whole heads of one kv head keep their block; whole heads over two
    # kv heads that end mid-group take whole groups (gathered q)
    two = tmesh.abstract_mesh((1, 2), ("data", "model"), rank0=True)
    two.coords = {"data": 0, "model": 1}
    hb = sharding.head_block(6, 2, 16, two)          # heads 3..5, G 3
    assert (hb.h0, hb.h1, hb.kv0, hb.kv1, hb.cuts) == (3, 6, 1, 2, False)
    hb = sharding.head_block(6, 3, 16, two)          # heads 3..5, G 2
    assert (hb.h0, hb.h1, hb.kv0, hb.kv1, hb.cuts) == (2, 6, 1, 3, True)
    hb = sharding.head_block(4, 2, 16, tmesh.abstract_mesh(
        (1, 4), ("data", "model"), rank0=True))
    assert (hb.h0, hb.h1, hb.kv0, hb.kv1, hb.cuts) == (0, 1, 0, 1, False)
    assert sharding.current_ctx() is None
    with pytest.raises(ValueError, match="unknown policy"):
        sharding._rules("zero3", ("data",))
