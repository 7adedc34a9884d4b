"""PyTorch port vs the JAX package: AdamW, the cosine schedule, global-norm
clipping and gradient compression (``optim/``), on random trees made with
numpy and handed to both.

Tolerance: fp32 at ``rtol = 1e-6`` (and ``atol = 1e-7`` for values near
zero), the same elementwise arithmetic in the same order on both sides;
the round-to-nearest int8 payload must be equal, since ``jnp.round`` and
``torch.round`` both round half to even.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.tree import (flatten_with_paths, tree_leaves,  # noqa: E402
                              tree_map)

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(rng, scale=1.0):
    """A nested tree of dicts and lists with leaves of several shapes."""
    r = lambda *s: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    return {"embedding": {"table": r(11, 6)}, "final_norm": {"w": r(6)},
            "groups": [[{"mixer": {"wq": r(2, 6, 4)}, "ln1": {"w": r(2, 6)}}]]}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _close_trees(got, want):
    flat = flatten_with_paths(got)
    jflat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(flat) == sorted(jflat)
    for k, v in flat.items():
        _close(v.numpy(), jflat[k])


@pytest.mark.parametrize("total,warmup", [(10, 3), (50, 0), (5, 10)])
def test_cosine_schedule_matches_jax(total, warmup):
    for step in range(0, total + 4):
        got = adamw.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                    peak_lr=3e-4, warmup=warmup, total=total)
        want = jadamw.cosine_schedule(jnp.asarray(step, jnp.int32),
                                      peak_lr=3e-4, warmup=warmup,
                                      total=total)
        assert got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_clip_by_global_norm_matches_jax(scale):
    """Both below and above the clip norm, and a bf16 leaf promoted to
    fp32 as JAX promotes it."""
    tree = _tree(np.random.RandomState(0), scale)
    got, gn = adamw.clip_by_global_norm(_torch(tree), 1.0)
    want, jgn = jadamw.clip_by_global_norm(_jax(tree), 1.0)
    _close(gn, jgn)
    _close_trees(got, want)
    bf = {"a": torch.ones(3, dtype=torch.bfloat16) * 5}
    got, _ = adamw.clip_by_global_norm(bf, 1.0)
    want, _ = jadamw.clip_by_global_norm({"a": jnp.ones(3, jnp.bfloat16) * 5},
                                         1.0)
    assert got["a"].dtype == torch.float32 and want["a"].dtype == jnp.float32
    _close(got["a"], want["a"])


@pytest.mark.parametrize("lr", [1e-2, 3e-4])
def test_adamw_matches_jax_over_steps(lr):
    """Five steps on the same gradients: parameters, m, v and the int32
    step count agree; the decay reaches every leaf."""
    rng = np.random.RandomState(1)
    params = _tree(rng)
    tp, jp = _torch(params), _jax(params)
    ts, js = adamw.adamw_init(tp), jadamw.adamw_init(jp)
    assert ts.step.dtype == torch.int32 and ts.step.dim() == 0
    for _ in range(5):
        g = _tree(rng, 0.1)
        tp, ts = adamw.adamw_update(tp, _torch(g), ts, lr=lr)
        jp, js = jadamw.adamw_update(jp, _jax(g), js, lr=lr)
        _close_trees(tp, jp)
        _close_trees(ts.m, js.m)
        _close_trees(ts.v, js.v)
        assert int(ts.step) == int(js.step)
    assert ts.step.dtype == torch.int32


def test_adamw_step_zero_is_a_noop_and_keeps_dtypes():
    """lr comes from the step count before the increment, so step 0 (lr
    0) leaves the parameters bit for bit, while m and v move; a bf16
    parameter stays bf16 with fp32 moments."""
    params = {"w": torch.randn(4, 3).to(torch.bfloat16),
              "b": torch.randn(3)}
    st = adamw.adamw_init(params)
    lr = adamw.cosine_schedule(st.step, peak_lr=1e-2, warmup=5, total=20)
    assert float(lr) == 0.0
    grads = tree_map(lambda p: torch.ones_like(p), params)
    new, st2 = adamw.adamw_update(params, grads, st, lr=lr)
    assert torch.equal(new["w"], params["w"]) and new["w"].dtype == \
        torch.bfloat16
    assert torch.equal(new["b"], params["b"])
    assert st2.m["w"].dtype == torch.float32 and bool((st2.m["w"] > 0).all())
    assert int(st2.step) == 1


def test_quantize_round_to_nearest_payload_equals_jax():
    """Half-way values round to even on both sides: the int8 payload is
    equal, scale and residual agree; the residual carries over a second
    step, and the tree forms and the wire ratio match too."""
    rng = np.random.RandomState(2)
    g = rng.randn(64).astype(np.float32)
    g[:4] = [0.5, 1.5, 2.5, -3.5]
    g[4] = 127.0                          # scale 1: x = g exactly
    res = None
    jres = None
    for _ in range(2):
        c, res = compression.quantize(torch.from_numpy(g), res)
        jc, jres = jcomp.quantize(jnp.asarray(g), jres)
        assert c.q.dtype == torch.int8
        np.testing.assert_array_equal(c.q.numpy(), np.asarray(jc.q))
        _close(c.scale, jc.scale)
        _close(res, jres)
        _close(compression.dequantize(c), jcomp.dequantize(jc))
    np.testing.assert_array_equal(c.q[:4].numpy(), np.asarray(jc.q[:4]))
    tree = _tree(rng)
    ct, rt = compression.tree_quantize(_torch(tree))
    jct, jrt = jcomp.tree_quantize(_jax(tree))
    leaves, jleaves = tree_leaves(ct), jax.tree_util.tree_leaves(jct)
    assert len(leaves) == len(jleaves) == 8        # (q, scale) of 4 leaves
    for a, b in zip(leaves, jleaves):
        assert a.dtype == (torch.int8 if b.dtype == jnp.int8 else
                           torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close_trees(rt, jrt)
    _close_trees(compression.tree_dequantize(ct), jcomp.tree_dequantize(jct))
    assert compression.compression_ratio(_torch(tree)) == \
        jcomp.compression_ratio(_jax(tree))


def test_stochastic_rounding_is_unbiased_and_psum_raises():
    """The port's noise comes from a torch.Generator: reproducible for a
    seed, unbiased in the mean (JAX's draws cannot be reproduced, so the
    two match only in distribution)."""
    g = torch.full((20000,), 0.3)
    g[0] = 127.0
    gen = torch.Generator().manual_seed(0)
    c, _ = compression.quantize(g, generator=gen)
    c2, _ = compression.quantize(g, generator=torch.Generator().manual_seed(0))
    assert torch.equal(c.q, c2.q)
    assert set(c.q[1:].tolist()) == {0, 1}
    assert abs(c.q[1:].float().mean().item() - 0.3) < 0.02
    # the psum (the name kept from when it raised): over an axis of one
    # rank it is the rank's own dequantized gradient and payload; with no
    # mesh named or in context it raises.  tests/test_torch_dist_pipeline.py
    # holds it against JAX's shard_map reduction on 4 ranks
    from repro_torch.core.sharding import use_sharding
    from repro_torch.launch.mesh import abstract_mesh
    val, raw = compression.compressed_psum(
        c, "data", abstract_mesh((1,), ("data",)))
    assert torch.equal(val, compression.dequantize(c))
    assert raw.dtype == torch.int32 and torch.equal(raw, c.q.int())
    with use_sharding(abstract_mesh((1, 1), ("data", "model"))):
        val2, _ = compression.compressed_psum(c, "data")
    assert torch.equal(val2, val)
    with pytest.raises(RuntimeError, match="a collective needs a mesh"):
        compression.compressed_psum(c, "data")
