"""PyTorch port vs the JAX package: data-parallel training
(``steps.make_train_step(..., mesh=)`` under ``broadcast``).

Three AdamW steps of the two-layer reduced internlm2-1.8b and of the
reduced whisper-base (2 + 2 layers) on 2 ranks spawned over gloo, each
taking 2 of the batch's 4 rows, against JAX's jitted ``make_train_step``
on the whole batch (GSPMD's data parallelism gives the one-device
numbers: ``tests/test_fault.py``'s mesh invariance) and against the
port's one-rank step on the whole batch: losses, grad norms and lr at
rtol 1e-5, m and v within 1e-5 of each leaf's largest magnitude, the
parameters within 1e-3 * lr (``tests/test_torch_train.py``'s
tolerances).  After every step the two ranks' parameters are
bit-identical.  MoE, ``seqtp`` and the weight-sharded policies raise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from repro.checkpoint.checkpointer import _flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ScanGroup as JScanGroup  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.launch.steps import \
    make_train_step as jmake_train_step  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

RTOL = 1e-5
LR = ranks.DP_HYPER["lr"]
B = 4


def _jax_config(case):
    cfg = jax_reduced(jax_get_config(ranks.DP_CASES[case]))
    if case == "internlm2":
        return cfg.replace(n_layers=2, groups=(JScanGroup(("A",), 2),))
    return cfg.replace(enc_layers=2, dec_layers=2, n_layers=4)


def _batches(cfg, case):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(3):
        b = {"tokens": rng.randint(0, cfg.vocab, (B, 12)).astype(np.int32)}
        if case == "whisper":
            b["frames"] = rng.randn(B, 20, cfg.d_model).astype(np.float32)
        out.append(b)
    return out


def _flat(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree)[0].items()}


@pytest.fixture(scope="module", params=["internlm2", "whisper"])
def runs(request, tmp_path_factory):
    """JAX's three steps and the port's one-rank three steps in this
    process, the port's data-parallel three on 2 ranks."""
    case = request.param
    jcfg = _jax_config(case)
    jparams = jax.jit(lambda k: japi.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    flat = _flat(jparams)
    batches = _batches(jcfg, case)
    path = str(tmp_path_factory.mktemp("dp") / f"{case}.npz")
    np.savez(path, **{f"p/{k}": v for k, v in flat.items()},
             **{f"b{i}/{k}": v for i, b in enumerate(batches)
                for k, v in b.items()})
    jfn = jax.jit(jmake_train_step(jcfg, **ranks.DP_HYPER))
    p, opt, jax_out = jparams, jadamw_init(jparams), []
    for b in batches:
        p, opt, m = jfn(p, opt, {k: jnp.asarray(v) for k, v in b.items()})
        jax_out.append({k: float(v) for k, v in m.items()})
    jax_final = (_flat(p), _flat(opt.m), _flat(opt.v))
    tcfg = ranks.dp_config(case)
    tp = weights.params_from_numpy(flat, tcfg, "cpu")
    topt, one_out = adamw_init(tp), []
    fn = steps.make_train_step(tcfg, **ranks.DP_HYPER)
    for b in batches:
        tp, topt, m = fn(tp, topt, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        one_out.append({k: float(v) for k, v in m.items()})
    num = lambda t: {k: v.numpy() for k, v in  # noqa: E731
                     flatten_with_paths(t).items()}
    one_final = (num(tp), num(topt.m), num(topt.v))
    dp = collectives.spawn(ranks.dp_rank, 2, backend="gloo", device="cpu",
                           timeout_s=120, args=(path, case), threads=2)
    return case, jax_out, jax_final, one_out, one_final, dp


def _close(got, want):
    scale = lambda r: RTOL * float(np.abs(r).max())  # noqa: E731
    for g, w, atol in zip(got, want, (lambda r: 1e-3 * LR, scale, scale)):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, rtol=RTOL,
                                       atol=atol(w[k]))


def test_data_parallel_steps_equal_jax_and_one_rank(runs):
    case, jax_out, jax_final, one_out, one_final, dp = runs
    (out0, *final0), (out1, *final1) = dp
    for i in range(3):
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            for want in (jax_out[i][key], one_out[i][key]):
                np.testing.assert_allclose(out0[i][0][key], want, rtol=RTOL,
                                           err_msg=f"{case} {key} {i}")
        # the ranks' parameters bit for bit, and their metrics
        assert out0[i] == out1[i]
    _close(final0, jax_final)
    _close(final0, one_final)
    for a, b in zip(final0, final1):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_refusals():
    """MoE under data parallelism now runs (its capacity, slots and aux
    loss from the whole batch: ``tests/test_torch_tp.py`` holds a (2, 2)
    run against JAX's whole batch), here a step on rank 0 of a (1, 1)
    mesh equal to the one-device step; ``tp`` / ``fsdp_tp`` build their
    steps (item 14's tensor-parallel layers), and so does ``seqtp``
    (Queue 2 item 12; tests/test_torch_seqshard_coupled.py runs it on 2
    and 4 ranks), whose step on rank 0 of a (1, 1) mesh equals the
    one-device step."""
    moe = reduced(get_config("qwen3-moe-30b-a3b"))
    params = weights.init_params(moe, torch.Generator().manual_seed(0),
                                 "cpu")
    batch = {"tokens": torch.randint(0, moe.vocab, (2, 8), generator=(
        torch.Generator().manual_seed(1)), dtype=torch.int32)}
    one = abstract_mesh((1, 1), ("data", "model"), rank0=True)
    got = steps.make_train_step(moe, mesh=one)(params, adamw_init(params),
                                               batch)[2]
    want = steps.make_train_step(moe)(params, adamw_init(params), batch)[2]
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()} and float(got["aux"]) > 0
    mesh = abstract_mesh((1, 2), ("data", "model"))
    dense = reduced(get_config("internlm2-1.8b"))
    for policy in ("tp", "fsdp_tp"):
        assert callable(steps.make_train_step(dense, mesh=mesh,
                                              policy=policy))
    assert callable(steps.make_train_step(dense, mesh=mesh,
                                          policy="seqtp"))
    got = steps.make_train_step(moe, mesh=one, policy="seqtp")(
        params, adamw_init(params), batch)[2]
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
    # the batch is cut over every axis of "broadcast"'s batch rule
    m = abstract_mesh((2, 2), ("data", "model"))
    m.coords = {"data": 1, "model": 0}
    rows = steps.local_rows({"tokens": torch.arange(8)[:, None]}, m)
    assert rows["tokens"][:, 0].tolist() == [4, 5]
