"""PyTorch port vs the JAX package: the train step (``launch/steps.py``)
and the training driver (``launch/train.py``).

The train step runs on the two-layer variant of the reduced internlm2-1.8b
config, fp32, with the JAX weights carried over by ``params_from_numpy``
and the same tokens on both sides, for three AdamW steps at accum 1 and
2, against JAX's jitted ``make_train_step``.  JAX's reference is taken
with remat ``none``: rematerialisation recomputes, it does not change the
values, so the port's three remat modes (``none``, ``full``, ``dots``) are
each held against it.  Tolerances, all ``rtol = 1e-5`` (fp32, sums in
another order): the loss, ce, aux, grad norm and lr at that alone; m and v
also within ``1e-5`` of each leaf's largest magnitude, since fp32 noise in
a gradient is relative to its leaf's scale, not to each element; the
parameters also within ``1e-3 * lr``, since Adam moves an element by lr
times m/sqrt(v), a ratio that is itself noise where the element's
gradient cancels to fp32 noise (a wrong update rule moves them by ~lr).
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import _flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ScanGroup as JScanGroup  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCH = "internlm2-1.8b"
RTOL = 1e-5
B, S, LR, WARMUP, TOTAL = 4, 16, 1e-2, 1, 10


def _cfgs(**kw):
    j = jax_reduced(jax_get_config(ARCH)).replace(
        n_layers=2, groups=(JScanGroup(("A",), 2),), **kw)
    t = reduced(get_config(ARCH)).replace(
        n_layers=2, groups=(ScanGroup(("A",), 2),), **kw)
    return j, t


def _flat_numpy(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree)[0].items()}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = jax.jit(lambda k: japi.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    flat = _flat_numpy(jparams)
    return jcfg, tcfg, jparams, flat


def _tokens(vocab, n):
    rng = np.random.RandomState(5)
    return [rng.randint(0, vocab, (B, S)).astype(np.int32) for _ in range(n)]


_JAX_RUNS = {}


def _jax_run(model, accum):
    """Three steps of JAX's jitted train step: (metrics, flat params, flat
    m, flat v) after each."""
    if accum not in _JAX_RUNS:
        jcfg, _, jparams, _ = model
        fn = jax.jit(jmake_train_step(jcfg, lr=LR, warmup=WARMUP,
                                      total=TOTAL, accum_steps=accum))
        p, opt, out = jparams, jadamw_init(jparams), []
        for tok in _tokens(jcfg.vocab, 3):
            p, opt, m = fn(p, opt, {"tokens": jnp.asarray(tok)})
            out.append(({k: float(v) for k, v in m.items()}, _flat_numpy(p),
                        _flat_numpy(opt.m), _flat_numpy(opt.v)))
        _JAX_RUNS[accum] = out
    return _JAX_RUNS[accum]


def _scale(ref):
    return RTOL * float(np.abs(ref).max())


def _numpy(tree):
    return {k: v.detach().numpy() for k, v in flatten_with_paths(tree).items()}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_step_matches_jax(model, accum, remat):
    _, tcfg, _, flat = model
    tcfg = tcfg.replace(remat=remat)
    params = weights.params_from_numpy(flat, tcfg, device="cpu")
    opt = adamw_init(params)
    fn = steps.make_train_step(tcfg, lr=LR, warmup=WARMUP, total=TOTAL,
                               accum_steps=accum)
    want = _jax_run(model, accum)
    for i, tok in enumerate(_tokens(tcfg.vocab, 3)):
        params, opt, m = fn(params, opt, {"tokens": torch.from_numpy(tok)})
        jm, jp, jmom, jv = want[i]
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert m[key].dtype == torch.float32, key
            np.testing.assert_allclose(float(m[key]), jm[key], err_msg=key,
                                       rtol=RTOL)
        for got, ref, atol in ((_numpy(params), jp, lambda r: 1e-3 * LR),
                               (_numpy(opt.m), jmom, _scale),
                               (_numpy(opt.v), jv, _scale)):
            assert sorted(got) == sorted(ref)
            for k in got:
                np.testing.assert_allclose(got[k], ref[k], err_msg=k,
                                           rtol=RTOL, atol=atol(ref[k]))
        assert int(opt.step) == i + 1
    assert m["lr"] > 0 and float(m["aux"]) == 0.0


def test_train_step_leaves_its_inputs_and_every_leaf_trains(model):
    """The step takes gradients on its own detached leaves: the caller's
    parameters stay as they were, and after two steps (step 0 trains at
    lr 0) every parameter has moved."""
    _, tcfg, _, flat = model
    params = weights.params_from_numpy(flat, tcfg, device="cpu")
    before = {k: v.clone() for k, v in flatten_with_paths(params).items()}
    opt = adamw_init(params)
    fn = steps.make_train_step(tcfg, lr=LR, warmup=WARMUP, total=TOTAL)
    p, o = params, opt
    for tok in _tokens(tcfg.vocab, 2):
        p, o, _ = fn(p, o, {"tokens": torch.from_numpy(tok)})
    for k, v in flatten_with_paths(params).items():
        assert torch.equal(v, before[k]) and not v.requires_grad, k
    for k, v in flatten_with_paths(p).items():
        assert not torch.equal(v, before[k]), k


def test_lm_loss_targets_pad_with_token_zero(model):
    """JAX's loss: targets are ``tokens[:, 1:]`` padded with token 0, the
    last position included in the mean; explicit targets equal to that
    give the same loss."""
    _, tcfg, _, flat = model
    params = weights.params_from_numpy(flat, tcfg, device="cpu")
    tok = torch.from_numpy(_tokens(tcfg.vocab, 1)[0])
    with torch.no_grad():
        loss, (ce, aux) = ttfm.lm_loss(params, tcfg, tok)
        tgt = torch.cat([tok[:, 1:], torch.zeros(B, 1, dtype=tok.dtype)], 1)
        loss2, _ = ttfm.lm_loss(params, tcfg, tok, targets=tgt)
        logits, _ = ttfm.forward(params, tcfg, tokens=tok)
    assert torch.equal(loss, loss2)
    logp = torch.log_softmax(logits.float(), -1)
    want = -logp.gather(-1, tgt.long()[..., None]).mean()
    torch.testing.assert_close(ce, want)
    assert float(aux) == 0.0 and torch.equal(loss, ce + aux)


def _run_cli(ckpt_dir, *extra):
    return train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(ckpt_dir), *extra])


def test_cli_resumed_run_equals_an_uninterrupted_one(tmp_path, capsys):
    """An uninterrupted 3-step run against one cut after its step-1
    checkpoint (steps 2 and 3 removed, LATEST back at 1) and run again:
    the resumed run restores 2 updates, takes step 2 on the stream's third
    batch, and ends on the same final checkpoint, leaf for leaf."""
    ops.reset_counts()
    whole = _run_cli(tmp_path / "whole")
    n_layers = reduced(get_config(ARCH)).n_layers
    assert ops.PLAIN_CALLS["flash_attention"] == 3 * n_layers
    out = capsys.readouterr().out
    assert "[train] step    0 loss=" in out and "[train] step    2" in out
    assert "[train] done; checkpoints at [3]" in out
    cut = tmp_path / "cut"
    _run_cli(cut, "--ckpt-every", "1")
    for s in (2, 3):
        shutil.rmtree(cut / f"step_{s}")
    (cut / "LATEST").write_text("1")
    resumed = _run_cli(cut, "--ckpt-every", "1")
    out = capsys.readouterr().out
    assert "[train] resumed from checkpoint step 1 (2 updates)" in out
    assert resumed["start"] == 2 and [h["step"] for h in
                                      resumed["history"]] == [2]
    assert resumed["history"][0]["loss"] == whole["history"][2]["loss"]
    a = np.load(tmp_path / "whole" / "step_3" / "arrays.npz")
    b = np.load(cut / "step_3" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 37
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    entries = [e["mb_id"] for e in train.ReplayLog(
        str(cut / "replay.jsonl")).entries()]
    assert entries == [0, 1, 2, 2]


def test_cli_flags_and_refusals(tmp_path):
    """JAX's flags: ``--reduced`` cannot be turned off (store_true with
    default True); ``--policy seqtp`` trains (on one rank the one-device
    step: tests/test_torch_seqshard_coupled.py holds 2 ranks against it);
    ``tp`` and ``fsdp_tp`` train (on
    one rank the mesh (1, 1), as JAX's driver makes it) the steps of
    ``broadcast``, and a checkpoint of either resumes under the other
    (checkpoints hold whole leaves); ``--production-mesh`` on a world of
    one rank raises (it needs 256); the checkpoint holds JAX's
    ``params`` / ``opt`` layout."""
    args = train.build_parser().parse_args([])
    assert args.reduced is True and args.device == "cuda"
    assert (args.steps, args.batch, args.seq, args.lr, args.ckpt_every,
            args.warmup, args.policy, args.backend) == \
        (50, 8, 128, 3e-4, 25, 100, "broadcast", None)
    run = ["--device", "cpu", "--batch", "2", "--seq", "16"]
    loss = {}
    for policy in ("broadcast", "seqtp", "tp", "fsdp_tp"):
        out = train.main([*run, "--steps", "2", "--policy", policy,
                          "--ckpt-dir", str(tmp_path / policy)])
        loss[policy] = [h["loss"] for h in out["history"]]
        assert len(loss[policy]) == 2
    assert loss["seqtp"] == loss["broadcast"]
    for policy in ("tp", "fsdp_tp"):
        np.testing.assert_allclose(loss[policy], loss["broadcast"],
                                   rtol=RTOL)
    out = train.main([*run, "--steps", "3", "--policy", "fsdp_tp",
                      "--ckpt-dir", str(tmp_path / "tp")])
    assert out["start"] == 2 and len(out["history"]) == 1
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        train.main(["--device", "cpu", "--production-mesh",
                    "--ckpt-dir", str(tmp_path / "pm")])
    ck = Checkpointer(str(tmp_path / "x"))
    assert ck.latest_step() is None
