"""PyTorch port vs the JAX package: the tensor-parallel layers (``tp``,
``fsdp_tp``; ``core/collectives.py``'s ``tp_*``, ``core/sharding.py``'s
blocks, every layer kind's compute on them, ``launch/steps.py``'s train
step, the dry run's count of them).

Each case of ``torch_dist_ranks.TP_CASES`` (a two-layer fp32 reduced
config: kinds A, L with a ring and G, MLA with MoE and shared experts,
MoE with qk-norm, S, R with MQA local attention, the encoder-decoder's
self and cross attention, the VLM's token path, the three MLP kinds, and
"cut": 2 heads of 16, so that a (1, 4) mesh's column block holds half a
head) runs on gloo ranks under both policies on meshes (1, 2), (1, 4)
and (2, 2), in one spawn of 4 ranks, every case inside.  Each rank computes on
its blocks; every result comes back whole.  Against JAX's one-device
run: the forward's logits (1e-4), the loss and every leaf's gradient
(``rtol`` 1e-5 and 1e-5 of the leaf's largest magnitude, the train
tests' rule), three AdamW steps of internlm2 and of the MoE case (on
(2, 2) a batch split over ``data``: capacity, slots and aux loss are
the whole batch's).  Against the port's one-rank run: the logits, a
prefill and 6 greedy decode steps (tokens exact, caches 1e-4), and three
AdamW steps of every case (metrics ``rtol`` TRAIN_RTOL 1e-4, moments
within it of each leaf's largest magnitude, parameters within it
relative and 1e-3 * lr absolute, or 2 lr where an element's v is below
1e-8 of its leaf's largest: Adam's m / sqrt(v) turns the last bits of an
element whose gradient cancels into a step of up to lr; the one-rank
port and JAX differ there as much).  And the dry
run: a real gloo rank's count of a reduced ``tp`` cell equals the
fake-tensor count of the same cell.  The attention kinds are here, the
other mixers in ``test_torch_tp_mixers.py`` (two files, so that their
JAX compiles run on two workers).
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
from repro_torch.configs import base, get_config, reduced  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.launch import dryrun_lib  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
RTOL = 1e-5
#: chip_smoke.py's TRAIN_RTOL: three AdamW steps' metrics, moments (of
#: each leaf's largest magnitude) and parameters (rtol, and 1e-3 * lr)
TRAIN_RTOL = 1e-4
LR = ranks.TP_HYPER["lr"]
POLICIES = ("tp", "fsdp_tp")
MESHES = [(1, 2), (1, 4), (2, 2)]
#: this file's cases; test_torch_tp_mixers.py holds the others
CASES = ("internlm2", "cut", "starcoder2", "gemma3", "internvl2")
#: the cases whose three AdamW steps are also held against JAX's
JAX_TRAIN = ("internlm2", "qwen3moe")


def _jax_config(case):
    arch, over = ranks.TP_CASES[case]
    over = dict(over)
    if "groups" in over:
        pattern, reps = over["groups"]
        over["groups"] = (JScanGroup(pattern, reps),)
        over["n_layers"] = len(pattern) * reps
    return jax_reduced(jax_get_config(arch)).replace(**over)


def _batches(cfg):
    """Three batches of TP_B rows: TP_S tokens (8 after the VLM's
    patches), whisper's 12 frames."""
    rng = np.random.RandomState(5)
    out = []
    for _ in range(3):
        n = 8 if cfg.family == "vlm" else ranks.TP_S
        b = {"tokens": rng.randint(0, cfg.vocab, (ranks.TP_B, n)).astype(
            np.int32)}
        if cfg.family == "encdec":
            b["frames"] = rng.randn(ranks.TP_B, 12, cfg.d_model).astype(
                np.float32)
        if cfg.family == "vlm":
            b["patches"] = rng.randn(ranks.TP_B, cfg.n_patches,
                                     cfg.d_model).astype(np.float32)
        out.append(b)
    return out


def _flat(tree):
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in _flatten_with_paths(tree)[0].items()}


def make_refs(cases, path):
    """The weights and batches of every case in one ``.npz`` at
    ``path``; JAX's logits, loss and gradients of the first batch (one
    jit a case), and three train steps of :data:`JAX_TRAIN`; the port's
    one-rank :func:`tp_run`."""
    arrays, jax_out = {}, {}
    for case in cases:
        jcfg = _jax_config(case)
        jparams = japi.init(jax.random.PRNGKey(0), jcfg)[0]
        batches = _batches(jcfg)
        arrays.update({f"{case}/p/{k}": v for k, v in _flat(jparams).items()})
        arrays.update({f"{case}/b{i}/{k}": v for i, b in enumerate(batches)
                       for k, v in b.items()})

        def both(p, b, c=jcfg):
            (loss, _), g = jax.value_and_grad(
                lambda q: japi.loss_fn(q, c, b), has_aux=True)(p)
            return japi.forward_fn(p, c, b), loss, g

        logits, loss, grads = jax.jit(both)(
            jparams, {k: jnp.asarray(v) for k, v in batches[0].items()})
        jax_out[case] = {"logits": np.asarray(logits, np.float32),
                         "loss": float(loss), "grads": _flat(grads)}
        if case in JAX_TRAIN:
            fn = jax.jit(jmake_train_step(jcfg, **ranks.TP_HYPER))
            p, opt, metrics = jparams, jadamw_init(jparams), []
            for b in batches:
                p, opt, m = fn(p, opt, {k: jnp.asarray(v)
                                        for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
            jax_out[case]["metrics"] = metrics
            jax_out[case]["final"] = (_flat(p), _flat(opt.m), _flat(opt.v))
    np.savez(path, **arrays)
    d = ranks._load(path)
    one = {case: ranks.tp_run(*ranks.tp_inputs(d, case)) for case in cases}
    return path, jax_out, one


def spawn_meshes(refs, cases):
    """Every case under both policies on each mesh of :data:`MESHES`, in
    one spawn of 4 ranks (a (1, 2) mesh takes the first two)."""
    path = refs[0]
    return collectives.spawn(ranks.tp_rank, 4, backend="gloo", device="cpu",
                             timeout_s=300,
                             args=(path, MESHES, cases, POLICIES),
                             threads=1)[0]


def mesh_runs(refs, spawned, shape):
    """``(got, jax_out, one)`` of one mesh: ``got[case, policy]``."""
    _, jax_out, one = refs
    return ({(c, p): v for (s, c, p), v in spawned.items() if s == shape},
            jax_out, one)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return make_refs(CASES, str(tmp_path_factory.mktemp("tp") / "cases.npz"))


@pytest.fixture(scope="module")
def spawned(refs):
    return spawn_meshes(refs, CASES)


@pytest.fixture(params=MESHES, ids=lambda s: "x".join(map(str, s)))
def runs(request, refs, spawned):
    return mesh_runs(refs, spawned, request.param)


def _close(got, want, err_msg, rtol=RTOL, atol=None):
    np.testing.assert_allclose(
        got, want, rtol=rtol, err_msg=err_msg,
        atol=rtol * float(np.abs(want).max()) if atol is None else atol)


def check_logits_loss_and_grads(runs):
    got, jax_out, one = runs
    for (case, policy), g in got.items():
        j, o = jax_out[case], one[case]
        msg = f"{case} {policy}"
        np.testing.assert_allclose(g["logits"], j["logits"], **TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(g["logits"], o["logits"], **TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(g["loss"], j["loss"], rtol=RTOL,
                                   err_msg=msg)
        assert sorted(g["grads"]) == sorted(j["grads"]), msg
        for k, want in j["grads"].items():
            _close(g["grads"][k], want, f"{msg} {k}")


def check_prefill_and_decode(runs):
    got, _, one = runs
    for (case, policy), g in got.items():
        o = one[case]
        np.testing.assert_array_equal(g["tokens"], o["tokens"],
                                      err_msg=f"{case} {policy}")
        assert sorted(g["caches"]) == sorted(o["caches"])
        for k, want in o["caches"].items():
            np.testing.assert_allclose(g["caches"][k], want, **TOL,
                                       err_msg=f"{case} {policy} {k}")


def check_adamw_steps(runs):
    got, jax_out, one = runs
    for (case, policy), g in got.items():
        wants = [one[case]] + ([jax_out[case]] if case in JAX_TRAIN else [])
        for want in wants:
            for i, (gm, wm) in enumerate(zip(g["metrics"], want["metrics"])):
                for key in ("loss", "ce", "aux", "grad_norm", "lr"):
                    np.testing.assert_allclose(
                        gm[key], wm[key], rtol=TRAIN_RTOL,
                        err_msg=f"{case} {policy} {key} step {i}")
            (gp, gm, gv), (wp, wm, wv) = g["final"], want["final"]
            for name, gt, wt in (("m", gm, wm), ("v", gv, wv)):
                assert sorted(gt) == sorted(wt)
                for k in gt:
                    _close(gt[k], wt[k], f"{case} {policy} {name} {k}",
                           rtol=TRAIN_RTOL)
            assert sorted(gp) == sorted(wp)
            for k in gp:
                # an element whose v is at the cancellation floor (below
                # 1e-8 of its leaf's largest: |g| ~ 1e-4 of the largest)
                # steps by m / sqrt(v), a ratio of rounding noise; its m
                # and v are held above, its step to 2 lr
                floor = wv[k] < 1e-8 * float(np.abs(wv[k]).max())
                atol = np.where(floor, 2 * LR, 1e-3 * LR)
                err = np.abs(gp[k] - wp[k]) - TRAIN_RTOL * np.abs(wp[k])
                assert (err <= atol).all(), (
                    f"{case} {policy} params {k}: {float(err.max())}")


def test_logits_loss_and_grads_equal_jax_and_one_rank(runs):
    """The forward's logits, the loss and every leaf's gradient (each
    rank's block, gathered) of every case and policy."""
    check_logits_loss_and_grads(runs)


def test_prefill_and_greedy_decode_equal_one_rank(runs):
    """A prefill and 6 greedy decode steps (the argmax of the gathered
    logits): the tokens exactly, every cache (attention's whole on every
    rank, the recurrent states' channels gathered) within 1e-4."""
    check_prefill_and_decode(runs)


def test_three_adamw_steps_equal_one_rank_and_jax(runs):
    """Losses, aux losses, clipped global norms and lr of three AdamW
    steps; then every parameter and both moments, against the one-rank
    run and, for internlm2, JAX's."""
    check_adamw_steps(runs)


def test_dryrun_count_of_a_real_rank_equals_the_fake_count():
    """Reduced internlm2-1.8b's ``tp`` prefill and decode cells on rank 0
    of a real (1, 2) gloo mesh, their step run on real tensors under
    ``dryrun_lib.counting``, count what the dry run counts on fake
    tensors on an abstract rank 0: FLOPs, kernel calls by kernel, and
    every collective (op, buffer, group, wire bytes) in order."""
    kinds = ("prefill", "decode")
    real = collectives.spawn(ranks.tp_count_rank, 2, backend="gloo",
                             device="cpu", timeout_s=120,
                             args=("internlm2-1.8b", kinds), threads=1)[0]
    cfg = reduced(get_config("internlm2-1.8b"))
    mesh = abstract_mesh((1, 2), ("data", "model"), rank0=True)
    for kind in kinds:
        fake = dryrun_lib.count_cell(cfg, base.ShapeCase(kind, 16, 2, kind),
                                     mesh, "tp")
        r = real[kind]
        assert r["flops"] == fake["flops"] > 0, kind
        assert r["launches"] == fake["launches"] != {}, kind
        assert len(r["colls"]) == fake["ncoll"] > 0, kind
        assert sum(c["wire_bytes"] for c in r["colls"]) == fake["wire"]
        by_op = {}
        for c in r["colls"]:
            by_op[c["op"]] = by_op.get(c["op"], 0.0) + c["wire_bytes"]
        assert by_op == fake["by_op"] and set(by_op) == {"all-reduce"}
