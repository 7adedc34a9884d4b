"""PyTorch port vs the JAX package: every layer kind under ``seqtp``,
served and trained (the coupled kinds' sequence split, and training on
it).

* Reduced fp32 falcon-mamba-7b (the carry of Mamba's state from rank to
  rank), recurrentgemma-2b (the RG-LRU's carry, its local layer on the
  halo), deepseek-v2-lite-16b (its dense ``D`` layer, then MLA over the
  gathered latent with MoE) and qwen3-moe-30b-a3b (MoE at the whole
  sequence's capacity) at S 1,024 under ``seqtp`` on 2 ranks spawned over
  gloo: the forward's logits, the prefill's last logits and every cache
  leaf equal JAX's ``seqtp`` run on forced devices and the port's
  one-rank run (1e-4).  falcon-mamba-7b on 4 ranks (S_loc 256; the
  carry's fold itself, with a state that outlives its shard, against the
  one-rank scan too); qwen3-moe-30b-a3b on a (2, 2) mesh, its batch split
  over ``data`` and its sequence over ``model`` at once.
* Training: the loss and the gradients of ``lm_loss`` under ``seqtp``
  (summed over the mesh as the train step sums them) against
  ``jax.grad`` under ``seqtp`` and the port's one-rank gradients, for
  those four archs and internlm2-1.8b (the gathered route) and gemma3-4b
  (the halo route at a window), each gradient within GRAD_REL of its
  leaf's largest magnitude; and 2 AdamW steps through
  ``launch/train.py --policy seqtp`` on 2 ranks equal to the one-rank
  steps.
* The plain flash backward at a query offset against ``jax.grad`` of
  ``flash_attention_jnp`` at ``q_offset_dynamic`` (the gathered route)
  and at ``kv_offset`` over a halo, causal and windowed (1e-5).

JAX's side runs in one subprocess on 4 forced devices; the port's in one
spawn per mesh (``tests/torch_dist_ranks.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL = dict(rtol=1e-4, atol=1e-4)
S = 1024
#: a gradient's limit, of its leaf's largest magnitude: fp32 sums taken
#: in another order (the ranks' partial sums, JAX's XLA fusions) read
#: 1e-7 to 1e-6 of it
GRAD_REL = 1e-5

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config
from repro.configs.base import ScanGroup, reduced
from repro.core.sharding import use_sharding
from repro.models import api, transformer as tfm

CASES = {"mamba": ("falcon-mamba-7b", None),
         "rgemma": ("recurrentgemma-2b", (("R", "L"), 1)),
         "deepseek": ("deepseek-v2-lite-16b", None),
         "qwen3moe": ("qwen3-moe-30b-a3b", None),
         "internlm2": ("internlm2-1.8b", (("A", "A"), 1)),
         "gemma3": ("gemma3-4b", (("L", "G"), 1))}
SERVE = ("mamba", "rgemma", "deepseek", "qwen3moe")
# (case, mesh, batch, run name, gradients)
RUNS = [(c, (1, 2), 2, c, True) for c in CASES] + [
    ("mamba", (1, 4), 2, "mamba4", False),
    ("qwen3moe", (2, 2), 4, "qwen22", True)]
S = int(sys.argv[2])
res = {}
for case, shape, B, name, grads in RUNS:
    arch, groups = CASES[case]
    cfg = reduced(get_config(arch))
    if groups:
        cfg = cfg.replace(n_layers=len(groups[0]) * groups[1],
                          groups=(ScanGroup(*groups),))
    params = jax.jit(lambda k: api.init(k, cfg)[0])(jax.random.PRNGKey(3))
    toks = np.random.RandomState(4).randint(0, cfg.vocab, (B, S)).astype(
        np.int32)
    if name == case:
        for k, v in _flatten_with_paths(params)[0].items():
            res[f"{name}/p/{k}"] = np.asarray(v)
    res[name + "/tokens"] = toks
    serve = case in SERVE

    def run(p, t):
        out = {}
        if serve:
            out["logits"] = tfm.forward(p, cfg, tokens=t)[0]
            out["last"], out["caches"] = tfm.prefill(
                p, cfg, t, tfm.init_caches(cfg, B, S))
        if grads:
            (out["loss"], _), out["grads"] = jax.value_and_grad(
                lambda q: tfm.lm_loss(q, cfg, t), has_aux=True)(p)
        return out
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    with use_sharding(mesh, "seqtp"):
        out = jax.jit(run)(params, jnp.asarray(toks))
    for k in ("logits", "last", "loss"):
        if k in out:
            res[f"{name}/{k}"] = np.asarray(out[k])
    for k in ("caches", "grads"):
        if k in out:
            for kk, v in _flatten_with_paths(out[k])[0].items():
                res[f"{name}/{k[0]}/{kk}"] = np.asarray(v)
np.savez(sys.argv[1], **res)
print("JAX-OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's seqtp runs, then the port's on (1, 2), (1, 4) and (2, 2)."""
    path = str(tmp_path_factory.mktemp("seqtp_coupled") / "jax.npz")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, path, str(S)],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "JAX-OK" in r.stdout, r.stdout + r.stderr
    with np.load(path) as f:
        want = {k: f[k] for k in f.files}
    spawn = lambda world, shape, runs_, carry=False: collectives.spawn(  # noqa
        ranks.seqtp_coupled_rank, world, backend="gloo", device="cpu",
        timeout_s=300, args=(path, shape, runs_, carry), threads=1)
    got = {"1x2": spawn(2, (1, 2), [(c, c) for c in ranks.COUPLED_CASES]),
           "1x4": spawn(4, (1, 4), [("mamba", "mamba4")], carry=True),
           "2x2": spawn(4, (2, 2), [("qwen3moe", "qwen22")])}
    return path, want, got


_ONE = {}


def _one_rank(path, case, name=None):
    """The port's one-rank run of ``case`` on run ``name``'s tokens."""
    key = (case, name or case)
    if key not in _ONE:
        cfg, params, toks = ranks.coupled_inputs(ranks._load(path), case,
                                                 name)
        _ONE[key] = ranks.seqtp_run(cfg, params, toks,
                                    serve=case in ranks.SERVE_CASES)
    return _ONE[key]


def _check_serve(got, want, one, name, rows=slice(None)):
    np.testing.assert_allclose(got["logits"], want[name + "/logits"][rows],
                               **TOL)
    np.testing.assert_allclose(got["logits"], one["logits"][rows], **TOL)
    np.testing.assert_allclose(got["last"], want[name + "/last"][rows],
                               **TOL)
    np.testing.assert_allclose(got["last"], one["last"][rows], **TOL)
    assert set(got["caches"]) == set(one["caches"])
    for k, v in got["caches"].items():
        np.testing.assert_allclose(v, want[f"{name}/c/{k}"][:, rows], **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(v, one["caches"][k][:, rows], **TOL,
                                   err_msg=k)


def _check_grads(got, want_grads, label):
    """Each gradient within GRAD_REL of its leaf's largest magnitude."""
    assert set(got) == set(want_grads), label
    for k, g in got.items():
        w = want_grads[k]
        err = np.abs(g - w).max()
        assert err <= GRAD_REL * max(np.abs(w).max(), 1e-30), \
            (label, k, err, np.abs(w).max())


#: the layer calls of each route, in a forward and a prefill: kinds S and
#: R take the carry, L on the halo (window 16 <= S_loc), MLA the latent
#: and the gathered route's attention count, MoE its own
SERVE_ROUTES = {
    "mamba": {"halo": 0, "gather": 0, "latent": 0, "carry": 2, "moe": 0},
    "rgemma": {"halo": 2, "gather": 0, "latent": 0, "carry": 2, "moe": 0},
    "deepseek": {"halo": 0, "gather": 2, "latent": 2, "carry": 0,
                 "moe": 2},
    "qwen3moe": {"halo": 0, "gather": 2, "latent": 0, "carry": 0,
                 "moe": 2}}


@pytest.mark.parametrize("case", ranks.SERVE_CASES)
def test_coupled_kinds_forward_and_prefill_equal_jax_and_one_rank(runs,
                                                                  case):
    path, want, got = runs
    one = _one_rank(path, case)
    for g in got["1x2"]:
        _check_serve(g[case], want, one, case)
    # a forward, a prefill and the gradient's forward, each through
    # every layer: the serve's routes and half as many again
    routes = got["1x2"][0][case]["routes"]
    assert routes == {k: v * 3 // 2 for k, v in SERVE_ROUTES[case].items()}


def test_mamba_carry_chain_over_four_ranks(runs):
    """S_loc 256 on 4 ranks: every rank's forward and prefill as JAX's
    on 4 devices and the one-rank run's, its gradients as the one-rank
    gradients; and the carry's fold itself: ``collectives.shard_scan``
    of 16-step shards whose state outlives them (dt ~ 0.01), y, the
    final state and every input's gradient as the one-rank scan's
    (1e-5)."""
    path, want, got = runs
    one = _one_rank(path, "mamba", "mamba4")
    for g in got["1x4"]:
        _check_serve(g["mamba4"], want, one, "mamba4")
        np.testing.assert_allclose(g["mamba4"]["loss"], one["loss"],
                                   rtol=1e-5)
        _check_grads(g["mamba4"]["grads"], one["grads"], "mamba4")
    assert got["1x4"][0]["mamba4"]["routes"]["carry"] == 3
    xc, dt, Bc, Cc, A, D, w = ranks.carry_inputs()
    leaves = [t.clone().requires_grad_(True) for t in (xc, dt, Bc, Cc, A,
                                                        D)]
    y, h = ssm.selective_scan(*leaves)
    grads = torch.autograd.grad((y * w).sum() + h.sum(), leaves)
    # the state entering the last shard is mostly carried, not rebuilt
    _, h_tail = ssm.selective_scan(*(t[:, 48:].contiguous()
                                     for t in (xc, dt, Bc, Cc)),
                                   A, D)
    h = h.detach()
    assert float((h_tail - h).abs().max()) > 0.1 * float(h.abs().max())
    for g in got["1x4"]:
        c = g["carry"]
        np.testing.assert_allclose(c["y"], y.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(c["h"], h.numpy(), rtol=1e-5,
                                   atol=1e-5)
        for a, b in zip(c["grads"], grads):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-5)


def test_moe_on_a_split_batch_and_a_split_sequence(runs):
    """qwen3-moe-30b-a3b on a (2, 2) mesh under ``seqtp``: each rank its
    2 rows of the B 4 batch and its half of their positions, the
    capacity and slots the whole batch's; every rank's rows as JAX's
    and the one-rank run's, the loss and gradients too."""
    path, want, got = runs
    one = _one_rank(path, "qwen3moe", "qwen22")
    for r, g in enumerate(got["2x2"]):
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        _check_serve(g["qwen22"], want, one, "qwen22", rows)
        np.testing.assert_allclose(g["qwen22"]["loss"], want["qwen22/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(g["qwen22"]["loss"], one["loss"],
                                   rtol=1e-5)
        _check_grads(g["qwen22"]["grads"], one["grads"], "qwen22 one")
        _check_grads(g["qwen22"]["grads"], {
            k[len("qwen22/g/"):]: v for k, v in want.items()
            if k.startswith("qwen22/g/")}, "qwen22 jax")
    assert got["2x2"][0]["qwen22"]["routes"]["moe"] == 3


@pytest.mark.parametrize("case", list(ranks.COUPLED_CASES))
def test_seqtp_gradients_equal_jax_and_one_rank(runs, case):
    path, want, got = runs
    one = _one_rank(path, case)
    jax_grads = {k[len(case) + 3:]: v for k, v in want.items()
                 if k.startswith(case + "/g/")}
    for g in got["1x2"]:
        np.testing.assert_allclose(g[case]["loss"], want[case + "/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(g[case]["loss"], one["loss"], rtol=1e-5)
        _check_grads(g[case]["grads"], jax_grads, case + " jax")
        _check_grads(g[case]["grads"], one["grads"], case + " one")
    routes = got["1x2"][0][case]["routes"]
    if case == "internlm2":
        assert routes == {"halo": 0, "gather": 2, "latent": 0, "carry": 0,
                          "moe": 0}
    elif case == "gemma3":
        assert routes == {"halo": 1, "gather": 1, "latent": 0, "carry": 0,
                          "moe": 0}


def test_training_cli_under_seqtp_equals_one_rank(tmp_path):
    """2 AdamW steps of reduced deepseek-v2-lite-16b (a dense layer, MLA
    and MoE) through ``launch/train.py --policy seqtp`` on 2 ranks (S
    1,024 split 2 x 512) equal the one-rank CLI's steps: each step's
    metrics and the final parameters."""
    argv = ["--device", "cpu", "--arch", "deepseek-v2-lite-16b", "--policy",
            "seqtp", "--steps", "2", "--batch", "2", "--seq", str(S),
            "--warmup", "1", "--lr", "1e-2", "--ckpt-every", "0"]
    got = collectives.spawn(ranks.seqtp_train_rank, 2, backend="gloo",
                            device="cpu", timeout_s=300,
                            args=(str(tmp_path / "two"), argv), threads=1)
    want = ranks.seqtp_train_rank(0, str(tmp_path / "one"), argv)
    lr = 1e-2
    for hist, params, _ in got:
        for h, w in zip(hist, want[0]):
            for k in h:
                np.testing.assert_allclose(h[k], w[k], rtol=1e-5, err_msg=k)
        assert len(hist) == 2 and hist[1]["lr"] > 0
        assert set(params) == set(want[1])
        for k, p in params.items():
            # tests/test_torch_tp.py's rule: Adam's m / sqrt(v) of a
            # gradient at its cancellation floor is a ratio of rounding
            # noise, which moves a parameter by up to lr
            v = want[2][k]
            atol = np.where(v < 1e-8 * v.max(), 2 * lr, 1e-3 * lr)
            assert (np.abs(p - want[1][k]) <=
                    atol + 1e-5 * np.abs(want[1][k])).all(), k


def _qkv_dout(seed, B, S_q, T, H, KV, hd):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return f(B, S_q, H, hd), f(B, T, KV, hd), f(B, T, KV, hd), \
        f(B, S_q, H, hd)


def _port_grads(q, k, v, dout, window):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*ts, causal=True, window=window)
    out.backward(torch.from_numpy(dout))
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("B,S_loc,off,H,KV,hd,window", [
    (1, 8, 8, 2, 2, 16, 0), (2, 16, 32, 4, 2, 16, 0), (1, 24, 72, 8, 2, 32,
                                                       0),
    (2, 16, 16, 4, 4, 16, 5), (1, 32, 64, 4, 1, 16, 40)])
def test_flash_backward_at_a_query_offset_equals_jax_gathered(
        B, S_loc, off, H, KV, hd, window):
    """The gathered route's backward: queries at ``off .. off + S_loc -
    1`` over the first ``off + S_loc`` keys, against ``jax.grad`` through
    JAX's ``q_offset_dynamic`` over the whole gathered K/V (the later
    keys' gradients zero)."""
    T_all = off + S_loc + 16
    q, k, v, dout = _qkv_dout(off + S_loc, B, S_loc, T_all, H, KV, hd)

    def f(q_, k_, v_):
        return jnp.sum(flash_attention_jnp(
            q_, k_, v_, causal=True, window=window, q_chunk=8, kv_chunk=16,
            q_offset_dynamic=jnp.int32(off)) * dout)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    T = off + S_loc
    got = _port_grads(q, np.ascontiguousarray(k[:, :T]),
                      np.ascontiguousarray(v[:, :T]), dout, window)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, np.asarray(w)[:, :T], rtol=1e-5,
                                   atol=1e-5)
        assert not np.asarray(w)[:, T:].any()


@pytest.mark.parametrize("B,S_loc,W,H,KV,hd", [
    (1, 16, 4, 2, 2, 16), (2, 32, 16, 4, 2, 16), (1, 24, 24, 4, 1, 32)])
def test_flash_backward_at_a_query_offset_equals_jax_halo(B, S_loc, W, H,
                                                          KV, hd):
    """The halo route's backward: W keys of the previous shard before the
    shard's own at window W, against ``jax.grad`` through JAX's static
    ``kv_offset = -W``."""
    q, k, v, dout = _qkv_dout(W, B, S_loc, W + S_loc, H, KV, hd)

    def f(q_, k_, v_):
        return jnp.sum(flash_attention_jnp(
            q_, k_, v_, causal=True, window=W, q_chunk=8, kv_chunk=8,
            kv_offset=-W, kv_valid=jnp.ones((W + S_loc,), bool)) * dout)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    for g, w in zip(_port_grads(q, k, v, dout, W), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
