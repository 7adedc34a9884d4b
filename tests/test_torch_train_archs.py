"""PyTorch port vs the JAX package: ``models/api.py``'s loss and its
gradients on the attention-only decoder archs the port serves (the
recurrent and MLA ones, and internvl2-1b, are in
``tests/test_torch_train_recurrent.py``, which reuses
:func:`check_loss_and_gradients`), and ``api.input_batch``.

Each arch runs its reduced fp32 config with the JAX weights carried over
by ``params_from_numpy`` and the same batch (numpy tokens, and patch
embeddings for internvl2-1b through ``vlm.loss``): ``api.loss_fn``'s
value, ce and aux (qwen3-moe's and deepseek's router loss) against JAX's
``jax.value_and_grad(api.loss_fn, has_aux=True)``, and the gradient of
every parameter.  Tolerance: ``rtol = 1e-5`` on the values; each gradient
within ``1e-5`` of its leaf's largest magnitude (fp32, sums in another
order: the RG-LRU and Mamba scans run in order here and chunked in JAX,
so their noise is relative to the leaf's scale).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import _flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api, weights  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

RTOL = 1e-5
ARCHS = ["starcoder2-3b", "gemma-7b", "gemma3-4b", "qwen3-moe-30b-a3b"]
_jgrad = jax.jit(jax.value_and_grad(japi.loss_fn, has_aux=True),
                 static_argnums=1)


def _batch(cfg, B=2, S=16):
    rng = np.random.RandomState(1)
    batch = {}
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(B, cfg.n_patches, cfg.d_model).astype(
            np.float32)
        S -= cfg.n_patches
    batch["tokens"] = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    return batch


def check_loss_and_gradients(arch):
    jcfg, tcfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    jparams = jax.jit(lambda k: japi.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v)
            for k, v in _flatten_with_paths(jparams)[0].items()}
    params = weights.params_from_numpy(flat, tcfg, "cpu")
    batch = _batch(tcfg)
    (jl, (jce, jaux)), jg = _jgrad(jparams, jcfg, {
        k: jnp.asarray(v) for k, v in batch.items()})
    ops.reset_counts()
    (loss, (ce, aux)), grads = steps.value_and_grad(params, tcfg, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    for got, want in ((loss, jl), (ce, jce), (aux, jaux)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    if tcfg.n_experts:
        assert float(aux) > 0
    jflat = {k: np.asarray(v) for k, v in _flatten_with_paths(jg)[0].items()}
    tflat = {k: v.numpy() for k, v in flatten_with_paths(grads).items()}
    assert sorted(tflat) == sorted(jflat)
    for k, want in jflat.items():
        scale = float(np.abs(want).max())
        assert scale > 0, k                  # every leaf gets a gradient
        np.testing.assert_allclose(tflat[k], want, rtol=RTOL,
                                   atol=RTOL * scale, err_msg=k)
    # the attention, the scans and the MLA prefill ran their plain
    # versions, differentiated by autograd
    assert sum(ops.PLAIN_CALLS.values()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    check_loss_and_gradients(arch)


def test_input_batch_has_jax_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    for arch in ("internlm2-1.8b", "internvl2-1b"):
        jcfg, tcfg = jax_reduced(jax_get_config(arch)), \
            reduced(get_config(arch))
        for kind in ("train", "decode"):
            got = api.input_batch(tcfg, kind, 2, 12, gen, device="cpu")
            want = japi.input_batch(jcfg, kind, 2, 12)
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape, (arch, kind, k)
                assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
            assert int(got["tokens"].max()) < tcfg.vocab
