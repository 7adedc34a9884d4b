"""PyTorch port vs the JAX package: ``models/api.py``'s loss and its
gradients on the recurrent and MLA decoder archs (falcon-mamba-7b,
recurrentgemma-2b, deepseek-v2-lite-16b) and on internvl2-1b through
``vlm.loss`` with patch embeddings, by
``test_torch_train_archs.check_loss_and_gradients`` (its docstring gives
the tolerance); and the rest of the API: the forward, prefill and decode
steps, and what still raises.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import ArchConfig, get_config, reduced  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402
from test_torch_train_archs import check_loss_and_gradients  # noqa: E402

ARCHS = ["falcon-mamba-7b", "recurrentgemma-2b", "deepseek-v2-lite-16b",
         "internvl2-1b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    check_loss_and_gradients(arch)


def test_api_steps_run_and_encdec_and_dry_run_raise():
    """forward_fn, prefill_fn and decode_fn on the port's engine paths;
    the refusal that stands: the training driver on whisper-base's family
    (it feeds token batches only, as JAX's does, which has no frames for
    the encoder); the family's API itself runs (tests/test_torch_encdec.py).
    The dry run's shape-only entry points (item 9, which raised until it
    was ported) give ``init``'s tree and ``input_batch``'s shapes on the
    ``meta`` device."""
    cfg = reduced(get_config("internlm2-1.8b"))
    gen = torch.Generator().manual_seed(0)
    params = api.init(gen, cfg, "cpu")
    batch = api.input_batch(cfg, "train", 2, 8, gen, device="cpu")
    with torch.no_grad():
        logits = api.forward_fn(params, cfg, batch)
        caches = api.init_caches(cfg, 2, 16, device="cpu")
        last, caches = steps.make_prefill_step(cfg, 16)(params, batch,
                                                        caches)
        nxt, caches = steps.make_decode_step(cfg)(params, {
            "tokens": batch["tokens"][:, -1:],
            "pos": torch.full((2,), 8, dtype=torch.int32)}, caches)
    assert logits.shape == (2, 8, cfg.padded_vocab)
    torch.testing.assert_close(last[:, 0], logits[:, -1])
    assert nxt.shape == (2, 1, cfg.padded_vocab)
    whisper = ArchConfig(name="whisper-base", family="encdec", n_layers=2,
                         enc_layers=1, dec_layers=1, d_model=64, n_heads=4,
                         n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
                         rope_base=0.0, mlp="gelu_mlp", norm="layernorm",
                         dtype="float32", param_dtype="float32")
    caches = api.init_caches(whisper, 1, 8, device="cpu")
    assert caches["cross_k"].shape == (1, 1, 8, 4, 16)
    from repro_torch.launch import train
    for fn, args in ((train.train, (whisper,)),
                     (train.train, (reduced(get_config("whisper-base")),))):
        with pytest.raises(ValueError, match="token batches only"):
            fn(*args, steps=1, batch=1, seq=8, device="cpu")
    abstract, axes = api.abstract_params(cfg)
    assert {k: (t.shape, t.dtype, t.device.type) for k, t in
            flatten_with_paths(abstract).items()} == \
        {k: (t.shape, t.dtype, "meta") for k, t in
         flatten_with_paths(params).items()}
    assert axes == api.init(gen, cfg, "cpu", with_axes=True)[1]
    for kind in ("train", "decode"):
        specs = api.input_specs(cfg, kind, 2, 8)
        real = api.input_batch(cfg, kind, 2, 8, gen, device="cpu")
        assert {k: (t.shape, t.dtype, t.device.type) for k, t in
                specs.items()} == \
            {k: (t.shape, t.dtype, "meta") for k, t in real.items()}
