"""deepseek-v2-lite-16b in the port against the JAX package: MLA's prefill
and absorbed decode, the shared experts of ``apply_moe``, the plain
versions of the two kernels on its path (flash at q/k 24, v 16 and the MLA
decode), the dense first layer (kind ``D``), the weight tree, the model's
logits and greedy decode through the reference and dense fused engines
(and ``paged=True``, which serves dense).

Both sides run the fp32 ``reduced()`` config made three layers deep, ``D``
x 1 + ``M`` x 2 (``R = 2`` exercises the stacked ``(repeats, ...)``
layout): d_model 64, 4 heads, kv_lora_rank 32, rope 8, nope 16, v 16, 8
experts top-2, expert d_ff 32, 2 shared experts of d_ff 64, dense d_ff
128.  The JAX weights are carried over with ``params_from_numpy``; the
port runs on the CPU, where its kernels take their plain versions, and
JAX its plain path (``use_kernels=False``).  Tolerances: fp32 layer and
op parity ``atol = rtol = 1e-5`` (the same arithmetic in another library,
sums in another order); whole-model logits ``atol = rtol = 1e-4``
(tests/test_kernels.py:16); bf16 ``apply_moe`` tests/test_kernels.py:16's
``3e-2`` with the absolute limit raised to one bf16 ulp of the largest
output (tests/test_torch_moe.py says why); tokens and finish reasons must
be equal.
"""
import contextlib
import io
import math
import types
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes: one thread is faster and leaves
                           # the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import (Checkpointer,  # noqa: E402
                                           _flatten_with_paths)
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ScanGroup as JScanGroup  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.cluster.backends import checkpoint_step_dir  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.kernels import decode_plan, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mla_decode as md  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe, weights  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.layers import apply_mlp, embed  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TOL = dict(atol=1e-5, rtol=1e-5)            # fp32 layers and ops
BF16_TOL = dict(atol=3e-2, rtol=3e-2)       # tests/test_kernels.py:16
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)      # fp32 whole-model logits

_jmla = jax.jit(jattn.mla_forward, static_argnums=2)
_jmla_dec = jax.jit(jattn.mla_decode, static_argnums=4)
_jmoe = jax.jit(jmoe.apply_moe, static_argnums=2)
_jpre = jax.jit(jtfm.prefill, static_argnums=1)
_jdec = jax.jit(jtfm.decode_step, static_argnums=1)


def _cfgs(**over):
    """The reduced config, D x 1 + M x 2, on both sides."""
    j = jax_reduced(jax_get_config(ARCH))
    t = reduced(get_config(ARCH))
    j = j.replace(n_layers=3, groups=(JScanGroup(("D",), 1),
                                      JScanGroup(("M",), 2)), **over)
    t = t.replace(n_layers=3, groups=(ScanGroup(("D",), 1),
                                      ScanGroup(("M",), 2)), **over)
    return j, t


def _flat_numpy(params):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(params)[0].items()}


def _build(**over):
    jcfg, tcfg = _cfgs(**over)
    assert not jcfg.use_kernels
    jparams = jax.jit(lambda k: api.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    # the JAX init draws unit norm weights: perturb them, so the parity
    # below sees every norm, kv_norm included
    flat = _flat_numpy(jparams)
    rng = np.random.RandomState(9)
    for k in flat:
        if "norm" in k or "/ln" in k:
            flat[k] = (flat[k] + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(flat[k].dtype)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams),
        [jnp.asarray(flat[k]) for k in _flatten_with_paths(jparams)[0]])
    tparams = weights.params_from_numpy(flat, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def model():
    return _build()


def _t(a):
    return torch.from_numpy(np.array(a))


def _node(tree, key):
    for part in key.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _layer(model, r=1, what="mixer"):
    """Repeat ``r`` of the MLA group's ``what`` on both sides."""
    jcfg, tcfg, jparams, tparams = model
    j = jax.tree_util.tree_map(lambda a: a[r], jparams["groups"][1][0][what])
    t = jax.tree_util.tree_map(lambda a: a[r], tparams["groups"][1][0][what])
    return jcfg, tcfg, j, t


# ----------------------------------------------------------------------
# MLA's prefill and absorbed decode
@pytest.mark.parametrize("S", [8, 1030])
def test_mla_forward_matches_jax(model, S):
    """At S 8 JAX takes its plain ``mha``, at S >= 1024 its
    ``flash_attention_jnp``; the port takes flash at every S."""
    jcfg, tcfg, jp, tp = _layer(model)
    assert (S >= jattn.FLASH_MIN_SEQ) == (S == 1030)
    x = np.random.RandomState(S).standard_normal(
        (2 if S < 100 else 1, S, tcfg.d_model)).astype(np.float32)
    want, (wckv, wkrope) = _jmla(jp, jnp.asarray(x), jcfg)
    ops.reset_counts()
    got, (ckv, krope) = tattn.mla_forward(tp, _t(x), tcfg)
    assert ops.PLAIN_CALLS["flash_attention"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ckv.numpy(), np.asarray(wckv), **TOL)
    np.testing.assert_allclose(krope.numpy(), np.asarray(wkrope), **TOL)


@pytest.mark.parametrize("pos", [[0, 5], [7, 15], [15, 3], [16, 21]])
def test_mla_decode_matches_jax(model, pos):
    """One absorbed decode step over a 16-row latent cache holding random
    rows: the output and both cache leaves after the write.  A pos of 15
    writes the last row; pos >= L (16, 21: a frozen slot past its cache)
    writes the clamped last row and sees all L rows, as JAX's
    ``dynamic_update_slice`` and mask do."""
    jcfg, tcfg, jp, tp = _layer(model)
    rng = np.random.RandomState(sum(pos))
    B, L = 2, 16
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    cache = {"ckv": rng.standard_normal((B, L, tcfg.kv_lora_rank)),
             "krope": rng.standard_normal((B, L, tcfg.rope_head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    p = np.asarray(pos, np.int32)
    want, wc = _jmla_dec(jp, jnp.asarray(x),
                         {k: jnp.asarray(v) for k, v in cache.items()},
                         jnp.asarray(p), jcfg)
    tc = {k: _t(v) for k, v in cache.items()}
    ops.reset_counts()
    got, tc2 = tattn.mla_decode(tp, _t(x), tc, _t(p), tcfg)
    assert tc2 is tc and ops.PLAIN_CALLS["mla_decode_attention"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in cache:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(wc[k]), **TOL)


def _jax_chain(q_lat, q_rope, ckv, krope, lengths, scale):
    """JAX's einsum chain of ``mla_decode`` (``attention.py:636-643``) on
    given inputs, with ``l < lengths`` for its ``l <= pos``."""
    s = (jnp.einsum("bhr,bsr->bhs", q_lat, ckv)
         + jnp.einsum("bhd,bsd->bhs", q_rope, krope)).astype(jnp.float32)
    s = s * scale
    valid = jnp.arange(ckv.shape[1])[None, :] < lengths[:, None]
    s = jnp.where(valid[:, None, :], s, jattn.NEG_INF)
    p = jax.nn.softmax(s, axis=-1).astype(q_lat.dtype)
    return jnp.einsum("bhs,bsr->bhr", p, ckv)


@pytest.mark.parametrize("B,H,L,r,rh,lengths", [
    (2, 4, 16, 32, 8, [1, 16]),
    (3, 16, 130, 32, 8, [64, 65, 200]),        # a chunk's edge, past L
    (2, 16, 40, 512, 64, [0, 37]),             # length 0: the mean of ckv
])
def test_mla_decode_ref_matches_the_jax_chain(B, H, L, r, rh, lengths):
    rng = np.random.RandomState(L)
    args = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, H, r), (B, H, rh), (B, L, r), (B, L, rh))]
    lens = np.asarray(lengths, np.int32)
    scale = 1.0 / math.sqrt(24)
    want = _jax_chain(*map(jnp.asarray, args), jnp.asarray(lens), scale)
    got = ref.mla_decode_attention_ref(*map(_t, args), _t(lens), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if 0 in lengths:
        b = lengths.index(0)
        np.testing.assert_allclose(
            got[b].numpy(), np.broadcast_to(args[2][b].mean(0), (H, r)),
            **TOL)


@pytest.mark.parametrize("S,causal", [(5, True), (64, True), (130, True),
                                      (33, False)])
def test_plain_flash_with_a_narrower_v_matches_jax(S, causal):
    """The plain flash at (q/k 24, v 16), G 1 and G 2, against the JAX
    oracle ``flash_attention_jnp`` (which takes ``hd_v != hd``) at scale
    1/sqrt(24)."""
    rng = np.random.RandomState(S)
    for H, KV in ((4, 4), (4, 2)):
        q = rng.standard_normal((2, S, H, 24)).astype(np.float32)
        k = rng.standard_normal((2, S, KV, 24)).astype(np.float32)
        v = rng.standard_normal((2, S, KV, 16)).astype(np.float32)
        want = jattn.flash_attention_jnp(*map(jnp.asarray, (q, k, v)),
                                         causal=causal, q_chunk=32,
                                         kv_chunk=32)
        got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
        assert got.shape == (2, S, H, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------------
# the wrappers' checks, on both routes
def test_unbuilt_widths_raise_on_both_routes():
    """(q/k, v) and (r, rope) pairs without a kernel raise ValueError on
    the CPU route (the op) and on the CUDA route (the wrapper checks
    before it asks for CUDA tensors); (24, 16) is fp32 only."""
    z = torch.zeros
    bad_flash = [(z(1, 4, 2, 192), z(1, 4, 2, 192), z(1, 4, 2, 64)),
                 (z(1, 4, 2, 24, dtype=torch.bfloat16),
                  z(1, 4, 2, 24, dtype=torch.bfloat16),
                  z(1, 4, 2, 16, dtype=torch.bfloat16)),
                 (z(1, 4, 2, 200), z(1, 4, 2, 200), z(1, 4, 2, 128))]
    for q, k, v in bad_flash:
        for fn in (ops.flash_attention, fa.flash_attention_bshd):
            with pytest.raises(ValueError, match="head dims"):
                fn(q, k, v)
    lens = torch.ones(1, dtype=torch.int32)
    bad_mla = [(512, 32, torch.float32), (32, 8, torch.bfloat16),
               (256, 64, torch.float32)]
    for r, rh, dt in bad_mla:
        args = (z(1, 4, r, dtype=dt), z(1, 4, rh, dtype=dt),
                z(1, 8, r, dtype=dt), z(1, 8, rh, dtype=dt), lens, 0.1)
        for fn in (ops.mla_decode_attention, md.mla_decode_attention_bhr):
            with pytest.raises(ValueError, match="rope dim"):
                fn(*args)
    # too many heads for a CTA, on both routes
    args = (z(1, 17, 32), z(1, 17, 8), z(1, 8, 32), z(1, 8, 8), lens, 0.1)
    for fn in (ops.mla_decode_attention, md.mla_decode_attention_bhr):
        with pytest.raises(ValueError, match="17 heads"):
            fn(*args)


def test_wrappers_take_cuda_tensors_only():
    ops.reset_counts()
    z = torch.zeros
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa.flash_attention_bshd(z(1, 4, 2, 192), z(1, 4, 2, 192),
                                z(1, 4, 2, 128))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        md.mla_decode_attention_bhr(z(1, 4, 32), z(1, 4, 8), z(1, 8, 32),
                                    z(1, 8, 8),
                                    torch.ones(1, dtype=torch.int32), 0.1)
    assert set(kernels.LAUNCHES.values()) == {0}


@pytest.fixture
def fake_card(monkeypatch):
    """The MLA wrapper's path on a card, with the CUDA calls stubbed:
    every tensor passes as a CUDA tensor, and the library records its
    calls."""
    calls = []

    class Lib:
        def repro_mla_decode_attention(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(md, "_library", lambda: Lib())
    monkeypatch.setattr(md, "check_cuda", lambda *a: None)
    monkeypatch.setattr(md, "_sm_count", lambda dev: 132)   # an H100 SXM
    monkeypatch.setattr(decode_plan, "scratch", lambda plan, dev, st: (
        torch.zeros(plan.ws_floats), torch.zeros(plan.n_tickets,
                                                 dtype=torch.int32)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("B,H,L,r,rh,dtype", [
    (8, 16, 2048, 512, 64, torch.bfloat16), (1, 16, 1, 512, 64,
                                             torch.float32),
    (2, 4, 65, 32, 8, torch.float32)])
def test_mla_wrapper_passes_the_plan_and_counts_one_launch(fake_card, B, H,
                                                           L, r, rh, dtype):
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    ops.reset_counts()
    out = md.mla_decode_attention_bhr(z(B, H, r), z(B, H, rh), z(B, L, r),
                                      z(B, L, rh),
                                      torch.ones(B, dtype=torch.int32), 0.25)
    assert out.shape == (B, H, r) and out.dtype == dtype
    assert kernels.LAUNCHES["mla_decode_attention"] == 1
    (args,) = fake_card
    s_max = max(1, min(-(-L // md.MIN_KEYS), md.MAX_SPLITS, 132 // B))
    assert args[:3] == (kernels.DTYPE_CODE[dtype], r, rh)
    assert args[11:16] == (B, H, L, s_max, md.MIN_KEYS)
    assert args[16] == 0.25
    # the bf16 kernel merges in its cluster's shared memory: no scratch
    bf16 = dtype == torch.bfloat16
    assert (args[9] is None and args[10] is None) == bf16
    plan = md.split_plan(B, H, r, L, 132)
    assert plan == (s_max, B * H * s_max * (r + 2), B)


def test_mla_wrapper_raises_on_a_failed_launch(fake_card, monkeypatch):
    monkeypatch.setattr(md, "_library", lambda: types.SimpleNamespace(
        repro_mla_decode_attention=lambda *a: 700))
    ops.reset_counts()
    z = torch.zeros
    with pytest.raises(RuntimeError, match="mla_decode_attention.*CUDA "
                                           "error 700"):
        md.mla_decode_attention_bhr(z(1, 4, 32), z(1, 4, 8), z(1, 8, 32),
                                    z(1, 8, 8),
                                    torch.ones(1, dtype=torch.int32), 0.1)
    assert kernels.LAUNCHES["mla_decode_attention"] == 0


def test_kernel_source_holds_the_plan_constants():
    """The wrapper's grain, head limit, tile and split limit are the
    kernel's constants."""
    import re

    from repro_torch.kernels import build
    assert "mla_decode.cu" in build.SOURCES
    text = (build.CSRC / "mla_decode.cu").read_text()
    for const, want in (("MLA_GRAIN", md.GRAIN_KEYS),
                        ("MLA_HEADS", md.MAX_HEADS),
                        ("MLA_TILE", md.TILE_KEYS),
                        ("MLA_MAX_SPLITS", md.MAX_SPLITS)):
        assert re.findall(rf"constexpr int {const} = (\d+);", text) == \
            [str(want)], const
    assert md.MIN_KEYS % md.GRAIN_KEYS == 0
    flash = (build.CSRC / "flash_attention.cu").read_text()
    assert "launch<192, 128>" in flash and "launch<24, 16>" in flash


# ----------------------------------------------------------------------
# the shared experts
_MOE_CASES = {"T1": (1, 1), "T8": (2, 4), "T13": (1, 13)}


@pytest.mark.parametrize("case", list(_MOE_CASES))
def test_apply_moe_with_shared_experts_matches_jax(model, case):
    jcfg, tcfg, jffn, tffn = _layer(model, r=1, what="ffn")
    assert sorted(tffn["shared"]) == ["w_down", "w_gate", "w_up"]
    B, S = _MOE_CASES[case]
    x = np.random.RandomState(len(case) + S).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    want, want_aux = _jmoe(jffn, jnp.asarray(x), jcfg)
    got, aux = moe.apply_moe(tffn, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)
    # the shared branch is there: the routed part alone differs
    routed, _ = moe.apply_moe(tffn, _t(x), tcfg.replace(n_shared_experts=0))
    np.testing.assert_allclose(
        (got - routed).numpy(),
        apply_mlp(tffn["shared"], _t(x), tcfg).numpy(), **TOL)


def test_apply_moe_with_shared_experts_bf16_matches_jax(model):
    jcfg, tcfg, jffn, tffn = _layer(model, r=0, what="ffn")
    jcfg = jcfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    tcfg = tcfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    x = np.random.RandomState(3).standard_normal(
        (2, 4, tcfg.d_model)).astype(np.float32)
    jffn = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jffn)
    tffn = jax.tree_util.tree_map(lambda a: a.to(torch.bfloat16), tffn)
    want, want_aux = _jmoe(jffn, jnp.asarray(x, jnp.bfloat16), jcfg)
    got, aux = moe.apply_moe(tffn, _t(x).to(torch.bfloat16), tcfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=max(BF16_TOL["atol"], ulp),
                               rtol=BF16_TOL["rtol"])
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **BF16_TOL)


# ----------------------------------------------------------------------
# weights
def test_params_from_numpy_carries_the_mla_tree(model):
    """Every leaf of the JAX tree is in the port's specs and the reverse:
    kind D's attention and MLP of dense_d_ff, the MLA mixer, the router,
    the experts and the shared experts; every value carried over."""
    jcfg, tcfg, jparams, tparams = model
    flat = _flat_numpy(jparams)
    specs = weights.param_specs(tcfg)
    assert sorted(flat) == sorted(specs)
    d, H, r = tcfg.d_model, tcfg.n_heads, tcfg.kv_lora_rank
    shapes = {"0/0/mixer/wq": (1, d, H * 16), "0/0/ffn/w_up": (1, d, 128),
              "1/0/mixer/wq": (2, d, H * 24), "1/0/mixer/w_dkv": (2, d, r),
              "1/0/mixer/w_krope": (2, d, 8), "1/0/mixer/kv_norm": (2, r),
              "1/0/mixer/w_uk": (2, r, H * 16),
              "1/0/mixer/w_uv": (2, r, H * 16),
              "1/0/mixer/wo": (2, H * 16, d),
              "1/0/ffn/shared/w_gate": (2, d, 64),
              "1/0/ffn/shared/w_down": (2, 64, d)}
    for leaf, shape in shapes.items():
        assert weights._full_shape(specs[f"groups/{leaf}"]) == shape, leaf
    for key, arr in flat.items():
        np.testing.assert_array_equal(_node(tparams, key).numpy(), arr)
    with pytest.raises(KeyError, match="w_dkv"):
        weights.params_from_numpy(
            {k: v for k, v in flat.items() if "w_dkv" not in k}, tcfg,
            device="cpu")
    # a leaf the port's tree has no place for (an MLA tree read as GQA)
    with pytest.raises(KeyError, match="not leaves"):
        weights.params_from_numpy(flat, tcfg.replace(kv_lora_rank=0),
                                  device="cpu")


def test_full_width_specs_match_jax():
    """The full-width deepseek-v2-lite tree, shapes checked without
    allocating: 15.71 B parameters."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    abstract = jax.eval_shape(lambda k: api.init(k, jcfg)[0],
                              jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in _flatten_with_paths(abstract)[0].items()}
    got = {k: weights._full_shape(s)
           for k, s in weights.param_specs(tcfg).items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 15_709_498_368


def test_init_params_draws_mla_and_shared_leaves_as_jax(model):
    """kv_norm ones; w_uk and w_uv N(0, 1/r) (JAX's fan-in is their first
    axis, the latent rank); a shared expert's w_gate N(0, 1/d)."""
    _, tcfg, _, _ = model
    full = get_config(ARCH).replace(dtype="float32", param_dtype="float32",
                                    n_layers=2, groups=(
                                        ScanGroup(("D",), 1),
                                        ScanGroup(("M",), 1)),
                                    vocab=256)
    p = weights.init_params(full, torch.Generator().manual_seed(0), "cpu")
    mixer, ffn = p["groups"][1][0]["mixer"], p["groups"][1][0]["ffn"]
    assert torch.equal(mixer["kv_norm"], torch.ones(1, 512))
    for key, fan_in in (("w_uk", 512), ("w_uv", 512), ("w_dkv", 2048)):
        assert abs(mixer[key].std().item() * math.sqrt(fan_in) - 1) < 0.02
    assert abs(ffn["shared"]["w_gate"].std().item() * math.sqrt(2048) - 1) \
        < 0.02
    assert p["groups"][0][0]["ffn"]["w_up"].shape == (1, 2048, 10944)


def test_load_checkpoint_is_exact(model, tmp_path):
    jcfg, tcfg, jparams, tparams = model
    Checkpointer(str(tmp_path)).save(3, jparams)
    got = weights.load_checkpoint(checkpoint_step_dir(str(tmp_path)), tcfg,
                                  "cpu")
    for key in _flat_numpy(jparams):
        assert torch.equal(_node(got, key), _node(tparams, key)), key


# ----------------------------------------------------------------------
# the model
def test_prefill_and_dense_decode_logits(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(3)
    B, S, L = 2, 8, 16
    toks = rng.randint(0, tcfg.vocab, size=(B, S)).astype(np.int32)
    last = np.array([7, 4], np.int32)
    jc = api.init_caches(jcfg, B, L)
    tc = ttfm.init_caches(tcfg, B, L, "cpu")
    assert sorted(tc[1][0]) == ["ckv", "krope"] and \
        tuple(tc[1][0]["ckv"].shape) == (2, B, L, 32)
    assert sorted(tc[0][0]) == ["k", "v"]
    lj, jc = _jpre(jparams, jcfg, jnp.asarray(toks), jc,
                   last_index=jnp.asarray(last))
    lt, tc = ttfm.prefill(tparams, tcfg, _t(toks), tc, last_index=_t(last))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for pos in ([8, 5], [9, 6], [15, 15], [16, 15]):
        tok = rng.randint(0, tcfg.vocab, size=(B, 1)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        lj, jc = _jdec(jparams, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos))
        lt, tc = ttfm.decode_step(tparams, tcfg, _t(tok), tc, _t(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for gi, group in enumerate(jc):
        for key, arr in group[0].items():
            np.testing.assert_allclose(tc[gi][0][key].numpy(),
                                       np.asarray(arr), **LOGIT_TOL)


def test_decode_matches_forward_stepwise():
    """``tests/test_arch_smoke.py:71-103`` for the port: decoding token by
    token from an empty cache (the absorbed MLA decode) gives the logits
    of one teacher-forced pass (MLA's expanded prefill) at every position,
    at a no-drop capacity (full-sequence routing would drop tokens that
    per-token decode keeps); and JAX's stepwise logits on the same
    weights."""
    jcfg, tcfg, jparams, tparams = _build(capacity_factor=8.0)
    T = 24
    toks = np.random.RandomState(2).randint(0, tcfg.vocab, (1, T)).astype(
        np.int32)
    x = embed(tparams["embedding"], _t(toks), tcfg)
    x, _, _ = ttfm.run_backbone(tparams, x, tcfg, "prefill",
                                ttfm.init_caches(tcfg, 1, T, "cpu"), None)
    full = ttfm._head(tparams, ttfm.apply_norm(tparams["final_norm"], x,
                                                tcfg), tcfg)
    tc = ttfm.init_caches(tcfg, 1, T + 1, "cpu")
    jc = api.init_caches(jcfg, 1, T + 1)
    steps, jsteps = [], []
    for t in range(T):
        pos = np.array([t], np.int32)
        lt, tc = ttfm.decode_step(tparams, tcfg, _t(toks[:, t:t + 1]), tc,
                                  _t(pos))
        lj, jc = _jdec(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]), jc,
                       jnp.asarray(pos))
        steps.append(lt[:, 0])
        jsteps.append(np.asarray(lj)[:, 0])
    stepwise = torch.stack(steps, dim=1)
    np.testing.assert_allclose(stepwise.numpy(), full.numpy(), **LOGIT_TOL)
    np.testing.assert_allclose(stepwise.numpy(), np.stack(jsteps, axis=1),
                               **LOGIT_TOL)


def test_bf16_mla_stays_near_jax(model, monkeypatch):
    """The P-precision divergence (ROADMAP Queue 3, "Routing"): in bf16
    JAX rounds P to bf16 in ``mha`` (a prefill below 1024 tokens) and in
    ``mla_decode`` (``p.astype(x.dtype)``), where the port keeps P in fp32
    on both paths.  One MLA layer in bf16 on the same inputs, on the CPU
    route (the reduced widths widened to bf16 for the plain versions,
    which the kernels are not built for): the prefill of 40 tokens and a
    decode step over 40 cached rows stay within 2 bf16 ulps of the
    largest output of JAX's, and the port's decode is no farther than
    JAX's from the fp32 result.  The test prints the gaps."""
    jcfg, tcfg, jp, _ = _layer(model)
    monkeypatch.setitem(kernels.FLASH_QK_V_DIMS, (24, 16),
                        (torch.float32, torch.bfloat16))
    monkeypatch.setitem(kernels.MLA_DIMS, (32, 8),
                        (torch.float32, torch.bfloat16))
    bf = dict(dtype="bfloat16", param_dtype="bfloat16")
    jb, tb = jcfg.replace(**bf), tcfg.replace(**bf)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = {k: _t(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
          for k, v in jp.items()}
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, (ckv, krope) = _jmla(jp, xb, jb)
    got, _ = tattn.mla_forward(tp, _t(x).to(torch.bfloat16), tb)
    exact = tattn.mla_forward({k: v.float() for k, v in tp.items()},
                              _t(np.asarray(xb.astype(jnp.float32))),
                              tcfg)[0].numpy()

    def gap(a, b):
        return float(np.abs(a - b).max())
    want_f = np.asarray(want.astype(jnp.float32))
    pre = gap(want_f, got.float().numpy())
    # a decode step at pos 40 over the prefill's 40 latent rows
    cache = {"ckv": jnp.zeros((2, 48, 32), jnp.bfloat16).at[:, :40].set(ckv),
             "krope": jnp.zeros((2, 48, 8), jnp.bfloat16).at[:, :40].set(
                 krope)}
    xd = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([40, 40], np.int32)
    wd, _ = _jmla_dec(jp, jnp.asarray(xd, jnp.bfloat16), cache,
                      jnp.asarray(pos), jb)
    tcache = {k: _t(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
              for k, v in cache.items()}
    gd, _ = tattn.mla_decode(tp, _t(xd).to(torch.bfloat16), tcache,
                             _t(pos), tb)
    ed, _ = tattn.mla_decode({k: v.float() for k, v in tp.items()},
                             _t(np.asarray(jnp.asarray(
                                 xd, jnp.bfloat16).astype(jnp.float32))),
                             {k: v.float() for k, v in tcache.items()},
                             _t(pos), tcfg)
    wd_f = np.asarray(wd.astype(jnp.float32))
    dec, port_err, jax_err = (gap(wd_f, gd.float().numpy()),
                              gap(gd.float().numpy(), ed.numpy()),
                              gap(wd_f, ed.numpy()))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want_f).max())) - 7)
    ulp_d = 2.0 ** (np.floor(np.log2(np.abs(wd_f).max())) - 7)
    print(f"bf16 MLA: prefill gap {pre:.4g} (JAX to fp32 "
          f"{gap(want_f, exact):.4g}; bf16 ulp {ulp:.4g}), decode gap "
          f"{dec:.4g} (port to fp32 {port_err:.4g}, JAX to fp32 "
          f"{jax_err:.4g}; bf16 ulp {ulp_d:.4g})")
    assert pre <= 2 * ulp and dec <= 2 * ulp_d
    assert port_err <= jax_err


# ----------------------------------------------------------------------
# engines: greedy decode token-exact against the JAX engine
_ENGINES = {"reference": dict(fused=False), "dense-fused": dict(fused=True),
            "paged-asked": dict(fused=True, paged=True, block_size=8)}


@pytest.mark.parametrize("sync_every", [4, 1])
@pytest.mark.parametrize("kind", list(_ENGINES))
def test_engine_greedy_tokens_exact(model, kind, sync_every):
    """2 slots, 5 prompts (slots finish mid-K-loop and refill), then a
    wave sharing a 16-token prefix with the first: tokens and finish
    reasons equal the JAX engine's, every admit batch-1.  Asked for the
    paged engine, both serve dense (MLA's latent cache cannot page) and
    count the fallback once."""
    jcfg, tcfg, jparams, tparams = model
    kw = dict(max_len=64, slots=2, sync_every=sync_every, **_ENGINES[kind])
    rng = np.random.RandomState(5)
    common = rng.randint(0, tcfg.vocab, 16).astype(np.int32)
    waves = [[rng.randint(0, tcfg.vocab, n).astype(np.int32)
              for n in (5, 9, 7, 12, 6)],
             [np.concatenate([common, rng.randint(0, tcfg.vocab, n)])
              .astype(np.int32) for n in (3, 9)]]
    waves[0][1] = np.concatenate([common, waves[0][1]])
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
    ops.reset_counts()
    teng = Engine(tparams, tcfg, ServeConfig(**kw), device="cpu")
    jreqs, treqs = [], []
    for wave in waves:
        jreqs += [jeng.submit(p, max_new=6) for p in wave]
        treqs += [teng.submit(p, max_new=6) for p in wave]
        jeng.run_until_drained()
        teng.run_until_drained()
    assert not teng.paged and not jeng.paged and teng.fns.row_coupled
    fallback = teng.metrics.counter("engine.paged_fallback_dense").value
    assert fallback == jeng.metrics.counter(
        "engine.paged_fallback_dense").value == int(kind == "paged-asked")
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert b.out_tokens == a.out_tokens, i
        assert b.finish_reason == a.finish_reason == "max_new", i
    # the layers' ops: flash for D and the MLA prefill, the split-K decode
    # for D, the MLA decode for the two M layers
    calls = ops.PLAIN_CALLS
    assert calls["flash_attention"] > 0 and calls["paged_decode_attention"] \
        == calls["paged_extend_attention"] == 0
    assert calls["mla_decode_attention"] == 2 * calls["decode_attention"] > 0


def test_speculative_falls_back_and_serves_dense(model):
    """``speculative=True`` with ``paged=True``: the engine serves dense,
    so speculation (paged only) is off, counted, with the same tokens."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, tcfg.vocab, size=6).astype(np.int32)
               for _ in range(2)]
    out = []
    for kw in (dict(), dict(paged=True, block_size=8, speculative=True)):
        eng = Engine(tparams, tcfg, ServeConfig(max_len=32, slots=2,
                                                sync_every=4, **kw),
                     device="cpu")
        reqs = [eng.submit(p, max_new=5) for p in prompts]
        eng.run_until_drained()
        out.append([r.out_tokens for r in reqs])
    assert not eng.paged and not eng.speculative
    assert eng.metrics.counter("engine.spec_fallback").value == 1
    assert out[0] == out[1]


@pytest.mark.parametrize("paged", [False, True])
def test_serve_driver_serves(paged):
    out = io.StringIO()
    argv = ["--device", "cpu", "--reduce", "--arch", ARCH, "--requests", "3",
            "--max-new", "4", "--slots", "2", "--max-len", "32"]
    with redirect_stdout(out):
        serve.main(argv + (["--paged", "--block-size", "8"] if paged else []))
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith(f"[serve] arch={ARCH}")
    assert "kv=dense" in line and "tokens=15" in line


def test_build_engine_builds_the_mla_engine():
    """A replica's backend builder takes the arch id like the driver."""
    from repro_torch.cluster.backends import build_engine
    backend = build_engine(arch=ARCH, max_len=32, slots=2, device="cpu")
    eng = backend.engine
    assert eng.cfg.kv_lora_rank == 32 and eng.fns.row_coupled
    assert sorted(eng.caches[1][0]) == ["ckv", "krope"]
    assert eng.params["groups"][1][0]["ffn"]["shared"]["w_up"].shape == \
        (1, 64, 64)
