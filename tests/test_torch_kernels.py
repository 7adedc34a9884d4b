"""PyTorch port vs the JAX package: the kernel modules (flash, split-K
decode, paged decode and paged extend attention, and the phase-2 pair
score).

On the CPU the port's ops take their plain versions
(``repro_torch.kernels.ref``); they are held against the JAX oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode on the
grids of tests/test_kernels.py:21-137.  The CUDA kernels themselves run
only on the card, where ``chip_smoke.py`` holds them against these plain
versions.  Tolerances as tests/test_kernels.py:16: fp32 ``2e-5``, bf16
``3e-2`` (bf16 output rounding); the pair score's are at its tests.
"""
import functools
import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes: one thread is faster and leaves
                           # the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core.sharding import split_params  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import svm as jsvm  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import pair_score as ps  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import svm  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}

# the JAX oracles and Pallas kernels (interpret mode) jitted whole: one
# compile per shape, not one per operation
_jref_flash = jax.jit(jref.flash_attention_ref,
                      static_argnames=("causal", "window"))
_jref_dense_decode = jax.jit(jref.decode_attention_ref)
_jpallas_flash = jax.jit(functools.partial(
    jops.flash_attention, block_q=64, block_kv=64, interpret=True),
    static_argnames=("causal", "window"))
_jpallas_dense_decode = jax.jit(functools.partial(jops.decode_attention,
                                                  interpret=True),
                                static_argnames=("n_splits",))
_jref_decode = jax.jit(jref.paged_decode_attention_ref)
_jref_extend = jax.jit(jref.paged_extend_attention_ref)
_jpallas_decode = jax.jit(functools.partial(jops.paged_decode_attention,
                                            interpret=True))
_jpallas_extend = jax.jit(functools.partial(jops.paged_extend_attention,
                                            interpret=True))
_jref_pair = jax.jit(jref.pair_score_ref)


def _pair(a, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    if dtype == "bfloat16":
        a16 = a.astype(ml_dtypes.bfloat16)
        return (torch.from_numpy(a16.view(np.int16)).view(torch.bfloat16),
                jnp.asarray(a16))
    return torch.from_numpy(a), jnp.asarray(a)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _paged_inputs(seed, B, nb_seq, bs, KV, hd, q_shape, dtype):
    rng = np.random.RandomState(seed)
    num_blocks = B * nb_seq + 1               # + reserved null block 0
    q = _pair(rng.randn(*q_shape).astype(np.float32), dtype)
    kp = _pair(rng.randn(num_blocks, bs, KV, hd).astype(np.float32), dtype)
    vp = _pair(rng.randn(num_blocks, bs, KV, hd).astype(np.float32), dtype)
    # each sequence owns a random disjoint set of blocks, scrambled
    bt = (rng.permutation(num_blocks - 1) + 1).reshape(B, nb_seq)
    bt = bt.astype(np.int32)
    return rng, q, kp, vp, (torch.from_numpy(bt), jnp.asarray(bt))


def _dense_inputs(seed, dtype, *shapes):
    rng = np.random.RandomState(seed)
    return rng, [_pair(rng.randn(*s).astype(np.float32), dtype)
                 for s in shapes]


_FLASH_SHAPES = [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 512, 4, 1, 128),    # MQA
    (1, 192, 6, 2, 32),     # ragged seq (the TPU kernel's pad path)
]


@pytest.mark.parametrize("B,S,H,KV,hd", _FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_attention(B, S, H, KV, hd, dtype, causal, window):
    """tests/test_kernels.py:21-38: the plain flash attention against the
    JAX oracle."""
    _, (q, k, v) = _dense_inputs(42, dtype, (B, S, H, hd), (B, S, KV, hd),
                                 (B, S, KV, hd))
    out = ops.flash_attention(q[0], k[0], v[0], causal=causal, window=window)
    assert out.shape == (B, S, H, hd) and out.dtype == q[0].dtype
    want = _jref_flash(q[1], k[1], v[1], causal=causal, window=window)
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 64, 4, 2, 32),
                                         (1, 192, 6, 2, 32)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_attention_vs_pallas(B, S, H, KV, hd, causal, window):
    """The plain flash attention against the Pallas kernel in interpret
    mode (64-blocks, so S = 192 walks the pad path), fp32."""
    _, (q, k, v) = _dense_inputs(43, "float32", (B, S, H, hd),
                                 (B, S, KV, hd), (B, S, KV, hd))
    out = ops.flash_attention(q[0], k[0], v[0], causal=causal, window=window)
    want = _jpallas_flash(q[1], k[1], v[1], causal=causal, window=window)
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("B,L,H,KV,hd,n_splits", [
    (2, 256, 8, 2, 64, 4),
    (1, 512, 4, 4, 128, 8),
    (3, 128, 4, 1, 64, 2),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(B, L, H, KV, hd, n_splits, dtype):
    """tests/test_kernels.py:41-55: the plain split-K decode against the
    JAX oracle and the Pallas kernel in interpret mode."""
    rng, (q, k, v) = _dense_inputs(7, dtype, (B, H, hd), (B, L, KV, hd),
                                   (B, L, KV, hd))
    lengths = rng.randint(1, L + 1, size=B).astype(np.int32)
    ln = (torch.from_numpy(lengths), jnp.asarray(lengths))
    out = ops.decode_attention(q[0], k[0], v[0], ln[0], n_splits=n_splits)
    assert out.shape == (B, H, hd) and out.dtype == q[0].dtype
    want = _jref_dense_decode(q[1], k[1], v[1], ln[1])
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL[dtype])
    pallas = _jpallas_dense_decode(q[1], k[1], v[1], ln[1],
                                   n_splits=n_splits)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOL[dtype])


def test_decode_attention_length_zero_is_the_mean_of_v():
    """A row of length 0 sees no key: the Pallas kernel, the JAX oracle and
    the plain version all give the mean of V over the L rows (the CUDA
    kernel is held to the same on the card)."""
    rng, (q, k, v) = _dense_inputs(8, "float32", (2, 4, 32), (2, 64, 2, 32),
                                   (2, 64, 2, 32))
    lengths = np.asarray([0, 17], np.int32)
    out = ops.decode_attention(q[0], k[0], v[0], torch.from_numpy(lengths),
                               n_splits=4)
    mean_v = v[0][0].mean(dim=0)                       # (KV, hd)
    np.testing.assert_allclose(
        out[0].numpy(), mean_v.repeat_interleave(2, dim=0).numpy(),
        **TOL["float32"])
    pallas = _jpallas_dense_decode(q[1], k[1], v[1], jnp.asarray(lengths),
                                   n_splits=4)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOL["float32"])


@pytest.mark.parametrize("B,nb_seq,bs,H,KV,hd,dtype", [
    (2, 4, 16, 8, 2, 64, "float32"),     # GQA 4:1
    (1, 3, 32, 4, 4, 128, "float32"),    # MHA
    (3, 5, 8, 4, 1, 64, "float32"),      # MQA, small blocks
    (2, 4, 16, 8, 2, 64, "bfloat16"),
    (3, 5, 8, 4, 1, 64, "bfloat16"),
])
def test_paged_decode_attention(B, nb_seq, bs, H, KV, hd, dtype):
    rng, q, kp, vp, bt = _paged_inputs(13, B, nb_seq, bs, KV, hd,
                                       (B, H, hd), dtype)
    lengths = rng.randint(1, nb_seq * bs + 1, size=B).astype(np.int32)
    ln = (torch.from_numpy(lengths), jnp.asarray(lengths))
    out = ops.paged_decode_attention(q[0], kp[0], vp[0], bt[0], ln[0])
    assert out.shape == (B, H, hd) and out.dtype == q[0].dtype
    want = _jref_decode(q[1], kp[1], vp[1], bt[1], ln[1])
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL[dtype])
    pallas = _jpallas_decode(q[1], kp[1], vp[1], bt[1], ln[1])
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOL[dtype])


@pytest.mark.parametrize("B,S,nb_seq,bs,H,KV,hd,dtype", [
    (2, 4, 4, 16, 8, 2, 64, "float32"),    # GQA 4:1
    (1, 8, 3, 32, 4, 4, 128, "float32"),   # MHA
    (3, 3, 5, 8, 4, 1, 64, "float32"),     # MQA, small blocks, odd suffix
    (2, 16, 2, 16, 8, 2, 64, "float32"),   # suffix spanning whole blocks
    (2, 4, 4, 16, 8, 2, 64, "bfloat16"),
])
def test_paged_extend_attention(B, S, nb_seq, bs, H, KV, hd, dtype):
    rng, q, kp, vp, bt = _paged_inputs(17, B, nb_seq, bs, KV, hd,
                                       (B, S, H, hd), dtype)
    pos0 = rng.randint(0, nb_seq * bs - S + 1, size=B).astype(np.int32)
    p0 = (torch.from_numpy(pos0), jnp.asarray(pos0))
    out = ops.paged_extend_attention(q[0], kp[0], vp[0], bt[0], p0[0])
    assert out.shape == (B, S, H, hd) and out.dtype == q[0].dtype
    want = _jref_extend(q[1], kp[1], vp[1], bt[1], p0[1])
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL[dtype])
    pallas = _jpallas_extend(q[1], kp[1], vp[1], bt[1], p0[1])
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOL[dtype])


def test_paged_decode_matches_dense_decode():
    """A pool holding the same tokens as a dense cache gives the dense
    decode's output (the paged engine's parity in miniature)."""
    rng = np.random.RandomState(21)
    B, L, H, KV, hd, bs = 2, 64, 4, 2, 32, 16
    nb = L // bs
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, L, KV, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, L, KV, hd).astype(np.float32))
    lengths = torch.tensor([L, 23], dtype=torch.int32)
    # sequences interleaved block by block in the pool
    kp = torch.cat([torch.zeros(1, bs, KV, hd)] +
                   [k[b, j * bs:(j + 1) * bs][None]
                    for j in range(nb) for b in range(B)])
    vp = torch.cat([torch.zeros(1, bs, KV, hd)] +
                   [v[b, j * bs:(j + 1) * bs][None]
                    for j in range(nb) for b in range(B)])
    bt = torch.tensor([[1 + j * B + b for j in range(nb)] for b in range(B)],
                      dtype=torch.int32)
    out = ops.paged_decode_attention(q, kp, vp, bt, lengths)
    want = ref.decode_attention_ref(q, k, v, lengths)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL["float32"])


def test_paged_extend_from_zero_is_causal_prefill():
    """pos0 = 0 over the whole sequence is causal prefill: it must match
    the JAX flash oracle on the same tokens."""
    rng = np.random.RandomState(23)
    B, S, H, KV, hd, bs = 2, 64, 4, 2, 32, 16
    nb = S // bs
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, S, KV, hd).astype(np.float32)
    v = rng.randn(B, S, KV, hd).astype(np.float32)
    blocks = lambda a: np.concatenate(  # noqa: E731
        [np.zeros((1, bs, KV, hd), np.float32)] +
        [a[b, j * bs:(j + 1) * bs][None] for j in range(nb)
         for b in range(B)])
    bt = np.array([[1 + j * B + b for j in range(nb)] for b in range(B)],
                  np.int32)
    out = ops.paged_extend_attention(
        torch.from_numpy(q), torch.from_numpy(blocks(k)),
        torch.from_numpy(blocks(v)), torch.from_numpy(bt),
        torch.zeros(B, dtype=torch.int32))
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               **TOL["float32"])


def _decode_args(**over):
    B, H, KV, hd, bs, nb = 2, 4, 2, 16, 8, 3
    args = dict(q=torch.zeros(B, H, hd), k_pool=torch.zeros(7, bs, KV, hd),
                v_pool=torch.zeros(7, bs, KV, hd),
                block_tables=torch.ones(B, nb, dtype=torch.int32),
                lengths=torch.ones(B, dtype=torch.int32))
    args.update(over)
    return args


@pytest.mark.parametrize("bad", [
    dict(q=torch.zeros(2, 4, 48), k_pool=torch.zeros(7, 8, 2, 48),
         v_pool=torch.zeros(7, 8, 2, 48)),                 # head_dim 48
    dict(q=torch.zeros(2, 4, 16, dtype=torch.float16)),    # dtype
    dict(k_pool=torch.zeros(7, 8, 2, 16, dtype=torch.bfloat16)),  # mixed
    dict(block_tables=torch.ones(2, 3, dtype=torch.int64)),      # int64
    dict(lengths=torch.ones(3, dtype=torch.int32)),              # shape
    dict(q=torch.zeros(4, 2, 16).transpose(0, 1)),         # non-contiguous
    dict(q=torch.zeros(2, 3, 16)),                         # 3 heads / 2 kv
    dict(q=torch.zeros(2, 4, 16, device="meta")),          # device mix
])
def test_wrapper_rejects(bad):
    with pytest.raises(ValueError):
        ops.paged_decode_attention(**_decode_args(**bad))


def test_wrapper_rejects_unroutable_device():
    meta = {k: v.to("meta") for k, v in _decode_args().items()}
    with pytest.raises(ValueError, match="no route"):
        ops.paged_decode_attention(**meta)


def _flash_args(**over):
    B, S, H, KV, hd = 2, 5, 4, 2, 16
    args = dict(q=torch.zeros(B, S, H, hd), k=torch.zeros(B, S, KV, hd),
                v=torch.zeros(B, S, KV, hd))
    args.update(over)
    return args


def _dense_decode_args(**over):
    B, L, H, KV, hd = 2, 12, 4, 2, 16
    args = dict(q=torch.zeros(B, H, hd), k=torch.zeros(B, L, KV, hd),
                v=torch.zeros(B, L, KV, hd),
                lengths=torch.ones(B, dtype=torch.int32))
    args.update(over)
    return args


@pytest.mark.parametrize("bad", [
    dict(q=torch.zeros(2, 5, 4, 48), k=torch.zeros(2, 5, 2, 48),
         v=torch.zeros(2, 5, 2, 48)),                      # head_dim 48
    dict(q=torch.zeros(2, 5, 4, 16, dtype=torch.float16)),  # dtype
    dict(k=torch.zeros(2, 5, 2, 16, dtype=torch.bfloat16)),  # mixed
    dict(k=torch.zeros(2, 6, 2, 16)),                      # S differs
    dict(q=torch.zeros(2, 4, 5, 16).transpose(1, 2)),      # non-contiguous
    dict(q=torch.zeros(2, 5, 3, 16)),                      # 3 heads / 2 kv
    dict(q=torch.zeros(2, 5, 4, 16, device="meta")),       # device mix
    dict(window=-1),
])
def test_flash_wrapper_rejects(bad):
    window = bad.pop("window", 0)
    with pytest.raises(ValueError):
        ops.flash_attention(**_flash_args(**bad), window=window)


@pytest.mark.parametrize("bad", [
    dict(q=torch.zeros(2, 4, 48), k=torch.zeros(2, 12, 2, 48),
         v=torch.zeros(2, 12, 2, 48)),                     # head_dim 48
    dict(q=torch.zeros(2, 4, 16, dtype=torch.float16)),    # dtype
    dict(v=torch.zeros(2, 12, 2, 16, dtype=torch.bfloat16)),  # mixed
    dict(lengths=torch.ones(2, dtype=torch.int64)),        # int64
    dict(lengths=torch.ones(3, dtype=torch.int32)),        # shape
    dict(k=torch.zeros(2, 12, 2, 16)[:, ::2]),             # non-contiguous
    dict(q=torch.zeros(2, 3, 16)),                         # 3 heads / 2 kv
    dict(n_splits=0),
])
def test_decode_wrapper_rejects(bad):
    n_splits = bad.pop("n_splits", 8)
    with pytest.raises(ValueError):
        ops.decode_attention(**_dense_decode_args(**bad), n_splits=n_splits)


def test_kernel_wrappers_take_cuda_tensors_only():
    a = _decode_args()
    q4 = a["q"].view(2, 2, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_attention_bkgd(q4, a["k_pool"], a["v_pool"],
                                       a["block_tables"], a["lengths"])
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_extend_attention_bkgd(q4.view(2, 1, 2, 2, 16), a["k_pool"],
                                       a["v_pool"], a["block_tables"],
                                       a["lengths"])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bshd(**_flash_args())
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_bhd(**_dense_decode_args())
    link, c, e = _pair_args()
    with pytest.raises(ValueError, match="CUDA"):
        ps.pair_score_blocked(c, e, link["W"], link["w"][:16],
                              link["w"][16:], link["bias"])


def test_cpu_route_counts_plain_calls_only():
    ops.reset_counts()
    ops.paged_decode_attention(**_decode_args())
    a = _decode_args()
    ops.paged_extend_attention(a["q"][:, None].contiguous(), a["k_pool"],
                               a["v_pool"], a["block_tables"], a["lengths"])
    ops.flash_attention(**_flash_args())
    ops.decode_attention(**_dense_decode_args())
    ops.pair_score(*_pair_args())
    xc = torch.rand(1, 3, 4)
    ops.ssm_scan(xc, xc, torch.rand(1, 3, 2), torch.rand(1, 3, 2),
                 -torch.rand(4, 2), torch.rand(4))
    assert ops.PLAIN_CALLS == {"paged_decode_attention": 1,
                               "paged_extend_attention": 1,
                               "flash_attention": 1, "decode_attention": 1,
                               "pair_score": 1, "ssm_scan": 1}
    assert set(kernels.LAUNCHES.values()) == {0}
    assert pa.LAUNCHES is kernels.LAUNCHES
    ops.reset_counts()
    assert set(ops.PLAIN_CALLS.values()) == {0}


def test_build_failure_raises(tmp_path, monkeypatch):
    """A failing nvcc raises with its output; nothing is loaded."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build.shutil, "which", lambda name: str(fake))
    with pytest.raises(RuntimeError, match="no such target"):
        build.build_all()
    assert not any(p.suffix == ".so" for p in (tmp_path / "out").iterdir())


def _fake_nvcc(tmp_path):
    """An nvcc that logs each call and writes the library it is asked
    for."""
    fake = tmp_path / "nvcc"
    fake.write_text(f'#!/bin/sh\necho call >> "{tmp_path}/calls"\n'
                    'while [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then touch "$2"; fi\n'
                    '  shift\ndone\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return fake


def test_build_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header that a source includes, directly or through
    another header, renames the library and rebuilds it; an unchanged
    tree reuses it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "x.cuh"\nint a;\n')
    (csrc / "x.cuh").write_text('#pragma once\n  #  include "y.cuh"\n')
    (csrc / "y.cuh").write_text("// v1\n")
    (csrc / "z.cuh").write_text("// not included\n")
    fake = _fake_nvcc(tmp_path)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "SOURCES", ("a.cu",))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build.shutil, "which", lambda name: str(fake))
    assert build.local_includes("a.cu") == ["x.cuh", "y.cuh"]
    calls = lambda: (tmp_path / "calls").read_text().count("call")  # noqa
    first = build.build_all()["a.cu"]
    assert first.exists() and calls() == 1
    (csrc / "z.cuh").write_text("// edited, still not included\n")
    assert build.build_all()["a.cu"] == first and calls() == 1
    (csrc / "y.cuh").write_text("// v2\n")
    second = build.build_all()["a.cu"]
    assert second != first and second.exists() and calls() == 2


def test_port_sources_share_the_common_header():
    for source in build.SOURCES:
        assert "common.cuh" in build.local_includes(source), source


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert os.listdir(tmp_path) == []


# ----------------------------------------------------------------------
# The phase-2 pair score.  Both packages cast the inputs to fp32 first, so
# bf16 inputs are held to the fp32 tolerance.  The scores reach |134| at
# d = 512 and the two differ only in fp32 summation order: measured, at
# most 9.2e-5 absolute, 31% of atol + rtol * |want|, so the limit cannot
# be halved; it is still far inside tests/test_kernels.py:177-180.
PAIR_TOL = dict(atol=1e-4, rtol=1e-4)


def _pair_inputs(seed, N, M, d, dtype):
    rng = np.random.RandomState(seed)
    c = _pair(rng.randn(N, d).astype(np.float32), dtype)
    e = _pair(rng.randn(M, d).astype(np.float32), dtype)
    W = (rng.randn(d, d) / np.sqrt(d)).astype(np.float32)
    w = rng.randn(2 * d).astype(np.float32)
    return c, e, W, w


@pytest.mark.parametrize("N,M,d", [(64, 128, 256), (100, 60, 128),
                                   (128, 128, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_score(N, M, d, dtype):
    """tests/test_kernels.py:165-180: the plain pair score against the
    Pallas kernel in interpret mode and the JAX oracle."""
    c, e, W, w = _pair_inputs(3, N, M, d, dtype)
    link = {"W": torch.from_numpy(W), "w": torch.from_numpy(w),
            "bias": torch.tensor(0.3)}
    out = ops.pair_score(link, c[0], e[0])
    assert out.shape == (N, M) and out.dtype == torch.float32
    jlink = {"W": jnp.asarray(W), "w": jnp.asarray(w),
             "bias": jnp.asarray(0.3)}
    pallas = jops.pair_score(jlink, c[1], e[1], block_n=32, block_m=64,
                             interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **PAIR_TOL)
    want = _jref_pair(c[1], e[1], jnp.asarray(W), jnp.asarray(w[:d]),
                      jnp.asarray(w[d:]), 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **PAIR_TOL)


def test_pair_score_matches_link_score_matrix():
    """tests/test_kernels.py:234-247: the port's pair score on the JAX
    package's link model equals the JAX ``svm.link_score_matrix``."""
    d = 128
    params, _ = split_params({"link": jsvm.init_link(jax.random.PRNGKey(1),
                                                      d)})
    jlink = params["link"]
    rng = np.random.RandomState(2)
    c = rng.randn(96, d).astype(np.float32)
    e = rng.randn(64, d).astype(np.float32)
    link = {k: torch.from_numpy(np.array(v)) for k, v in jlink.items()}
    out = ops.pair_score(link, torch.from_numpy(c), torch.from_numpy(e))
    want = jsvm.link_score_matrix(jlink, jnp.asarray(c), jnp.asarray(e))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **PAIR_TOL)
    assert torch.equal(svm.link_score_matrix(link, torch.from_numpy(c),
                                             torch.from_numpy(e)), out)


def _pair_args(**over):
    d = 16
    link = {"W": torch.zeros(d, d), "w": torch.zeros(2 * d),
            "bias": torch.tensor(0.0)}
    args = dict(claims=torch.zeros(5, d), evidence=torch.zeros(3, d))
    link.update({k: over.pop(k) for k in list(over) if k in link})
    args.update(over)
    return link, args["claims"], args["evidence"]


@pytest.mark.parametrize("bad", [
    dict(claims=torch.zeros(5, 8)),                        # d differs
    dict(claims=torch.zeros(5, 16, 1)),                    # 3-D
    dict(claims=torch.zeros(0, 16)),                       # N = 0
    dict(W=torch.zeros(16, 8)),                            # W shape
    dict(w=torch.zeros(16)),                               # w shape
    dict(bias=torch.zeros(2)),                             # bias size
    dict(claims=torch.zeros(5, 16, dtype=torch.float16)),  # dtype
    dict(evidence=torch.zeros(3, 16, dtype=torch.bfloat16)),  # mixed
    dict(W=torch.zeros(16, 16, dtype=torch.bfloat16)),     # W vs w dtype
    dict(claims=torch.zeros(16, 5).T),                     # non-contiguous
    dict(evidence=torch.zeros(3, 16, device="meta")),      # device mix
])
def test_pair_score_rejects(bad):
    with pytest.raises(ValueError):
        ops.pair_score(*_pair_args(**bad))


def test_pair_score_rejects_low_rank_link():
    """The JAX op raises KeyError on "W" for a U/V link; the port names
    the form."""
    link, c, e = _pair_args()
    low = {"U": torch.zeros(16, 4), "V": torch.zeros(16, 4),
           "w": link["w"], "bias": link["bias"]}
    with pytest.raises(ValueError, match="U/V"):
        ops.pair_score(low, c, e)


def test_pair_score_mixed_input_dtypes():
    """bf16 claims and evidence with an fp32 W (tests/test_kernels.py:
    170-172) are accepted on both routes: each is cast to fp32."""
    c, e, W, w = _pair_inputs(4, 7, 5, 32, "bfloat16")
    link = {"W": torch.from_numpy(W), "w": torch.from_numpy(w),
            "bias": torch.tensor(-0.1)}
    out = ops.pair_score(link, c[0], e[0])
    want = ops.pair_score(link, c[0].float(), e[0].float())
    assert torch.equal(out, want)
