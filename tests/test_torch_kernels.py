"""PyTorch port vs the JAX package: the paged attention kernel modules.

On the CPU the port's ops take their plain versions
(``repro_torch.kernels.ref``); they are held against the JAX oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode on the
grids of tests/test_kernels.py:60-137.  The CUDA kernels themselves run
only on the card, where ``chip_smoke.py`` holds them against these plain
versions.  Tolerances as tests/test_kernels.py:16: fp32 ``2e-5``, bf16
``3e-2`` (bf16 output rounding).
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

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}

# the JAX oracles and Pallas kernels (interpret mode) jitted whole: one
# compile per shape, not one per operation
_jref_decode = jax.jit(jref.paged_decode_attention_ref)
_jref_extend = jax.jit(jref.paged_extend_attention_ref)
_jpallas_decode = jax.jit(functools.partial(jops.paged_decode_attention,
                                            interpret=True))
_jpallas_extend = jax.jit(functools.partial(jops.paged_extend_attention,
                                            interpret=True))


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


def test_cpu_route_counts_plain_calls_only():
    ops.reset_counts()
    ops.paged_decode_attention(**_decode_args())
    a = _decode_args()
    ops.paged_extend_attention(a["q"][:, None].contiguous(), a["k_pool"],
                               a["v_pool"], a["block_tables"], a["lengths"])
    assert ops.PLAIN_CALLS == {"paged_decode_attention": 1,
                               "paged_extend_attention": 1}
    assert pa.LAUNCHES == {"paged_decode_attention": 0,
                           "paged_extend_attention": 0}
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


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert os.listdir(tmp_path) == []
