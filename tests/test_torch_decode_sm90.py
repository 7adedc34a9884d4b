"""The edge shapes of the Hopper decode design (chunks of
``decode_plan.CHUNK_KEYS`` keys a CTA, ``csrc/decode_sm90.cuh``) held on
the CPU: the plain paged and dense decode attention against the JAX
oracles (``repro.kernels.ref``) and the Pallas kernels in interpret mode,
at the tolerances of tests/test_kernels.py:16.  ``chip_smoke.py`` phase 2
then holds the CUDA kernels against these plain versions at the same
kinds of shapes on the card.

Also: the split plan covers every live key once and takes shapes only,
the Pallas paged decode gives 0 for a row of length 0 (the contract the
CUDA kernel keeps), and both decode sources share the header.
"""
import functools
import inspect
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, decode_plan, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
C = decode_plan.CHUNK_KEYS

_jref_paged = jax.jit(jref.paged_decode_attention_ref)
_jpallas_paged = jax.jit(functools.partial(jops.paged_decode_attention,
                                           interpret=True))
_jref_dense = jax.jit(jref.decode_attention_ref)
_jpallas_dense = jax.jit(functools.partial(jops.decode_attention,
                                           interpret=True),
                         static_argnames=("n_splits",))


def _lengths(max_keys):
    """One short of, at and one past a chunk, one past two chunks, the
    longest row, and a short row whose later chunks all exit at once."""
    return [C - 1, C, C + 1, 2 * C + 1, max_keys, 3]


def _paged_case(bs, nb, H, KV, lengths, seed, hd=16, table=None):
    rng = np.random.RandomState(seed)
    B = len(lengths)
    n_blocks = B * nb + 1
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(n_blocks, bs, KV, hd).astype(np.float32)
    vp = rng.randn(n_blocks, bs, KV, hd).astype(np.float32)
    bt = (rng.permutation(n_blocks - 1) + 1).reshape(B, nb).astype(np.int32)
    if table is not None:
        table(bt, n_blocks)
    ln = np.asarray(lengths, np.int32)
    # the port's plain version gathers with torch indexing, so it takes
    # the table as the kernels read it: entries clamped into the pool
    out = ops.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp)),
        torch.from_numpy(np.clip(bt, 0, n_blocks - 1)),
        torch.from_numpy(ln)).numpy()
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, ln)]
    np.testing.assert_allclose(out, np.asarray(_jref_paged(*args)), **TOL)
    np.testing.assert_allclose(out, np.asarray(_jpallas_paged(*args)),
                               **TOL)


@pytest.mark.parametrize("bs,nb", [(8, 40), (16, 20), (32, 10), (12, 27)])
def test_paged_decode_chunk_and_page_edges(bs, nb):
    """Lengths around one and two chunks and at nb * bs, pages of 8, 16
    and 32 rows (which tile a chunk) and of 12 (which straddle chunk
    ends: keys 60-71 share a page); G = 2."""
    _paged_case(bs, nb, 4, 2, _lengths(nb * bs), seed=bs)


@pytest.mark.parametrize("H,KV", [(2, 2), (8, 2), (16, 2), (32, 2)])
def test_paged_decode_group_sizes(H, KV):
    """G = 1, 4 and 8 heads in one row group, and G = 16 in two."""
    _paged_case(16, 20, H, KV, _lengths(320), seed=H)


def test_paged_decode_clamps_lengths_and_table_entries():
    """A length past the table's span reads nb * bs keys, and table
    entries past the pool read its last row, as JAX's gather clamps."""
    def past_the_pool(bt, n_blocks):
        bt[0, 1] = n_blocks
        bt[2, 0] = n_blocks + 5
        bt[3, 4] = 2 ** 30

    _paged_case(16, 9, 4, 2, [100, 144, 145, 1000], seed=3,
                table=past_the_pool)                    # 144: two chunks


@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2), (16, 2), (32, 2)])
def test_dense_decode_chunk_edges(H, KV):
    """The dense decode at lengths around one and two chunks and at L,
    G 1, 2, 8 and 16, against the oracle and the Pallas kernel."""
    rng = np.random.RandomState(H)
    L, hd = 320, 16
    lengths = np.asarray(_lengths(L), np.int32)
    q = rng.randn(len(lengths), H, hd).astype(np.float32)
    k = rng.randn(len(lengths), L, KV, hd).astype(np.float32)
    v = rng.randn(len(lengths), L, KV, hd).astype(np.float32)
    out = ops.decode_attention(*(torch.from_numpy(a) for a in
                                 (q, k, v, lengths))).numpy()
    args = [jnp.asarray(a) for a in (q, k, v, lengths)]
    np.testing.assert_allclose(out, np.asarray(_jref_dense(*args)), **TOL)
    np.testing.assert_allclose(
        out, np.asarray(_jpallas_dense(*args, n_splits=8)), **TOL)


def test_paged_decode_length_zero_gives_zero_in_pallas():
    """A row of length 0 sees no key.  The Pallas paged decode skips every
    block and gives 0 (acc / max(l, 1e-30) with l = 0), which the CUDA
    kernel keeps; the oracle and the port's plain version give the mean
    of V over the table's rows instead."""
    rng = np.random.RandomState(5)
    q = rng.randn(2, 4, 16).astype(np.float32)
    kp = rng.randn(9, 8, 2, 16).astype(np.float32)
    vp = rng.randn(9, 8, 2, 16).astype(np.float32)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    ln = np.asarray([0, 20], np.int32)
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, ln)]
    pallas = np.asarray(_jpallas_paged(*args))
    assert np.all(pallas[0] == 0)
    plain = ops.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, ln))).numpy()
    mean_v = vp[bt[0]].reshape(32, 2, 16).mean(axis=0)       # (KV, hd)
    np.testing.assert_allclose(plain[0], np.repeat(mean_v, 2, axis=0),
                               **TOL)
    np.testing.assert_allclose(plain[1], pallas[1], **TOL)


def _merged_chunks(plan, live):
    """The chunks the kernel merges for a row of ``live`` keys, by its
    rule (decode_sm90.cuh): chunk c holds keys [c * C, min(live, (c + 1)
    * C)), and a chunk starting at or past ``live`` exits at once."""
    return [(c * C, min(live, (c + 1) * C)) for c in range(plan.n_chunks)
            if c * C < live]


@pytest.mark.parametrize("max_keys", [1, C - 1, C, C + 1, 300, 2048, 4097,
                                      12 * 27])
def test_split_plan_covers_each_live_key_once(max_keys):
    plan = decode_plan.split_plan(8, 16, 8, 128, max_keys)
    assert plan.n_chunks == -(-max_keys // C)
    for live in sorted({0, 1, C - 1, C, C + 1, max_keys // 2, max_keys}):
        if live > max_keys:
            continue
        chunks = _merged_chunks(plan, live)
        keys = [t for k0, k1 in chunks for t in range(k0, k1)]
        assert keys == list(range(live))                # each key once
        assert all(k0 < k1 <= live for k0, k1 in chunks)  # none past live
        assert len(chunks) == -(-live // C)


@pytest.mark.parametrize("B,H,KV,hd,max_keys,want", [
    (8, 16, 8, 128, 2048, (16, 8 * 16 * 16 * 130, 64)),
    (1, 4, 4, 16, 8, (1, 4 * 18, 4)),
    (3, 32, 2, 64, 0, (1, 3 * 32 * 66, 12)),      # G 16: two row groups
    (2, 12, 4, 32, 129, (2, 2 * 12 * 2 * 34, 8)),
])
def test_split_plan_sizes_scratch_from_shapes(B, H, KV, hd, max_keys, want):
    assert tuple(decode_plan.split_plan(B, H, KV, hd, max_keys)) == want


def test_split_plan_takes_shapes_only(monkeypatch):
    """The plan's arguments are shapes; the paged wrapper passes it ints
    (nothing that reads ``lengths``), before it asks for CUDA tensors."""
    assert list(inspect.signature(decode_plan.split_plan).parameters) == \
        ["B", "H", "KV", "hd", "max_keys"]
    seen = []
    real = decode_plan.split_plan
    monkeypatch.setattr(decode_plan, "split_plan",
                        lambda *a: seen.append(a) or real(*a))
    q = torch.zeros(2, 2, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_attention_bkgd(q, torch.zeros(5, 8, 2, 16),
                                       torch.zeros(5, 8, 2, 16),
                                       torch.ones(2, 3, dtype=torch.int32),
                                       torch.tensor([5, 9],
                                                    dtype=torch.int32))
    assert seen == [(2, 4, 2, 16, 24)]
    assert all(type(x) is int for x in seen[0])


@pytest.mark.parametrize("source", ["paged_attention.cu",
                                    "decode_attention.cu"])
def test_decode_sources_share_the_decode_header(source):
    assert "decode_sm90.cuh" in build.local_includes(source)
    text = (build.CSRC / source).read_text()
    for gone in ("decode_split_kernel", "decode_merge_kernel"):
        assert gone not in text, gone


def test_decode_header_holds_the_split_key_design():
    text = (build.CSRC / "decode_sm90.cuh").read_text()
    ptx = "".join((build.CSRC / n).read_text()
                  for n in build.local_includes("decode_attention.cu"))
    for needle in ("cp.async.bulk.tensor", "mbarrier", "expect_tx",
                   "try_wait.parity", "cuTensorMapEncodeTiled"):
        assert needle in ptx, needle
    for needle in ("tma_load_4d", "mbar_wait(empty", "mbar_arrive(empty",
                   "atomicAdd", "__ldcg", "static std::unordered_map"):
        assert needle in text, needle
    chunk = re.findall(r"constexpr int DECODE_CHUNK = (\d+);", text)
    assert chunk == [str(decode_plan.CHUNK_KEYS)]
    rows = re.findall(r"constexpr int DECODE_ROWS = (\d+);", text)
    assert rows == [str(decode_plan.ROWS_PER_CTA)]
