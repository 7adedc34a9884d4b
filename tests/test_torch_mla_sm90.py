"""The split plan of the MLA decode's Hopper design (``kernels/mla_decode.py``,
``csrc/mla_decode.cu``), on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` phase 2 holds
it against its plain version); here:
- :func:`mla_decode.splits`, the mirror of the kernel's ``mla_split``,
  covers every live key once, in at most ``s_max`` runs, none empty, each
  boundary but the last a multiple of ``GRAIN_KEYS``;
- :func:`mla_decode.split_plan` takes shapes only, never ``lengths``, so a
  CUDA graph can capture the call;
- the bf16 kernel's arithmetic, emulated in torch (each split's key tiles
  of ``TILE_KEYS`` rows with an online softmax in the log2 domain, P as
  bf16 hi + lo before P V, the splits merged in split order as the
  cluster's CTAs merge them), against JAX's einsum chain of
  ``mla_decode`` (``src/repro/models/attention.py:636-643``) on the same
  inputs, rounded to bf16 values and run in fp32.  Tolerance ``atol =
  rtol = 1e-5``: P = hi + lo holds P to ~2^-17 of itself, and the rest is
  fp32 summation order.  Rows past the live keys hold NaN in the
  emulation's cache, which must not reach the output.
"""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import mla_decode as md  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
LOG2E = 1.4426950408889634
NEG_INF = -2.0e38
#: the serve's plan on an H100 (132 SMs): B 8 over L 2048
S_MAX = md.split_plan(8, 16, 512, 2048, 132).n_chunks


def _edge_lengths(s_max, min_keys, L):
    g, k = md.GRAIN_KEYS, min_keys
    return sorted({0, 1, g - 1, g, g + 1, k - 1, k, k + 1,
                   s_max * k - 1, s_max * k, s_max * k + 1, L, L + 1, 2 * L})


@pytest.mark.parametrize("s_max,min_keys", [
    (S_MAX, md.MIN_KEYS), (1, md.MIN_KEYS), (3, 16), (8, 32), (5, 128)])
def test_splits_cover_each_live_key_once(s_max, min_keys):
    L = 2048
    for length in _edge_lengths(s_max, min_keys, L):
        live = min(max(length, 0), L)
        runs = md.splits(live, s_max, min_keys)
        if live == 0:
            assert runs == []
            continue
        assert 1 <= len(runs) <= s_max
        assert len(runs) == min(s_max, -(-live // min_keys))
        assert runs[0][0] == 0 and runs[-1][1] == live
        for (a0, a1), (b0, _) in zip(runs, runs[1:]):
            assert a1 == b0                        # no gap, no overlap
        for k0, k1 in runs:
            assert k0 < k1                         # none empty
            assert k0 % md.GRAIN_KEYS == 0
        for _, k1 in runs[:-1]:
            assert k1 % md.GRAIN_KEYS == 0
        sizes = [k1 - k0 for k0, k1 in runs[:-1]]
        if sizes:                                  # near-equal runs
            assert max(sizes) - min(sizes) <= md.GRAIN_KEYS


def test_splits_refuse_a_grain_below_the_kernels():
    with pytest.raises(ValueError):
        md.splits(100, 4, md.GRAIN_KEYS - 1)


@pytest.mark.parametrize("B,L,n_sm,want", [
    (8, 2048, 132, 8), (1, 1, 132, 1),
    (8, 70, 132, -(-70 // md.MIN_KEYS)), (64, 2048, 132, 2),
    (200, 4096, 132, 1)])
def test_split_plan_sizes_the_grid_from_shapes(B, L, n_sm, want):
    plan = md.split_plan(B, 16, 512, L, n_sm)
    assert plan == (want, B * 16 * want * 514, B)
    assert 1 <= plan.n_chunks <= md.MAX_SPLITS


def test_split_plan_takes_shapes_only(monkeypatch):
    """The plan's arguments are shapes and the SM count; the wrapper passes
    it ints, whatever the lengths."""
    assert list(inspect.signature(md.split_plan).parameters) == \
        ["B", "H", "r", "L", "n_sm"]
    seen, calls = [], []

    class Lib:
        def repro_mla_decode_attention(self, *args):
            calls.append(args)
            return 0

    real = md.split_plan
    monkeypatch.setattr(md, "split_plan",
                        lambda *a: seen.append(a) or real(*a))
    monkeypatch.setattr(md, "_library", lambda: Lib())
    monkeypatch.setattr(md, "check_cuda", lambda *a: None)
    monkeypatch.setattr(md, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    for lens in ([1, 2048], [300, 0]):
        md.mla_decode_attention_bhr(z(2, 16, 512), z(2, 16, 64),
                                    z(2, 2048, 512), z(2, 2048, 64),
                                    torch.tensor(lens, dtype=torch.int32),
                                    0.1)
    assert seen == [(2, 16, 512, 2048, 132)] * 2
    assert all(type(x) is int for x in seen[0])
    # only the lengths' pointer (and the tensors') differ between calls
    for i in (0, 1, 2, 11, 12, 13, 14, 15, 16):
        assert calls[0][i] == calls[1][i]


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ----------------------------------------------------------------------
# the bf16 kernel's arithmetic, emulated

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_sm90(q_lat, q_rope, ckv, krope, lengths, scale, s_max,
                  min_keys):
    """What ``mla_decode_sm90_kernel`` computes, step for step: per split,
    tiles of TILE_KEYS keys, raw scores' running max, p = 2^(s qs - m qs),
    P V with P as bf16 hi + lo, (m qs, l, O) per split; the cluster's
    merge in split order.  Inputs are fp32 tensors holding bf16 values."""
    B, H, r = q_lat.shape
    L = ckv.shape[1]
    qs = scale * LOG2E
    q = torch.cat([q_lat, q_rope], -1)
    k = torch.cat([ckv, krope], -1)
    out = torch.empty(B, H, r)
    for b in range(B):
        live = min(max(int(lengths[b]), 0), L)
        if live == 0:
            out[b] = ckv[b].mean(0)
            continue
        parts = []
        for k0, k1 in md.splits(live, s_max, min_keys):
            m = torch.full((H,), NEG_INF)
            l = torch.zeros(H)
            o = torch.zeros(H, r)
            for t0 in range(k0, k1, md.TILE_KEYS):
                t1 = min(k1, t0 + md.TILE_KEYS)
                s = q[b] @ k[b, t0:t1].T
                mn = torch.maximum(m, s.max(1).values)
                corr = torch.exp2((m - mn) * qs)
                p = torch.exp2(s * qs - (mn * qs)[:, None])
                hi = _bf16(p)
                lo = _bf16(p - hi)
                l = l * corr + p.sum(1)
                o = o * corr[:, None] + (hi + lo) @ ckv[b, t0:t1]
                m = mn
            parts.append((m * qs, l, o))
        mx = torch.stack([pm for pm, _, _ in parts]).max(0).values
        li, acc = torch.zeros(H), torch.zeros(H, r)
        for pm, pl, po in parts:
            w = torch.exp2(pm - mx)
            li = li + pl * w
            acc = acc + po * w[:, None]
        out[b] = acc / li.clamp_min(1e-30)[:, None]
    return out


def _jax_chain(q_lat, q_rope, ckv, krope, lengths, scale):
    s = (jnp.einsum("bhr,bsr->bhs", q_lat, ckv)
         + jnp.einsum("bhd,bsd->bhs", q_rope, krope)) * scale
    valid = jnp.arange(ckv.shape[1])[None, :] < lengths[:, None]
    s = jnp.where(valid[:, None, :], s, jattn.NEG_INF)
    import jax
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhs,bsr->bhr", p, ckv)


@pytest.mark.parametrize("B,H,L,r,rh,lengths,s_max,min_keys", [
    (2, 4, 200, 32, 8, [1, 200], 4, 16),
    (3, 16, 130, 32, 8, [63, 64, 65], 8, 16),        # tile edges
    (4, 16, 300, 64, 16, [0, 17, 129, 299], 3, 64),  # length 0; s_max caps
    (2, 5, 520, 32, 8, [520, 9999], 8, 32),          # past L; 5 heads
    (8, 16, 330, 512, 64, list(range(301, 330, 4)), S_MAX, md.MIN_KEYS),
])
def test_sm90_emulation_matches_the_jax_chain(B, H, L, r, rh, lengths,
                                              s_max, min_keys):
    rng = np.random.RandomState(B * L + r)
    args = [_bf16(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))) for s in ((B, H, r), (B, H, rh), (B, L, r), (B, L, rh))]
    lens = np.asarray(lengths, np.int32)
    scale = 1.0 / math.sqrt(24)
    want = _jax_chain(*(jnp.asarray(a.numpy()) for a in args),
                      jnp.asarray(lens), scale)
    # rows past each row's live keys NaN (a row of length 0 averages all)
    ckv, krope = args[2].clone(), args[3].clone()
    for b, n in enumerate(lengths):
        if 0 < n < L:
            ckv[b, n:] = float("nan")
            krope[b, n:] = float("nan")
    got = _emulate_sm90(args[0], args[1], ckv, krope, torch.from_numpy(lens),
                        scale, s_max, min_keys)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
