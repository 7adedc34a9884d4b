"""Plain PyTorch versions of the kernels (the port of
``repro.kernels.ref``, ``ref.py:13-115``).

They are the ground truth the CUDA kernels in ``csrc/*.cu`` are held
against, and what :mod:`repro_torch.kernels.ops` runs for a tensor on the
CPU.  All math is fp32 (fp64 inputs stay fp64 in :func:`pair_score_ref`);
masked scores take the finite ``NEG_INF`` so a fully masked row never
produces a NaN.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,hd)  k,v: (B,S,KV,hd).  Masked full attention: query s
    sees key t iff ``t <= s`` (causal) and ``t > s - window`` (window).
    Returns (B,S,H,hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    qi = torch.arange(S, device=q.device)[:, None]
    si = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= si <= qi
    if window:
        ok &= si > qi - window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q, k, v, lengths):
    """q: (B,H,hd) single query; k,v: (B,L,KV,hd); lengths: (B,) valid
    prefix.  Returns (B,H,hd)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) / math.sqrt(hd)
    L = k.shape[1]
    ok = torch.arange(L, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def _gather(pool, block_tables):
    """(B, nb*bs, KV, hd) virtual caches materialized through the table."""
    B, nb = block_tables.shape
    bs = pool.shape[1]
    return pool[block_tables.long()].reshape(B, nb * bs, *pool.shape[2:])


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths):
    """Single-query decode attention through a block table.

    q: (B,H,hd); k_pool/v_pool: (num_blocks, bs, KV, hd); block_tables:
    (B, nb) physical block ids (padded with the null block); lengths: (B,)
    valid prefix length.  Returns (B,H,hd)."""
    return decode_attention_ref(q, _gather(k_pool, block_tables),
                                _gather(v_pool, block_tables), lengths)


def paged_extend_attention_ref(q, k_pool, v_pool, block_tables, pos0):
    """Suffix-extend attention through a block table.

    q: (B,S,H,hd) queries at absolute positions ``pos0 + s``; pools and
    tables as in :func:`paged_decode_attention_ref`; pos0: (B,).  Key at
    virtual position p is visible to query s iff ``p <= pos0 + s``.
    Returns (B,S,H,hd)."""
    B, S, H, hd = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    k = _gather(k_pool, block_tables)
    v = _gather(v_pool, block_tables)
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    L = k.shape[1]
    positions = pos0[:, None] + torch.arange(S, device=q.device)[None, :]
    ok = torch.arange(L, device=q.device)[None, None, :] <= positions[:, :, None]
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def pair_score_ref(claims, evidence, W, w_c, w_e, bias):
    """The paper's phase-2 Cartesian scoring: claims (N,d) x evidence
    (M,d) -> (N,M), ``(C W) E^T + (C w_c)[:, None] + (E w_e)[None, :] +
    bias``, with every input cast to at least fp32 first."""
    f = lambda t: t.to(torch.promote_types(t.dtype, torch.float32))  # noqa
    c, e = f(claims), f(evidence)
    bil = (c @ f(W)) @ e.T
    lin = (c @ f(w_c))[:, None] + (e @ f(w_e))[None, :]
    return bil + lin + bias


def ssm_scan_ref(a_bar, b_bar, h0):
    """Diagonal SSM recurrence ``h_t = a_t * h_{t-1} + b_t``, one step at a
    time (``ref.py:106-115``).  a_bar, b_bar: (B,S,D,N) fp32; h0: (B,D,N).
    Returns (h_seq (B,S,D,N), h_final (B,D,N))."""
    h_seq = torch.empty_like(b_bar)
    h = h0
    for t in range(a_bar.shape[1]):
        h = a_bar[:, t] * h + b_bar[:, t]
        h_seq[:, t] = h
    return h_seq, h
