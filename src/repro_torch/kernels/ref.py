"""Plain PyTorch versions of the kernels (the port of
``repro.kernels.ref``, ``ref.py:13-115``, and of MLA's absorbed decode,
which JAX computes in plain ``jnp``).

They are the ground truth the CUDA kernels in ``csrc/*.cu`` are held
against, and what :mod:`repro_torch.kernels.ops` runs for a tensor on the
CPU; a backward kernel's plain version is autograd through its forward's.
:func:`linear_scan_bwd_ref` and :func:`selective_scan_bwd_ref` write the
scans' adjoint out step by step, equal to that autograd result, for the
tests and for ``chip_smoke.py``'s controls.  All math is fp32 (fp64
inputs stay fp64 in :func:`pair_score_ref` and the attention versions but
MLA's); masked scores take the
finite ``NEG_INF`` so a fully masked row never produces a NaN.  The
attention versions take ``softcap``: with c > 0 every scaled score s
becomes ``c * tanh(s / c)`` before the mask, as JAX's plain ``mha`` and
``flash_attention_jnp`` compute it (``attention.py:69-70``, ``:152-153``),
so a masked score stays ``NEG_INF``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def _acc(t):
    """The dtype the attention versions compute in: fp32, fp64 for fp64
    inputs."""
    return torch.promote_types(t.dtype, torch.float32)


def _capped(s, softcap: float):
    """``softcap * tanh(s / softcap)`` for a cap > 0, else ``s``."""
    return torch.tanh(s / softcap) * softcap if softcap else s


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """q, k: (B,S,H,hd), (B,T,KV,hd); v: (B,T,KV,hd_v), where hd_v may be
    narrower than hd (MLA's prefill).  Masked full attention at scale
    1/sqrt(hd).  The S queries are the last S of the T key positions:
    query s sits at position s + T - S and sees key t iff ``t <= s + T -
    S`` (causal) and ``t > s + T - S - window`` (window).  T == S is a
    whole prefill; T > S under a mask is a sequence shard's queries over
    the keys before them (``models.attention.seqshard_attn_forward``);
    with neither mask each query sees all T keys (a cross attention).
    ``softcap`` > 0 caps the scaled scores before the mask.  Returns
    (B,S,H,hd_v); under autograd its gradient is the plain backward."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    acc = _acc(q)
    qg = q.reshape(B, S, KV, G, hd).to(acc)
    s = _capped(torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(acc)) /
                math.sqrt(hd), softcap)
    qi = torch.arange(S, device=q.device)[:, None] + (T - S)
    si = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= si <= qi
    if window:
        ok &= si > qi - window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(acc))
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, softcap: float = 0.0):
    """q: (B,H,hd) single query; k,v: (B,L,KV,hd); lengths: (B,) valid
    prefix; ``softcap`` > 0 caps the scaled scores before the mask.
    Returns (B,H,hd)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    acc = _acc(q)
    qg = q.reshape(B, KV, G, hd).to(acc)
    s = _capped(torch.einsum("bkgh,bskh->bkgs", qg, k.to(acc)) /
                math.sqrt(hd), softcap)
    L = k.shape[1]
    ok = torch.arange(L, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.to(acc))
    return o.reshape(B, H, hd).to(q.dtype)


def mla_decode_attention_ref(q_lat, q_rope, ckv, krope, lengths, scale):
    """MLA's absorbed decode attention (``repro.models.attention.
    mla_decode``, ``attention.py:636-643``): q_lat (B,H,r) the absorbed
    query, q_rope (B,H,rh), the latent cache ckv (B,L,r) and its RoPE key
    krope (B,L,rh), lengths (B,).  Scores ``(q_lat ckv^T + q_rope
    krope^T) * scale`` in fp32 over keys ``l < lengths`` (a length past L
    sees all L rows; a length of 0 sees none, and its softmax over the
    finite NEG_INF is uniform: the mean of ckv), P in fp32 (JAX rounds it
    to the activation dtype), out ``P ckv``.  Returns (B,H,r) in q_lat's
    dtype."""
    s = (torch.einsum("bhr,blr->bhl", q_lat.float(), ckv.float()) +
         torch.einsum("bhd,bld->bhl", q_rope.float(), krope.float())) * scale
    L = ckv.shape[1]
    ok = torch.arange(L, device=q_lat.device)[None, :] < lengths[:, None]
    s = torch.where(ok[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhl,blr->bhr", p, ckv.float()).to(q_lat.dtype)


def _gather(pool, block_tables):
    """(B, nb*bs, KV, hd) virtual caches materialized through the table."""
    B, nb = block_tables.shape
    bs = pool.shape[1]
    return pool[block_tables.long()].reshape(B, nb * bs, *pool.shape[2:])


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                               softcap: float = 0.0):
    """Single-query decode attention through a block table.

    q: (B,H,hd); k_pool/v_pool: (num_blocks, bs, KV, hd); block_tables:
    (B, nb) physical block ids (padded with the null block); lengths: (B,)
    valid prefix length; ``softcap`` as in :func:`decode_attention_ref`.
    Returns (B,H,hd)."""
    return decode_attention_ref(q, _gather(k_pool, block_tables),
                                _gather(v_pool, block_tables), lengths,
                                softcap)


def paged_extend_attention_ref(q, k_pool, v_pool, block_tables, pos0,
                               softcap: float = 0.0):
    """Suffix-extend attention through a block table.

    q: (B,S,H,hd) queries at absolute positions ``pos0 + s``; pools and
    tables as in :func:`paged_decode_attention_ref`; pos0: (B,).  Key at
    virtual position p is visible to query s iff ``p <= pos0 + s``;
    ``softcap`` > 0 caps the scaled scores before the mask.  Returns
    (B,S,H,hd)."""
    B, S, H, hd = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    k = _gather(k_pool, block_tables)
    v = _gather(v_pool, block_tables)
    acc = _acc(q)
    qg = q.reshape(B, S, KV, G, hd).to(acc)
    s = _capped(torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(acc)) /
                math.sqrt(hd), softcap)
    L = k.shape[1]
    positions = pos0[:, None] + torch.arange(S, device=q.device)[None, :]
    ok = torch.arange(L, device=q.device)[None, None, :] <= positions[:, :, None]
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(acc))
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


def selective_scan_ref(xc, dt, Bc, Cc, A, D, h0=None):
    """Mamba-1's selective scan as the op composes it around the scan
    (``repro.kernels.ops.ssm_scan``, ``ops.py:98-111``): ``a_bar = exp(dt
    A)``, ``b_bar = (dt xc) Bc`` (both (B,S,di,N)), :func:`ssm_scan_ref`,
    then ``y = einsum(h_seq, Cc) + xc D``.  xc, dt (B,S,di); Bc, Cc
    (B,S,N); A (di,N); D (di,); h0 (B,di,N) or None (zeros); fp32.  Returns
    (y (B,S,di), h_final (B,di,N))."""
    a_bar = (dt[..., None] * A).exp_()                  # (B,S,di,N)
    b_bar = (dt * xc)[..., None] * Bc[:, :, None, :]    # (B,S,di,N)
    if h0 is None:
        h0 = torch.zeros((xc.shape[0], xc.shape[2], A.shape[-1]),
                         dtype=torch.float32, device=xc.device)
    h_seq, h_fin = ssm_scan_ref(a_bar, b_bar, h0)
    return torch.einsum("bsdn,bsn->bsd", h_seq, Cc) + xc * D, h_fin


def linear_scan_bwd_ref(a, hs, h0, g, gT):
    """The backward of :func:`ssm_scan_ref` written out: the adjoint lam_t
    (the gradient reaching h_t) walked from the end, ``lam_{S-1} = g_{S-1}
    + gT``, ``lam_t = g_t + a_{t+1} lam_{t+1}``; ``db_t = lam_t``, ``da_t =
    lam_t h_{t-1}`` (``h_{-1} = h0``) and ``dh0 = a_0 lam_0``.  a, hs (the
    forward's h_seq) and g (the gradient of h_seq): (B,S,...); h0 and gT
    (the gradient of h_final): (B,...).  Returns (da, db, dh0)."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    m = gT
    for t in range(a.shape[1] - 1, -1, -1):
        lam = m + g[:, t]
        db[:, t] = lam
        da[:, t] = lam * (hs[:, t - 1] if t else h0)
        m = a[:, t] * lam
    return da, db, m


def selective_scan_bwd_ref(xc, dt, Bc, Cc, A, D, h0, gy, gT):
    """The backward of :func:`selective_scan_ref` written out, for upstream
    gradients gy (B,S,di) of y and gT (B,di,N) of h_final: the adjoint of
    the scan by :func:`linear_scan_bwd_ref` on ``a_bar`` with ``gy C``
    reaching each h_t, then ``dC = sum_d gy h``, ``dB = sum_d lam dt x``,
    ``dx = gy D + dt sum_n lam B``, ``ddt = sum_n lam x B + sum_n da_bar
    a_bar A``, ``dA = sum_{b,s} da_bar a_bar dt``, ``dD = sum_{b,s} gy
    x``.  Returns (dxc, ddt, dBc, dCc, dA, dD, dh0)."""
    a_bar = (dt[..., None] * A).exp()                   # (B,S,di,N)
    b_bar = (dt * xc)[..., None] * Bc[:, :, None, :]
    if h0 is None:
        h0 = torch.zeros((xc.shape[0], xc.shape[2], A.shape[-1]),
                         dtype=torch.float32, device=xc.device)
    hs, _ = ssm_scan_ref(a_bar, b_bar, h0)
    da_bar, lam, dh0 = linear_scan_bwd_ref(
        a_bar, hs, h0, gy[..., None] * Cc[:, :, None, :], gT)
    lam_b = torch.einsum("bsdn,bsn->bsd", lam, Bc)
    dA_bar = da_bar * a_bar                             # d/d(dt A)
    dxc = gy * D + dt * lam_b
    ddt = lam_b * xc + torch.einsum("bsdn,dn->bsd", dA_bar, A)
    dBc = torch.einsum("bsdn,bsd->bsn", lam, dt * xc)
    dCc = torch.einsum("bsdn,bsd->bsn", hs, gy)
    dA = torch.einsum("bsdn,bsd->dn", dA_bar, dt)
    dD = (gy * xc).sum((0, 1))
    return dxc, ddt, dBc, dCc, dA, dD, dh0
