"""Attention of the port, GQA paged subset (``repro.models.attention``).

K/V live in one shared block pool per layer, ``(num_blocks + 1, bs, KV,
hd)``, addressed through per-sequence block tables; physical block 0 is the
reserved null block that absorbs pad and stale writes.  The paged decode
and extend steps always run their attention through
:mod:`repro_torch.kernels.ops`: the Hopper kernels on CUDA tensors, the
plain versions on the CPU.

In place, unlike JAX: :func:`_paged_scatter` writes K/V rows into the pool
tensors it is given (``index_put_``), so the decode and extend steps
update the engine's pools where they lie and return the same dict.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rms_norm

NEG_INF = -2.0e38


def _project_qkv(params, xq, xkv, cfg, positions_q, positions_kv, rope_base):
    """(``attention.py:40-58``) -> q (B,Sq,H,hd), k/v (B,Skv,KV,hd)."""
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (xq @ params["wq"]).reshape(B, Sq, H, hd)
    k = (xkv @ params["wk"]).reshape(B, Skv, KV, hd)
    v = (xkv @ params["wv"]).reshape(B, Skv, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if rope_base:
        q = apply_rope(q, positions_q, rope_base)
        k = apply_rope(k, positions_kv, rope_base)
    return q, k, v


def mha(q, k, v, mask, softcap: float = 0.0):
    """q: (B,Sq,H,hd)  k,v: (B,Skv,KV,hd)  mask: broadcastable (B,1,Sq,Skv).
    Probabilities are cast to ``q.dtype`` before P·V, as in
    ``attention.py:73``."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = torch.where(mask[:, :, None] if mask.dim() == 4 else mask,
                             scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def init_paged_kv_cache(cfg, num_blocks: int, block_size: int, device):
    """Per-layer block pool; ``num_blocks`` usable + 1 reserved null row."""
    shape = (num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"kp": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
            "vp": torch.zeros(shape, dtype=cfg.act_dtype, device=device)}


def is_paged_cache(cache) -> bool:
    return isinstance(cache, dict) and "kp" in cache


def _paged_scatter(cache, k, v, vpos, bt):
    """Write per-position K/V rows into the pool through the block table,
    in place.  k/v: (B, S, KV, hd); vpos: (B, S) virtual positions; bt:
    (B, nb).  Positions beyond the table redirect to the null block
    (``attention.py:483-498``)."""
    bs = cache["kp"].shape[1]
    nb = bt.shape[1]
    vblock = vpos // bs
    phys = torch.gather(bt, 1, vblock.clamp(max=nb - 1))
    phys = torch.where(vblock < nb, phys, 0).long()
    off = (vpos % bs).long()
    cache["kp"][phys, off] = k.to(cache["kp"].dtype)
    cache["vp"][phys, off] = v.to(cache["vp"].dtype)
    return cache


def _paged_gather(cache, bt):
    """(B, nb*bs, KV, hd) virtual caches, materialized via the table."""
    B, nb = bt.shape
    bs = cache["kp"].shape[1]
    idx = bt.long()
    k = cache["kp"][idx].reshape(B, nb * bs, *cache["kp"].shape[2:])
    v = cache["vp"][idx].reshape(B, nb * bs, *cache["vp"].shape[2:])
    return k, v


def _rope_base(cfg, kind: str) -> float:
    return cfg.rope_local_base if kind == "local" else cfg.rope_base


def paged_attn_decode(params, x, cache, pos, bt, cfg, *, kind: str):
    """Single decode step over a paged cache (``attention.py:510-532``).
    x: (B,1,d); pos: (B,) int32 absolute write position; bt: (B, nb)
    int32.  Keys ``<= pos`` are visible."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, x, cfg, pos[:, None], pos[:, None],
                           _rope_base(cfg, kind))
    cache = _paged_scatter(cache, k, v, pos[:, None], bt)
    out = kops.paged_decode_attention(q[:, 0].contiguous(), cache["kp"],
                                      cache["vp"], bt, pos + 1)
    return out.reshape(B, 1, -1) @ params["wo"], cache


def paged_attn_extend(params, x, cache, pos0, bt, cfg, *, kind: str):
    """Prefill a suffix into a paged cache (``attention.py:535-561``): S
    tokens at absolute positions ``pos0 + s`` (per row) attend to the
    cached prefix blocks and causally within the suffix.  x: (B,S,d);
    pos0: (B,) int32; bt: (B, nb) int32."""
    B, S, _ = x.shape
    positions = pos0[:, None] + torch.arange(S, dtype=pos0.dtype,
                                             device=pos0.device)[None, :]
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions,
                           _rope_base(cfg, kind))
    cache = _paged_scatter(cache, k, v, positions, bt)
    out = kops.paged_extend_attention(q.contiguous(), cache["kp"],
                                      cache["vp"], bt, pos0)
    return out.reshape(B, S, -1) @ params["wo"], cache
