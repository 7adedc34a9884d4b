"""Attention of the port, the GQA subset of ``repro.models.attention``:
full-sequence causal prefill, dense-cache decode, and the paged decode and
extend steps, for kinds ``causal``, ``global`` and ``local`` (a sliding
window of ``cfg.window`` keys, RoPE at ``cfg.rope_local_base``), and the
encoder-decoder's full-sequence kinds ``bidir`` (the encoder's
self-attention) and ``cross`` (the decoder over the encoder states), both
without RoPE (``attention.py:256-274``).

Dense caches are ``{"k", "v"}`` of ``(B, L, KV, hd)`` per layer.  A local
layer whose window is shorter than the cache keeps a ring instead
(``attention.py:350-359``): ``L = window`` rows, position ``p`` in row
``p % L``, and a ``"pos"`` leaf ``(B, L)`` int32 of the position each row
holds (-1 for none).  Every path writes a ring in position order from 0
(exact-length prefills, then one row a decode step), so after position
``pos`` is written its visible rows, JAX's ``0 <= pos_row``, ``pos_row >
pos - window`` and ``pos_row <= pos``, are exactly rows ``0 ..
min(pos + 1, L) - 1``: the decode runs the split-K decode kernel over the
ring with ``lengths = min(pos + 1, L)``.  Paged
caches are one shared block pool per layer, ``(num_blocks + 1, bs, KV,
hd)``, addressed through per-sequence block tables; physical block 0 is the
reserved null block that absorbs pad and stale writes.  Every attention of
these paths runs through :mod:`repro_torch.kernels.ops`: the Hopper
kernels on CUDA tensors, the plain versions on the CPU.  Unlike the JAX
package, which sends prefills shorter than 128 tokens to its plain
``mha``, every causal prefill goes through ``flash_attention``, so no
plain attention runs on the card.  So do ``bidir`` and ``cross`` (JAX
runs ``mha`` below 1,024 tokens, which rounds P to the activation dtype;
flash keeps P in fp32): ``cross`` at a key count T of its own, the
encoder's length.

Attention logit soft-capping (``cfg.attn_softcap`` > 0, Gemma 2's
``attn_logit_softcapping``): every route here but MLA's passes the cap to
its kernel op, which caps each scaled score before the mask, as JAX's
``jnp`` path does on every non-MLA route (``mha``, ``flash_attention_jnp``,
``_local_attention``); MLA's prefill and absorbed decode are not capped,
as in JAX (``attention.py:606-609``, ``:621-646``).  JAX's Pallas kernels
take no cap, so its ``use_kernels`` path drops it; the port follows the
``jnp`` path (ROADMAP.md, Standing divergences).

MLA (deepseek-v2-lite, ``attention.py:565-646``) keeps a compressed
cache per layer, ``{"ckv" (B, L, kv_lora_rank), "krope" (B, L,
rope_head_dim)}``: the normalised latent and the RoPE'd key shared by all
heads.  Its prefill expands them into q/k of ``nope + rope`` and v of
``v_head_dim`` per head and runs ``flash_attention`` at every S (JAX runs
its plain ``mha`` below 1024 tokens, which rounds P to the activation
dtype); its decode is the absorbed form, through
``kops.mla_decode_attention`` over the latent cache.

Sequence-sharded passes (``seqtp``, :func:`seqshard_attn_forward`,
:func:`seqshard_mla_forward`): each rank of the mesh's ``model`` axis
holds S / n consecutive positions and runs flash at a query offset over
the keys up to its last position: a halo of the previous rank's last W
keys for a local layer whose window fits the shard, else the K/V of
every rank all-gathered (MLA: the latent, 576 values a token against
the 5,120 of its expanded K/V, up-projected after the gather).  A local
layer keeps its window on the gathered route, where JAX's drops it
(``attention.py:237-242``; ROADMAP.md, Queue 3).  The gathers and the
halo shift are the differentiable ``collectives.tp_gather`` and
``collectives.halo_cat``, and flash's backward takes the offset, so the
same code trains.

Tensor-parallel (``tp``, ``fsdp_tp``; ``core.sharding.tp_mesh``): q comes
from the rank's ``wq`` block, the heads of ``core.sharding.head_block``
(the block's own whole heads; where it cuts a head, or its heads do not
map onto whole kv heads, the covering heads' columns through a gather
over ``model``, ``sharding.gathered_columns``).  K and V are computed
whole from the replicated ``wk`` / ``wv`` (entered into the region, so
their gradients are summed over ``model``), so every rank writes the
whole cache, as JAX's cache specs hold it (``kv_heads`` never split);
the attention reads the kv heads its q heads use, and ``wo``'s row block
is followed by a sum over ``model``.  MLA splits ``wq``, ``w_uk``,
``w_uv`` and ``wo`` by heads and keeps the latent projections
replicated.

In place, unlike JAX: :func:`batched_cache_update`, :func:`prefill_into_cache`
and :func:`_paged_scatter` write K/V rows into the cache tensors they are
given, so the decode, prefill and extend steps update the engine's caches
where they lie and return the same dict.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import collectives
from repro_torch.core import sharding
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rms_norm

NEG_INF = -2.0e38
#: the shortest sequence JAX shards under ``seqtp`` (``attention.py:18``)
FLASH_MIN_SEQ = 1024
#: layer calls of each sequence-sharded route: ``"halo"`` (a local layer
#: whose window fits the shard), ``"gather"`` (every other attention
#: layer), ``"latent"`` (MLA), ``"carry"`` (a Mamba or RG-LRU layer,
#: ``models/ssm.py``, ``models/rglru.py``) and ``"moe"`` (a MoE FFN whose
#: capacity is the whole sequence's, ``models/moe.py``)
SEQSHARD_ROUTES = {"halo": 0, "gather": 0, "latent": 0, "carry": 0,
                   "moe": 0}


def _head_block(cfg):
    """This rank's :class:`core.sharding.HeadBlock` under ``tp``, or
    None."""
    mesh = sharding.tp_mesh()
    if mesh is None:
        return None
    return sharding.head_block(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                               mesh)


def _project_q(params, x, cfg, positions, rope_base, hb):
    """q (B,S,Hc,hd) of the heads ``hb`` computes (all H without tp),
    qk-normed and rotated; under tp ``x`` has entered the region."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    if hb is not None and hb.cuts:
        q, = sharding.gathered_columns(x, params["wq"],
                                       [(hb.h0 * hd, hb.h1 * hd)],
                                       sharding.tp_mesh())
    else:
        q = x @ params["wq"]
    q = q.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, sharding.enter_model(params["q_norm"]), cfg.norm_eps)
    if rope_base:
        q = apply_rope(q, positions, rope_base)
    return q


def _project_qkv(params, xq, xkv, cfg, positions_q, positions_kv, rope_base,
                 hb=None):
    """(``attention.py:40-58``) -> q (B,Sq,H,hd), k/v (B,Skv,KV,hd); with
    a head block ``hb`` (``tp``), q of its heads and k / v whole."""
    B, Skv = xkv.shape[:2]
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    enter = sharding.enter_model
    same = xkv is xq
    xq = enter(xq)
    xkv = xq if same else enter(xkv)
    q = _project_q(params, xq, cfg, positions_q, rope_base, hb)
    k = (xkv @ enter(params["wk"])).reshape(B, Skv, KV, hd)
    v = (xkv @ enter(params["wv"])).reshape(B, Skv, KV, hd)
    if cfg.qk_norm:
        k = rms_norm(k, enter(params["k_norm"]), cfg.norm_eps)
    if rope_base:
        k = apply_rope(k, positions_kv, rope_base)
    return q, k, v


def _kv_heads(t, hb):
    """The kv heads ``[kv0, kv1)`` of a (B, L, KV, hd) tensor that the
    block's q heads read, contiguous (the kernels take dense tensors);
    ``t`` itself without tp."""
    if hb is None or (hb.kv0, hb.kv1) == (0, t.shape[2]):
        return t
    return t[:, :, hb.kv0:hb.kv1].contiguous()


def _out_proj(params, o, hb):
    """``o`` (B, S, Hc, hd_v) through ``wo``: under tp the block's columns
    of the computed heads times ``wo``'s row block, summed over
    ``model``."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, -1)
    if hb is None:
        return o @ params["wo"]
    o = o[..., hb.c0 - hb.h0 * hb.hd:hb.c1 - hb.h0 * hb.hd]
    return sharding.sum_model(o @ params["wo"])


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


def causal_mask(Sq: int, Skv: int, offset: int = 0):
    """mask[q, s] = s <= q + offset (offset = Skv - Sq for suffix queries)
    (``attention.py:78-82``)."""
    qi = torch.arange(Sq)[:, None]
    si = torch.arange(Skv)[None, :]
    return si <= qi + offset


def _check_kind(kind: str):
    """JAX's attention kinds (``attention.py:258``); raises ``ValueError``
    on any other."""
    if kind not in ("causal", "global", "local", "bidir", "cross"):
        raise ValueError(f"attention kind {kind!r}: not one of causal, "
                         f"global, local, bidir, cross")


def _rope_base(cfg, kind: str) -> float:
    """gemma3's dual base: local layers rotate at ``rope_local_base``;
    ``bidir`` and ``cross`` do not rotate (``attention.py:262-263``)."""
    if kind in ("bidir", "cross"):
        return 0.0
    return cfg.rope_local_base if kind == "local" else cfg.rope_base


def attn_forward(params, x, cfg, *, kind: str, positions=None,
                 encoder_kv=None, qkv=None):
    """Full-sequence attention (``attention.py:256-301``) through
    ``kops.flash_attention`` at every S: causal for kinds ``causal``,
    ``global`` and ``local`` (query s sees keys ``t > s - window`` too),
    bidirectional for ``bidir``, and for ``cross`` q from x over k/v
    projected from ``encoder_kv`` (B,T,d), every query seeing all T keys.
    x: (B,S,d); ``qkv`` reuses projections the caller already made with
    :func:`_project_qkv` (under tp, of this rank's head block).  Scores
    are capped at ``cfg.attn_softcap`` where it is set."""
    _check_kind(kind)
    B, S, _ = x.shape
    hb = _head_block(cfg)
    if qkv is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        xkv = encoder_kv if kind == "cross" else x
        pos_kv = positions if kind != "cross" else torch.arange(
            xkv.shape[1], device=x.device)[None, :]
        qkv = _project_qkv(params, x, xkv, cfg, positions, pos_kv,
                           _rope_base(cfg, kind), hb)
    q, k, v = qkv
    q, k, v = q.contiguous(), _kv_heads(k, hb).contiguous(), \
        _kv_heads(v, hb).contiguous()
    window = cfg.window if kind == "local" else 0
    causal = kind not in ("bidir", "cross")
    out = kops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cfg.attn_softcap)
    return _out_proj(params, out, hb)


def seqshard_attn_forward(params, x, cfg, *, kind: str, mesh,
                          keep_kv: bool = False):
    """Context-parallel attention of one layer (``attention.py:203-251``)
    on this rank's S_loc positions ``off .. off + S_loc - 1`` of the
    ``model`` axis (``off = axis_index * S_loc``), x: (B, S_loc, d).

    RoPE at the global positions.  A local layer whose window W fits the
    shard (W <= S_loc) takes the previous rank's last W keys and values
    as a halo (``collectives.halo_cat``) and runs flash over the W +
    S_loc keys at window W; rank 0 has no earlier keys and runs over its
    own S_loc, which is what JAX's ``kv_valid`` mask leaves of its zero
    halo.  Every other layer all-gathers K/V over the axis and runs flash
    over the first ``off + S_loc`` of them, causal, with the layer's
    window where it has one.  Each query thus sits at key position
    ``T - S_loc + s`` of a call of T keys: flash at a query offset.

    Returns ``(out (B, S_loc, d), kv)``: ``kv`` is the whole sequence's
    (k, v) (B, S, KV, hd) where the route gathered them or ``keep_kv``
    asks (a prefill fills its cache from them), else None.  Under grad
    the gather's backward sums every rank's gradient of this rank's
    keys (a reduce-scatter), and the halo's sends its gradient back to
    the rank it came from.  Scores are capped at ``cfg.attn_softcap``."""
    _check_kind(kind)
    B, S_loc, _ = x.shape
    off = collectives.axis_index("model", mesh) * S_loc
    pos = off + torch.arange(S_loc, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, x, cfg, pos, pos,
                           _rope_base(cfg, kind))
    q = q.contiguous()
    W = cfg.window if kind == "local" else 0
    kv = None
    if W and W <= S_loc:
        SEQSHARD_ROUTES["halo"] += 1
        k, v = (collectives.halo_cat(t, W, "model", mesh) for t in (k, v))
        out = kops.flash_attention(q, k.contiguous(), v.contiguous(),
                                   causal=True, window=W,
                                   softcap=cfg.attn_softcap)
        if keep_kv:
            kv = tuple(collectives.all_gather(t[:, -S_loc:].contiguous(),
                                              "model", dim=1, mesh=mesh)
                       for t in (k, v))
    else:
        SEQSHARD_ROUTES["gather"] += 1
        kv = tuple(collectives.tp_gather(t, "model", 1, mesh)
                   for t in (k, v))
        T = off + S_loc
        out = kops.flash_attention(q, kv[0][:, :T].contiguous(),
                                   kv[1][:, :T].contiguous(), causal=True,
                                   window=W, softcap=cfg.attn_softcap)
    return out.reshape(B, S_loc, -1) @ params["wo"], kv


def init_kv_cache(cfg, batch: int, max_len: int, device, *,
                  ring: bool = False):
    """Dense per-slot K/V stripes, ``(batch, max_len, KV, hd)`` zeros, or
    with ``ring`` (a local layer's window shorter than ``max_len``) a ring
    of ``min(max_len, window)`` rows and its ``"pos"`` leaf at -1
    (``attention.py:350-359``)."""
    L = min(max_len, cfg.window) if ring and cfg.window else max_len
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
         "v": torch.zeros(shape, dtype=cfg.act_dtype, device=device)}
    if ring:
        c["pos"] = torch.full((batch, L), -1, dtype=torch.int32,
                              device=device)
    return c


def is_ring_cache(cache) -> bool:
    return "pos" in cache


def batched_cache_update(cache_arr, new_row, slot):
    """cache_arr: (B, L, ...); new_row: (B, ...); slot: (B,).  Writes row b
    at ``slot[b]`` in place, the start clamped to ``[0, L - 1]`` as
    ``dynamic_update_slice`` clamps it (``attention.py:374-383``)."""
    B, L = cache_arr.shape[:2]
    rows = torch.arange(B, device=cache_arr.device)
    cache_arr[rows, slot.long().clamp(0, L - 1)] = new_row.to(cache_arr.dtype)
    return cache_arr


def attn_decode(params, x, cache, pos, cfg, *, kind: str):
    """Single decode step over a dense cache (``attention.py:386-408``).
    x: (B,1,d); pos: (B,) int32 absolute write position.  Keys ``<= pos``
    are visible: the attention is ``kops.decode_attention`` with
    ``lengths = pos + 1``.  A ring writes row ``pos % L`` and its ``"pos"``
    entry, and sees its first ``min(pos + 1, L)`` rows (the module
    docstring says why that is JAX's ring mask).  Scores are capped at
    ``cfg.attn_softcap``."""
    _check_kind(kind)
    hb = _head_block(cfg)
    q, k, v = _project_qkv(params, x, x, cfg, pos[:, None], pos[:, None],
                           _rope_base(cfg, kind), hb)
    if is_ring_cache(cache):
        L = cache["k"].shape[1]
        slot = pos % L
        batched_cache_update(cache["pos"], pos, slot)
        lengths = torch.clamp(pos + 1, max=L)
    else:
        slot, lengths = pos, pos + 1
    batched_cache_update(cache["k"], k[:, 0], slot)
    batched_cache_update(cache["v"], v[:, 0], slot)
    out = kops.decode_attention(q[:, 0].contiguous(),
                                _kv_heads(cache["k"], hb),
                                _kv_heads(cache["v"], hb), lengths,
                                softcap=cfg.attn_softcap)
    return _out_proj(params, out[:, None], hb), cache


def prefill_into_cache(params_unused, k, v, cache, cfg, *, kind: str):
    """Write full-sequence K/V (B,S,KV,hd) into rows ``[0, S)`` of a
    cache, in place; a ring keeps the last ``min(S, L)`` positions, ``p``
    in row ``p % L`` (``attention.py:437-456``)."""
    _check_kind(kind)
    S = k.shape[1]
    if is_ring_cache(cache):
        L = cache["k"].shape[1]
        take = min(S, L)
        pos = torch.arange(S - take, S, device=k.device)
        slots = pos % L
        cache["k"][:, slots] = k[:, S - take:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, S - take:].to(cache["v"].dtype)
        cache["pos"][:, slots] = pos.to(torch.int32)
        return cache
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return cache


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


def paged_attn_decode(params, x, cache, pos, bt, cfg, *, kind: str):
    """Single decode step over a paged cache (``attention.py:510-532``).
    x: (B,1,d); pos: (B,) int32 absolute write position; bt: (B, nb)
    int32.  Keys ``<= pos`` are visible; scores are capped at
    ``cfg.attn_softcap``."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, x, cfg, pos[:, None], pos[:, None],
                           _rope_base(cfg, kind))
    cache = _paged_scatter(cache, k, v, pos[:, None], bt)
    out = kops.paged_decode_attention(q[:, 0].contiguous(), cache["kp"],
                                      cache["vp"], bt, pos + 1,
                                      softcap=cfg.attn_softcap)
    return out.reshape(B, 1, -1) @ params["wo"], cache


def paged_attn_extend(params, x, cache, pos0, bt, cfg, *, kind: str):
    """Prefill a suffix into a paged cache (``attention.py:535-561``): S
    tokens at absolute positions ``pos0 + s`` (per row) attend to the
    cached prefix blocks and causally within the suffix, scores capped at
    ``cfg.attn_softcap``.  x: (B,S,d); pos0: (B,) int32; bt: (B, nb)
    int32."""
    B, S, _ = x.shape
    positions = pos0[:, None] + torch.arange(S, dtype=pos0.dtype,
                                             device=pos0.device)[None, :]
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions,
                           _rope_base(cfg, kind))
    cache = _paged_scatter(cache, k, v, positions, bt)
    out = kops.paged_extend_attention(q.contiguous(), cache["kp"],
                                      cache["vp"], bt, pos0,
                                      softcap=cfg.attn_softcap)
    return out.reshape(B, S, -1) @ params["wo"], cache


# ----------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV, absorbed decode
def init_mla_cache(cfg, batch: int, max_len: int, device):
    """The latent cache of one MLA layer, zeros (``attention.py:614-618``)."""
    z = dict(dtype=cfg.act_dtype, device=device)
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), **z),
            "krope": torch.zeros((batch, max_len, cfg.rope_head_dim), **z)}


def _mla_view(params, x, cfg):
    """``(params, x, hb, Hc)`` of an MLA layer: without tp the layer's
    own and all H heads; under tp ``x`` entered into the region, the
    latent projections entered (their gradients summed over ``model``),
    and ``wq`` / ``w_uk`` / ``w_uv`` of the heads of the rank's ``wo``
    block (its own blocks, or the covering heads' columns of the
    gathered weights where the block cuts a head)."""
    mesh = sharding.tp_mesh()
    if mesh is None:
        return params, x, None, cfg.n_heads
    H, rh, nh, vh = (cfg.n_heads, cfg.rope_head_dim, cfg.nope_head_dim,
                     cfg.v_head_dim)
    hb = sharding.head_block(H, H, vh, mesh)
    enter = sharding.enter_model
    p = {k: enter(params[k]) for k in ("w_dkv", "kv_norm", "w_krope")}
    p["wo"] = params["wo"]
    for key, w in (("wq", nh + rh), ("w_uk", nh), ("w_uv", vh)):
        p[key] = params[key] if not hb.cuts else collectives.tp_gather(
            params[key], "model", -1, mesh)[:, hb.h0 * w:hb.h1 * w]
    return p, enter(x), hb, hb.heads


def _mla_q(params, x, cfg, positions, H=None):
    """(``attention.py:582-588``) -> q_nope (B,S,H,nh), q_rope (B,S,H,rh)
    RoPE'd at ``positions``; ``H`` the heads of ``params["wq"]``."""
    B, S, _ = x.shape
    H = H or cfg.n_heads
    rh, nh = cfg.rope_head_dim, cfg.nope_head_dim
    q = (x @ params["wq"]).reshape(B, S, H, nh + rh)
    return q[..., :nh], apply_rope(q[..., nh:], positions, cfg.rope_base)


def _mla_latent(params, x, cfg, positions):
    """The normalised latent ``ckv`` (B,S,r) and the RoPE'd shared key
    ``krope`` (B,S,rh) of ``x`` (``attention.py:597-599``)."""
    ckv = rms_norm(x @ params["w_dkv"], params["kv_norm"], cfg.norm_eps)
    krope = apply_rope((x @ params["w_krope"])[:, :, None, :], positions,
                       cfg.rope_base)[:, :, 0]
    return ckv, krope


def mla_forward(params, x, cfg, positions=None):
    """Full-sequence causal MLA (``attention.py:591-611``): per head q and
    k of ``nope + rope`` and v of ``v_head_dim``, through
    ``kops.flash_attention`` at every S, scale 1/sqrt(nope + rope).
    Returns ``(out (B,S,d), (ckv (B,S,r), krope (B,S,rh)))``; under tp
    the rank's heads, the latent whole."""
    B, S, _ = x.shape
    params, x, hb, H = _mla_view(params, x, cfg)
    rh, nh, vh = cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(params, x, cfg, positions, H)
    ckv, krope = _mla_latent(params, x, cfg, positions)
    k_nope = (ckv @ params["w_uk"]).reshape(B, S, H, nh)
    v = (ckv @ params["w_uv"]).reshape(B, S, H, vh)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(B, S, H, rh)], dim=-1)
    out = kops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    return _out_proj(params, out, hb), (ckv, krope)


def seqshard_mla_forward(params, x, cfg, *, mesh):
    """MLA on this rank's S_loc positions ``off .. off + S_loc - 1`` of
    the ``model`` axis (:func:`seqshard_attn_forward`'s layout): q at the
    global positions, this rank's latent (``ckv``, ``krope``) all-gathered
    over ``model`` (``collectives.tp_gather``: under grad each rank gets
    the sum of every rank's gradient of its positions), ``k_nope`` / ``v``
    up-projected for the keys ``[0, off + S_loc)`` and flash at a query
    offset at (q/k, v) = (nope + rope, v_head_dim).  Returns ``(out (B,
    S_loc, d), (ckv (B, S, r), krope (B, S, rh)))``, the whole sequence's
    latent, which a prefill writes into its cache."""
    B, S_loc, _ = x.shape
    SEQSHARD_ROUTES["latent"] += 1
    H = cfg.n_heads
    rh, nh, vh = cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    off = collectives.axis_index("model", mesh) * S_loc
    pos = off + torch.arange(S_loc, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(params, x, cfg, pos, H)
    ckv, krope = (collectives.tp_gather(t.contiguous(), "model", 1, mesh)
                  for t in _mla_latent(params, x, cfg, pos))
    T = off + S_loc
    ck, kr = ckv[:, :T], krope[:, :T]
    k_nope = (ck @ params["w_uk"]).reshape(B, T, H, nh)
    v = (ck @ params["w_uv"]).reshape(B, T, H, vh)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, T, H, rh)], dim=-1)
    out = kops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    return out.reshape(B, S_loc, -1) @ params["wo"], (ckv, krope)


def mla_prefill_into_cache(ckv, krope, cache):
    """Write the prefill's latent rows into rows ``[0, S)`` of an MLA cache,
    in place (``transformer.py:155-160``)."""
    S = ckv.shape[1]
    cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, :S] = krope.to(cache["krope"].dtype)
    return cache


def mla_decode(params, x, cache, pos, cfg):
    """Absorbed decode step (``attention.py:621-646``): the latent row of
    ``x`` written at ``pos`` in place, the query absorbed into the latent
    space (``q_nope w_uk``, B x H x r), ``kops.mla_decode_attention`` over
    keys ``<= pos`` (``lengths = pos + 1``), and the context mapped back
    through ``w_uv`` and ``wo``.  x: (B,1,d); pos: (B,) int32.  Under tp
    the rank's heads over the whole latent cache."""
    params, x, hb, H = _mla_view(params, x, cfg)
    rh, nh, vh = cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(params, x, cfg, pos[:, None], H)
    ckv_t, krope_t = _mla_latent(params, x, cfg, pos[:, None])
    batched_cache_update(cache["ckv"], ckv_t[:, 0], pos)
    batched_cache_update(cache["krope"], krope_t[:, 0], pos)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0],
                         params["w_uk"].reshape(r, H, nh))
    ctx = kops.mla_decode_attention(
        q_lat.contiguous(), q_rope[:, 0].contiguous(), cache["ckv"],
        cache["krope"], pos + 1, 1.0 / math.sqrt(nh + rh))
    out = torch.einsum("bhr,rhd->bhd", ctx, params["w_uv"].reshape(r, H, vh))
    return _out_proj(params, out[:, None], hb), cache
