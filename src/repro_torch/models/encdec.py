"""Encoder-decoder backbone of the port (whisper-base), the counterpart of
``repro.models.encdec``.  The conv audio frontend is a stub, as in JAX:
``frames`` (B, S_enc, d_model) come in already embedded.  Positions are
fixed sinusoids on both sides, computed in fp32 and cast to the
activation dtype before the add (``encdec.py:32-37``, ``:199-203``).

The tree (``encdec.init_params``)::

    {"embedding": {"table"}, "enc": {"ln1", "self", "ln2", "ffn"},
     "dec": {"ln1", "self", "ln_x", "cross", "ln2", "ffn"},
     "enc_norm", "dec_norm", "lm_head"}

with the ``enc`` and ``dec`` leaves stacked ``(enc_layers, ...)`` and
``(dec_layers, ...)``.  Each layer body runs under the config's
``remat`` (:func:`transformer._remat_wrap`).  Every attention runs a
kernel of :mod:`repro_torch.kernels.ops` (the plain versions on the CPU):
the encoder's bidirectional self-attention and the decoder's causal one
and its cross attention over the encoder states on ``flash_attention``
(the cross one at a key count of its own, the encoder's length), the
decode steps on ``decode_attention``.  JAX runs them in plain ``jnp``
(``mha``, or ``flash_attention_jnp`` from 1,024 tokens).

The caches are JAX's four stacked tensors (``encdec.py:121-129``):
``self_k`` / ``self_v`` (dec_layers, B, max_len, KV, hd) and ``cross_k``
/ ``cross_v`` (dec_layers, B, enc_len, KV, hd), written in place as the
port's other caches are.  A decode step writes its self-attention row at
``pos`` clamped to the last row, as ``dynamic_update_slice`` clamps, and
sees rows ``< min(pos + 1, max_len)``.

JAX does not sequence-shard this family: under ``seqtp`` every pass runs
whole on each rank.  Under a weight-sharded policy (``tp``, ``fsdp_tp``)
every attention, MLP, the embedding, the head and the loss compute on the
rank's blocks as the decoder LM's do (``models/transformer.py``); the
four caches stay whole on every rank, and under ``fsdp_tp`` each layer's
leaves are gathered over the data axes at its start.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.sharding import (enter_model, fsdp_active,
                                       fsdp_gather, fsdp_gather_leaf,
                                       stack_axes)
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, embed, mask_padded_logits,
                                       token_nll)
from repro_torch.models.transformer import _remat_wrap, _unstack, apply_norm
from repro_torch.models.weights import param_axes


def _inv_freq(d: int, device):
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    return torch.exp(-dim * (math.log(10000.0) / max(d // 2 - 1, 1)))


def sinusoid(seq: int, d: int, dtype, device=None):
    """(seq, d): ``[sin(p w), cos(p w)]`` at positions 0 .. seq - 1."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    ang = pos * _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def sinusoid_at(pos, d: int, dtype):
    """(B, d): the sinusoid at each row's position ``pos`` (B,)."""
    ang = pos.float()[:, None] * _inv_freq(d, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _layers(params, cfg, side: str):
    """The ``side`` stack's layers, one tree each, beside their logical
    axes where the context gathers leaves over the data axes (else
    None)."""
    n = cfg.enc_layers if side == "enc" else cfg.dec_layers
    axes = stack_axes(param_axes(cfg)[side]) if fsdp_active() else None
    return [(lp, axes) for lp in _unstack(params[side], n)]


def encode(params, frames, cfg):
    """frames: (B, S_enc, d) stub frame embeddings -> encoder states."""
    x = frames.to(cfg.act_dtype) + sinusoid(
        frames.shape[1], cfg.d_model, cfg.act_dtype, frames.device)[None]

    def body(xx, lp, axes):
        lp = fsdp_gather(lp, axes)
        h = apply_norm(lp["ln1"], xx, cfg)
        xx = xx + attn.attn_forward(lp["self"], h, cfg, kind="bidir")
        h = apply_norm(lp["ln2"], xx, cfg)
        return xx + apply_mlp(lp["ffn"], h, cfg)

    body = _remat_wrap(body, cfg)
    for lp, axes in _layers(params, cfg, "enc"):
        x = body(x, lp, axes)
    return apply_norm(params["enc_norm"], x, cfg)


def _embed_tokens(params, tokens, cfg):
    return embed(params["embedding"], tokens, cfg) + sinusoid(
        tokens.shape[1], cfg.d_model, cfg.act_dtype, tokens.device)[None]


def _head(params, x, cfg):
    """Logits over the vocab, under ``tp`` over the rank's block."""
    x = enter_model(apply_norm(params["dec_norm"], x, cfg))
    w = fsdp_gather_leaf(params["lm_head"], ("embed", "vocab"))
    return mask_padded_logits(x @ w, cfg)


def decode_full(params, tokens, enc_states, cfg):
    """Teacher-forced decoder pass (train / prefill-score) -> logits
    (B, S, V)."""
    x = _embed_tokens(params, tokens, cfg)

    def body(xx, lp, axes, enc):
        lp = fsdp_gather(lp, axes)
        h = apply_norm(lp["ln1"], xx, cfg)
        xx = xx + attn.attn_forward(lp["self"], h, cfg, kind="causal")
        h = apply_norm(lp["ln_x"], xx, cfg)
        xx = xx + attn.attn_forward(lp["cross"], h, cfg, kind="cross",
                                    encoder_kv=enc)
        h = apply_norm(lp["ln2"], xx, cfg)
        return xx + apply_mlp(lp["ffn"], h, cfg)

    body = _remat_wrap(body, cfg)
    for lp, axes in _layers(params, cfg, "dec"):
        x = body(x, lp, axes, enc_states)
    return _head(params, x, cfg)


def loss(params, cfg, frames, tokens):
    """Next-token cross-entropy (``encdec.py:110-116``): targets are the
    tokens shifted by one with 0 padded at the end; ``(loss, (loss,
    0))``, fp32 scalars."""
    logits = decode_full(params, tokens, encode(params, frames, cfg), cfg)
    targets = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    ce = token_nll(logits, targets).mean()
    return ce, (ce, torch.zeros((), dtype=torch.float32, device=ce.device))


# ----------------------------------------------------------------------
def init_caches(cfg, batch: int, max_len: int, enc_len: int, device):
    KV, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.dec_layers
    z = dict(dtype=cfg.act_dtype, device=device)
    return {"self_k": torch.zeros((L, batch, max_len, KV, hd), **z),
            "self_v": torch.zeros((L, batch, max_len, KV, hd), **z),
            "cross_k": torch.zeros((L, batch, enc_len, KV, hd), **z),
            "cross_v": torch.zeros((L, batch, enc_len, KV, hd), **z)}


def prefill(params, tokens, frames, cfg, caches):
    """Encode, run the decoder over the prompt, fill rows ``[0, S)`` of
    the self caches and the whole cross caches, and return ``(logits (B,
    1, V) at the last position, caches)`` (``encdec.py:132-162``).  The
    cross caches are written in place where their length is the
    encoder's; JAX replaces them, so another length is replaced too."""
    enc = encode(params, frames, cfg)
    S = tokens.shape[1]
    T = enc.shape[1]
    hb = attn._head_block(cfg)
    x = _embed_tokens(params, tokens, cfg)
    pos = torch.arange(S, device=tokens.device)[None, :]
    pos_enc = torch.arange(T, device=tokens.device)[None, :]
    cross = []
    for li, (lp, axes) in enumerate(_layers(params, cfg, "dec")):
        lp = fsdp_gather(lp, axes)
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = attn._project_qkv(lp["self"], h, h, cfg, pos, pos, 0.0,
                                    hb)
        x = x + attn.attn_forward(lp["self"], h, cfg, kind="causal",
                                  qkv=(q, k, v))
        caches["self_k"][li, :, :S] = k.to(caches["self_k"].dtype)
        caches["self_v"][li, :, :S] = v.to(caches["self_v"].dtype)
        h = apply_norm(lp["ln_x"], x, cfg)
        qc, ck, cv = attn._project_qkv(lp["cross"], h, enc, cfg, pos,
                                       pos_enc, 0.0, hb)
        x = x + attn.attn_forward(lp["cross"], h, cfg, kind="cross",
                                  qkv=(qc, ck, cv))
        h = apply_norm(lp["ln2"], x, cfg)
        x = x + apply_mlp(lp["ffn"], h, cfg)
        cross.append((ck, cv))
    for i, name in enumerate(("cross_k", "cross_v")):
        new = torch.stack([c[i] for c in cross]).to(cfg.act_dtype)
        if caches[name].shape == new.shape:
            caches[name].copy_(new)
        else:
            caches[name] = new
    return _head(params, x[:, -1:], cfg), caches


def decode_step(params, tokens, caches, pos, cfg):
    """tokens: (B, 1); pos: (B,) int32.  The self-attention row is
    written at ``pos`` (clamped to the last row) and the step sees rows
    ``< min(pos + 1, max_len)``; the cross attention sees all ``enc_len``
    rows (``encdec.py:165-196``); both capped at ``cfg.attn_softcap``, as
    JAX's ``mha`` caps them (``encdec.py:180``, ``:184``).  Returns
    ``(logits (B, 1, V), caches)``."""
    B = tokens.shape[0]
    hb = attn._head_block(cfg)
    x = embed(params["embedding"], tokens, cfg) + sinusoid_at(
        pos, cfg.d_model, cfg.act_dtype)[:, None, :]
    L, T = caches["self_k"].shape[2], caches["cross_k"].shape[2]
    lengths = torch.clamp(pos + 1, max=L).to(torch.int32)
    enc_lengths = torch.full((B,), T, dtype=torch.int32, device=pos.device)
    for li, (lp, axes) in enumerate(_layers(params, cfg, "dec")):
        lp = fsdp_gather(lp, axes)
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = attn._project_qkv(lp["self"], h, h, cfg, pos[:, None],
                                    pos[:, None], 0.0, hb)
        sk, sv = caches["self_k"][li], caches["self_v"][li]
        attn.batched_cache_update(sk, k[:, 0], pos)
        attn.batched_cache_update(sv, v[:, 0], pos)
        o = kops.decode_attention(q[:, 0].contiguous(),
                                  attn._kv_heads(sk, hb),
                                  attn._kv_heads(sv, hb), lengths,
                                  softcap=cfg.attn_softcap)
        x = x + attn._out_proj(lp["self"], o[:, None], hb)
        h = enter_model(apply_norm(lp["ln_x"], x, cfg))
        qc = attn._project_q(lp["cross"], h, cfg, None, 0.0, hb)[:, 0]
        oc = kops.decode_attention(qc.contiguous(),
                                   attn._kv_heads(caches["cross_k"][li], hb),
                                   attn._kv_heads(caches["cross_v"][li], hb),
                                   enc_lengths, softcap=cfg.attn_softcap)
        x = x + attn._out_proj(lp["cross"], oc[:, None], hb)
        h = apply_norm(lp["ln2"], x, cfg)
        x = x + apply_mlp(lp["ffn"], h, cfg)
    return _head(params, x, cfg), caches
