"""Shared layers of the port (``repro.models.layers``): plain functions on
tensors and nested parameter dicts, with the JAX package's math and
layouts."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, weight, eps: float = 1e-6, plus_one: bool = False):
    """fp32 math, result in ``x``'s dtype (``layers.py:31-39``)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:                       # gemma-style (1 + w) scaling
        w = 1.0 + w
    return (x * w).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """fp32 statistics with the population variance, weight and bias in
    fp32, the result cast back to ``x``'s dtype (``layers.py:42-48``)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def rope_freqs(head_dim: int, base: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (base ** exponent)                      # (head_dim/2,)


def apply_rope(x, positions, base: float):
    """x: (..., seq, heads, head_dim), positions: (..., seq).  Rotates the
    split halves (not interleaved pairs) in fp32 (``layers.py:58-67``)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, base, x.device)
    angles = positions[..., :, None].float() * freqs     # (..., seq, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mlp(params, x, cfg):
    """The gated MLPs, SwiGLU and GeGLU (the gate through the tanh GELU,
    ``jax.nn.gelu(approximate=True)``), or the plain two-layer MLP with
    biases and the tanh GELU (``layers.py:91-104``)."""
    if cfg.mlp in ("swiglu", "geglu"):
        gate = x @ params["w_gate"]
        gate = F.silu(gate) if cfg.mlp == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        return (gate * (x @ params["w_up"])) @ params["w_down"]
    if cfg.mlp == "gelu_mlp":
        h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
        return h @ params["w_down"] + params["b_down"]
    raise ValueError(f"mlp={cfg.mlp!r}: not an MLP kind of the JAX package "
                     f"(swiglu, geglu, gelu_mlp)")


def embed(params, tokens, cfg):
    x = params["table"][tokens.long()].to(cfg.act_dtype)
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.act_dtype,
                             device=x.device)
    return x


def mask_padded_logits(logits, cfg):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    keep = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return torch.where(keep, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


def unembed(params, x, cfg):
    logits = torch.einsum("...d,vd->...v", x, params["table"].to(x.dtype))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return mask_padded_logits(logits, cfg)
