"""Shared layers of the port (``repro.models.layers``): plain functions on
tensors and nested parameter dicts, with the JAX package's math and
layouts.

Under ``tp`` / ``fsdp_tp`` (``core.sharding.tp_mesh``) each computes on
the rank's blocks: the MLP's ``ff`` columns and rows, the embedding's and
the head's ``vocab`` rows (a vocab-parallel lookup, logits over the
rank's block, :func:`token_nll`'s cross entropy over the blocks), and
under ``fsdp_tp`` the embedding table gathered over the data axes where
it is used."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.core.sharding import enter_model, fsdp_gather_leaf, \
    sum_model, tp_mesh


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


def apply_mlp(params, x, cfg, reduce: bool = True):
    """The gated MLPs, SwiGLU and GeGLU (the gate through the tanh GELU,
    ``jax.nn.gelu(approximate=True)``), or the plain two-layer MLP with
    biases and the tanh GELU (``layers.py:91-104``).  Under ``tp`` the
    ``ff`` columns and rows are the rank's blocks: ``x`` enters the
    region, ``w_down``'s partial product is summed over ``model`` (not
    with ``reduce=False``: the caller sums it with its own, and the gated
    kinds have no bias to add once) and ``b_down`` is added after."""
    x = enter_model(x)
    if cfg.mlp in ("swiglu", "geglu"):
        gate = x @ params["w_gate"]
        gate = F.silu(gate) if cfg.mlp == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        out = (gate * (x @ params["w_up"])) @ params["w_down"]
        return sum_model(out) if reduce else out
    if cfg.mlp == "gelu_mlp":
        if not reduce:
            raise ValueError("a partial gelu_mlp would leave b_down to the "
                             "caller")
        h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
        return sum_model(h @ params["w_down"]) + params["b_down"]
    raise ValueError(f"mlp={cfg.mlp!r}: not an MLP kind of the JAX package "
                     f"(swiglu, geglu, gelu_mlp)")


def _vocab_start(n_local: int, mesh) -> int:
    return collectives.axis_index("model", mesh) * n_local


def embed(params, tokens, cfg):
    """The table's rows of ``tokens`` in the activation dtype, times
    sqrt(d) where the config scales (gemma).  Under ``tp`` a vocab-parallel
    lookup: each rank gives the rows in its block of the vocab and zeros
    elsewhere, summed over ``model`` (exact: one rank gives each row)."""
    table = fsdp_gather_leaf(params["table"], ("vocab", "embed"))
    mesh = tp_mesh()
    if mesh is None:
        x = table[tokens.long()].to(cfg.act_dtype)
    else:
        n = table.shape[0]
        idx = tokens.long() - _vocab_start(n, mesh)
        hit = (idx >= 0) & (idx < n)
        rows = table[idx.clamp(0, n - 1)]
        rows = torch.where(hit[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        x = sum_model(rows).to(cfg.act_dtype)
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.act_dtype,
                             device=x.device)
    return x


def mask_padded_logits(logits, cfg):
    """-1e30 at the padded vocab ids ``>= cfg.vocab``; under ``tp`` the
    logits are the rank's block of the padded vocab."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    mesh = tp_mesh()
    n = logits.shape[-1]
    v0 = 0 if mesh is None else _vocab_start(n, mesh)
    keep = torch.arange(v0, v0 + n, device=logits.device) < cfg.vocab
    return torch.where(keep, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


def unembed(params, x, cfg):
    """Logits over the tied table (``embed``'s rows): under ``tp`` over
    the rank's block of the vocab."""
    table = fsdp_gather_leaf(params["table"], ("vocab", "embed"))
    x = enter_model(x)
    logits = torch.einsum("...d,vd->...v", x, table.to(x.dtype))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return mask_padded_logits(logits, cfg)


class _VocabParallelNLL(torch.autograd.Function):
    """``-log_softmax(logits)[target]`` in fp32 over logits split over
    ``model`` by the vocab: the row max by ``pmax``, then one ``psum`` of
    each row's sum of exponentials and of its target's logit (from the
    rank whose block holds it).  Backward, each rank's block of
    ``softmax - one_hot``: the whole (B, S, V) logits are never
    gathered."""

    @staticmethod
    def forward(ctx, logits, targets, mesh):
        lf = logits.float()
        n = lf.shape[-1]
        m = collectives.pmax(lf.amax(-1), "model", mesh)
        e = torch.exp(lf - m[..., None])
        idx = targets.long() - _vocab_start(n, mesh)
        hit = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        t = torch.where(hit, torch.gather(lf, -1, idx[..., None])[..., 0],
                        torch.zeros((), device=lf.device))
        s, t = collectives.psum(torch.stack([e.sum(-1), t]), "model",
                                mesh).unbind(0)
        ctx.save_for_backward(e, s, idx, hit)
        ctx.dtype = logits.dtype
        return torch.log(s) + m - t

    @staticmethod
    def backward(ctx, g):
        e, s, idx, hit = ctx.saved_tensors
        p = e / s[..., None]
        p = p.scatter_add(-1, idx[..., None], -hit.float()[..., None])
        return (p * g[..., None]).to(ctx.dtype), None, None


def token_nll(logits, targets):
    """The fp32 negative log-likelihood of each position's target (JAX's
    ``-log_softmax(logits)[target]``); under ``tp`` over the rank's vocab
    block (:class:`_VocabParallelNLL`)."""
    mesh = tp_mesh()
    if mesh is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return _VocabParallelNLL.apply(logits, targets, mesh)
