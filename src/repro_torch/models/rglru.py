"""RG-LRU recurrent block of the port (``repro.models.rglru``,
RecurrentGemma / Griffin).

Temporal mixing: x -> {branch: linear -> causal conv(k=4) -> RG-LRU,
gate: linear -> gelu} -> elementwise product -> out projection.
The RG-LRU recurrence is diagonal:  h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * (i_t * x_t)
with a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t + b_a)), c = 8.

Every full-sequence pass (:func:`rglru_forward`) runs the recurrence
through :func:`repro_torch.kernels.ops.linear_scan`: the Hopper scan
kernel at N = 1 on a CUDA tensor, the plain sequential recurrence on the
CPU.  JAX computes it in plain ``jnp`` (a chunked ``associative_scan``);
both compute the same recurrence.  A single-token step
(:func:`rglru_decode`) is one multiply-add in torch, as in JAX.

The gates are fp32 whatever the model's dtype, in JAX's order of
operations; ``lambda`` stays fp32 in a bf16 tree.  State per layer:
``{"conv": (B, K-1, w), "h": (B, w)}``, both fp32; ``conv`` holds values
already rounded to the activation dtype.

Under ``tp`` (``core.sharding.tp_mesh``) a rank runs its block of the
``lru`` channels: ``in_x`` / ``in_gate`` are column blocks and the conv
is local; ``w_a`` / ``w_i`` are row blocks whose partial products are
summed over ``model``, of which the rank keeps its own block
(``collectives.tp_reduce_scatter``); ``b_a``, ``b_i`` and ``lambda`` are
replicated and entered, the rank taking its block; the scan runs on the
local channels and ``out``'s row block is summed over ``model``.  The
state is the rank's channels, as JAX's cache specs split ``lru``.

Under ``seqtp`` at a sharded length a rank runs its shard of the
positions as ``models/ssm.py`` does: the conv's first K - 1 inputs from
the previous rank (``collectives.halo_cat``, zeros on rank 0), and the
recurrence's state entering the shard folded from every earlier rank's
map h -> P_r h + F_r, P_r = exp(sum_t log a_t) per (b, channel), then
the shard scanned again from it (``collectives.shard_scan``; rank 0 and
the last rank scan once).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.core.sharding import col_block, enter_model, sum_model, \
    tp_mesh
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import SEQSHARD_ROUTES

RG_C = 8.0


def _conv1d_causal(x, w, b, prev=None):
    """x: (B,S,w), depthwise causal conv, kernel (K,w), in the activation
    dtype (``rglru.py:39-46``; the K taps summed in the same order).  With
    ``prev`` (B,K-1,w) the conv continues from it, else from zeros."""
    K, S = w.shape[0], x.shape[1]
    if prev is not None:
        x_ext = torch.cat([prev.to(x.dtype), x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, K - 1, 0))
    out = x_ext[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + x_ext[:, i:i + S] * w[i]
    return out + b


def _gates(params, xc, log: bool = False):
    """a_t and the gated input, fp32 (``rglru.py:49-57``), and with
    ``log`` log a_t too.  xc: (B,S,w)."""
    xf = xc.float()
    mesh = tp_mesh()
    if mesh is None:
        r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"].float())
        i = torch.sigmoid(xf @ params["w_i"].float() + params["b_i"].float())
        lam = params["lambda"]
    else:
        c0, c1 = col_block(params["lambda"].shape[0], mesh)
        own = {k: enter_model(params[k])[c0:c1]
               for k in ("b_a", "b_i", "lambda")}
        r, i = (torch.sigmoid(collectives.tp_reduce_scatter(
            xf @ params[w].float(), "model", -1, mesh) + own[b].float())
            for w, b in (("w_a", "b_a"), ("w_i", "b_i")))
        lam = own["lambda"]
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    log_a = -RG_C * softplus * r                               # (B,S,w)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return (a, gated, log_a) if log else (a, gated)


def diag_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t, elementwise.  a, b: (B,S,w) fp32; h0:
    (B,w) or None for zeros.  Returns (h_seq (B,S,w), h_final (B,w))
    (``rglru.py:60-96``), through the scan kernel's route."""
    if h0 is None:
        h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                         device=a.device)
    return kops.linear_scan(a, b, h0)


def rglru_forward(params, x, cfg, state=None, seq=None, keep_state=True):
    """x: (B,S,d) -> (out, new_state) (``rglru.py:99-117``); with
    ``state`` the conv continues from ``state["conv"]`` and the scan from
    ``state["h"]``.  With ``seq`` (the mesh of a sequence-sharded pass) x
    is this rank's shard and the state comes from the ranks before it
    (the module docstring); the new state is the whole sequence's, the
    last rank's, or None without ``keep_state`` (a ``full`` pass)."""
    S = x.shape[1]
    K = cfg.conv_k_rg
    x = enter_model(x)
    xb = x @ params["in_x"]
    gate = x @ params["in_gate"]
    if seq is not None:
        ext = collectives.halo_cat(xb, K - 1, "model", seq, zeros_first=True)
        xc = _conv1d_causal(ext[:, K - 1:], params["conv_w"],
                            params["conv_b"], prev=ext[:, :K - 1])
    else:
        xc = _conv1d_causal(xb, params["conv_w"], params["conv_b"],
                            prev=state["conv"] if state is not None else None)
    a, gated, log_a = _gates(params, xc, log=True)
    if seq is not None:
        SEQSHARD_ROUTES["carry"] += 1
        h_seq, h_fin = collectives.shard_scan(
            lambda g, h0: diag_scan(a, g, h0), gated,
            torch.exp(log_a.sum(1)), "model", seq)
    else:
        h0 = state["h"] if state is not None else None
        h_seq, h_fin = diag_scan(a, gated, h0)
    y = h_seq.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = sum_model(y @ params["out"])
    if seq is not None:
        if not keep_state:
            return out, None
        # the last rank's state, on every rank
        conv, h = (collectives.all_gather(t.contiguous(), "model",
                                          tiled=False, mesh=seq)[-1]
                   for t in (xb[:, -(K - 1):].float(), h_fin))
        return out, {"conv": conv, "h": h}
    if S >= K - 1:
        conv = xb[:, -(K - 1):]
    elif state is not None:
        conv = torch.cat([state["conv"].to(xb.dtype), xb], dim=1)[:, -(K - 1):]
    else:
        conv = F.pad(xb, (0, 0, K - 1 - S, 0))
    return out, {"conv": conv.float(), "h": h_fin}


def init_rglru_state(cfg, batch: int, device):
    return {
        "conv": torch.zeros((batch, cfg.conv_k_rg - 1, cfg.lru_width),
                            dtype=torch.float32, device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }


def rglru_decode(params, x, state, cfg):
    """Single-token step (``rglru.py:127-137``).  x: (B,1,d) -> (out
    (B,1,d), new_state)."""
    x = enter_model(x)
    xb = x @ params["in_x"]
    gate = x @ params["in_gate"]
    conv_in = torch.cat([state["conv"].to(xb.dtype), xb], dim=1)  # (B,K,w)
    xc = (torch.einsum("bkw,kw->bw", conv_in, params["conv_w"]) +
          params["conv_b"])[:, None]
    a, gated = _gates(params, xc)
    h = a[:, 0] * state["h"] + gated[:, 0]
    y = h[:, None].to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = sum_model(y @ params["out"])
    return out, {"conv": conv_in[:, 1:].float(), "h": h}
