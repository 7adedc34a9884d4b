"""Mamba-1 SSM block of the port (``repro.models.ssm``, falcon-mamba-7b):
in_proj -> causal depthwise conv -> selective scan -> gate -> out_proj.

Every full-sequence pass (:func:`ssm_forward`) runs its scan through
:func:`repro_torch.kernels.ops.ssm_scan`: the fused Hopper kernel on a
CUDA tensor, the plain sequential recurrence on the CPU.  JAX sends only
``S >= 128`` with ``cfg.use_kernels`` to its Pallas kernel and the rest to
a chunked ``associative_scan``; both compute the same recurrence.  A
single-token step (:func:`ssm_decode`) has no kernel, in JAX too.

State per layer: ``{"conv": (B, K-1, di), "h": (B, di, N)}``, fp32.

Under ``tp`` (``core.sharding.tp_mesh``) a rank runs its block of the
``inner`` channels: ``in_proj``'s columns hold ``[xs | z]``, so the
rank's channels of both come from its block through a gather over
``model`` (``sharding.gathered_columns``); conv, ``dt_proj``, ``A_log``,
``D`` and the scan run on the local channels; ``x_proj``'s row block
gives partial dt / B / C, summed over ``model`` and entered again (each
rank uses them on its channels); ``out_proj``'s row block is summed over
``model``.  The state is the rank's channels, as JAX's cache specs split
``inner`` over ``model``.

Under ``seqtp`` at a sharded length (``transformer.seqshard_mesh``) a
rank runs its S_loc positions ``off .. off + S_loc - 1``: the conv's
first K - 1 inputs are the previous rank's last ones
(``collectives.halo_cat``; rank 0's are zeros, the unsharded zero pad),
and the recurrence, diagonal, is an affine map h -> P_r h + F_r of each
shard, P_r = exp(A sum_t dt_t) (from the summed exponent, not a product
of rounded factors) and F_r the shard's final state from zeros.  The
ranks' (P, F) are all-gathered and folded in rank order into the state
entering each shard, and a rank scans its shard again from it
(``collectives.shard_scan``: rank 0, whose carry is zero, and the last
rank, whose F nobody reads, scan once, every other rank twice).  Both
scans go
through ``ops.ssm_scan``, whose kernel route's backward gives dh0, the
carry's gradient.  A prefill's state is the last rank's, on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.core.sharding import col_block, enter_model, \
    gathered_columns, sum_model, tp_mesh
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import SEQSHARD_ROUTES


def _conv1d_causal(x, w, b):
    """x: (B,S,di), depthwise causal conv, kernel (K,di)
    (``ssm.py:39-44``; the taps are summed in the same order)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _in_proj(params, x, cfg):
    """xs and z (B,S,di each), or under tp the rank's channels of each."""
    mesh = tp_mesh()
    if mesh is None:
        return (x @ params["in_proj"]).chunk(2, dim=-1)
    x = enter_model(x)
    c0, c1 = col_block(cfg.d_inner, mesh)
    di = cfg.d_inner
    xs, z = gathered_columns(x, params["in_proj"],
                             [(c0, c1), (di + c0, di + c1)], mesh)
    return xs, z


def _ssm_params(params, xc, cfg):
    """Per-token dt, B, C (fp32) and A (di,N) from the conv output xc
    (B,S,di) (``ssm.py:47-54``)."""
    N, dtr = cfg.ssm_state, cfg.dt_rank
    # under tp x_proj's row block: dt / B / C summed, then used in part
    proj = enter_model(sum_model(xc @ params["x_proj"]))  # (B,S,dtr+2N)
    dt_in, Bc, Cc = torch.split(proj, [dtr, N, N], dim=-1)
    dt = F.softplus(dt_in @ params["dt_proj"] + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())            # (di,N)
    return dt.float(), Bc.float(), Cc.float(), A


def selective_scan(xc, dt, Bc, Cc, A, D, h0=None):
    """xc: (B,S,di)  dt: (B,S,di)  Bc,Cc: (B,S,N)  A: (di,N)  D: (di,)

    Returns (y (B,S,di), h_final (B,di,N)), fp32 (``ssm.py:57-104``),
    through :func:`repro_torch.kernels.ops.ssm_scan`."""
    return kops.ssm_scan(xc.float(), dt, Bc, Cc, A, D.float(), h0=h0)


def ssm_forward(params, x, cfg, state=None, seq=None, keep_state=True):
    """x: (B,S,d) -> (out, new_state) (``ssm.py:107-138``).  With
    ``state`` the conv continues from ``state["conv"]`` and the scan from
    ``state["h"]``.  With ``seq`` (the mesh of a sequence-sharded pass) x
    is this rank's shard and the state comes from the ranks before it
    (the module docstring); the new state is the whole sequence's, the
    last rank's, or None without ``keep_state`` (a ``full`` pass)."""
    S = x.shape[1]
    K = cfg.conv_k
    xs, z = _in_proj(params, x, cfg)
    if state is not None or seq is not None:
        xs_ext = torch.cat([state["conv"].to(xs.dtype), xs], dim=1) \
            if seq is None else collectives.halo_cat(xs, K - 1, "model",
                                                     seq, zeros_first=True)
        conv_full = _conv1d_causal(xs_ext, params["conv_w"],
                                   params["conv_b"])
        xc = conv_full[:, K - 1:]
    else:
        xc = _conv1d_causal(xs, params["conv_w"], params["conv_b"])
    xc = F.silu(xc)
    dt, Bc, Cc, A = _ssm_params(params, xc, cfg)
    if seq is not None:
        SEQSHARD_ROUTES["carry"] += 1
        D = params["D"]
        y, h_fin = collectives.shard_scan(
            lambda x_, h0: selective_scan(x_, dt, Bc, Cc, A, D, h0=h0), xc,
            torch.exp(A[None] * dt.sum(1)[..., None]), "model", seq)
    else:
        h0 = state["h"] if state is not None else None
        y, h_fin = selective_scan(xc, dt, Bc, Cc, A, params["D"], h0=h0)
    y = y.to(x.dtype) * F.silu(z)
    out = sum_model(y @ params["out_proj"])
    if seq is not None:
        if not keep_state:
            return out, None
        # the last rank's state, on every rank
        conv, h = (collectives.all_gather(t.contiguous(), "model",
                                          tiled=False, mesh=seq)[-1]
                   for t in (xs[:, -(K - 1):].float(), h_fin))
        return out, {"conv": conv, "h": h}
    if S >= K - 1:
        conv = xs[:, -(K - 1):].float()
    elif state is not None:
        conv = torch.cat([state["conv"], xs.float()], dim=1)[:, -(K - 1):]
    else:
        conv = F.pad(xs, (0, 0, K - 1 - S, 0)).float()
    return out, {"conv": conv, "h": h_fin}


def init_ssm_state(cfg, batch: int, device):
    return {
        "conv": torch.zeros((batch, cfg.conv_k - 1, cfg.d_inner),
                            dtype=torch.float32, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def ssm_decode(params, x, state, cfg):
    """Single-token step, plain torch (``ssm.py:148-164``).  x: (B,1,d)
    -> (out (B,1,d), new_state)."""
    xs, z = _in_proj(params, x, cfg)                    # (B,1,di)
    conv_in = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)  # (B,K,di)
    xc = torch.einsum("bkd,kd->bd", conv_in, params["conv_w"]) + \
        params["conv_b"]
    xc = F.silu(xc)[:, None]                            # (B,1,di)
    dt, Bc, Cc, A = _ssm_params(params, xc, cfg)
    xf = xc[:, 0].float()
    a_bar = torch.exp(dt[:, 0, :, None] * A)            # (B,di,N)
    b_bar = (dt[:, 0] * xf)[..., None] * Bc[:, 0, None, :]
    h = a_bar * state["h"] + b_bar
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0]) + xf * params["D"].float()
    y = y[:, None].to(x.dtype) * F.silu(z)
    return sum_model(y @ params["out_proj"]), \
        {"conv": conv_in[:, 1:].float(), "h": h}
