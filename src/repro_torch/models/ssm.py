"""Mamba-1 SSM block of the port (``repro.models.ssm``, falcon-mamba-7b):
in_proj -> causal depthwise conv -> selective scan -> gate -> out_proj.

Every full-sequence pass (:func:`ssm_forward`) runs its scan through
:func:`repro_torch.kernels.ops.ssm_scan`: the fused Hopper kernel on a
CUDA tensor, the plain sequential recurrence on the CPU.  JAX sends only
``S >= 128`` with ``cfg.use_kernels`` to its Pallas kernel and the rest to
a chunked ``associative_scan``; both compute the same recurrence.  A
single-token step (:func:`ssm_decode`) has no kernel, in JAX too.

State per layer: ``{"conv": (B, K-1, di), "h": (B, di, N)}``, fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def _conv1d_causal(x, w, b):
    """x: (B,S,di), depthwise causal conv, kernel (K,di)
    (``ssm.py:39-44``; the taps are summed in the same order)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _ssm_params(params, xc, cfg):
    """Per-token dt, B, C (fp32) and A (di,N) from the conv output xc
    (B,S,di) (``ssm.py:47-54``)."""
    N, dtr = cfg.ssm_state, cfg.dt_rank
    proj = xc @ params["x_proj"]                       # (B,S,dtr+2N)
    dt_in, Bc, Cc = torch.split(proj, [dtr, N, N], dim=-1)
    dt = F.softplus(dt_in @ params["dt_proj"] + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())            # (di,N)
    return dt.float(), Bc.float(), Cc.float(), A


def selective_scan(xc, dt, Bc, Cc, A, D, h0=None):
    """xc: (B,S,di)  dt: (B,S,di)  Bc,Cc: (B,S,N)  A: (di,N)  D: (di,)

    Returns (y (B,S,di), h_final (B,di,N)), fp32 (``ssm.py:57-104``),
    through :func:`repro_torch.kernels.ops.ssm_scan`."""
    return kops.ssm_scan(xc.float(), dt, Bc, Cc, A, D.float(), h0=h0)


def ssm_forward(params, x, cfg, state=None):
    """x: (B,S,d) -> (out, new_state) (``ssm.py:107-138``).  With
    ``state`` the conv continues from ``state["conv"]`` and the scan from
    ``state["h"]``."""
    S = x.shape[1]
    K = cfg.conv_k
    xs, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    if state is not None:
        xs_ext = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
        conv_full = _conv1d_causal(xs_ext, params["conv_w"],
                                   params["conv_b"])
        xc = conv_full[:, K - 1:]
    else:
        xc = _conv1d_causal(xs, params["conv_w"], params["conv_b"])
    xc = F.silu(xc)
    dt, Bc, Cc, A = _ssm_params(params, xc, cfg)
    h0 = state["h"] if state is not None else None
    y, h_fin = selective_scan(xc, dt, Bc, Cc, A, params["D"], h0=h0)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
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
    xs, z = (x @ params["in_proj"]).chunk(2, dim=-1)    # (B,1,di)
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
    return y @ params["out_proj"], {"conv": conv_in[:, 1:].float(), "h": h}
