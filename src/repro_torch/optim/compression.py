"""Gradient compression for data-parallel reductions (``repro.optim.
compression``): int8 uniform quantization with a per-tensor scale and
error feedback (a residual carried to the next step).  Wire bytes drop 4x
against fp32.

Round-to-nearest rounds half to even in both ``jnp.round`` and
``torch.round``, so its int8 payload equals JAX's.  Stochastic rounding
draws its noise from a ``torch.Generator`` and matches JAX only in
distribution.  :func:`compressed_psum` sums compressed gradients across
the ranks of a mesh axis (``core.collectives``), as JAX's does inside
``shard_map``."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class CompressedGrad(NamedTuple):
    q: torch.Tensor         # int8 payload
    scale: torch.Tensor     # () fp32


def quantize(g: torch.Tensor, residual: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[CompressedGrad, torch.Tensor]:
    """int8-quantize g (+ the residual carry) -> (compressed, new
    residual) (``compression.py:26-44``); with ``generator``, stochastic
    rounding (unbiased), otherwise round-to-nearest."""
    g32 = g.float()
    if residual is not None:
        g32 = g32 + residual
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    x = g32 / scale
    if generator is not None:
        noise = torch.rand(x.shape, generator=generator, device=x.device,
                           dtype=torch.float32) - 0.5
        x = x + noise
    q = torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    new_residual = g32 - q.float() * scale
    return CompressedGrad(q, scale), new_residual


def dequantize(c: CompressedGrad) -> torch.Tensor:
    return c.q.float() * c.scale


def compressed_psum(c: CompressedGrad, axis_name, mesh=None):
    """All-reduce a compressed gradient over ``axis_name`` of ``mesh``
    (default: the current sharding context's), JAX's three reductions
    (``compression.py:50-62``): the int8 payloads summed in int32, the
    scales maxed, and the payloads rescaled to the max scale summed in
    fp32.  Returns ``(value, raw int32 sum)``; ``value`` is the sum of
    every rank's gradient within one scale step a rank."""
    from repro_torch.core import collectives
    total = collectives.psum(c.q.to(torch.int32), axis_name, mesh)
    s_max = collectives.pmax(c.scale, axis_name, mesh)
    rescaled = collectives.psum(c.q.float() * (c.scale / s_max), axis_name,
                                mesh)
    return rescaled * s_max, total


def tree_quantize(grads, residuals=None):
    """(tree of CompressedGrad, tree of new residuals)."""
    res = residuals if residuals is not None else tree_map(
        lambda g: None, grads)
    pairs = tree_map(lambda g, r: quantize(g, r), grads, res)
    is_pair = lambda p: isinstance(p, tuple) and len(p) == 2 and \
        isinstance(p[0], CompressedGrad)  # noqa: E731
    return tuple(tree_map(lambda p: p[i], pairs, is_leaf=is_pair)
                 for i in range(2))


def tree_dequantize(ctree):
    return tree_map(dequantize, ctree,
                    is_leaf=lambda x: isinstance(x, CompressedGrad))


def compression_ratio(grads) -> float:
    """Wire bytes (int8 payloads and fp32 scales) over fp32 bytes."""
    leaves = tree_leaves(grads)
    n = sum(int(g.numel()) for g in leaves)
    return (n * 1 + len(leaves) * 4) / (n * 4)
