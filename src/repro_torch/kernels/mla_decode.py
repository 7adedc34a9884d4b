"""Launch wrapper and split plan of the Hopper MLA decode kernel
(``csrc/mla_decode.cu``): the absorbed attention core of
``repro.models.attention.mla_decode`` (``attention.py:636-643``), which the
JAX package computes in plain ``jnp`` and no TPU kernel replaces.

:func:`mla_decode_attention_bhr` takes the absorbed query q_lat ``(B, H,
r)``, its RoPE part q_rope ``(B, H, rh)``, the latent cache ckv ``(B, L,
r)`` and its RoPE key krope ``(B, L, rh)``.  It takes CUDA tensors only: it
allocates the output and the scratch of :func:`split_plan`, launches the
kernel (split over CTAs and merged in one launch) on PyTorch's current
stream without synchronising, raises if the launch reports an error, and
adds one to its count in :data:`repro_torch.kernels.LAUNCHES`.
:func:`check_args` validates a call for both routes; the plain version is
:func:`repro_torch.kernels.ref.mla_decode_attention_ref`.

The plan: chunk ``c`` of a row holds keys ``c * CHUNK_KEYS`` up to
``min(live, (c + 1) * CHUNK_KEYS)``; one CTA takes a (row, chunk) with all
its heads, and the last CTA of a row merges the chunks' fp32 partials.
It is sized from the shapes alone, never from ``lengths``, so a CUDA graph
can capture the call; the ticket counters are
:func:`repro_torch.kernels.decode_plan.scratch`'s, one per stream, which
the kernel leaves at zero.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (DTYPE_CODE, LAUNCHES, MLA_DIMS, build,
                                 check_cuda, check_dims, check_floats,
                                 check_launch, decode_plan)

#: keys a CTA owns (``MLA_CHUNK`` in csrc/mla_decode.cu)
CHUNK_KEYS = 64
#: query heads a CTA holds, at most (``MLA_HEADS``)
MAX_HEADS = 16

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("mla_decode.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (dtype, r, rh, q_lat, q_rope, ckv, krope, lengths, out, ws,
        #  tickets, B, H, L, n_chunks, scale, stream)
        lib.repro_mla_decode_attention.argtypes = [
            i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
            i32, i32, ctypes.c_float, ptr]
        lib.repro_mla_decode_attention.restype = i32
        for fn, want in (("repro_mla_chunk_keys", CHUNK_KEYS),
                         ("repro_mla_max_heads", MAX_HEADS)):
            got = getattr(lib, fn)()
            if got != want:
                raise RuntimeError(f"mla_decode_attention: the kernel's {fn} "
                                   f"is {got}, the wrapper's {want}")
        _lib = lib
    return _lib


def split_plan(B: int, H: int, r: int, L: int) -> decode_plan.Plan:
    """The plan of a decode of ``B`` rows of ``H`` heads over caches of
    ``L`` rows at latent rank ``r``: ceil(L / CHUNK_KEYS) chunks a row,
    fp32 partials (B, H, n_chunks, r + 2), one ticket a row."""
    n_chunks = max(1, -(-L // CHUNK_KEYS))
    return decode_plan.Plan(n_chunks, B * H * n_chunks * (r + 2), B)


def check_args(q_lat, q_rope, ckv, krope, lengths, scale: float):
    """Validate q_lat (B,H,r), q_rope (B,H,rh), ckv (B,L,r), krope (B,L,rh)
    and lengths (B,) int32, with (r, rh) a pair of
    :data:`repro_torch.kernels.MLA_DIMS` in a dtype it is built for and H
    at most :data:`MAX_HEADS`; raises ``ValueError`` on anything the kernel
    does not take."""
    name = "mla_decode_attention"
    tensors = {"q_lat": q_lat, "q_rope": q_rope, "ckv": ckv, "krope": krope,
               "lengths": lengths}
    dtype = check_floats(name, tensors,
                         floats=("q_lat", "q_rope", "ckv", "krope"))
    if q_lat.dim() != 3 or q_rope.dim() != 3 or ckv.dim() != 3 or \
            krope.dim() != 3:
        raise ValueError(f"{name}: q_lat, q_rope, ckv and krope must be 3-d, "
                         f"got {tuple(q_lat.shape)}, {tuple(q_rope.shape)}, "
                         f"{tuple(ckv.shape)} and {tuple(krope.shape)}")
    B, H, r = q_lat.shape
    rh = q_rope.shape[2]
    check_dims(name, "(latent rank, rope dim)", (r, rh), dtype, MLA_DIMS)
    L = ckv.shape[1]
    if tuple(q_rope.shape) != (B, H, rh) or tuple(ckv.shape) != (B, L, r) \
            or tuple(krope.shape) != (B, L, rh) or L < 1:
        raise ValueError(f"{name}: expected q_rope ({B}, {H}, {rh}), ckv "
                         f"({B}, L >= 1, {r}) and krope ({B}, L, {rh}), got "
                         f"{tuple(q_rope.shape)}, {tuple(ckv.shape)} and "
                         f"{tuple(krope.shape)}")
    if not 1 <= H <= MAX_HEADS:
        raise ValueError(f"{name}: {H} heads; the kernel holds 1 to "
                         f"{MAX_HEADS} a CTA")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: lengths must be int32 of shape ({B},)")
    if not scale > 0:
        raise ValueError(f"{name}: scale must be > 0, got {scale}")


def mla_decode_attention_bhr(q_lat, q_rope, ckv, krope, lengths,
                             scale: float):
    """q_lat (B,H,r), q_rope (B,H,rh), ckv (B,L,r), krope (B,L,rh),
    lengths (B,) int32 -> (B,H,r): softmax((q_lat ckv^T + q_rope krope^T)
    * scale) over keys ``< min(lengths, L)``, times ckv; scores and P in
    fp32."""
    check_args(q_lat, q_rope, ckv, krope, lengths, scale)
    name = "mla_decode_attention"
    check_cuda(name, {"q_lat": q_lat, "q_rope": q_rope, "ckv": ckv,
                      "krope": krope, "lengths": lengths})
    B, H, r = q_lat.shape
    rh, L = q_rope.shape[2], ckv.shape[1]
    plan = split_plan(B, H, r, L)
    out = torch.empty_like(q_lat)
    with torch.cuda.device(q_lat.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws, tickets = decode_plan.scratch(plan, q_lat.device, stream)
        rc = _library().repro_mla_decode_attention(
            DTYPE_CODE[q_lat.dtype], r, rh, q_lat.data_ptr(),
            q_rope.data_ptr(), ckv.data_ptr(), krope.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
            tickets.data_ptr(), B, H, L, plan.n_chunks, float(scale), stream)
    check_launch(name, rc)
    LAUNCHES[name] += 1
    return out
