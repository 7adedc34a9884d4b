"""Launch wrapper and split plan of the Hopper MLA decode kernels
(``csrc/mla_decode.cu``): the absorbed attention core of
``repro.models.attention.mla_decode`` (``attention.py:636-643``), which the
JAX package computes in plain ``jnp`` and no TPU kernel replaces.

:func:`mla_decode_attention_bhr` takes the absorbed query q_lat ``(B, H,
r)``, its RoPE part q_rope ``(B, H, rh)``, the latent cache ckv ``(B, L,
r)`` and its RoPE key krope ``(B, L, rh)``.  It takes CUDA tensors only: it
allocates the output (and for fp32 the scratch of :func:`split_plan`),
launches the kernel (bf16: keys on ``wgmma`` fed by a TMA ring; fp32: the
CUDA cores; split over CTAs and merged in one launch) on PyTorch's current
stream without synchronising, raises if the launch reports an error, and
adds one to its count in :data:`repro_torch.kernels.LAUNCHES`.
:func:`check_args` validates a call for both routes; the plain version is
:func:`repro_torch.kernels.ref.mla_decode_attention_ref`.

The plan: the grid is ``(B, s_max)``, with ``s_max`` from the shapes and
the card's SM count alone (:func:`split_plan`), never from ``lengths``, so
a CUDA graph can capture the call.  On the card, row ``b`` with ``live``
keys takes the splits of :func:`splits` (the kernel's ``mla_split``):
``min(s_max, ceil(live / MIN_KEYS))`` near-equal runs of keys, each a
whole number of :data:`GRAIN_KEYS` keys but the last, merged in split
order.  In bf16 a row's CTAs are one cluster and merge through its
distributed shared memory; in fp32 the last CTA of a row, found by a
ticket, merges the splits' partials from the workspace.  The ticket
counters are :func:`repro_torch.kernels.decode_plan.scratch`'s, one per
stream, which the kernel leaves at zero.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import (DTYPE_CODE, LAUNCHES, MLA_DIMS, build,
                                 check_cuda, check_dims, check_floats,
                                 check_launch, decode_plan)

#: a split boundary is a multiple of this many keys (``MLA_GRAIN``)
GRAIN_KEYS = 16
#: query heads a CTA holds, at most (``MLA_HEADS``)
MAX_HEADS = 16
#: key rows of the bf16 kernel's tiles (``MLA_TILE``, wgmma's M)
TILE_KEYS = 64
#: the fewest keys worth a split of their own (a multiple of GRAIN_KEYS):
#: a split costs a CTA and its share of the merge (a partial of H (r + 2)
#: fp32, 33 KB at H 16, r 512) against 1,152 bytes a bf16 key row.  Set
#: from the sweep of scripts/attention_ab.py on an H100: 16-128 within
#: 0.0003 ms of each other at the serve's ~315 keys a row, 128 the
#: fastest there, 256 17% slower, all equal at 2,048 keys (PERF.md, 6)
MIN_KEYS = 128
#: splits a row, at most (``MLA_MAX_SPLITS``: the bf16 kernel's cluster,
#: the largest an H100 takes by default)
MAX_SPLITS = 8

_lib = None
_SMS: Dict[int, int] = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("mla_decode.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (dtype, r, rh, q_lat, q_rope, ckv, krope, lengths, out, ws,
        #  tickets, B, H, L, s_max, min_keys, scale, stream)
        lib.repro_mla_decode_attention.argtypes = [
            i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
            i32, i32, i32, ctypes.c_float, ptr]
        lib.repro_mla_decode_attention.restype = i32
        for fn, want in (("repro_mla_grain_keys", GRAIN_KEYS),
                         ("repro_mla_max_heads", MAX_HEADS),
                         ("repro_mla_tile_keys", TILE_KEYS),
                         ("repro_mla_max_splits", MAX_SPLITS)):
            got = getattr(lib, fn)()
            if got != want:
                raise RuntimeError(f"mla_decode_attention: the kernel's {fn} "
                                   f"is {got}, the wrapper's {want}")
        _lib = lib
    return _lib


def _sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (132 on an H100 SXM)."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def split_plan(B: int, H: int, r: int, L: int, n_sm: int) -> decode_plan.Plan:
    """The plan of a decode of ``B`` rows of ``H`` heads over caches of
    ``L`` rows at latent rank ``r`` on a card of ``n_sm`` SMs: ``s_max =
    min(ceil(L / MIN_KEYS), MAX_SPLITS, n_sm // B)`` splits a row at most
    (at least 1; the grid holds at most a CTA an SM), fp32 partials (B,
    s_max, H, r + 2) and one ticket a row for the fp32 kernel's merge."""
    s_max = max(1, min(-(-L // MIN_KEYS), MAX_SPLITS, n_sm // B))
    return decode_plan.Plan(s_max, B * H * s_max * (r + 2), B)


def splits(live: int, s_max: int, min_keys: int) -> List[Tuple[int, int]]:
    """The key runs [k0, k1) of a row with ``live`` keys (``mla_split`` in
    the kernel): n = clamp(ceil(live / min_keys), 1, s_max) runs, the
    live keys' grains of GRAIN_KEYS dealt out as evenly as integers allow;
    none for a row without keys."""
    if min_keys < GRAIN_KEYS:
        raise ValueError(f"min_keys {min_keys} < {GRAIN_KEYS}")
    if live <= 0:
        return []
    n = max(1, min(s_max, -(-live // min_keys)))
    g = -(-live // GRAIN_KEYS)
    return [(GRAIN_KEYS * (s * g // n),
             min(live, GRAIN_KEYS * ((s + 1) * g // n))) for s in range(n)]


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
    plan = split_plan(B, H, r, L, _sm_count(q_lat.device))
    out = torch.empty_like(q_lat)
    with torch.cuda.device(q_lat.device):
        stream = torch.cuda.current_stream().cuda_stream
        # the bf16 kernel merges a row's splits in its cluster's shared
        # memory; the fp32 one through the workspace, behind a ticket
        ws = tickets = None
        if q_lat.dtype != torch.bfloat16:
            ws, tickets = decode_plan.scratch(plan, q_lat.device, stream)
        rc = _library().repro_mla_decode_attention(
            DTYPE_CODE[q_lat.dtype], r, rh, q_lat.data_ptr(),
            q_rope.data_ptr(), ckv.data_ptr(), krope.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            tickets.data_ptr() if tickets is not None else None, B, H, L,
            plan.n_chunks, MIN_KEYS, float(scale), stream)
    check_launch(name, rc)
    LAUNCHES[name] += 1
    return out
