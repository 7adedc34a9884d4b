"""Launch wrapper for the Hopper split-K decode kernel
(``csrc/decode_attention.cu`` on the shared ``csrc/decode_sm90.cuh``), the
port of ``repro.kernels.decode_attention.decode_attention_bhd``.

:func:`decode_attention_bhd` takes q ``(B, H, hd)`` and the caches in the
model's ``(B, L, KV, hd)`` layout (the TPU wrapper transposed them to
``(B, KV, L, hd)``).  It takes CUDA tensors only: it allocates the output
and the scratch of :mod:`repro_torch.kernels.decode_plan`, launches the
kernel (split and merge in one launch) on PyTorch's current stream
without synchronising, raises if the launch reports an error, and adds
one to its count in :data:`repro_torch.kernels.LAUNCHES`.
:func:`check_args` validates a call for both routes; the plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import (DTYPE_CODE, LAUNCHES, build, check_cuda,
                                 check_launch, check_tensors, decode_plan)

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("decode_attention.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (dtype, hd, q, k, v, lengths, out, ws, tickets, B, L, KV, G,
        #  n_chunks, scale, stream)
        lib.repro_decode_attention.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
            i32, ctypes.c_float, ptr]
        lib.repro_decode_attention.restype = i32
        decode_plan.check_library(lib, "decode_attention")
        _lib = lib
    return _lib


def check_args(q, k, v, lengths, n_splits: int):
    """Validate q (B,H,hd), k/v (B,L,KV,hd), lengths (B,) int32; raises
    ``ValueError`` on anything the kernel does not take."""
    name = "decode_attention"
    check_tensors(name, {"q": q, "k": k, "v": v, "lengths": lengths},
                  floats=("q", "k", "v"))
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (B, H, hd), got "
                         f"{tuple(q.shape)}")
    B, H, hd = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != B or \
            k.shape[3] != hd:
        raise ValueError(f"{name}: k and v must both be (B={B}, L, KV, "
                         f"hd={hd}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{name}: {H} query heads do not group over {KV} "
                         f"kv heads")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: lengths must be int32 of shape ({B},)")
    if n_splits < 1:
        raise ValueError(f"{name}: n_splits must be >= 1, got {n_splits}")


def decode_attention_bhd(q, k, v, lengths, *, n_splits: int = 8):
    """q: (B,H,hd); k/v: (B,L,KV,hd) caches; lengths: (B,) int32 valid
    prefix -> (B,H,hd).  ``n_splits`` is the TPU wrapper's contract
    (``repro.kernels.ops.decode_attention``) and is checked, but the
    kernel plans its own split: chunks of ``decode_plan.CHUNK_KEYS`` keys,
    from the shapes alone."""
    check_args(q, k, v, lengths, n_splits)
    check_cuda("decode_attention", {"q": q, "k": k, "v": v})
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    plan = decode_plan.split_plan(B, H, KV, hd, L)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws, tickets = decode_plan.scratch(plan, q.device, stream)
        rc = _library().repro_decode_attention(
            DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
            tickets.data_ptr(), B, L, KV, H // KV, plan.n_chunks,
            1.0 / math.sqrt(hd), stream)
    check_launch("decode_attention", rc)
    LAUNCHES["decode_attention"] += 1
    return out
