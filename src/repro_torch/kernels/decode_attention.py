"""Launch wrapper for the Hopper split-K decode kernel
(``csrc/decode_attention.cu``), the port of
``repro.kernels.decode_attention.decode_attention_bhd``.

:func:`decode_attention_bhd` takes q ``(B, H, hd)`` and the caches in the
model's ``(B, L, KV, hd)`` layout (the TPU wrapper transposed them to
``(B, KV, L, hd)``).  It takes CUDA tensors only: it allocates the output
and the fp32 split workspace, launches the split pass and the merge pass
on PyTorch's current stream without synchronising, raises if a launch
reports an error, and adds one to its count in
:data:`repro_torch.kernels.LAUNCHES`.  :func:`check_args` validates a call
for both routes; the plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import (DTYPE_CODE, LAUNCHES, build, check_cuda,
                                 check_tensors)

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("decode_attention.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (dtype, hd, q, k, v, lengths, out, ws, B, L, KV, G, n_splits,
        #  scale, stream)
        lib.repro_decode_attention.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
            ctypes.c_float, ptr]
        lib.repro_decode_attention.restype = i32
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


def num_splits(L: int, n_splits: int) -> int:
    """The TPU wrapper's split count: ``n_splits`` halved until it divides
    the cache length ``L``."""
    while n_splits > 1 and L % n_splits:
        n_splits //= 2
    return max(n_splits, 1)


def decode_attention_bhd(q, k, v, lengths, *, n_splits: int = 8):
    """q: (B,H,hd); k/v: (B,L,KV,hd) caches; lengths: (B,) int32 valid
    prefix -> (B,H,hd)."""
    check_args(q, k, v, lengths, n_splits)
    check_cuda("decode_attention", {"q": q, "k": k, "v": v})
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    ns = num_splits(L, n_splits)
    out = torch.empty_like(q)
    ws = torch.empty(B * H * ns * (hd + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().repro_decode_attention(
            DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
            B, L, KV, H // KV, ns, 1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES["decode_attention"] += 1
    return out
