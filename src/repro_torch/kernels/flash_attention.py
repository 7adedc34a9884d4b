"""Launch wrapper for the Hopper flash attention kernel
(``csrc/flash_attention.cu``), the port of
``repro.kernels.flash_attention.flash_attention_bhsd``.

:func:`flash_attention_bshd` reads q/k/v in the model's ``(B, S, H, hd)``
/ ``(B, S, KV, hd)`` layout, so the TPU wrapper's transposes and pad copies
are gone.  It takes CUDA tensors only: it allocates the output, launches
the kernel on PyTorch's current stream without synchronising, raises if
the launch reports an error, and adds one to its count in
:data:`repro_torch.kernels.LAUNCHES`.  :func:`check_args` validates a call
for both routes; the plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import (DTYPE_CODE, LAUNCHES, build, check_cuda,
                                 check_launch, check_tensors)

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (dtype, hd, q, k, v, out, B, S, KV, G, causal, window, scale,
        #  stream)
        lib.repro_flash_attention.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, ptr]
        lib.repro_flash_attention.restype = i32
        _lib = lib
    return _lib


def check_args(q, k, v, window: int):
    """Validate q (B,S,H,hd), k/v (B,S,KV,hd); raises ``ValueError`` on
    anything the kernel does not take."""
    name = "flash_attention"
    check_tensors(name, {"q": q, "k": k, "v": v}, floats=("q", "k", "v"))
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q, k and v must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, hd = q.shape
    if v.shape != k.shape or tuple(k.shape[:2]) != (B, S) or \
            k.shape[3] != hd:
        raise ValueError(f"{name}: k and v must both be (B={B}, S={S}, KV, "
                         f"hd={hd}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{name}: {H} query heads do not group over {KV} "
                         f"kv heads")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,hd), k/v: (B,S,KV,hd) -> (B,S,H,hd).  Query s sees key t
    iff ``t <= s`` when ``causal`` and ``t > s - window`` when ``window``;
    ``causal=False, window=0`` is bidirectional."""
    check_args(q, k, v, window)
    check_cuda("flash_attention", {"q": q, "k": k, "v": v})
    B, S, H, hd = q.shape
    KV = k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().repro_flash_attention(
            DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, S, KV, H // KV, int(causal),
            int(window), 1.0 / math.sqrt(hd), stream)
    check_launch("flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out
