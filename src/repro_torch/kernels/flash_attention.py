"""Launch wrapper for the Hopper flash attention kernel
(``csrc/flash_attention.cu``), the port of
``repro.kernels.flash_attention.flash_attention_bhsd``.

:func:`flash_attention_bshd` reads q/k/v in the model's ``(B, S, H, hd)``
/ ``(B, S, KV, hd)`` layout, so the TPU wrapper's transposes and pad copies
are gone.  v may be narrower than q and k (MLA's prefill: q/k 192, v 128),
as the TPU kernel's jnp oracle allows (``flash_attention_jnp``).  It takes CUDA tensors only: it allocates the output, launches
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

from repro_torch.kernels import (DTYPE_CODE, FLASH_QK_V_DIMS, LAUNCHES,
                                 build, check_cuda, check_dims, check_floats,
                                 check_launch, check_tensors)

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (dtype, hd, hd_v, q, k, v, out, B, S, KV, G, causal, window,
        #  scale, stream)
        lib.repro_flash_attention.argtypes = [
            i32, i32, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, ptr]
        lib.repro_flash_attention.restype = i32
        _lib = lib
    return _lib


def check_args(q, k, v, window: int):
    """Validate q (B,S,H,hd), k (B,S,KV,hd), v (B,S,KV,hd_v): hd_v is hd,
    or with hd a pair of :data:`repro_torch.kernels.FLASH_QK_V_DIMS` in a
    dtype it is built for.  Raises ``ValueError`` on anything the kernel
    does not take."""
    name = "flash_attention"
    tensors = {"q": q, "k": k, "v": v}
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k and v must be 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    hd_v = v.shape[3]
    if hd_v == hd:
        check_tensors(name, tensors, floats=("q", "k", "v"))
    else:
        dtype = check_floats(name, tensors, floats=("q", "k", "v"))
        check_dims(name, "(q/k, v) head dims", (hd, hd_v), dtype,
                   FLASH_QK_V_DIMS)
    if tuple(k.shape[:2]) != (B, S) or k.shape[3] != hd or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name}: k must be (B={B}, S={S}, KV, hd={hd}) "
                         f"and v (B, S, KV, hd_v), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{name}: {H} query heads do not group over {KV} "
                         f"kv heads")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,hd), k: (B,S,KV,hd), v: (B,S,KV,hd_v) -> (B,S,H,hd_v), at
    scale 1/sqrt(hd).  Query s sees key t iff ``t <= s`` when ``causal``
    and ``t > s - window`` when ``window``; ``causal=False, window=0`` is
    bidirectional."""
    check_args(q, k, v, window)
    check_cuda("flash_attention", {"q": q, "k": k, "v": v})
    B, S, H, hd = q.shape
    KV, hd_v = k.shape[2], v.shape[3]
    out = q.new_empty((B, S, H, hd_v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().repro_flash_attention(
            DTYPE_CODE[q.dtype], hd, hd_v, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, S, KV, H // KV, int(causal),
            int(window), 1.0 / math.sqrt(hd), stream)
    check_launch("flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out
