"""Launch wrapper for the Hopper pair-score kernel (``csrc/pair_score.cu``),
the port of ``repro.kernels.pair_score.pair_score_blocked``.

:func:`pair_score_blocked` takes claims ``(N, d)``, evidence ``(M, d)``,
``W (d, d)``, ``w_c`` and ``w_e`` ``(d,)`` and a bias, and returns the
fp32 ``(N, M)`` scores ``c_i^T W e_j + w_c . c_i + w_e . e_j + b``.  It
takes no block sizes: the kernel masks its ragged edges itself, so
nothing is padded.  It takes CUDA tensors only: it allocates the output
and the fp32 workspace (``C W`` and the two linear terms), launches the
projection pass and the score pass on PyTorch's current stream without
synchronising, raises if a launch reports an error, and adds one to
``LAUNCHES["pair_score"]``.  The kernel loads one element at a time, so
it needs no alignment beyond the element's (``w_c`` and ``w_e`` are views
into ``w``).  :func:`check_args` validates a call for both
routes; the plain version is :func:`repro_torch.kernels.ref.pair_score_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (DTYPE_CODE, LAUNCHES, build,
                                 check_placement, count)

NAME = "pair_score"
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("pair_score.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (c_dtype, w_dtype, C, E, W, w_c, w_e, bias, out, ws, N, M, d,
        #  stream)
        lib.repro_pair_score.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
            ptr]
        lib.repro_pair_score.restype = i32
        _lib = lib
    return _lib


def check_args(claims, evidence, W, w_c, w_e, bias) -> None:
    """Validate claims (N, d), evidence (M, d), W (d, d), w_c and w_e
    (d,) and a bias of one element: one device, contiguous, claims and
    evidence of one dtype and W, w_c and w_e of one, each float32 or
    bfloat16.  Raises ``ValueError``."""
    tensors = {"claims": claims, "evidence": evidence, "W": W, "w_c": w_c,
               "w_e": w_e}
    if isinstance(bias, torch.Tensor):
        tensors["bias"] = bias
        if bias.numel() != 1:
            raise ValueError(f"{NAME}: bias must hold one value, got shape "
                             f"{tuple(bias.shape)}")
    check_placement(NAME, tensors)
    if claims.dim() != 2 or evidence.dim() != 2 or \
            claims.shape[1] != evidence.shape[1]:
        raise ValueError(f"{NAME}: claims and evidence must be (N, d) and "
                         f"(M, d), got {tuple(claims.shape)} and "
                         f"{tuple(evidence.shape)}")
    d = claims.shape[1]
    if min(claims.shape[0], evidence.shape[0], d) < 1:
        raise ValueError(f"{NAME}: N, M and d must be >= 1, got "
                         f"{tuple(claims.shape)}, {tuple(evidence.shape)}")
    if tuple(W.shape) != (d, d) or tuple(w_c.shape) != (d,) or \
            tuple(w_e.shape) != (d,):
        raise ValueError(f"{NAME}: W must be ({d}, {d}) and w_c, w_e "
                         f"({d},), got {tuple(W.shape)}, {tuple(w_c.shape)}, "
                         f"{tuple(w_e.shape)}")
    for group in (("claims", "evidence"), ("W", "w_c", "w_e")):
        dtype = tensors[group[0]].dtype
        if dtype not in DTYPE_CODE:
            raise ValueError(f"{NAME}: dtype {dtype} not supported "
                             f"(float32, bfloat16)")
        if any(tensors[k].dtype != dtype for k in group):
            raise ValueError(f"{NAME}: {', '.join(group)} must share one "
                             f"dtype")


def pair_score_blocked(claims, evidence, W, w_c, w_e, bias):
    """claims: (N, d), evidence: (M, d), W: (d, d), w_c/w_e: (d,), bias:
    a number or a one-element tensor -> (N, M) fp32 scores."""
    check_args(claims, evidence, W, w_c, w_e, bias)
    for key, t in (("claims", claims), ("evidence", evidence), ("W", W),
                   ("w_c", w_c), ("w_e", w_e)):
        if t.device.type != "cuda":
            raise ValueError(f"{NAME}: the kernel takes CUDA tensors, got "
                             f"{key} on {t.device}; the plain version is in "
                             f"repro_torch.kernels.ref")
    N, d = claims.shape
    M = evidence.shape[0]
    dev = claims.device
    b = torch.as_tensor(bias, dtype=torch.float32, device=dev).reshape(1)
    out = torch.empty((N, M), dtype=torch.float32, device=dev)
    ws = torch.empty(N * d + N + M, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().repro_pair_score(
            DTYPE_CODE[claims.dtype], DTYPE_CODE[W.dtype], claims.data_ptr(),
            evidence.data_ptr(), W.data_ptr(), w_c.data_ptr(),
            w_e.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), N,
            M, d, stream)
    if rc != 0:
        raise RuntimeError(f"{NAME}: kernel launch failed with CUDA error "
                           f"{rc}")
    count(LAUNCHES, NAME)
    return out
