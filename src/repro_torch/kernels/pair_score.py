"""Launch wrapper for the Hopper pair-score kernels (``csrc/pair_score.cu``),
the port of ``repro.kernels.pair_score.pair_score_blocked``.

:func:`pair_score_blocked` takes claims ``(N, d)``, evidence ``(M, d)``,
``W (d, d)``, ``w_c`` and ``w_e`` ``(d,)`` and a bias, and returns the
fp32 ``(N, M)`` scores ``c_i^T W e_j + w_c . c_i + w_e . e_j + b``.  It
takes no block sizes: the kernels mask their ragged edges themselves, so
nothing is padded.  It takes CUDA tensors only: it allocates the output
and the fp32 workspace (``C W`` and the two linear terms), launches the
projection and the score on PyTorch's current stream without
synchronising, raises if a launch reports an error, and adds one to
``LAUNCHES["pair_score"]``.  :func:`repro_torch.kernels.pair_plan.plan`
picks the route from the shapes and dtypes: fp32 with ``d % 4 == 0`` runs
3xTF32 on ``wgmma`` (its tensors must start on 16-byte boundaries, as TMA
reads them; ``w_c`` and ``w_e`` are views into ``w``, so ``d % 4 == 0``
keeps ``w_e`` aligned), anything else the CUDA-core kernels, which load
one element at a time and need no alignment beyond the element's.
:func:`check_args` validates a call for both routes; the plain version is
:func:`repro_torch.kernels.ref.pair_score_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (DTYPE_CODE, LAUNCH_ERRORS, LAUNCHES,
                                 build, check_placement, count, pair_plan)

NAME = "pair_score"
_lib = None
#: what the C entry points return besides a CUDA error
_ERRORS = {**LAUNCH_ERRORS,
           -1: "no kernel for these dtypes, or a plan that does not cover "
               "the depth once"}


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
        # (C, E, W, w_c, w_e, bias, out, ws, N, M, d, proj_split,
        #  proj_per, score_split, score_per, stream)
        lib.repro_pair_score_sm90.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
        lib.repro_pair_score_sm90.restype = i32
        lib.repro_pair_sm90_config.argtypes = [ptr]
        lib.repro_pair_sm90_config.restype = None
        pair_plan.check_library(lib, NAME)
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


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def pair_score_blocked(claims, evidence, W, w_c, w_e, bias):
    """claims: (N, d), evidence: (M, d), W: (d, d), w_c/w_e: (d,), bias:
    a number or a one-element tensor -> (N, M) fp32 scores."""
    check_args(claims, evidence, W, w_c, w_e, bias)
    tensors = {"claims": claims, "evidence": evidence, "W": W, "w_c": w_c,
               "w_e": w_e}
    for key, t in tensors.items():
        if not _on_card(t):
            raise ValueError(f"{NAME}: the kernel takes CUDA tensors, got "
                             f"{key} on {t.device}; the plain version is in "
                             f"repro_torch.kernels.ref")
    N, d = claims.shape
    M = evidence.shape[0]
    plan = pair_plan.plan(N, M, d, claims.dtype, W.dtype)
    if plan.route == "wgmma":
        for key, t in tensors.items():
            if t.data_ptr() % 16:
                raise ValueError(f"{NAME}: {key} must start on a 16-byte "
                                 f"boundary (TMA reads the fp32 route's "
                                 f"tensors)")
    dev = claims.device
    b = torch.as_tensor(bias, dtype=torch.float32, device=dev).reshape(1)
    out = torch.empty((N, M), dtype=torch.float32, device=dev)
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _library()
        if plan.route == "wgmma":
            rc = lib.repro_pair_score_sm90(
                claims.data_ptr(), evidence.data_ptr(), W.data_ptr(),
                w_c.data_ptr(), w_e.data_ptr(), b.data_ptr(), out.data_ptr(),
                ws.data_ptr(), N, M, d, plan.project.split,
                plan.project.per_split, plan.score.split,
                plan.score.per_split, stream)
        else:
            rc = lib.repro_pair_score(
                DTYPE_CODE[claims.dtype], DTYPE_CODE[W.dtype],
                claims.data_ptr(), evidence.data_ptr(), W.data_ptr(),
                w_c.data_ptr(), w_e.data_ptr(), b.data_ptr(), out.data_ptr(),
                ws.data_ptr(), N, M, d, stream)
    if rc != 0:
        raise RuntimeError(f"{NAME}: kernel launch failed: "
                           f"{_ERRORS.get(rc, f'CUDA error {rc}')}")
    count(LAUNCHES, NAME)
    return out
