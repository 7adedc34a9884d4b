"""Launch wrappers for the Hopper scan kernels: ``csrc/ssm_scan.cu``, the
port of ``repro.kernels.ssm_scan.ssm_scan_blocked``, and
``csrc/selective_scan.cu``, which fuses that kernel with the op around it
(``repro.kernels.ops.ssm_scan``).

:func:`ssm_scan_blocked` takes ``a_bar`` and ``b_bar`` ``(B, S, D, N)`` and
``h0`` ``(B, D, N)``, all fp32 (the TPU kernel's contract,
``ssm_scan.py:46``), and returns ``(h_seq (B, S, D, N), h_final (B, D,
N))`` of the recurrence ``h_t = a_t * h_{t-1} + b_t``.  It takes no chunk
or block sizes: :mod:`repro_torch.kernels.scan_plan` picks, from the
shapes, the single walk or the chunked scan and its chunks.

:func:`selective_scan_fused` takes the op's ``(xc, dt, Bc, Cc, A, D,
h0)`` (the contract of ``models.ssm.selective_scan``) and returns ``(y (B,
S, di), h_final (B, di, N))`` from one kernel that keeps the states in
registers: no ``(B, S, di, N)`` tensor is made.

Both take CUDA tensors only: they allocate the outputs (and the chunked
scan's scratch), launch on PyTorch's current stream without
synchronising, raise if the launch reports an error, and add one to
``LAUNCHES["ssm_scan"]``.  :func:`check_args` and :func:`check_fused_args`
validate a call for both routes; the plain versions are
:func:`repro_torch.kernels.ref.ssm_scan_ref` and
:func:`repro_torch.kernels.ref.selective_scan_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build, check_placement, count
from repro_torch.kernels import scan_plan

NAME = "ssm_scan"
_lib = None
_fused_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("ssm_scan.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (a, b, h0, hs, hT, B, S, D, N, chunk, n_chunks, agg, flags,
        #  stream)
        lib.repro_ssm_scan.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                       i32, i32, i32, ptr, ptr, ptr]
        lib.repro_ssm_scan.restype = i32
        scan_plan.check_library(lib, NAME)
        _lib = lib
    return _lib


def _fused_library() -> ctypes.CDLL:
    global _fused_lib
    if _fused_lib is None:
        lib = build.load("selective_scan.cu")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # (xc, dt, Bc, Cc, A, D, h0, y, hT, B, S, di, N, b_batch, b_step,
        #  c_batch, c_step, stream)
        lib.repro_selective_scan_fused.argtypes = (
            [ptr] * 9 + [i32] * 4 + [i64] * 4 + [ptr])
        lib.repro_selective_scan_fused.restype = i32
        _fused_lib = lib
    return _fused_lib


#: the fused kernel's largest N: 4 states a lane, 32 lanes a channel
#: (``SPL * MAX_LANES`` in csrc/selective_scan.cu)
MAX_STATES = 128


def check_args(a_bar, b_bar, h0) -> None:
    """Validate a_bar and b_bar (B, S, D, N) and h0 (B, D, N): fp32, one
    device, contiguous, every size >= 1.  Raises ``ValueError``."""
    check_placement(NAME, {"a_bar": a_bar, "b_bar": b_bar, "h0": h0})
    if a_bar.dim() != 4 or b_bar.shape != a_bar.shape:
        raise ValueError(f"{NAME}: a_bar and b_bar must both be (B, S, D, "
                         f"N), got {tuple(a_bar.shape)} and "
                         f"{tuple(b_bar.shape)}")
    B, S, D, N = a_bar.shape
    if min(B, S, D, N) < 1:
        raise ValueError(f"{NAME}: B, S, D and N must be >= 1, got "
                         f"{tuple(a_bar.shape)}")
    if tuple(h0.shape) != (B, D, N):
        raise ValueError(f"{NAME}: h0 must be ({B}, {D}, {N}), got "
                         f"{tuple(h0.shape)}")
    for key, t in (("a_bar", a_bar), ("b_bar", b_bar), ("h0", h0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{NAME}: {key} must be float32 (the TPU "
                             f"kernel's contract), got {t.dtype}")


def _cuda_only(t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{NAME}: the kernel takes CUDA tensors, got "
                         f"{t.device}; the plain version is in "
                         f"repro_torch.kernels.ref")


def ssm_scan_blocked(a_bar, b_bar, h0):
    """a_bar, b_bar: (B, S, D, N) fp32; h0: (B, D, N) fp32 -> (h_seq,
    h_final)."""
    check_args(a_bar, b_bar, h0)
    _cuda_only(a_bar)
    B, S, D, N = a_bar.shape
    if B > 65535:
        raise ValueError(f"{NAME}: B = {B} is above the kernel's 65,535 "
                         f"rows")
    plan = scan_plan.split_plan(B, S, D, N)
    hs = torch.empty_like(a_bar)
    hT = torch.empty_like(h0)
    with torch.cuda.device(a_bar.device):
        scratch = (None, None)
        if plan.n_chunks > 1:
            agg, flags = scan_plan.scratch(plan, a_bar.device)
            scratch = (agg.data_ptr(), flags.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().repro_ssm_scan(
            a_bar.data_ptr(), b_bar.data_ptr(), h0.data_ptr(), hs.data_ptr(),
            hT.data_ptr(), B, S, D, N, plan.chunk, plan.n_chunks, *scratch,
            stream)
    if rc != 0:
        raise RuntimeError(f"{NAME}: kernel launch failed with CUDA error "
                           f"{rc}")
    count(LAUNCHES, NAME)
    return hs, hT


def check_fused_args(xc, dt, Bc, Cc, A, D, h0) -> None:
    """Validate the fused op's inputs: xc, dt (B, S, di) and A (di, N), D
    (di,), h0 (B, di, N) or None contiguous; Bc, Cc (B, S, N) with unit
    stride over N (``torch.split`` views of the projection qualify); all
    fp32 on one device, every size >= 1, N <= :data:`MAX_STATES`.  Raises
    ``ValueError``."""
    dense = {"xc": xc, "dt": dt, "A": A, "D": D}
    if h0 is not None:
        dense["h0"] = h0
    check_placement(NAME, dense)
    named = dict(dense, Bc=Bc, Cc=Cc)
    if len({t.device for t in named.values()}) != 1:
        raise ValueError(f"{NAME}: all tensors must share one device, got "
                         f"{sorted({str(t.device) for t in named.values()})}")
    for key, t in named.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{NAME}: {key} must be float32, got {t.dtype}")
    if xc.dim() != 3 or dt.shape != xc.shape:
        raise ValueError(f"{NAME}: xc and dt must both be (B, S, di), got "
                         f"{tuple(xc.shape)} and {tuple(dt.shape)}")
    B, S, di = xc.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"{NAME}: A must be ({di}, N), got "
                         f"{tuple(A.shape)}")
    N = A.shape[1]
    if min(B, S, di, N) < 1:
        raise ValueError(f"{NAME}: B, S, di and N must be >= 1, got "
                         f"{(B, S, di, N)}")
    if N > MAX_STATES:
        raise ValueError(f"{NAME}: N = {N} is above the fused kernel's "
                         f"{MAX_STATES} states")
    for key, t in (("Bc", Bc), ("Cc", Cc)):
        if tuple(t.shape) != (B, S, N) or t.stride(-1) != 1:
            raise ValueError(f"{NAME}: {key} must be ({B}, {S}, {N}) with "
                             f"unit stride over N, got {tuple(t.shape)} at "
                             f"strides {t.stride()}")
    if tuple(D.shape) != (di,):
        raise ValueError(f"{NAME}: D must be ({di},), got {tuple(D.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, di, N):
        raise ValueError(f"{NAME}: h0 must be ({B}, {di}, {N}), got "
                         f"{tuple(h0.shape)}")


def selective_scan_fused(xc, dt, Bc, Cc, A, D, h0=None):
    """xc, dt: (B, S, di); Bc, Cc: (B, S, N); A: (di, N); D: (di,); h0:
    (B, di, N) or None (zeros); fp32 -> (y (B, S, di), h_final (B, di,
    N))."""
    check_fused_args(xc, dt, Bc, Cc, A, D, h0)
    _cuda_only(xc)
    B, S, di = xc.shape
    N = A.shape[1]
    if B > 65535:
        raise ValueError(f"{NAME}: B = {B} is above the kernel's 65,535 "
                         f"rows")
    y = torch.empty_like(xc)
    hT = torch.empty((B, di, N), dtype=torch.float32, device=xc.device)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fused_library().repro_selective_scan_fused(
            xc.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hT.data_ptr(), B, S, di, N, Bc.stride(0),
            Bc.stride(1), Cc.stride(0), Cc.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME}: fused kernel launch failed with CUDA "
                           f"error {rc}")
    count(LAUNCHES, NAME)
    return y, hT
