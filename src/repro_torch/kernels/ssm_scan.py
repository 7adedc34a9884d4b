"""Launch wrapper for the Hopper selective-scan kernel
(``csrc/ssm_scan.cu``), the port of
``repro.kernels.ssm_scan.ssm_scan_blocked``.

:func:`ssm_scan_blocked` takes ``a_bar`` and ``b_bar`` ``(B, S, D, N)`` and
``h0`` ``(B, D, N)``, all fp32 (the TPU kernel's contract,
``ssm_scan.py:46``), and returns ``(h_seq (B, S, D, N), h_final (B, D,
N))`` of the recurrence ``h_t = a_t * h_{t-1} + b_t``.  It takes no chunk
or block sizes: a thread walks the whole sequence, so nothing is padded.
It takes CUDA tensors only: it allocates the outputs, launches the kernel
on PyTorch's current stream without synchronising, raises if the launch
reports an error, and adds one to ``LAUNCHES["ssm_scan"]``.
:func:`check_args` validates a call for both routes; the plain version is
:func:`repro_torch.kernels.ref.ssm_scan_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build, check_placement, count

NAME = "ssm_scan"
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("ssm_scan.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (a, b, h0, hs, hT, B, S, D, N, stream)
        lib.repro_ssm_scan.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                       i32, ptr]
        lib.repro_ssm_scan.restype = i32
        _lib = lib
    return _lib


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


def ssm_scan_blocked(a_bar, b_bar, h0):
    """a_bar, b_bar: (B, S, D, N) fp32; h0: (B, D, N) fp32 -> (h_seq,
    h_final)."""
    check_args(a_bar, b_bar, h0)
    if a_bar.device.type != "cuda":
        raise ValueError(f"{NAME}: the kernel takes CUDA tensors, got "
                         f"{a_bar.device}; the plain version is in "
                         f"repro_torch.kernels.ref")
    B, S, D, N = a_bar.shape
    if B > 65535:
        raise ValueError(f"{NAME}: B = {B} is above the kernel's 65,535 "
                         f"rows")
    hs = torch.empty_like(a_bar)
    hT = torch.empty_like(h0)
    with torch.cuda.device(a_bar.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().repro_ssm_scan(
            a_bar.data_ptr(), b_bar.data_ptr(), h0.data_ptr(), hs.data_ptr(),
            hT.data_ptr(), B, S, D, N, stream)
    if rc != 0:
        raise RuntimeError(f"{NAME}: kernel launch failed with CUDA error "
                           f"{rc}")
    count(LAUNCHES, NAME)
    return hs, hT
