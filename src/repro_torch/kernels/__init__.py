"""Hopper kernels of the port, their launch wrappers and plain versions."""
import math
import threading
from typing import Dict, Sequence

import torch

#: what every kernel of the port is built for: head dims, and the dtype
#: codes of their C interfaces
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: flash's (q/k, v) head-dim pairs with a v narrower than q/k (MLA's
#: prefill: nope + rope over v), and the dtypes each is built for; the
#: bf16 kernel's Q K^T runs in k-steps of 16, which 24 is not a multiple of
FLASH_QK_V_DIMS = {(192, 128): (torch.float32, torch.bfloat16),
                   (24, 16): (torch.float32,)}
#: the head dims at which flash (forward and backward), the paged extend
#: and both decodes have soft-capped kernels (``csrc/common.cuh``,
#: ``softcap_dims``; q/k and v of one width): the widths a cap is set on
#: in practice.  MLA's pairs are not capped, as in JAX.
SOFTCAP_HEAD_DIMS = (64, 128, 256)
#: the MLA decode's (latent rank r, rope dim) pairs, and their dtypes
MLA_DIMS = {(512, 64): (torch.float32, torch.bfloat16),
            (32, 8): (torch.float32,)}

#: kernel launches per wrapper, counted where each wrapper launches its
#: kernel (one call of ``pair_score`` is its projection and its score
#: pass, counted once; one call of the flash backward is its three
#: kernels, counted once, and one of the selective scan's backward its
#: two); ``linear_scan_bwd`` is the backward of the scan kernel at N = 1
#: (``ops.linear_scan``), ``selective_scan_bwd`` that of the fused
#: selective scan (``ops.ssm_scan``), both counted apart from their
#: forwards (``ssm_scan``)
LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0,
                            "paged_extend_attention": 0,
                            "flash_attention": 0,
                            "decode_attention": 0,
                            "pair_score": 0,
                            "ssm_scan": 0,
                            "mla_decode_attention": 0,
                            "flash_attention_bwd": 0,
                            "linear_scan_bwd": 0,
                            "selective_scan_bwd": 0}

_count_lock = threading.Lock()


def count(counts: Dict[str, int], name: str) -> None:
    """Add one to ``counts[name]``; safe from the batch driver's worker
    threads, where ``+=`` on a dict item could lose an update."""
    with _count_lock:
        counts[name] += 1


def check_placement(name: str, tensors: Dict[str, torch.Tensor]) -> None:
    """The tensors share one device and are contiguous; raises
    ``ValueError``."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: all tensors must share one device, got "
                         f"{sorted(str(d) for d in devices)}")
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def check_floats(name: str, tensors: Dict[str, torch.Tensor],
                 floats: Sequence[str]) -> torch.dtype:
    """The tensors share one device and are contiguous, and the ``floats``
    share a dtype the kernels are built for, which it returns.  Raises
    ``ValueError``."""
    check_placement(name, tensors)
    dtype = tensors[floats[0]].dtype
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32, bfloat16)")
    if any(tensors[k].dtype != dtype for k in floats):
        raise ValueError(f"{name}: {', '.join(floats)} must share one dtype")
    return dtype


def check_tensors(name: str, tensors: Dict[str, torch.Tensor],
                  floats: Sequence[str]) -> None:
    """The checks every attention op makes on both routes:
    :func:`check_floats`, and the first of the ``floats`` ends in a head
    dim the kernels are built for.  Raises ``ValueError``."""
    check_floats(name, tensors, floats)
    hd = tensors[floats[0]].shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")


def check_dims(name: str, what: str, dims, dtype, built) -> None:
    """``dims`` is a key of ``built`` (a pair of widths -> the dtypes its
    kernel is built for) and ``dtype`` one of its dtypes.  Raises
    ``ValueError``."""
    if dims not in built or dtype not in built[dims]:
        raise ValueError(f"{name}: {what} {dims} in {dtype} has no kernel; "
                         f"built: " + ", ".join(
                             f"{k} in {[str(t).split('.')[1] for t in v]}"
                             for k, v in built.items()))


def check_softcap(name: str, softcap: float) -> None:
    """An attention logit soft-cap is 0 (none) or a finite positive c of
    ``c * tanh(s / c)``; raises ``ValueError`` on both routes."""
    if not (math.isfinite(softcap) and softcap >= 0):
        raise ValueError(f"{name}: softcap must be finite and >= 0 (0 for "
                         f"none), got {softcap}")


def check_softcap_dims(name: str, softcap: float, hd: int) -> None:
    """The kernel and count routes' own check: a cap > 0 only at the head
    dims of :data:`SOFTCAP_HEAD_DIMS`, where it has kernels.  Raises
    ``ValueError``."""
    if softcap and hd not in SOFTCAP_HEAD_DIMS:
        raise ValueError(f"{name}: no soft-capped kernel at head_dim {hd}; "
                         f"built at {SOFTCAP_HEAD_DIMS} (the plain version "
                         f"takes any)")


def check_cuda(name: str, tensors: Dict[str, torch.Tensor]) -> None:
    """The kernel route's own checks: CUDA tensors whose data starts on a
    16-byte boundary (the kernels load 16 bytes at once)."""
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                             f"{t.device}; the plain version is in "
                             f"repro_torch.kernels.ref")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             f"boundary")


#: what the attention kernels' C entry points return besides a CUDA error
LAUNCH_ERRORS = {
    -1: "no kernel for this dtype and these widths",
    -2: "cuTensorMapEncodeTiled could not be found through the CUDA "
        "runtime's driver entry point (cudaGetDriverEntryPoint); the TMA "
        "tensor maps need a driver that provides it (CUDA 12 or later)",
    -3: "cuTensorMapEncodeTiled refused a TMA tensor map for these "
        "tensors"}


def check_launch(name: str, rc: int) -> None:
    """Raise ``RuntimeError`` for a C entry point's nonzero return code."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{LAUNCH_ERRORS.get(rc, f'CUDA error {rc}')}")
