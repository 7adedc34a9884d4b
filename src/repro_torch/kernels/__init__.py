"""Hopper kernels of the port, their launch wrappers and plain versions."""
import threading
from typing import Dict, Sequence

import torch

#: what every kernel of the port is built for: head dims, and the dtype
#: codes of their C interfaces
HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches per wrapper, counted where each wrapper launches its
#: kernel (one call of ``pair_score`` is its projection and its score
#: pass, counted once)
LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0,
                            "paged_extend_attention": 0,
                            "flash_attention": 0,
                            "decode_attention": 0,
                            "pair_score": 0,
                            "ssm_scan": 0}

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


def check_tensors(name: str, tensors: Dict[str, torch.Tensor],
                  floats: Sequence[str]) -> None:
    """The checks every attention op makes on both routes: the tensors
    share one device and are contiguous, the ``floats`` share a dtype the
    kernels are built for, and the first of them ends in a head dim they
    are built for.  Raises ``ValueError``."""
    check_placement(name, tensors)
    dtype = tensors[floats[0]].dtype
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32, bfloat16)")
    if any(tensors[k].dtype != dtype for k in floats):
        raise ValueError(f"{name}: {', '.join(floats)} must share one dtype")
    hd = tensors[floats[0]].shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")


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
    -1: "no kernel for this dtype and head_dim",
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
