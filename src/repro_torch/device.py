"""Device selection for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.
Asking for CUDA where there is none raises: nothing falls back to the CPU.
The CPU is a device a caller names (the tests do), and there the kernels'
plain versions run.  ``meta`` holds shapes and dtypes alone (the dry
run's abstract trees, ``models.api.abstract_params``).
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} requested but CUDA is "
                               f"not available; pass device='cpu' to run "
                               f"the plain versions on the CPU")
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda, cpu, or "
                         f"meta for shapes and dtypes alone)")
    return dev
