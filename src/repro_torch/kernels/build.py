"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes) under ``build/repro_torch_kernels/`` at the
repository root, which ``.gitignore`` lists.  The library's file name
carries a hash of its source, every ``csrc/`` header it includes (directly
or through another header) and the flags, so an edited source or shared
header rebuilds and an unchanged one is reused.  Beside each library lies
``nvcc``'s report of its build (the same name ending in ``.log``), so a
reused library still has its ptxas report; a library without one is
rebuilt.  All sources that need building are compiled by concurrent
``nvcc`` processes.  A build failure raises; nothing falls back to a plain
version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_attention.cu", "flash_attention.cu",
           "decode_attention.cu", "pair_score.cu", "ssm_scan.cu",
           "selective_scan.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: nvcc's output per source of the libraries in use, from this process's
#: build or from the report kept beside a reused library (ptxas prints
#: each kernel's registers, shared memory and spills with -v)
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels of repro_torch build only on a "
                           "machine with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_includes(source: str) -> List[str]:
    """The ``csrc/`` files ``source`` includes with ``#include "..."``,
    directly or through another of them, in the order first reached."""
    seen: List[str] = []
    todo = [source]
    while todo:
        for name in _INCLUDE.findall((CSRC / todo.pop()).read_bytes()):
            name = name.decode()
            if name not in seen and (CSRC / name).is_file():
                seen.append(name)
                todo.append(name)
    return seen


def library_path(source: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [source, *local_includes(source)]:
        digest.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def log_path(source: str) -> Path:
    """Where ``nvcc``'s report of the build of ``library_path(source)``
    is kept."""
    return library_path(source).with_suffix(".log")


def build_all() -> Dict[str, Path]:
    """Compile every source whose library or report is missing, all
    ``nvcc`` processes started together, and fill :data:`BUILD_LOG`;
    returns source -> library path."""
    pending = [s for s in SOURCES
               if not (library_path(s).exists() and log_path(s).exists())]
    if pending:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for source in pending:
            out = library_path(source)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            procs.append((source, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for source, tmp, out, proc in procs:     # wait for every nvcc
            BUILD_LOG[source] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{source} (exit {proc.returncode}):\n"
                              f"{BUILD_LOG[source]}")
            else:
                log_tmp = tmp.with_suffix(".log.tmp")
                log_tmp.write_text(BUILD_LOG[source])
                os.replace(log_tmp, log_path(source))
                os.replace(tmp, out)             # atomic publish
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
    for s in SOURCES:
        BUILD_LOG[s] = log_path(s).read_text()
    return {s: library_path(s) for s in SOURCES}


def load(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>`` (built first if
    needed)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(build_all()[source]))
        return lib
