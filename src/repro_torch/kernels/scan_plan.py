"""The split plan of the scan kernel (``csrc/ssm_scan.cu``), the port of
``ssm_scan_blocked``: does one thread walk a channel's whole sequence, or
is S split into chunks over CTAs?

The single walk (one thread per 4 channels, S in order) keeps enough loads
in flight only when a call has many channels: at (4, 512, 8192, 16) it
runs 131,072 threads and sits near its bound.  The RG-LRU recurrence runs
the same kernel at N = 1 on 2,560 channels a row: 640 threads, 5 CTAs on
132 SMs.  So when the threads of the single walk,
``B * ceil(D * N / 4)``, are fewer than :data:`FILL_THREADS`, the plan cuts
S into ``n_chunks`` chunks of ``chunk`` steps (the last may be shorter)
and each row's channels into tiles of :data:`TILE` (one a thread), one CTA
per (row, chunk, tile).  A CTA stages its chunk in shared memory, publishes the
chunk's aggregate (the product of its ``a``, and its ``h`` from 0), takes
the carry from the chunks before it by decoupled look-back and rescans
from shared memory, so each element is read and written once.

The chunk is sized for about :data:`TARGET_CTAS` CTAs, a multiple of
:data:`CHUNK_MIN` steps (the aggregates cost 12 bytes a channel and chunk,
against 12 a step) and :data:`CHUNK_MAX` (what a CTA stages:
``SCAN_CHUNK_MAX`` in the source).  Long chunks keep the look-back short:
a CTA folds in the aggregates of the chunks between it and the nearest
published prefix, and in the first wave of CTAs that is every chunk
before it.  A plan of one chunk is the single walk.

:func:`split_plan` reads shapes only, never the data, so a CUDA graph can
capture the call; :func:`scratch` allocates the aggregates and the flags.
:func:`bwd_plan` plans the backward (``linear_scan_bwd_kernel``), the
chunked design walked from the last chunk, with the same chunks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: SMs of an H100 SXM
SMS = 132
#: threads of the single walk from which it is no slower than the
#: chunked kernel: on an H100 at S 512 (``chip_smoke.py``'s crossover
#: sweep) the single walk is faster at 16,384 threads and more, where the
#: chunked kernel's aggregates and look-back cost more than its extra
#: CTAs give, and 1.8x slower at 4,096
FILL_THREADS = 16384
#: channels of a row a CTA of the chunked kernel owns, one a thread
#: (``SCAN_TILE``)
TILE = 128
#: steps a CTA of the chunked kernel owns, at least and at most
#: (``SCAN_CHUNK_MAX``: 2 x 96 x 128 fp32 are 96 KiB of shared memory, two
#: CTAs an SM), in multiples of CHUNK_MIN
CHUNK_MIN, CHUNK_MAX = 16, 96
#: CTAs the chunk is sized for: two an SM
TARGET_CTAS = 2 * SMS


class Plan(NamedTuple):
    chunk: int          # steps a chunk (S for the single walk)
    n_chunks: int       # 1: the single walk
    n_tiles: int        # channel tiles a row (chunked kernel)
    ws_floats: int      # aggregates a, h and prefixes: 3 x (B, n_chunks, D N)
    n_flags: int        # one status a (row, chunk, tile), then the ticket


def _chunked(B: int, S: int, C: int, n_tiles: int) -> Plan:
    """Chunks sized for about TARGET_CTAS CTAs of the chunked kernels."""
    chunk = -(-S * B * n_tiles // TARGET_CTAS)
    chunk = min(-(-chunk // CHUNK_MIN) * CHUNK_MIN, CHUNK_MAX)
    n_chunks = -(-S // chunk)
    return Plan(chunk, n_chunks, n_tiles, 3 * B * n_chunks * C,
                B * n_chunks * n_tiles + 1)


def split_plan(B: int, S: int, D: int, N: int) -> Plan:
    """The plan of a scan over ``(B, S, D, N)``."""
    C = D * N
    n_tiles = -(-C // TILE)
    if B * -(-C // 4) < FILL_THREADS:
        plan = _chunked(B, S, C, n_tiles)
        if plan.n_chunks > 1:
            return plan
    return Plan(S, 1, n_tiles, 0, 0)


def bwd_plan(B: int, S: int, D: int, N: int) -> Plan:
    """The plan of the scan's backward (``linear_scan_bwd_kernel``)
    over ``(B, S, D, N)``: always the chunked design walked from the end,
    with the forward's chunk sizing, so one chunk (no look-back) where S
    fits it; there is no single-walk backward."""
    C = D * N
    return _chunked(B, S, C, -(-C // TILE))


def scratch(plan: Plan, device: torch.device):
    """The fp32 aggregates (never read before they are written) and the
    int32 flags and ticket, zeroed on the current stream, of one call of
    a chunked ``plan``."""
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=device)
    flags = torch.zeros(plan.n_flags, dtype=torch.int32, device=device)
    return ws, flags


def check_library(lib, name: str) -> None:
    """The library was built with the tile and chunk this plan assumes."""
    got = (lib.repro_scan_tile(), lib.repro_scan_chunk_max())
    if got != (TILE, CHUNK_MAX):
        raise RuntimeError(f"{name}: the kernel's SCAN_TILE, SCAN_CHUNK_MAX "
                           f"are {got}, the plan's {(TILE, CHUNK_MAX)}")
