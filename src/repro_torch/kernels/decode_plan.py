"""The split plan of the Hopper decode design (``csrc/decode_sm90.cuh``),
shared by the paged decode and the dense split-K decode wrappers.

The kernel splits each sequence's keys over CTAs in chunks of
:data:`CHUNK_KEYS` consecutive keys (``DECODE_CHUNK`` in the header): chunk
``c`` of a row with ``live`` keys holds keys ``c * CHUNK_KEYS`` up to
``min(live, (c + 1) * CHUNK_KEYS)``, and a chunk that starts at or past
``live`` exits at once and enters no merge.  The last CTA of a row to
finish merges the chunks' fp32 partials in the same launch.

:func:`split_plan` sizes the grid and the scratch from shapes only, never
from ``lengths``, so nothing reads the lengths on the host and a CUDA graph
can capture the call; :func:`scratch` allocates the scratch.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

#: keys a CTA owns (``DECODE_CHUNK`` in csrc/decode_sm90.cuh)
CHUNK_KEYS = 128
#: query rows a CTA, at most (``DECODE_ROWS``); more heads per kv head
#: take more row groups
ROWS_PER_CTA = 8


class Plan(NamedTuple):
    n_chunks: int       # the grid's chunk axis: ceil(max_keys / CHUNK_KEYS)
    ws_floats: int      # fp32 partials: (B, H, n_chunks, hd + 2)
    n_tickets: int      # one counter per (b, kv head, row group)


def split_plan(B: int, H: int, KV: int, hd: int, max_keys: int) -> Plan:
    """The plan of a decode of ``B`` sequences, ``H`` query heads over
    ``KV`` kv heads of dim ``hd``, each row holding at most ``max_keys``
    keys (``nb * bs`` for a block table, ``L`` for a dense cache)."""
    n_chunks = max(1, -(-max_keys // CHUNK_KEYS))
    n_row_groups = -(-(H // KV) // ROWS_PER_CTA)
    return Plan(n_chunks, B * H * n_chunks * (hd + 2),
                B * KV * n_row_groups)


#: ticket counters per (device index, stream), zeroed once: the kernel's
#: merging CTA sets its counter back to 0, so they stay zero between calls
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def scratch(plan: Plan, device: torch.device, stream: int):
    """The fp32 workspace (from PyTorch's caching allocator, each call) and
    the ticket counters of ``stream`` (allocated once) for ``plan``.  A
    stream's counters are made on its first call, so a stream that a CUDA
    graph captures must have run the op once before the capture, as
    PyTorch's graph warm-up does; raises otherwise."""
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=device)
    key = (device.index, stream)
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < plan.n_tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode attention: this stream has no ticket counters for "
                f"{plan.n_tickets} rows yet; run the op once on the "
                f"capturing stream before the capture")
        tickets = _TICKETS[key] = torch.zeros(
            max(plan.n_tickets, 1024), dtype=torch.int32, device=device)
    return ws, tickets


def check_library(lib, name: str) -> None:
    """The library was built with the chunk this plan assumes."""
    chunk = lib.repro_decode_chunk_keys()
    if chunk != CHUNK_KEYS:
        raise RuntimeError(f"{name}: the kernel's DECODE_CHUNK is {chunk}, "
                           f"the wrapper's CHUNK_KEYS {CHUNK_KEYS}")
