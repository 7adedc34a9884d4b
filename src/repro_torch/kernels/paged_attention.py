"""Launch wrappers for the Hopper paged attention kernels
(``csrc/paged_attention.cu``), the port of ``repro.kernels.paged_attention``.

``paged_decode_attention_bkgd`` and ``paged_extend_attention_bkgd`` keep
the TPU wrappers' ``(B, [S,] KV, G, hd)`` query layout.  They take CUDA
tensors only: each checks its arguments, allocates the output (the decode
also the scratch of :mod:`repro_torch.kernels.decode_plan`), launches its
kernel on PyTorch's current stream without synchronising, raises if the
launch reports an error, and adds one to its count in
:data:`repro_torch.kernels.LAUNCHES`.  The plain versions live in
:mod:`repro_torch.kernels.ref` and :mod:`repro_torch.kernels.ops` chooses
between the two by device.
"""
from __future__ import annotations

import ctypes
import math
import torch

from repro_torch.kernels import (DTYPE_CODE, LAUNCHES, build, check_cuda,
                                 check_launch, check_tensors, decode_plan)

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("paged_attention.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # decode: (dtype, hd, q, k_pool, v_pool, bt, lengths, out, ws,
        #  tickets, B, KV, G, nb, bs, n_pool_rows, n_chunks, scale, stream)
        lib.repro_paged_decode_attention.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, ptr]
        # extend: (dtype, hd, q, k_pool, v_pool, bt, pos0, out, B, S, KV,
        #  G, nb, bs, n_pool_rows, scale, stream)
        lib.repro_paged_extend_attention.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, ptr]
        lib.repro_paged_decode_attention.restype = i32
        lib.repro_paged_extend_attention.restype = i32
        decode_plan.check_library(lib, "paged_attention")
        _lib = lib
    return _lib


def check_args(name: str, q, k_pool, v_pool, block_tables, index):
    """Validate a paged attention call whose query is ``(B, ..., hd)`` with
    ``H = KV * G`` heads folded somewhere in the middle; raises
    ``ValueError`` on anything the kernels do not take."""
    check_tensors(name, {"q": q, "k_pool": k_pool, "v_pool": v_pool,
                         "block_tables": block_tables,
                         _index_name(name): index},
                  floats=("q", "k_pool", "v_pool"))
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: pools must both be (num_blocks, bs, KV, "
                         f"hd), got {tuple(k_pool.shape)} and "
                         f"{tuple(v_pool.shape)}")
    hd = q.shape[-1]
    if k_pool.shape[-1] != hd:
        raise ValueError(f"{name}: pool head_dim {k_pool.shape[-1]} != "
                         f"query head_dim {hd}")
    B = q.shape[0]
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 or \
            block_tables.shape[0] != B:
        raise ValueError(f"{name}: block_tables must be int32 (B={B}, nb)")
    if index.dtype != torch.int32 or tuple(index.shape) != (B,):
        raise ValueError(f"{name}: {_index_name(name)} must be int32 "
                         f"of shape ({B},)")


def _index_name(name: str) -> str:
    return "lengths" if "decode" in name else "pos0"


def _launch(fn_name: str, q, k_pool, v_pool, block_tables, index, dims,
            plan=None):
    """Launch ``repro_<fn_name>``; the decode's split ``plan`` adds its
    scratch and chunk count to the call."""
    check_cuda(fn_name, {"q": q, "k_pool": k_pool, "v_pool": v_pool})
    out = torch.empty_like(q)
    hd = q.shape[-1]
    n_pool_rows, bs = k_pool.shape[0], k_pool.shape[1]
    nb = block_tables.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch, n_chunks = (), ()
        if plan is not None:
            ws, tickets = decode_plan.scratch(plan, q.device, stream)
            scratch = (ws.data_ptr(), tickets.data_ptr())
            n_chunks = (plan.n_chunks,)
        rc = getattr(_library(), f"repro_{fn_name}")(
            DTYPE_CODE[q.dtype], hd, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), index.data_ptr(),
            out.data_ptr(), *scratch, *dims, nb, bs, n_pool_rows, *n_chunks,
            1.0 / math.sqrt(hd), stream)
    check_launch(fn_name, rc)
    LAUNCHES[fn_name] += 1
    return out


def paged_decode_attention_bkgd(q, k_pool, v_pool, block_tables, lengths):
    """q: (B, KV, G, hd); k_pool/v_pool: (num_blocks, bs, KV, hd);
    block_tables: (B, nb) int32; lengths: (B,) int32 -> (B, KV, G, hd)."""
    check_args("paged_decode_attention", q, k_pool, v_pool, block_tables,
               lengths)
    B, KV, G, _ = q.shape
    if k_pool.shape[2] != KV:
        raise ValueError(f"paged_decode_attention: q has {KV} kv heads, "
                         f"pools {k_pool.shape[2]}")
    plan = decode_plan.split_plan(B, KV * G, KV, q.shape[-1],
                                  block_tables.shape[1] * k_pool.shape[1])
    return _launch("paged_decode_attention", q, k_pool, v_pool,
                   block_tables, lengths, (B, KV, G), plan)


def paged_extend_attention_bkgd(q, k_pool, v_pool, block_tables, pos0):
    """q: (B, S, KV, G, hd) suffix queries; k_pool/v_pool: (num_blocks,
    bs, KV, hd) with the suffix K/V already scattered in; block_tables:
    (B, nb) int32; pos0: (B,) int32 -> (B, S, KV, G, hd)."""
    check_args("paged_extend_attention", q, k_pool, v_pool, block_tables,
               pos0)
    B, S, KV, G, _ = q.shape
    if k_pool.shape[2] != KV:
        raise ValueError(f"paged_extend_attention: q has {KV} kv heads, "
                         f"pools {k_pool.shape[2]}")
    return _launch("paged_extend_attention", q, k_pool, v_pool,
                   block_tables, pos0, (B, S, KV, G))
