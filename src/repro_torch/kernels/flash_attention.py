"""Launch wrappers for the Hopper flash attention kernel
(``csrc/flash_attention.cu``), the port of
``repro.kernels.flash_attention.flash_attention_bhsd``, and for its
backward (``csrc/flash_attention_bwd.cu``, port-only: the JAX package
trains through plain ``jnp`` and has no backward kernel), bound together
as the ``torch.autograd.Function`` :class:`FlashAttention`.  The backward
takes its route from the dtype: bf16 runs the tensor-core kernels (their
tile plan is mirrored in :mod:`repro_torch.kernels.flash_bwd_plan`), fp32
the CUDA-core ones.

:func:`flash_attention_bshd` reads q/k/v in the model's ``(B, S, H, hd)``
/ ``(B, S, KV, hd)`` layout, so the TPU wrapper's transposes and pad copies
are gone.  v may be narrower than q and k (MLA's prefill: q/k 192, v 128),
as the TPU kernel's jnp oracle allows (``flash_attention_jnp``), and k/v
may hold T keys other than the S queries: any T where neither mask is
asked for (whisper's cross attention over its encoder states), and T >= S
under a causal or window mask, the queries then being the last S of the T
positions (a sequence shard's queries over the keys before them, JAX's
``q_offset_dynamic`` / ``kv_offset``).  It takes CUDA tensors only: it
allocates the output, launches the kernel on PyTorch's current stream
without synchronising, raises if the launch reports an error, and adds
one to its count in
:data:`repro_torch.kernels.LAUNCHES`.  :func:`check_args` validates a call
for both routes; the plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`, and the backward's
is autograd through it.  Every call takes ``softcap``: 0, or the c of
Gemma 2's ``attn_logit_softcapping``, each scaled score s becoming ``c *
tanh(s / c)`` before the masks (JAX's ``flash_attention_jnp(softcap=)``),
in the forward and, through the forward's lse and the recomputed capped
score, in the backward; the kernels are built capped at
:data:`repro_torch.kernels.SOFTCAP_HEAD_DIMS`, and a cap at MLA's (q/k, v)
pairs is refused, as JAX never asks for it there.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import flags
from repro_torch.kernels import (DTYPE_CODE, FLASH_QK_V_DIMS, LAUNCHES,
                                 build, check_cuda, check_dims,
                                 check_floats, check_launch, check_softcap,
                                 check_softcap_dims, check_tensors, count,
                                 work)

_lib = None
_bwd_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (dtype, hd, hd_v, q, k, v, out, lse, B, S, T, KV, G, causal,
        #  window, scale, softcap, stream)
        lib.repro_flash_attention.argtypes = [
            i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
            i32, i32, ctypes.c_float, ctypes.c_float, ptr]
        lib.repro_flash_attention.restype = i32
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.load("flash_attention_bwd.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (dtype, hd, hd_v, q, k, v, out, dout, lse, delta, dq, dk, dv, B,
        #  S, T, KV, G, causal, window, scale, softcap, stream)
        lib.repro_flash_attention_bwd.argtypes = [
            i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, ctypes.c_float,
            ctypes.c_float, ptr]
        lib.repro_flash_attention_bwd.restype = i32
        lib.repro_flash_bwd_smem.argtypes = [i32, i32, i32]
        lib.repro_flash_bwd_smem.restype = i32
        _bwd_lib = lib
    return _bwd_lib


def check_args(q, k, v, window: int, causal: bool, softcap: float = 0.0):
    """Validate q (B,S,H,hd), k (B,T,KV,hd), v (B,T,KV,hd_v): hd_v is hd,
    or with hd a pair of :data:`repro_torch.kernels.FLASH_QK_V_DIMS` in a
    dtype it is built for (and then no ``softcap``); T is any key count
    where neither ``causal`` nor ``window`` masks (a cross attention),
    and at least S under a mask (query s at position s + T - S);
    ``softcap`` finite and >= 0.  Raises ``ValueError`` on anything the
    kernel does not take."""
    name = "flash_attention"
    tensors = {"q": q, "k": k, "v": v}
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k and v must be 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    hd_v = v.shape[3]
    if hd_v == hd:
        check_tensors(name, tensors, floats=("q", "k", "v"))
    else:
        dtype = check_floats(name, tensors, floats=("q", "k", "v"))
        check_dims(name, "(q/k, v) head dims", (hd, hd_v), dtype,
                   FLASH_QK_V_DIMS)
    if k.shape[0] != B or k.shape[1] < 1 or k.shape[3] != hd or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name}: k must be (B={B}, T, KV, hd={hd}) and v "
                         f"(B, T, KV, hd_v), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    T = k.shape[1]
    if T < S and (causal or window):
        raise ValueError(f"{name}: {S} queries over {T} keys take neither "
                         f"a causal mask nor a window (causal={causal}, "
                         f"window={window}): a masked call's queries are "
                         f"the last S of T >= S positions, and only a "
                         f"cross attention has fewer keys than queries")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{name}: {H} query heads do not group over {KV} "
                         f"kv heads")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    check_softcap(name, softcap)
    if softcap and hd_v != hd:
        raise ValueError(f"{name}: no soft-cap at (q/k, v) head dims "
                         f"{(hd, hd_v)}: MLA's scores are not capped")


def _forward(q, k, v, causal: bool, window: int, lse=None,
             softcap: float = 0.0):
    """The forward's one launch; with ``lse`` (B,S,H) fp32 it also writes
    there each row's natural log-sum-exp of its scaled (capped) scores,
    which the backward reads.  On a fake tensor (``flags.counted``) the
    launch is skipped and only reported to the active counter: the output
    is allocated as for a launch and left empty."""
    check_args(q, k, v, window, causal, softcap)
    check_softcap_dims("flash_attention", softcap, q.shape[3])
    B, S, H, hd = q.shape
    T, KV, hd_v = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((B, S, H, hd_v))
    if not flags.counted(q):
        tensors = {"q": q, "k": k, "v": v}
        if lse is not None:
            tensors["lse"] = lse
        check_cuda("flash_attention", tensors)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _library().repro_flash_attention(
                DTYPE_CODE[q.dtype], hd, hd_v, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, S, T, KV,
                H // KV, int(causal), int(window), 1.0 / math.sqrt(hd),
                float(softcap), stream)
        check_launch("flash_attention", rc)
        count(LAUNCHES, "flash_attention")
    flags.add("flash_attention", work.flash_attention, B, S, T, H, KV, hd,
              hd_v=hd_v, dtype=q.dtype, causal=causal, window=window,
              lse=lse is not None, softcap=softcap)
    return out


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0):
    """q: (B,S,H,hd), k: (B,T,KV,hd), v: (B,T,KV,hd_v) -> (B,S,H,hd_v), at
    scale 1/sqrt(hd).  Query s sits at key position ``s + T - S`` and
    sees key t iff ``t <= s + T - S`` when ``causal`` and ``t > s + T - S
    - window`` when ``window``; ``causal=False, window=0`` is
    bidirectional, and only it takes T < S.  ``softcap`` > 0 caps each
    scaled score s as ``softcap * tanh(s / softcap)`` before the masks."""
    return _forward(q, k, v, causal, window, softcap=softcap)


def flash_attention_bwd_bshd(q, k, v, out, dout, lse, *, causal: bool,
                             window: int, softcap: float = 0.0):
    """The gradients (dq, dk, dv) of :func:`flash_attention_bshd`'s output
    ``out`` for the upstream gradient ``dout`` (B,S,H,hd_v), from the
    forward's ``lse`` (B,S,H) fp32, with the forward's masks and scale; dk
    (B,T,KV,hd) and dv (B,T,KV,hd_v) sum over each kv head's G query
    heads; hd_v is hd or one of MLA's pairs.  It takes every call the
    forward takes (:func:`check_args`): T keys other than the S queries
    with no mask, and T >= S under a mask, query s then at key position s
    + T - S (a sequence shard's); a key that no query sees gets zero
    gradients; with the forward's ``softcap`` the kernels recompute the
    capped score s' and scale dS by ``1 - (s' / softcap)^2``.  In q's
    dtype, fp32 inside.
    bf16 runs the kernels on ``wgmma`` (P and dS as bf16 hi + lo), fp32
    the kernels on the CUDA cores: the C entry point picks them by the
    dtype code.  CUDA tensors only; one call is three
    launches (D, then dK / dV, then dQ), counted once in
    :data:`repro_torch.kernels.LAUNCHES`."""
    name = "flash_attention_bwd"
    check_args(q, k, v, window, causal, softcap)
    check_softcap_dims(name, softcap, q.shape[3])
    tensors = {"q": q, "k": k, "v": v, "out": out, "dout": dout, "lse": lse}
    check_floats(name, tensors, floats=("q", "k", "v", "out", "dout"))
    B, S, H, hd = q.shape
    hd_v = v.shape[3]
    if out.shape != (B, S, H, hd_v) or dout.shape != out.shape:
        raise ValueError(f"{name}: out and dout must be {(B, S, H, hd_v)}, "
                         f"got {tuple(out.shape)} and {tuple(dout.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, S, H):
        raise ValueError(f"{name}: lse must be fp32 ({B}, {S}, {H}), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    T, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    if not flags.counted(q):
        check_cuda(name, tensors)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _bwd_library().repro_flash_attention_bwd(
                DTYPE_CODE[q.dtype], hd, hd_v, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, S, T, KV, H // KV,
                int(causal), int(window), 1.0 / math.sqrt(hd),
                float(softcap), stream)
        check_launch(name, rc)
        count(LAUNCHES, name)
    flags.add(name, work.flash_attention_bwd, B, S, T, H, KV, hd,
              hd_v=hd_v, dtype=q.dtype, causal=causal, window=window,
              softcap=softcap)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a backward kernel: the forward launches the
    flash kernel with its log-sum-exp and saves q, k, v, out and lse; the
    backward launches :func:`flash_attention_bwd_bshd` on them, with the
    forward's masks and soft-cap.  The kernel route of
    ``ops.flash_attention`` when grad is on and an input requires it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                softcap: float = 0.0):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, causal, window, lse, softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_bshd(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window, softcap=ctx.softcap)
        return dq, dk, dv, None, None, None
