"""Public kernel ops of the port, with the contracts of
``repro.kernels.ops`` (``ops.py:22-111``): attention queries in the
model's ``(B, [S,] H, hd)`` layout, the phase-2 pair score and the Mamba
selective scan; :func:`linear_scan`, the RG-LRU recurrence on the scan
kernel at N = 1; and :func:`mla_decode_attention`, MLA's absorbed decode,
which JAX computes in plain ``jnp``.

The tensors decide the route: a fake tensor
(:func:`repro_torch.core.flags.counted`, tested before the device, since
a fake tensor may report ``cuda``) takes the count route: after the
kernel route's checks and refusals it returns an empty result of the
kernel's shape and dtype and reports one call of the kernel, under its
name, with its work (:mod:`repro_torch.kernels.work`) to the active
counter, launching and building nothing (the dry run,
``launch/dryrun_lib.py``).  :data:`repro_torch.kernels.LAUNCHES` counts
the card's launches only.
A CUDA tensor launches the Hopper kernel (the ``*_bkgd`` / ``*_bshd`` /
``*_bhd`` wrappers, which check the arguments) or raises, and reports the
same work where a counter is active; a CPU tensor runs the plain version
from :mod:`repro_torch.kernels.ref` after the same checks, counted in
:data:`PLAIN_CALLS` (and, where a counter is active, reported with the
kernel's work in place of its own ops, :func:`_plain`).  Any other
device raises.  Each call is checked once.

Gradients: on the CPU autograd differentiates the plain versions.  On a
CUDA tensor that requires grad (with grad enabled) :func:`flash_attention`,
:func:`ssm_scan` and :func:`linear_scan` run their forward and backward
kernels bound as ``torch.autograd.Function`` s
(``flash_attention.FlashAttention``, ``ssm_scan.SelectiveScan``,
``ssm_scan.LinearScan``); the serving-only ops have no backward kernel
and raise ``NotImplementedError`` naming their ROADMAP item, so no op
hands back a tensor without a gradient, and none gives way to its plain
version on the card.  The count route takes the same paths and refusals.

Soft-capping: the attention ops take ``softcap`` (0 for none; Gemma 2's
``attn_logit_softcapping``), each scaled score s becoming ``softcap *
tanh(s / softcap)`` before the mask, as JAX's ``jnp`` path computes it.
Both routes refuse a negative or non-finite cap; the kernel and count
routes also one at a head dim outside ``kernels.SOFTCAP_HEAD_DIMS``.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.core import flags
from repro_torch.kernels import LAUNCHES, check_softcap_dims, count, work
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mla_decode as md
from repro_torch.kernels import pair_score as ps
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import pair_plan
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as ss

#: plain-version calls per op (the CPU route)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_counts() -> None:
    """Zero the kernel launch counts and the plain-version call counts."""
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def _heads(name: str, q, k_pool):
    H, KV = q.shape[-2], k_pool.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{name}: {H} query heads do not group over {KV} "
                         f"kv heads")
    return H // KV


def _route(name: str, q) -> str:
    """``"count"`` for a fake tensor, ``"cuda"`` for the kernel
    route, ``"cpu"`` for the plain version."""
    if flags.counted(q):
        return "count"
    if q.device.type == "cuda":
        return "cuda"
    if q.device.type == "cpu":
        count(PLAIN_CALLS, name)
        return "cpu"
    raise ValueError(f"{name}: no route for device {q.device}")


def _counted(name: str, out, work_fn, *args, **kwargs):
    """The count route's end: one call of kernel ``name`` and its work
    (``work_fn(*args, **kwargs)``) reported to the active counter, ``out``
    (empty tensors of the kernel's results) returned.  Nothing launched,
    so ``kernels.LAUNCHES`` is left be."""
    flags.add(name, work_fn, *args, **kwargs)
    return out


def _plain(name: str, plain, work_fn, *args, **kwargs):
    """The CPU route's end: ``plain()``, the plain version.  Where a
    counter is active (the dry run's count of a step on a real CPU rank,
    ``launch/dryrun_lib.counting``) its eager ops go uncounted and one
    call of kernel ``name`` with its work is reported instead, as the
    count and kernel routes report it, so a real rank's count equals the
    fake one."""
    if not flags.active():
        return plain()
    with _disable_current_modes():
        out = plain()
    flags.add(name, work_fn, *args, **kwargs)
    return out


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        getattr(t, "requires_grad", False) for t in tensors)


#: the ROADMAP item (Queue 2) of the ops with no backward kernel
_SERVING_BACKWARD = 11


def _no_backward(name: str, item: int, *tensors) -> None:
    """Raise where a kernel-route input requires grad: ``name`` has no
    backward kernel, and its forward kernel would return a tensor with no
    ``grad_fn``."""
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: an input requires grad, and the op has no backward "
            f"kernel on the card yet: ROADMAP.md, Queue 2, item {item}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (B,S,H,hd), k: (B,T,KV,hd), v: (B,T,KV,hd_v) -> (B,S,H,hd_v),
    at scale 1/sqrt(hd); hd_v is hd, or narrower for MLA's prefill (the
    pairs of ``kernels.FLASH_QK_V_DIMS``).  Query s sits at key position
    ``s + T - S`` and sees key t iff ``t <= s + T - S`` when ``causal``
    and ``t > s + T - S - window`` when ``window``; ``causal=False,
    window=0`` is bidirectional (a cross attention at any T).  Both routes
    raise ``ValueError`` on a causal or windowed call at T < S; the
    backward kernel takes every call the forward takes.  ``softcap`` > 0
    caps the scaled scores before the masks (not at MLA's pairs)."""
    if _route("flash_attention", q) == "cpu":
        fa.check_args(q, k, v, window, causal, softcap)
        B, S, H, hd = q.shape
        return _plain("flash_attention", lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap),
            work.flash_attention, B, S, k.shape[1], H, k.shape[2], hd,
            hd_v=v.shape[3], dtype=q.dtype, causal=causal, window=window,
            lse=_needs_grad(q, k, v), softcap=softcap)
    # the kernel and count routes share the wrappers, which count
    if _needs_grad(q, k, v):
        fa.check_args(q, k, v, window, causal, softcap)
        return fa.FlashAttention.apply(q, k, v, causal, window, softcap)
    return fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                   softcap=softcap)


def decode_attention(q, k, v, lengths, *, n_splits: int = 8,
                     softcap: float = 0.0):
    """q: (B,H,hd); k/v: (B,L,KV,hd) caches; lengths: (B,) int32 valid
    prefix -> (B,H,hd).  ``n_splits`` is the TPU wrapper's contract and
    is checked; the kernel plans its own split of the keys over CTAs
    (:mod:`repro_torch.kernels.decode_plan`).  ``softcap`` > 0 caps the
    scaled scores before the mask."""
    route = _route("decode_attention", q)
    B, H, hd = q.shape
    args = (B, H, k.shape[2], hd, k.shape[1])
    wk = dict(dtype=q.dtype, softcap=softcap)
    if route == "cpu":
        da.check_args(q, k, v, lengths, n_splits, softcap)
        return _plain("decode_attention", lambda: ref.decode_attention_ref(
            q, k, v, lengths, softcap), work.decode_attention, *args, **wk)
    _no_backward("decode_attention", _SERVING_BACKWARD, q, k, v)
    if route == "count":
        da.check_args(q, k, v, lengths, n_splits, softcap)
        check_softcap_dims("decode_attention", softcap, hd)
        return _counted("decode_attention", q.new_empty(q.shape),
                        work.decode_attention, *args, **wk)
    out = da.decode_attention_bhd(q, k, v, lengths, n_splits=n_splits,
                                  softcap=softcap)
    flags.add("decode_attention", work.decode_attention, *args, **wk)
    return out


def mla_decode_attention(q_lat, q_rope, ckv, krope, lengths, scale: float):
    """MLA's absorbed decode attention (``repro.models.attention.mla_decode``,
    ``attention.py:636-643``, plain ``jnp`` in JAX): q_lat (B,H,r), q_rope
    (B,H,rh), the latent cache ckv (B,L,r) and krope (B,L,rh), lengths
    (B,) int32 -> (B,H,r), the softmax of ``(q_lat ckv^T + q_rope
    krope^T) * scale`` over keys ``< lengths`` (all L past L) times
    ckv, with P in fp32."""
    route = _route("mla_decode_attention", q_lat)
    B, H, r = q_lat.shape
    args = (B, H, r, q_rope.shape[-1], ckv.shape[1])
    if route == "cpu":
        md.check_args(q_lat, q_rope, ckv, krope, lengths, scale)
        return _plain("mla_decode_attention",
                      lambda: ref.mla_decode_attention_ref(
                          q_lat, q_rope, ckv, krope, lengths, scale),
                      work.mla_decode_attention, *args, dtype=q_lat.dtype)
    _no_backward("mla_decode_attention", _SERVING_BACKWARD, q_lat, q_rope,
                 ckv, krope)
    if route == "count":
        md.check_args(q_lat, q_rope, ckv, krope, lengths, scale)
        return _counted("mla_decode_attention", q_lat.new_empty(q_lat.shape),
                        work.mla_decode_attention, *args, dtype=q_lat.dtype)
    out = md.mla_decode_attention_bhr(q_lat, q_rope, ckv, krope, lengths,
                                      scale)
    flags.add("mla_decode_attention", work.mla_decode_attention, *args,
              dtype=q_lat.dtype)
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           softcap: float = 0.0):
    """q: (B,H,hd); k_pool/v_pool: (num_blocks, bs, KV, hd) shared pools;
    block_tables: (B, nb) int32; lengths: (B,) int32 -> (B,H,hd);
    ``softcap`` > 0 caps the scaled scores before the mask."""
    name = "paged_decode_attention"
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (B, H, hd), got {tuple(q.shape)}")
    G = _heads(name, q, k_pool)
    route = _route(name, q)
    B, H, hd = q.shape
    args = (B, H, k_pool.shape[2], hd, k_pool.shape[1],
            block_tables.shape[1])
    wk = dict(dtype=q.dtype, softcap=softcap)
    if route == "cpu":
        pa.check_args(name, q, k_pool, v_pool, block_tables, lengths,
                      softcap)
        return _plain(name, lambda: ref.paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables, lengths, softcap),
            work.paged_decode_attention, *args, **wk)
    _no_backward(name, _SERVING_BACKWARD, q, k_pool, v_pool)
    if route == "count":
        pa.check_args(name, q, k_pool, v_pool, block_tables, lengths,
                      softcap)
        check_softcap_dims(name, softcap, hd)
        return _counted(name, q.new_empty(q.shape),
                        work.paged_decode_attention, *args, **wk)
    out = pa.paged_decode_attention_bkgd(q.view(B, H // G, G, hd), k_pool,
                                         v_pool, block_tables, lengths,
                                         softcap)
    flags.add(name, work.paged_decode_attention, *args, **wk)
    return out.view(B, H, hd)


def paged_extend_attention(q, k_pool, v_pool, block_tables, pos0, *,
                           softcap: float = 0.0):
    """q: (B,S,H,hd) suffix queries at absolute positions ``pos0 + s``;
    k_pool/v_pool: (num_blocks, bs, KV, hd) with the suffix K/V already
    scattered in; block_tables: (B, nb) int32; pos0: (B,) int32
    -> (B,S,H,hd).  Key p is visible to query s iff ``p <= pos0 + s``;
    ``softcap`` > 0 caps the scaled scores before the mask."""
    name = "paged_extend_attention"
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, S, H, hd), got "
                         f"{tuple(q.shape)}")
    G = _heads(name, q, k_pool)
    route = _route(name, q)
    B, S, H, hd = q.shape
    args = (B, S, H, k_pool.shape[2], hd, k_pool.shape[1],
            block_tables.shape[1])
    wk = dict(dtype=q.dtype, softcap=softcap)
    if route == "cpu":
        pa.check_args(name, q, k_pool, v_pool, block_tables, pos0, softcap)
        return _plain(name, lambda: ref.paged_extend_attention_ref(
            q, k_pool, v_pool, block_tables, pos0, softcap),
            work.paged_extend_attention, *args, **wk)
    _no_backward(name, _SERVING_BACKWARD, q, k_pool, v_pool)
    if route == "count":
        pa.check_args(name, q, k_pool, v_pool, block_tables, pos0, softcap)
        check_softcap_dims(name, softcap, hd)
        return _counted(name, q.new_empty(q.shape),
                        work.paged_extend_attention, *args, **wk)
    out = pa.paged_extend_attention_bkgd(q.view(B, S, H // G, G, hd),
                                         k_pool, v_pool, block_tables, pos0,
                                         softcap)
    flags.add(name, work.paged_extend_attention, *args, **wk)
    return out.view(B, S, H, hd)


def pair_score(link_params, claims, evidence):
    """Bilinear pair scoring of claims (N, d) against evidence (M, d) ->
    (N, M) fp32; the contract of ``svm.link_score_matrix`` in its
    full-rank form: ``link_params`` holds ``W`` (d, d), ``w`` (2d,) (the
    claim half, then the evidence half) and ``bias``."""
    name = "pair_score"
    if "W" not in link_params:
        raise ValueError(f"{name}: takes the full-rank link model (W, w, "
                         f"bias), got keys {sorted(link_params)}; the "
                         f"low-rank U/V form is scored by "
                         f"svm.link_score_matrix")
    W, w, bias = link_params["W"], link_params["w"], link_params["bias"]
    d = claims.shape[-1]
    if tuple(w.shape) != (2 * d,):
        raise ValueError(f"{name}: w must be ({2 * d},), got "
                         f"{tuple(w.shape)}")
    w_c, w_e = w[:d], w[d:]
    route = _route(name, claims)
    if route == "cpu":
        ps.check_args(claims, evidence, W, w_c, w_e, bias)
        return ref.pair_score_ref(claims, evidence, W, w_c, w_e, bias)
    _no_backward(name, _SERVING_BACKWARD, claims, evidence, W, w, bias)
    N, M = claims.shape[0], evidence.shape[0]
    wk = dict(dtype=claims.dtype, route=pair_plan.plan(
        N, M, d, claims.dtype, W.dtype).route)
    if route == "count":
        ps.check_args(claims, evidence, W, w_c, w_e, bias)
        return _counted(name, claims.new_empty((N, M), dtype=torch.float32),
                        work.pair_score, N, M, d, **wk)
    out = ps.pair_score_blocked(claims, evidence, W, w_c, w_e, bias)
    flags.add(name, work.pair_score, N, M, d, **wk)
    return out


def ssm_scan(xc, dt, Bc, Cc, A, D, h0=None):
    """The selective scan with the contract of ``models.ssm.selective_scan``
    (``repro.kernels.ops.ssm_scan``, ``ops.py:98-111``): xc, dt (B,S,di),
    Bc, Cc (B,S,N) (unit stride over N: ``torch.split`` views qualify), A
    (di,N), D (di,), h0 (B,di,N) or None, all fp32 -> (y (B,S,di), h_final
    (B,di,N)).  A CUDA tensor runs the fused kernel, which keeps the
    discretisation, the scan and the ``C`` contraction in registers (JAX
    runs the first and last in jnp around its Pallas kernel); the plain
    version composes them as JAX does.  Under grad the kernel route is
    ``ssm_scan.SelectiveScan``, whose backward is a kernel too (N <=
    ``ssm_scan.MAX_BWD_STATES``)."""
    route = _route("ssm_scan", xc)
    B, S, di = xc.shape
    args = (B, S, di, A.shape[1])
    if route == "cpu":
        ss.check_fused_args(xc, dt, Bc, Cc, A, D, h0)
        return _plain("ssm_scan", lambda: ref.selective_scan_ref(
            xc, dt, Bc, Cc, A, D, h0), work.selective_scan, *args,
            h0=h0 is not None)
    # the kernel and count routes share the Function, which counts
    if _needs_grad(xc, dt, Bc, Cc, A, D, h0):
        return ss.SelectiveScan.apply(xc, dt, Bc, Cc, A, D, h0)
    if route == "count":
        ss.check_fused_args(xc, dt, Bc, Cc, A, D, h0)
        return _counted("ssm_scan", (xc.new_empty(xc.shape),
                                     xc.new_empty((B, di, A.shape[1]))),
                        work.selective_scan, *args, h0=h0 is not None)
    out = ss.selective_scan_fused(xc, dt, Bc, Cc, A, D, h0)
    flags.add("ssm_scan", work.selective_scan, *args, h0=h0 is not None)
    return out


def linear_scan(a, b, h0):
    """The diagonal recurrence ``h_t = a_t * h_{t-1} + b_t`` of the RG-LRU
    block (``models.rglru.diag_scan``): a, b (B,S,w) and h0 (B,w), fp32 ->
    (h_seq (B,S,w), h_final (B,w)).  It is the contract of the TPU kernel
    ``ssm_scan_blocked`` at N = 1, so the inputs are viewed as (B,S,w,1)
    and take the scan kernel's route, counted under ``"ssm_scan"``, and
    under grad its backward kernel (``ssm_scan.LinearScan``).  JAX
    computes it in plain ``jnp`` (chunked ``associative_scan``); the
    kernel scans in order, so fp32 results agree up to summation order."""
    B, S, w = a.shape
    a4, b4 = a.contiguous().view(B, S, w, 1), b.contiguous().view(B, S, w, 1)
    h4 = h0.contiguous().view(B, w, 1)
    route = _route("ssm_scan", a4)
    if route == "cpu":
        ss.check_args(a4, b4, h4)
        h_seq, h_fin = _plain("ssm_scan", lambda: ref.ssm_scan_ref(
            a4, b4, h4), work.ssm_scan, B, S, w, 1)
    elif _needs_grad(a, b, h0):
        # the kernel and count routes share the Function, which counts
        h_seq, h_fin = ss.LinearScan.apply(a4, b4, h4)
    elif route == "count":
        ss.check_args(a4, b4, h4)
        h_seq, h_fin = _counted("ssm_scan", (a4.new_empty(a4.shape),
                                             h4.new_empty(h4.shape)),
                                work.ssm_scan, B, S, w, 1)
    else:
        h_seq, h_fin = ss.ssm_scan_blocked(a4, b4, h4)
        flags.add("ssm_scan", work.ssm_scan, B, S, w, 1)
    return h_seq.view(B, S, w), h_fin.view(B, w)
