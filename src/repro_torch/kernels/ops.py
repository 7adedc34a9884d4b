"""Public kernel ops of the port, with the contracts of
``repro.kernels.ops`` (``ops.py:22-111``): attention queries in the
model's ``(B, [S,] H, hd)`` layout, the phase-2 pair score and the Mamba
selective scan; and :func:`linear_scan`, the RG-LRU recurrence on the
scan kernel at N = 1.

The device of the tensors decides the route: a CUDA tensor launches the
Hopper kernel (the ``*_bkgd`` / ``*_bshd`` / ``*_bhd`` wrappers, which
check the arguments) or raises; a CPU tensor runs the plain version from
:mod:`repro_torch.kernels.ref` after the same checks, counted in
:data:`PLAIN_CALLS`.  Any other device raises.  Each call is checked once.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import LAUNCHES, count
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import pair_score as ps
from repro_torch.kernels import paged_attention as pa
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


def _route(name: str, q) -> bool:
    """True for the kernel route, False for the plain version."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        count(PLAIN_CALLS, name)
        return False
    raise ValueError(f"{name}: no route for device {q.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,hd), k/v: (B,S,KV,hd) -> (B,S,H,hd).  Query s sees key t
    iff ``t <= s`` when ``causal`` and ``t > s - window`` when ``window``;
    ``causal=False, window=0`` is bidirectional."""
    if not _route("flash_attention", q):
        fa.check_args(q, k, v, window)
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return fa.flash_attention_bshd(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths, *, n_splits: int = 8):
    """q: (B,H,hd); k/v: (B,L,KV,hd) caches; lengths: (B,) int32 valid
    prefix -> (B,H,hd).  ``n_splits`` is the TPU wrapper's contract and
    is checked; the kernel plans its own split of the keys over CTAs
    (:mod:`repro_torch.kernels.decode_plan`)."""
    if not _route("decode_attention", q):
        da.check_args(q, k, v, lengths, n_splits)
        return ref.decode_attention_ref(q, k, v, lengths)
    return da.decode_attention_bhd(q, k, v, lengths, n_splits=n_splits)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths):
    """q: (B,H,hd); k_pool/v_pool: (num_blocks, bs, KV, hd) shared pools;
    block_tables: (B, nb) int32; lengths: (B,) int32 -> (B,H,hd)."""
    name = "paged_decode_attention"
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (B, H, hd), got {tuple(q.shape)}")
    G = _heads(name, q, k_pool)
    if not _route(name, q):
        pa.check_args(name, q, k_pool, v_pool, block_tables, lengths)
        return ref.paged_decode_attention_ref(q, k_pool, v_pool,
                                              block_tables, lengths)
    B, H, hd = q.shape
    out = pa.paged_decode_attention_bkgd(q.view(B, H // G, G, hd), k_pool,
                                         v_pool, block_tables, lengths)
    return out.view(B, H, hd)


def paged_extend_attention(q, k_pool, v_pool, block_tables, pos0):
    """q: (B,S,H,hd) suffix queries at absolute positions ``pos0 + s``;
    k_pool/v_pool: (num_blocks, bs, KV, hd) with the suffix K/V already
    scattered in; block_tables: (B, nb) int32; pos0: (B,) int32
    -> (B,S,H,hd).  Key p is visible to query s iff ``p <= pos0 + s``."""
    name = "paged_extend_attention"
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, S, H, hd), got "
                         f"{tuple(q.shape)}")
    G = _heads(name, q, k_pool)
    if not _route(name, q):
        pa.check_args(name, q, k_pool, v_pool, block_tables, pos0)
        return ref.paged_extend_attention_ref(q, k_pool, v_pool,
                                              block_tables, pos0)
    B, S, H, hd = q.shape
    out = pa.paged_extend_attention_bkgd(q.view(B, S, H // G, G, hd),
                                         k_pool, v_pool, block_tables, pos0)
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
    if not _route(name, claims):
        ps.check_args(claims, evidence, W, w_c, w_e, bias)
        return ref.pair_score_ref(claims, evidence, W, w_c, w_e, bias)
    return ps.pair_score_blocked(claims, evidence, W, w_c, w_e, bias)


def ssm_scan(xc, dt, Bc, Cc, A, D, h0=None):
    """The selective scan with the contract of ``models.ssm.selective_scan``
    (``repro.kernels.ops.ssm_scan``, ``ops.py:98-111``): xc, dt (B,S,di),
    Bc, Cc (B,S,N) (unit stride over N: ``torch.split`` views qualify), A
    (di,N), D (di,), h0 (B,di,N) or None, all fp32 -> (y (B,S,di), h_final
    (B,di,N)).  A CUDA tensor runs the fused kernel, which keeps the
    discretisation, the scan and the ``C`` contraction in registers (JAX
    runs the first and last in jnp around its Pallas kernel); the plain
    version composes them as JAX does."""
    if not _route("ssm_scan", xc):
        ss.check_fused_args(xc, dt, Bc, Cc, A, D, h0)
        return ref.selective_scan_ref(xc, dt, Bc, Cc, A, D, h0)
    return ss.selective_scan_fused(xc, dt, Bc, Cc, A, D, h0)


def linear_scan(a, b, h0):
    """The diagonal recurrence ``h_t = a_t * h_{t-1} + b_t`` of the RG-LRU
    block (``models.rglru.diag_scan``): a, b (B,S,w) and h0 (B,w), fp32 ->
    (h_seq (B,S,w), h_final (B,w)).  It is the contract of the TPU kernel
    ``ssm_scan_blocked`` at N = 1, so the inputs are viewed as (B,S,w,1)
    and take the scan kernel's route, counted under ``"ssm_scan"``.  JAX
    computes it in plain ``jnp`` (chunked ``associative_scan``); the
    kernel scans in order, so fp32 results agree up to summation order."""
    B, S, w = a.shape
    a4, b4 = a.contiguous().view(B, S, w, 1), b.contiguous().view(B, S, w, 1)
    h4 = h0.contiguous().view(B, w, 1)
    if _route("ssm_scan", a4):
        h_seq, h_fin = ss.ssm_scan_blocked(a4, b4, h4)
    else:
        ss.check_args(a4, b4, h4)
        h_seq, h_fin = ref.ssm_scan_ref(a4, b4, h4)
    return h_seq.view(B, S, w), h_fin.view(B, w)
