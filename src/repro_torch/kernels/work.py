"""The work of each kernel op as a pure function of its arguments' shapes
and dtypes, and the card's peak rates.

A :class:`Work` holds the operations a call does (tensor-core multiply-adds
count two, as ``torch.utils.flop_counter`` counts a product; the scans
count their fp32 operations and, apart, their exponentials), the least
bytes it must move through HBM (each input read once, each output written
once) and the peak rate its operations run at.  :meth:`Work.bound_ms` is
the least time one NVIDIA H100 SXM could take for it: the larger of the
bytes over the HBM rate and the operations over their peak (and the
exponentials over the SFUs' rate where a clock is given).  ``chip_smoke.py``
reads its "bound ms" from here, and so does the dry run
(``launch/dryrun_lib.py``, through the reports of ``core/flags.py``), so
both read the same work for a kernel.

Where the work depends on the data (the live keys of a decode row), the
functions take it as host integers where the caller has them (the kernel
table's shapes); ``None`` counts every key a row could see, which is what
the dry run's decode at ``pos = seq - 1`` sees, and what a counted call on
the card counts (it does not read the lengths back).

A soft-capped attention call (``softcap`` > 0) adds one tanh per visible
score, counted with the exponentials (one special-function operation
each, as ``tanh.approx`` is); the backward, which recomputes the capped
score, adds its tanh too and two operations a score for ``dS * (1 -
t^2)``.  The cap moves the bytes not at all.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

# NVIDIA H100 SXM, dense peaks from its data sheet at the 700 W limit: HBM
# bytes/s, and operations/s in bf16 and TF32 on the tensor cores and fp32
# on the CUDA cores; "tf32x3" is the rate of fp32-accurate products made
# of three TF32 ones (the pair score's wgmma route)
HBM_BPS = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
# exponentials a clock on one SM's special function units, and the SMs
SFU_PER_CLOCK, H100_SMS = 16, 132

_ESZ = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float            # operations
    bytes: float            # least HBM bytes
    dtype: str              # the key of PEAK_OPS its operations run at
    exps: float = 0.0       # exponentials on the SFUs

    def bound_ms(self, clock_hz: Optional[float] = None):
        """``(ms, "bytes" or "operations")``: the least time on the card
        for this work; the exponentials count with the SM clock given."""
        t_bytes = self.bytes / HBM_BPS * 1e3
        t_ops = self.flops / PEAK_OPS[self.dtype] * 1e3
        if clock_hz and self.exps:
            t_ops = max(t_ops, self.exps / (SFU_PER_CLOCK * H100_SMS *
                                            clock_hz) * 1e3)
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")


def _dtype_name(dtype) -> str:
    """"bfloat16" or "float32" for a torch dtype or its name."""
    return str(dtype).replace("torch.", "")


@functools.lru_cache(maxsize=256)
def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs one row of a flash call lets through: query s
    sits at key position p = s + T - S and sees key t iff t <= p when
    ``causal`` and t > p - window when ``window``."""
    total = 0
    for s in range(S):
        p = s + T - S
        hi = min(p, T - 1) if causal else T - 1
        lo = max(p - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def _caps(n_scores: int, softcap: float) -> int:
    """The tanh a call with ``softcap`` does over ``n_scores`` scores."""
    return n_scores if softcap else 0


def flash_attention(B, S, T, H, KV, hd, *, hd_v=None, dtype="bfloat16",
                    causal=True, window=0, lse=False,
                    softcap=0.0) -> Work:
    """Flash forward: q (B,S,H,hd), k (B,T,KV,hd), v (B,T,KV,hd_v) read,
    out (B,S,H,hd_v) written (and the fp32 log-sum-exp (B,S,H) where the
    training forward writes it); Q K^T and P V over the visible pairs,
    and a tanh for each under a ``softcap``."""
    hd_v = hd if hd_v is None else hd_v
    esz = _ESZ[_dtype_name(dtype)]
    pairs = visible_pairs(S, T, causal, window)
    nbytes = (B * S * H * hd + B * T * KV * hd + B * T * KV * hd_v +
              B * S * H * hd_v) * esz + (4 * B * S * H if lse else 0)
    return Work(2 * (hd + hd_v) * H * B * pairs, nbytes, _dtype_name(dtype),
                exps=_caps(B * H * pairs, softcap))


def flash_attention_bwd(B, S, T, H, KV, hd, *, hd_v=None, dtype="bfloat16",
                        causal=True, window=0, softcap=0.0) -> Work:
    """Flash backward: q read and dq written (B,S,H,hd), out and dout read
    (B,S,H,hd_v); k read and dk written (B,T,KV,hd), v read and dv written
    (B,T,KV,hd_v); the fp32 lse read; S, dK and dQ (over hd) and dP and dV
    (over hd_v) over the visible pairs; under a ``softcap`` a tanh and
    two operations each.  hd_v is hd, or MLA's narrower v."""
    hd_v = hd if hd_v is None else hd_v
    esz = _ESZ[_dtype_name(dtype)]
    pairs = visible_pairs(S, T, causal, window)
    nbytes = (2 * B * S * H * (hd + hd_v) +
              2 * B * T * KV * (hd + hd_v)) * esz + 4 * B * S * H
    caps = _caps(B * H * pairs, softcap)
    return Work(2 * (3 * hd + 2 * hd_v) * pairs * B * H + 2 * caps, nbytes,
                _dtype_name(dtype), exps=caps)


def _live(lengths: Optional[Sequence[int]], B: int, L: int):
    if lengths is None:
        return [L] * B
    return [min(max(int(n), 0), L) for n in lengths]


def decode_attention(B, H, KV, hd, L, *, dtype="bfloat16",
                     lengths=None, softcap=0.0) -> Work:
    """Split-K decode: each row's live K and V rows, q in, out, lengths;
    a tanh a live score under a ``softcap``."""
    esz = _ESZ[_dtype_name(dtype)]
    n_tok = sum(_live(lengths, B, L))
    nbytes = 2 * n_tok * KV * hd * esz + 2 * B * H * hd * esz + 4 * B
    return Work(4 * H * hd * n_tok, nbytes, _dtype_name(dtype),
                exps=_caps(H * n_tok, softcap))


def paged_decode_attention(B, H, KV, hd, bs, nb, *, dtype="bfloat16",
                           lengths=None, softcap=0.0) -> Work:
    """Paged decode: as :func:`decode_attention`, plus each row's block
    table entries that hold live keys."""
    esz = _ESZ[_dtype_name(dtype)]
    live = _live(lengths, B, nb * bs)
    n_tok = sum(live)
    nbytes = (2 * n_tok * KV * hd * esz + 2 * B * H * hd * esz +
              4 * sum(-(-n // bs) for n in live) + 4 * B)
    return Work(4 * H * hd * n_tok, nbytes, _dtype_name(dtype),
                exps=_caps(H * n_tok, softcap))


def paged_extend_attention(B, S, H, KV, hd, bs, nb, *, dtype="bfloat16",
                           pos0=None, softcap=0.0) -> Work:
    """Paged extend of S queries a row at ``pos0 + s`` over a table of
    ``nb * bs`` keys: the keys each row needs (to its last query, at most
    the table), q in, out, the table entries, pos0; a tanh a visible score
    under a ``softcap``.  ``pos0`` None puts each row's last query on the
    table's last key."""
    esz = _ESZ[_dtype_name(dtype)]
    L = nb * bs
    pos0 = [L - S] * B if pos0 is None else [int(p) for p in pos0]
    rows = [min(p + S, L) for p in pos0]
    seen = sum(min(p + s + 1, L) for p in pos0 for s in range(S))
    nbytes = (2 * sum(rows) * KV * hd * esz + 2 * B * S * H * hd * esz +
              4 * sum(-(-k // bs) for k in rows) + 4 * B)
    return Work(4 * H * hd * seen, nbytes, _dtype_name(dtype),
                exps=_caps(H * seen, softcap))


def mla_decode_attention(B, H, r, rh, L, *, dtype="bfloat16",
                         lengths=None) -> Work:
    """MLA's absorbed decode: each live latent row (ckv and krope) once,
    the queries in and the output out, the lengths."""
    esz = _ESZ[_dtype_name(dtype)]
    n_tok = sum(_live(lengths, B, L))
    nbytes = n_tok * (r + rh) * esz + B * H * (2 * r + rh) * esz + 4 * B
    return Work(2 * H * (2 * r + rh) * n_tok, nbytes, _dtype_name(dtype))


def pair_score(N, M, d, *, dtype="float32", route="wgmma") -> Work:
    """Pair score of N claims and M evidence rows of width d: claims,
    evidence, W, w and bias read, the (N, M) fp32 scores written; the
    projection and the score pass.  ``route`` "wgmma" runs at the 3xTF32
    rate, "simt" at the CUDA cores' fp32 rate (or bf16 inputs there)."""
    esz = _ESZ[_dtype_name(dtype)]
    nbytes = esz * (N * d + M * d + d * d + 2 * d + 1) + 4 * N * M
    flops = 2 * N * d * (d + M) + 2 * (N + M) * d
    return Work(flops, nbytes, "tf32x3" if route == "wgmma" else "float32")


def ssm_scan(B, S, D, N) -> Work:
    """The scan kernel, fp32: a, b (B,S,D,N) read, h_seq written; h0 read,
    h_final written (B,D,N); one multiply-add a step."""
    n_el = B * S * D * N
    return Work(2 * n_el, 4 * (3 * n_el + 2 * B * D * N), "float32")


def selective_scan(B, S, di, N, *, h0=True) -> Work:
    """The fused selective scan, fp32: xc, dt read and y written (B,S,di);
    B and C read (B,S,N); A (di,N) and D (di,) read; h_final written and
    h0 read where given (B,di,N); the discretisation, the scan and the C
    contraction, and an exponential for every (b, s, d, n)."""
    n_el = B * S * di * N
    nbytes = 4 * (3 * B * S * di + 2 * B * S * N + di * N + di +
                  (2 if h0 else 1) * B * di * N)
    return Work(6 * n_el + 3 * B * S * di, nbytes, "float32", exps=n_el)


def linear_scan_bwd(B, S, D, N) -> Work:
    """The scan's backward (``ops.linear_scan`` under grad), fp32: a, the
    gradient of h_seq and h_seq read, da and db written (B,S,D,N); the
    gradient of h_final and h0 read, dh0 written (B,D,N); the adjoint's
    add, the carry's multiply and da's multiply a step."""
    n_el = B * S * D * N
    return Work(3 * n_el, 4 * (5 * n_el + 3 * B * D * N), "float32")


def selective_scan_bwd(B, S, di, N) -> Work:
    """The fused selective scan's backward, fp32: xc, dt and the gradient
    of y read, dxc and ddt written (B,S,di); Bc and Cc read, dBc and dCc
    written (B,S,N); the forward's checkpoints of h, one a 32-step chunk,
    read (B,ceil(S/32),di,N); A and the gradient of h_final and h0's place
    read, dA and dh0 written (di,N and B,di,N); D read and dD written
    (di,); the adjoint and the six gradients' terms, and an exponential
    for every (b, s, d, n) (a_t, which h and the adjoint both need)."""
    n_el = B * S * di * N
    n_ck = B * -(-S // 32) * di * N
    nbytes = 4 * (5 * B * S * di + 4 * B * S * N + n_ck + 2 * di * N +
                  2 * B * di * N + 2 * di)
    return Work(16 * n_el + 4 * B * S * di, nbytes, "float32", exps=n_el)
