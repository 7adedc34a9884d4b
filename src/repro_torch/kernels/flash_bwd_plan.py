"""The tile plan of the bf16 flash backward (``csrc/flash_attention_bwd.cu``,
``flash_bwd_dkdv_sm90_kernel`` and ``flash_bwd_dq_sm90_kernel``), mirrored
in Python for the tests and for ``chip_smoke.py``'s controls.

Rows are the (query, head) pairs of one (b, kv head).  A row tile holds
whole queries: ``gt = min(G, 64)`` heads of ``nq = 64 // gt`` queries
(``nq * gt`` rows, at most :data:`ROW_TILE`), the heads in ``ngb =
ceil(G / gt)`` blocks (one below G 65).  The dK / dV kernel gives a CTA
:func:`key_tile` keys and walks every row tile whose queries see one of
them (:func:`dkdv_queries`); its two consumer warpgroups take 64 keys
each, or at hd 256 the same 64 keys and half the columns each.  The dQ
kernel gives a CTA one row tile and walks the 64-key tiles its queries
see (:func:`dq_keys`).  A (64-key, row tile) pair is masked pair by pair
only where some pair of it is not visible (:func:`tile_masked`).

Keys count T: any T for a cross attention (whisper's decoder over its
encoder states, neither mask), T >= S under a mask, where the S queries
are the last S of the T positions (query s at key position s + T - S: a
sequence shard's queries over the keys up to its last, the gathered and
halo routes of ``models/attention.seqshard_attn_forward``).  The dK / dV
grid runs over the T keys, the dQ grid and the row tiles over the S
queries.  Every function that takes S takes ``T`` too, None for T = S;
those that take a query position take its ``shift`` T - S.

v may be narrower than q/k (MLA's (192, 128)): the products over q/k's
width (S, dK, dQ) take hd's column blocks, those over v's (dP, dV)
hd_v's.  Past hd 128 the dK / dV kernel's two warpgroups share 64 keys
and split the column blocks (:func:`column_split`); :func:`dkdv_smem`
and :func:`dq_smem` are the shared memory each kernel asks for
(``KvPlan<hd, hd_v>::SMEM``, ``DqPlan<hd, hd_v>::SMEM``).

Nothing here runs on the card: the kernels compute the same plan from
the shapes themselves.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

#: rows a row tile holds at most (``BWD_ROW_TILE``: wgmma's M and N)
ROW_TILE = 64
#: keys a dK / dV CTA takes at hd <= 128 (``BWD_KEY_TILE``: two consumer
#: warpgroups of 64 keys) and at hd 256 (``BWD_KEY_TILE_HD256``: both on
#: the same 64 keys, dK's and dV's columns split between them)
KEY_TILE = 128
KEY_TILE_HD256 = 64
#: keys a stage of the dQ kernel's ring, and a warpgroup's keys
SUB_TILE = 64


def key_tile(hd: int) -> int:
    """Keys a dK / dV CTA owns at head dim ``hd``."""
    return KEY_TILE if hd <= 128 else KEY_TILE_HD256


def column_blocks(hd: int) -> int:
    """Column blocks of 64 rows x min(2 hd, 128) bytes a 64-row bf16 tile
    of width ``hd`` holds (``Tile<hd>::NCB``)."""
    swb = min(2 * hd, 128)
    return hd // (swb // 2)


def column_split(hd: int, hd_v: int, w: int) -> Tuple[int, int, int, int]:
    """(first dK block, dK blocks, first dV block, dV blocks) of consumer
    warpgroup ``w`` (0, 1) of the dK / dV kernel (``KvPlan::kb``, ``nk``,
    ``vb``, ``nv``): every block to both at hd <= 128 (they own other
    keys); past it the first half of each, rounded up, to warpgroup 0."""
    nk, nv = column_blocks(hd), column_blocks(hd_v)
    if key_tile(hd) == KEY_TILE:
        return 0, nk, 0, nv
    nk0, nv0 = -(-nk // 2), -(-nv // 2)
    return (0, nk0, 0, nv0) if w == 0 else (nk0, nk - nk0, nv0, nv - nv0)


def _tile_bytes(hd: int) -> int:
    return column_blocks(hd) * SUB_TILE * min(2 * hd, 128)


def dkdv_smem(hd: int, hd_v: int) -> int:
    """Dynamic shared memory of the bf16 dK / dV kernel: K and V of the
    key tile, its stages of Q and dO (3, 2 at hd 256), their lse and D,
    the barriers and 1024 bytes of alignment slack."""
    subs = key_tile(hd) // SUB_TILE
    nst = 2 if hd >= 256 else 3
    return (subs * (_tile_bytes(hd) + _tile_bytes(hd_v)) +
            nst * (_tile_bytes(hd) + _tile_bytes(hd_v) + 2 * ROW_TILE * 4) +
            8 * (1 + 2 * nst) + 1024)


def dq_smem(hd: int, hd_v: int) -> int:
    """Dynamic shared memory of the bf16 dQ kernel: Q and dO, the
    forward's ring of K / V stages (3, 2 at hd >= 128), the barriers and
    1024 bytes of slack."""
    nst = 2 if hd >= 128 else 3
    return ((1 + nst) * (_tile_bytes(hd) + _tile_bytes(hd_v)) +
            8 * (1 + 2 * nst) + 1024)


class RowTiles(NamedTuple):
    gt: int             # heads a row tile
    nq: int             # queries a row tile
    ngb: int            # head blocks
    n: int              # row tiles of one (b, kv head): the dQ grid's y


def row_tiles(S: int, G: int) -> RowTiles:
    """The row tiles of S queries at G heads a kv head."""
    gt = min(G, ROW_TILE)
    nq = ROW_TILE // gt
    ngb = -(-G // gt)
    return RowTiles(gt, nq, ngb, -(-S // nq) * ngb)


def row_tile(rt: int, S: int, G: int) -> Tuple[int, int, int, int]:
    """Row tile ``rt`` (query tile major, head block minor) as its queries
    [s0, s1) and heads [g0, g1), both cut at S and G."""
    gt, nq, ngb, _ = row_tiles(S, G)
    qi, gb = divmod(rt, ngb)
    return qi * nq, min(qi * nq + nq, S), gb * gt, min(gb * gt + gt, G)


def bounds(s: int, T: int, causal: bool, window: int,
           shift: int = 0) -> Tuple[int, int]:
    """The keys lo <= t <= hi query s, at key position s + ``shift``,
    sees among T keys (``DenseSrc::bounds``)."""
    a = s + shift
    return (max(a - window + 1, 0) if window else 0,
            a if causal else T - 1)


def dkdv_queries(k0: int, S: int, hd: int, causal: bool, window: int,
                 T: Optional[int] = None) -> Tuple[int, int]:
    """The queries [s_lo, s_hi] that see a key of the key tile from k0
    (``key_queries``); s_hi < s_lo where none does."""
    T = S if T is None else T
    k1, shift = min(k0 + key_tile(hd), T), T - S
    s_lo = max(k0 - shift, 0) if causal else 0
    s_hi = min(S - 1, k1 - 1 - shift + window - 1) if window else S - 1
    return s_lo, s_hi


def dkdv_row_tiles(k0: int, S: int, G: int, hd: int, causal: bool,
                   window: int, T: Optional[int] = None) -> List[int]:
    """The row tiles the key tile from k0 walks, in order."""
    _, nq, ngb, _ = row_tiles(S, G)
    s_lo, s_hi = dkdv_queries(k0, S, hd, causal, window, T)
    if s_hi < s_lo:
        return []
    return list(range(s_lo // nq * ngb, (s_hi // nq + 1) * ngb))


def dq_keys(rt: int, S: int, G: int, causal: bool, window: int,
            T: Optional[int] = None) -> List[int]:
    """The first keys of the 64-key tiles row tile ``rt`` walks."""
    T = S if T is None else T
    s0, s1, _, _ = row_tile(rt, S, G)
    beg = bounds(s0, T, causal, window, T - S)[0]
    end = bounds(s1 - 1, T, causal, window, T - S)[1] + 1
    t0 = beg - beg % SUB_TILE
    return list(range(t0, end, SUB_TILE)) if end > beg else []


def tile_masked(kw0: int, s0: int, s1: int, T: int, causal: bool,
                window: int, shift: int = 0) -> bool:
    """Whether the pair (keys kw0 .. kw0 + 63, queries [s0, s1)) is masked
    pair by pair: some query of it does not see every key (keys >= T
    included)."""
    return (kw0 < bounds(s1 - 1, T, causal, window, shift)[0] or
            kw0 + SUB_TILE - 1 > bounds(s0, T, causal, window, shift)[1])


def key_rows(key: int, s0: int, gt: int, T: int, causal: bool,
             window: int, shift: int = 0) -> Tuple[int, int]:
    """The rows from <= n < to of a row tile from query s0 (row n is query
    s0 + n // gt, at key position s0 + n // gt + ``shift``) that key
    ``key`` is visible to, as the dK / dV kernel masks a masked pair: with
    d = key - s0 - shift, causal, n >= d gt; a window, n < (d + window)
    gt; none for a key >= T."""
    d = key - s0 - shift
    start = d * gt if causal else (0 if key < T else ROW_TILE)
    end = min(d + window, ROW_TILE) * gt if window else ROW_TILE ** 2
    return start, end


def visible(S: int, G: int, causal: bool, window: int,
            T: Optional[int] = None) -> np.ndarray:
    """(S * G, T) bool: row r = s * G + g, query s at key position s + T
    - S, sees key t."""
    T = S if T is None else T
    s = np.arange(S * G)[:, None] // G + (T - S)
    t = np.arange(T)[None, :]
    ok = np.ones((S * G, T), dtype=bool)
    if causal:
        ok &= t <= s
    if window:
        ok &= t > s - window
    return ok


def tile_pairs(kernel: str, kw0: int, rt: int, S: int, G: int,
               causal: bool, window: int, T: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, keys, ok): the existing rows and keys < T of a (64-key part,
    row tile) pair, and which pairs of them ``kernel`` lets into its sums:
    all on an unmasked pair; on a masked pair the dK / dV kernel's rows
    :func:`key_rows` of each key, the dQ kernel's keys in each row's
    :func:`bounds`."""
    T = S if T is None else T
    shift = T - S
    s0, s1, g0, g1 = row_tile(rt, S, G)
    gt = row_tiles(S, G).gt
    n = (np.arange(s1 - s0)[:, None] * gt +
         np.arange(g1 - g0)[None, :]).ravel()      # row in the tile
    rows = s0 * G + n // gt * G + g0 + n % gt
    keys = np.arange(kw0, min(kw0 + SUB_TILE, T))
    if not tile_masked(kw0, s0, s1, T, causal, window, shift):
        ok = np.ones((rows.size, keys.size), dtype=bool)
    elif kernel == "dkdv":
        span = np.array([key_rows(t, s0, gt, T, causal, window, shift)
                         for t in keys]).reshape(-1, 2)
        ok = (n[:, None] >= span[None, :, 0]) & (n[:, None] < span[None, :, 1])
    else:
        lohi = np.array([bounds(s, T, causal, window, shift)
                         for s in rows // G])
        ok = ((keys[None, :] >= lohi[:, :1]) & (keys[None, :] <= lohi[:, 1:]))
    return rows, keys, ok


def walk(kernel: str, S: int, G: int, hd: int, causal: bool, window: int,
         T: Optional[int] = None) -> Iterator[Tuple[int, int]]:
    """The (first key of a 64-key part, row tile) pairs ``kernel`` ("dkdv"
    or "dq") visits over its whole grid, each once (at hd 256 the dK / dV
    kernel's two warpgroups share one part)."""
    if kernel == "dkdv":
        for k0 in range(0, S if T is None else T, key_tile(hd)):
            for kw0 in range(k0, k0 + key_tile(hd), SUB_TILE):
                for rt in dkdv_row_tiles(k0, S, G, hd, causal, window, T):
                    yield kw0, rt
    else:
        for rt in range(row_tiles(S, G).n):
            for t0 in dq_keys(rt, S, G, causal, window, T):
                yield t0, rt


def coverage(kernel: str, S: int, G: int, hd: int, causal: bool,
             window: int, T: Optional[int] = None) -> np.ndarray:
    """(S * G, T) int: how often ``kernel`` lets each (row, key) pair into
    its sums over its whole grid."""
    cover = np.zeros((S * G, S if T is None else T), dtype=np.int64)
    for kw0, rt in walk(kernel, S, G, hd, causal, window, T):
        rows, keys, ok = tile_pairs(kernel, kw0, rt, S, G, causal, window,
                                    T)
        cover[np.ix_(rows, keys)] += ok
    return cover
