"""The plan of a pair-score call (``csrc/pair_score.cu``): its route, and
for the fp32 route (``csrc/pair_sm90.cuh``) the tiles and depth splits of
its two launches, from shapes and dtypes only.

Routes:

- ``"wgmma"``: claims, evidence, ``W`` and ``w`` in fp32 with ``d % 4 ==
  0`` (TMA needs rows of a multiple of 16 bytes).  3xTF32 on the tensor
  cores in two launches, the projection ``P^T = W^T C^T`` (``rows = d``,
  ``cols = N``) and the score ``out = P E^T + ...`` (``rows = N``, ``cols =
  M``), each a grid of 128 x 128 tiles whose depth ``d`` is split over the
  CTAs of a cluster.
- ``"simt"``: anything else (bf16 inputs, or ``d % 4 != 0``): the
  projection and score kernels on the CUDA cores.

The route is a function of the shapes and dtypes, never of a failure: a
CUDA call launches its route's kernel or raises.

The depth split: ``d`` is cut into ``steps = ceil(d / TILE_K)`` steps, and
each tile's steps into ``split`` chunks of ``per_split`` consecutive steps
(the last may be shorter: a ragged chunk), one CTA each, the CTAs of a tile
forming a cluster.  A CTA takes ~194 KB of shared memory, so one fits an
SM, and a cluster must fit one GPC: :data:`MAX_CLUSTERS` is how many
clusters of each size run at once on an H100 SXM (``cudaOccupancyMax
ActiveClusters``).  The split is the size, up to :data:`MAX_SPLIT` (a
portable cluster), that minimises the waves of clusters times the steps of
a chunk, the smaller on a tie; each chunk keeps at least :data:`MIN_STEPS`
steps, and chunks that would be empty are dropped.  The partial tiles are summed in shared memory across the
cluster in chunk order, so nothing but ``P`` and the linear terms lies in
the workspace, whose size is the same on both routes: ``N * d + N + M``
floats.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

#: a CTA's tile of the wgmma route: rows, columns, depth a stage
#: (``PAIR_BM``, ``PAIR_BN``, ``PAIR_BK`` in csrc/pair_sm90.cuh)
TILE_M, TILE_N, TILE_K = 128, 128, 32
#: CTAs a cluster, at most (``PAIR_MAX_SPLIT``)
MAX_SPLIT = 8
#: clusters of 1, 2, ..., 8 CTAs that run at once on an H100 SXM at one
#: CTA an SM (``cudaOccupancyMaxActiveClusters``; the GPCs' sizes set them)
MAX_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
#: depth steps a chunk keeps, at least, so that the ring overlaps one
#: stage's copy with another's products
MIN_STEPS = 2


class Gemm(NamedTuple):
    """One launch: D (rows x cols) = A (rows x K) B^T over tiles of
    TILE_M x TILE_N, the depth in ``split`` chunks of ``per_split``
    steps of TILE_K."""
    rows: int
    cols: int
    tiles: int          # row tiles x column tiles
    split: int          # CTAs a cluster: chunks of the depth
    per_split: int      # steps a chunk (the last chunk may have fewer)

    @property
    def ctas(self) -> int:
        return self.tiles * self.split


class Plan(NamedTuple):
    route: str                  # "wgmma" or "simt"
    ws_floats: int              # P (N x d), then lin (N + M)
    project: Optional[Gemm]     # wgmma: P^T = W^T C^T
    score: Optional[Gemm]       # wgmma: out = P E^T + lin + b


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm(rows: int, cols: int, K: int) -> Gemm:
    """The tiles and depth split of one launch of the wgmma route."""
    tiles = _cdiv(rows, TILE_M) * _cdiv(cols, TILE_N)
    steps = _cdiv(K, TILE_K)

    def cost(split):
        return _cdiv(tiles, MAX_CLUSTERS[split]) * _cdiv(steps, split)

    split = min((s for s in range(1, MAX_SPLIT + 1)
                 if s == 1 or _cdiv(steps, s) >= MIN_STEPS),
                key=lambda s: (cost(s), s))
    per = _cdiv(steps, split)
    return Gemm(rows, cols, tiles, _cdiv(steps, per), per)


@functools.lru_cache(maxsize=256)
def plan(N: int, M: int, d: int, c_dtype: torch.dtype,
         w_dtype: torch.dtype) -> Plan:
    """The plan of a call on claims (N, d) and evidence (M, d) of
    ``c_dtype`` and a link model of ``w_dtype``."""
    ws = N * d + N + M
    if c_dtype == w_dtype == torch.float32 and d % 4 == 0:
        return Plan("wgmma", ws, gemm(d, N, d), gemm(N, M, d))
    return Plan("simt", ws, None, None)


def check_library(lib, name: str) -> None:
    """The library was built with the tiles this plan assumes."""
    import ctypes
    cfg = (ctypes.c_int * 5)()
    lib.repro_pair_sm90_config(cfg)
    if tuple(cfg[:4]) != (TILE_M, TILE_N, TILE_K, MAX_SPLIT):
        raise RuntimeError(f"{name}: the kernel's tiles and largest split "
                           f"are {tuple(cfg[:4])}, the plan's "
                           f"{(TILE_M, TILE_N, TILE_K, MAX_SPLIT)}")


def smem_bytes(lib) -> int:
    """The dynamic shared memory a CTA of the wgmma route asks for."""
    import ctypes
    cfg = (ctypes.c_int * 5)()
    lib.repro_pair_sm90_config(cfg)
    return cfg[4]
