// Flash attention backward for Hopper (sm_90a).  Hand-written CUDA C++;
// built by repro_torch/kernels/build.py into a shared library with a
// plain C interface and bound with ctypes.
//
// Replaces no TPU kernel: the JAX package trains through plain jnp
// (use_kernels=False, src/repro/configs/base.py:106) and has no backward
// kernel.  It is the gradient of the port's flash forward
// (flash_attention.cu, the port of
// src/repro/kernels/flash_attention.py:flash_attention_bhsd), which every
// training step on the card runs; kernels/flash_attention.py binds the
// two as one torch.autograd.Function -> repro_flash_attention_bwd.
//
// Layouts are the forward's: q and dq (B, S, H, hd), out and dout (B, S,
// H, hd_v); k and dk (B, T, KV, hd), v and dv (B, T, KV, hd_v): T keys,
// any T for a cross attention (neither mask), T >= S under a mask, the
// queries then the last S of the T positions (a sequence shard's queries
// over the keys up to its last); hd_v = hd, or MLA's narrower v (the
// forward's pairs: (192, 128) on both routes, (24, 16) in fp32); lse and
// delta (B, S, H) fp32; head h = kvh * G + g.  Rows are the (query,
// head) pairs r = s * G + g of one (b, kv head).  Query s sits at key
// position a = s + T - S and sees key t iff t < T, t <= a when causal,
// and t > a - window when window > 0 (the forward's masks,
// DenseSrc::bounds).  A key no query sees (t <= T - S - window under a
// window) gets dK = dV = 0.  From the forward's natural
// log-sum-exp lse of each row's scaled scores, all in fp32:
//   D  = rowsum(dO * O)                         flash_bwd_delta_kernel
//   P  = exp(s * scale - lse), 0 where masked
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dK = scale * dS^T Q                         the dK / dV kernel
//   dQ = scale * dS K                           the dQ kernel
// With a soft-cap c > 0 (the forward's; Gemma 2's attn_logit_softcapping)
// the forward's scores and lse are of s' = c tanh(s / c), and each kernel
// recomputes s' from s, then P = exp(s' - lse) and dS = P * (dP - D) *
// (1 - (s' / c)^2): the derivative of the cap from its value, so one tanh
// an element (tanhf in fp32, tanh_ex2 in bf16; common.cuh).  The CAP
// instantiations are built at hd 64, 128 and 256 (softcap_dims); the
// uncapped ones are unchanged.
// dK and dV sum over the G heads of their kv head.  P and dS keep fp32
// accuracy (the forward keeps P in fp32 as the TPU kernel does); dq, dk
// and dv are rounded once, to the inputs' dtype.  Three launches and no
// atomics, so two calls give the same bits: a key tile's CTA owns dK and
// dV over every row that sees its keys, a row tile's CTA owns dQ over
// every key its rows see, and both recompute S and dP for their tile
// pairs.  Summing dQ in the dK / dV pass instead would take atomics
// (other bits on each call) or ordered waits between CTAs (which assume
// every CTA resident, where the grid is many waves).
//
// bf16, on the tensor cores (flash_bwd_dkdv_sm90_kernel,
// flash_bwd_dq_sm90_kernel): every product is one of the forward's two
// wgmma forms (attention_sm90.cuh): ss, both operands K-major in shared
// memory, or rs, A from registers (an accumulator's layout is the A
// fragment's) and B MN-major in shared memory.  P and dS enter their
// products as bf16 hi + lo (split_bf2), two wgmma into one fp32
// accumulator, the forward's rule.  Every tile comes in by TMA.
//   Row tiles hold whole queries: gt = min(G, 64) heads of nq = 64 / gt
//   queries (nq * gt <= 64 rows; heads in ngb = ceil(G / gt) blocks past
//   G 64), one 5-d box {BW, gt, 1, nq, 1} per 64-column block over q or
//   dout viewed as (B, S, KV, G, hd).  TMA never writes the stage rows
//   past nq * gt; they are zeroed once at the start (0 * NaN is NaN).
// - dK / dV: grid (B * KV, key tiles of BWD_KEY_TILE keys, 64 at hd 256),
//   the first key tiles, the heaviest under causal masking (at a query
//   offset the keys before it, which every query sees), first.  384
//   threads: a producer warpgroup (one working warp; setmaxnreg gives its
//   registers to the consumers) and two consumer warpgroups.  The
//   producer loads the tile's K and V once, then streams the row tiles
//   that see any of its keys (key_queries: from the query at key
//   position k0 under causal masking, up to the one at the tile's last
//   key + window - 1 under a window) through a ring of
//   NST stages: Q and dO by TMA, and the rows' -lse / scale and -D by
//   plain loads into the stage, which every lane's arrival on the
//   stage's "full" barrier publishes.  With the keys as M and the rows as
//   N, each consumer warpgroup takes a row tile in two halves of 32 rows:
//   it starts its S^T and dP^T accumulators (m64n32) at the rows' -lse /
//   scale and -D, runs S^T = K Q^T and dP^T = V dO^T into them (ss), then
//   P^T = 2^((S^T - lse / scale) scale log2e), masked only on tiles where
//   some pair is not visible (two row thresholds a key, no division by G
//   per element), dS^T = P^T * (dP^T - D), then dV += P^T dO and dK +=
//   dS^T Q (rs, each as hi + lo).  At hd <= 128 the two warpgroups own 64
//   keys each of a 128-key tile; at hd 256 both own the same 64 keys and
//   split dK's and dV's columns, 128 each, both computing the tile's S^T
//   and dP^T.
//   Registers are what bounds this design: dK and dV are 128 fp32 a
//   consumer thread at hd 128 and 256, so the producer warpgroup keeps 40
//   and each consumer takes 232 (setmaxnreg).  ptxas spilled the P / dS
//   phase while it held 32 + 32 values and their hi + lo halves, or the
//   rows' lse and D, or an integer division by G per element beside
//   them; the halves, the accumulators' start values and the thresholds
//   remove each.
// - dQ: the forward's structure: grid (B * KV, row tiles), the last row
//   tiles first; a consumer warpgroup and a producer warp, which loads
//   the CTA's Q and dO once and K / V tiles through the forward's ring
//   (Ring, DenseSrc::load_tile).  Each key tile runs S = Q K^T and dP =
//   dO V^T (ss), P from lse (no online softmax), dS, then dQ += dS K (rs,
//   K as the MN-major B, hi + lo).
//
// At (192, 128) the products over q/k's width (S, dK, dQ) take Tile<192>'s
// three column blocks and those over v's (dP, dV) Tile<128>'s two; the dK
// / dV kernel runs hd 256's plan (64-key tiles, both consumer warpgroups
// on the same keys), warpgroup 0 holding dK's blocks 0-1 and dV's 0, 1
// the rest (96 and 64 accumulator registers a thread, against 128 at hd
// 128 and 256), and the dQ kernel's 96 accumulators take one CTA an SM.
//
// fp32, on the CUDA cores (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel):
// the same split of the work over 32-row and 32-key tiles, every product
// in fp32 from shared memory.  They serve the fp32 parity runs and the
// reduced training only, and are not a redesign target.  The wrapper
// picks the route by dtype.
//
// What bounds it: at the training shape (bf16, B 4, S 1024 causal, H 16,
// KV 8, hd 128) the five products need 43 GFLOP, 0.043 ms at 989 TFLOP/s
// on the tensor cores, against ~101 MB of inputs and outputs (0.030 ms at
// 3.35 TB/s): operations.  The design issues ten tensor passes of the
// pairs it visits (S and dP twice, P and dS products twice for hi and
// lo), ~95 GFLOP with the masked halves of the diagonal tiles; on an H100
// (700 W) the three launches take ~0.22 ms (PERF.md, row 8).
#include <type_traits>

#include "attention_sm90.cuh"

namespace {

// ---------------------------------------------------------------------
// fp32 on the CUDA cores
constexpr int BT = 32;          // rows a row tile, keys a key tile
constexpr int NT = 256;         // threads a CTA (8 warps)
constexpr int PAD = 4;          // floats past each shared tile row

struct BwdParams {
  const void* q;                // (B, S, KV, G, hd)
  const void* k;                // (B, T, KV, hd)
  const void* v;
  const void* out;              // (B, S, KV, G, hd)
  const void* dout;
  const float* lse;             // (B, S, KV, G)
  const float* delta;           // (B, S, KV, G), flash_bwd_delta_kernel's
  void* dq;
  void* dk;
  void* dv;
  int S, KV, G, causal, window;
  float scale;
  int T;                        // keys
  int qoff;                     // T - S: query s at key position s + qoff
  // bf16's row tiles (BwdPlan below): gt heads of nq queries, heads in
  // ngb blocks; the dQ kernel's row tiles
  int gt, nq, ngb, n_row_tiles;
};

// The capped kernels' parameters: BwdParams and the soft-cap in raw units
// (c / scale) with its inverse; the uncapped kernels keep BwdParams.
struct CapBwdParams : BwdParams {
  float cap, cap_inv;
};
template <bool CAP>
using BwdArgs = std::conditional_t<CAP, CapBwdParams, BwdParams>;

// the keys lo <= t <= hi query s sees (DenseSrc::bounds)
__device__ __forceinline__ int key_lo(const BwdParams& p, int s) {
  return p.window ? max(s + p.qoff - p.window + 1, 0) : 0;
}
__device__ __forceinline__ int key_hi(const BwdParams& p, int s) {
  return p.causal ? s + p.qoff : p.T - 1;
}

// the queries [lo, hi] that see a key of [t0, t_end): causal, a >= t0;
// a window, a < t_end - 1 + window; empty (lo > hi) where none does
__device__ __forceinline__ int2 key_queries(const BwdParams& p, int t0,
                                            int t_end) {
  const int shift = p.qoff;
  return make_int2(p.causal ? max(t0 - shift, 0) : 0,
                   p.window ? min(p.S - 1, t_end - 1 - shift + p.window - 1)
                            : p.S - 1);
}

// Shared memory of the dK/dV and dQ kernels at q/k head dim HD and v head
// dim DV, in floats: the Q and K tiles (BT rows of LD floats: the pad puts
// the rows of a quarter-warp's float4 reads in distinct banks), the dO
// and V tiles (rows of LDV), P and dS (BT x PLD), then the rows' lse and
// D.
template <int HD, int DV>
struct Smem {
  static constexpr int LD = HD + PAD;
  static constexpr int LDV = DV + PAD;
  static constexpr int TILE = BT * LD;
  static constexpr int TILE_V = BT * LDV;
  static constexpr int PLD = BT + 1;
  static constexpr int BYTES =
      (2 * TILE + 2 * TILE_V + 2 * BT * PLD + 2 * BT) * 4;
};

// The columns of a thread's accumulators: c0 + 32c for c < N, c0 = 4 *
// (tid % 8); at hd 16 the threads with c0 >= 16 hold none.
template <int HD>
struct Cols {
  static constexpr int N = (HD + 31) / 32;
  static __device__ __forceinline__ bool in(int col) {
    return HD % 32 == 0 || col < HD;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ int64_t row_index(const BwdParams& p, int b,
                                             int kvh, int r) {
  const int s = r / p.G, g = r - s * p.G;
  return (((int64_t)b * p.S + s) * p.KV + kvh) * p.G + g;
}

// rows r0 .. r0 + BT - 1 of (b, kvh) of a (B, S, KV, G, W) tensor into
// dst (rows of W + PAD floats) as fp32, zeros from r_end on
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const void* src,
                                          const BwdParams& p, int b, int kvh,
                                          int r0, int r_end) {
  constexpr int C = W / 4;
  for (int e = threadIdx.x; e < BT * C; e += NT) {
    const int i = e / C, d = (e - i * C) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + i < r_end)
      Vec<float, 4>::load(reinterpret_cast<const float*>(src) +
                          row_index(p, b, kvh, r0 + i) * W + d, x);
    *reinterpret_cast<float4*>(dst + i * (W + PAD) + d) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// keys t0 .. t0 + BT - 1 of (b, kvh) of a (B, T, KV, W) tensor into dst
// (rows of W + PAD floats) as fp32, zeros from t_end on
template <int W>
__device__ __forceinline__ void load_keys(float* dst, const void* src,
                                          const BwdParams& p, int b, int kvh,
                                          int t0, int t_end) {
  constexpr int C = W / 4;
  for (int e = threadIdx.x; e < BT * C; e += NT) {
    const int j = e / C, d = (e - j * C) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (t0 + j < t_end)
      Vec<float, 4>::load(reinterpret_cast<const float*>(src) +
                          (((int64_t)b * p.T + t0 + j) * p.KV + kvh) * W + d,
                      x);
    *reinterpret_cast<float4*>(dst + j * (W + PAD) + d) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// the lse and D of rows r0 .. r0 + BT - 1 (zeros from r_end on)
__device__ __forceinline__ void load_row_stats(float* lse_s, float* d_s,
                                               const BwdParams& p, int b,
                                               int kvh, int r0, int r_end) {
  if (threadIdx.x < BT) {
    const int r = r0 + threadIdx.x;
    float l = 0.f, dd = 0.f;
    if (r < r_end) {
      const int64_t row = row_index(p, b, kvh, r);
      l = p.lse[row];
      dd = p.delta[row];
    }
    lse_s[threadIdx.x] = l;
    d_s[threadIdx.x] = dd;
  }
}

// P (if ps) and dS of one (row tile r0, key tile t0) pair into shared
// memory.  Thread (i, jj) = (tid / 8, tid % 8) takes row i and keys jj +
// 8c, c < 4; rows from r_end on and masked keys give P = dS = 0.  CAP:
// the score capped first, and dS times 1 - (s' / C)^2.
template <int HD, int DV, bool CAP>
__device__ __forceinline__ void tile_p_ds(const BwdArgs<CAP>& p,
                                          const float* qs, const float* dos,
                                          const float* ks, const float* vs,
                                          const float* lse_s,
                                          const float* d_s, int r0, int r_end,
                                          int t0, float* ps, float* dss) {
  using SM = Smem<HD, DV>;
  const int i = threadIdx.x >> 3, jj = threadIdx.x & 7;
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 qv = ld4(qs + i * SM::LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sc[c] = dot4(sc[c], qv, ld4(ks + (jj + 8 * c) * SM::LD + d));
  }
#pragma unroll 4
  for (int d = 0; d < DV; d += 4) {
    const float4 ov = ld4(dos + i * SM::LDV + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dp[c] = dot4(dp[c], ov, ld4(vs + (jj + 8 * c) * SM::LDV + d));
  }
  const int r = r0 + i;
  const bool row_ok = r < r_end;
  const int s = row_ok ? r / p.G : 0;
  const int lo = key_lo(p, s), hi = min(key_hi(p, s), p.T - 1);
  const float l = lse_s[i], dd = d_s[i];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = jj + 8 * c, t = t0 + j;
    const bool vis = row_ok && t >= lo && t <= hi;
    if constexpr (CAP) {
      const float th = tanhf(sc[c] * p.cap_inv);
      const float pr = vis ? expf(fmaf(p.cap * th, p.scale, -l)) : 0.f;
      if (ps != nullptr) ps[i * SM::PLD + j] = pr;
      dss[i * SM::PLD + j] = pr * (dp[c] - dd) * fmaf(-th, th, 1.f);
    } else {
      const float pr = vis ? expf(fmaf(sc[c], p.scale, -l)) : 0.f;
      if (ps != nullptr) ps[i * SM::PLD + j] = pr;
      dss[i * SM::PLD + j] = pr * (dp[c] - dd);
    }
  }
}

// D = rowsum(dO * O), a warp a row
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ delta, int64_t n_rows) {
  const int64_t row = (int64_t)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  float acc = 0.f;
  for (int d = lane * 4; d < HD; d += 128) {
    float o[4], g[4];
    Vec<T, 4>::load(out + row * HD + d, o);
    Vec<T, 4>::load(dout + row * HD + d, g);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = fmaf(o[e], g[e], acc);
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) delta[row] = acc;
}

// dK and dV of one key tile of (b, kv head): grid (B * KV, key tiles)
template <int HD, int DV, bool CAP>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const BwdArgs<CAP> p) {
  using SM = Smem<HD, DV>;
  float* qs = reinterpret_cast<float*>(smem_buffer<SM::BYTES>());
  float* dos = qs + SM::TILE;
  float* ks = dos + SM::TILE_V;
  float* vs = ks + SM::TILE;
  float* ps = vs + SM::TILE_V;
  float* dss = ps + BT * SM::PLD;
  float* lse_s = dss + BT * SM::PLD;
  float* d_s = lse_s + BT;

  const int b = blockIdx.x / p.KV, kvh = blockIdx.x - b * p.KV;
  const int t0 = blockIdx.y * BT, t_end = min(t0 + BT, p.T);
  load_keys<HD>(ks, p.k, p, b, kvh, t0, t_end);
  load_keys<DV>(vs, p.v, p, b, kvh, t0, t_end);
  // the rows that see any key of the tile (none where sq.y < sq.x)
  const int2 sq = key_queries(p, t0, t_end);
  const int s_lo = sq.x;
  const int r_end = (sq.y + 1) * p.G;
  // thread (j, c0): key j, columns c0 + 32c
  const int j = threadIdx.x >> 3, c0 = (threadIdx.x & 7) * 4;
  float4 dk[Cols<HD>::N], dv[Cols<DV>::N];
#pragma unroll
  for (int c = 0; c < Cols<HD>::N; ++c)
    dk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < Cols<DV>::N; ++c)
    dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = s_lo * p.G; r0 < r_end; r0 += BT) {
    __syncthreads();          // the last row tile's readers are done
    load_rows<HD>(qs, p.q, p, b, kvh, r0, r_end);
    load_rows<DV>(dos, p.dout, p, b, kvh, r0, r_end);
    load_row_stats(lse_s, d_s, p, b, kvh, r0, r_end);
    __syncthreads();
    tile_p_ds<HD, DV, CAP>(p, qs, dos, ks, vs, lse_s, d_s, r0, r_end, t0, ps,
                           dss);
    __syncthreads();
    for (int i = 0; i < BT; ++i) {
      const float pr = ps[i * SM::PLD + j], ds = dss[i * SM::PLD + j];
#pragma unroll
      for (int c = 0; c < Cols<DV>::N; ++c) {
        const int col = c0 + 32 * c;
        if (Cols<DV>::in(col)) axpy4(dv[c], pr, ld4(dos + i * SM::LDV + col));
      }
#pragma unroll
      for (int c = 0; c < Cols<HD>::N; ++c) {
        const int col = c0 + 32 * c;
        if (Cols<HD>::in(col)) axpy4(dk[c], ds, ld4(qs + i * SM::LD + col));
      }
    }
  }
  const int t = t0 + j;
  if (t >= p.T) return;
  const int64_t key = ((int64_t)b * p.T + t) * p.KV + kvh;
#pragma unroll
  for (int c = 0; c < Cols<HD>::N; ++c) {
    const int col = c0 + 32 * c;
    if (!Cols<HD>::in(col)) continue;
    float x[4] = {dk[c].x * p.scale, dk[c].y * p.scale, dk[c].z * p.scale,
                  dk[c].w * p.scale};
    Vec<float, 4>::store(reinterpret_cast<float*>(p.dk) + key * HD + col, x);
  }
#pragma unroll
  for (int c = 0; c < Cols<DV>::N; ++c) {
    const int col = c0 + 32 * c;
    if (!Cols<DV>::in(col)) continue;
    float y[4] = {dv[c].x, dv[c].y, dv[c].z, dv[c].w};
    Vec<float, 4>::store(reinterpret_cast<float*>(p.dv) + key * DV + col, y);
  }
}

// dQ of one row tile of (b, kv head): grid (B * KV, row tiles)
template <int HD, int DV, bool CAP>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const BwdArgs<CAP> p) {
  using SM = Smem<HD, DV>;
  float* qs = reinterpret_cast<float*>(smem_buffer<SM::BYTES>());
  float* dos = qs + SM::TILE;
  float* ks = dos + SM::TILE_V;
  float* vs = ks + SM::TILE;
  float* dss = vs + SM::TILE_V + BT * SM::PLD;
  float* lse_s = dss + BT * SM::PLD;
  float* d_s = lse_s + BT;

  const int b = blockIdx.x / p.KV, kvh = blockIdx.x - b * p.KV;
  const int r0 = blockIdx.y * BT, r_end = min(r0 + BT, p.S * p.G);
  load_rows<HD>(qs, p.q, p, b, kvh, r0, r_end);
  load_rows<DV>(dos, p.dout, p, b, kvh, r0, r_end);
  load_row_stats(lse_s, d_s, p, b, kvh, r0, r_end);
  // the keys any row of the tile sees
  const int k_lo = key_lo(p, r0 / p.G);
  const int k_hi = min(key_hi(p, (r_end - 1) / p.G), p.T - 1);
  // thread (i, c0): row i, columns c0 + 32c
  const int i = threadIdx.x >> 3, c0 = (threadIdx.x & 7) * 4;
  float4 dq[Cols<HD>::N];
#pragma unroll
  for (int c = 0; c < Cols<HD>::N; ++c)
    dq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = k_lo; t0 <= k_hi; t0 += BT) {
    __syncthreads();          // the last key tile's readers are done
    load_keys<HD>(ks, p.k, p, b, kvh, t0, min(t0 + BT, p.T));
    load_keys<DV>(vs, p.v, p, b, kvh, t0, min(t0 + BT, p.T));
    __syncthreads();
    tile_p_ds<HD, DV, CAP>(p, qs, dos, ks, vs, lse_s, d_s, r0, r_end, t0,
                           nullptr, dss);
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
      const float ds = dss[i * SM::PLD + j];
#pragma unroll
      for (int c = 0; c < Cols<HD>::N; ++c)
        if (Cols<HD>::in(c0 + 32 * c))
          axpy4(dq[c], ds, ld4(ks + j * SM::LD + c0 + 32 * c));
    }
  }
  if (r0 + i >= r_end) return;
  const int64_t at = row_index(p, b, kvh, r0 + i) * HD;
#pragma unroll
  for (int c = 0; c < Cols<HD>::N; ++c) {
    if (!Cols<HD>::in(c0 + 32 * c)) continue;
    float x[4] = {dq[c].x * p.scale, dq[c].y * p.scale, dq[c].z * p.scale,
                  dq[c].w * p.scale};
    Vec<float, 4>::store(reinterpret_cast<float*>(p.dq) + at + c0 + 32 * c, x);
  }
}


// ---------------------------------------------------------------------
// bf16 on the tensor cores
constexpr int BWD_ROW_TILE = 64;        // rows a row tile holds at most
constexpr int BWD_KEY_TILE = 128;       // keys a dK / dV CTA, hd <= 128
constexpr int BWD_KEY_TILE_HD256 = 64;  // keys a dK / dV CTA at hd 256
constexpr int KV_THREADS = 384;         // producer + 2 consumer warpgroups
constexpr int HALF = TILE / 2;          // rows of a half row tile
constexpr int PRODUCER_REGS = 40;       // setmaxnreg: 128 x 40 + 256 x 232
constexpr int CONSUMER_REGS = 232;      //   = 384 x 168, the launch's pool
static_assert(BWD_ROW_TILE == TILE && BWD_KEY_TILE_HD256 == TILE, "tiles");

// The dK / dV kernel's tiles at q/k head dim HD and v head dim DV (Q, K
// and dK in Tile<HD>'s column blocks, dO, V and dV in Tile<DV>'s, of the
// same 64 rows x SWB bytes).  Shared memory: K (SUBS 64-key tiles), V (as
// many), NST stages of Q and dO, the stages' lse and D (64 floats each),
// then the barriers: K/V's, NST "full", NST "empty".  At hd <= 128 the
// two consumer warpgroups own 64 keys each and all of dK's and dV's
// column blocks; past it (hd 256, and MLA's q/k 192) both own the tile's
// 64 keys, and warpgroup w the column blocks [KB(w), KB(w) + NK(w)) of dK
// and [VB(w), VB(w) + NV(w)) of dV: the first half of each, rounded up,
// to warpgroup 0 (at (192, 128): dK's blocks 0-1 and dV's 0 to 0, dK's 2
// and dV's 1 to 1).
template <int HD, int DV>
struct KvPlan {
  using T = Tile<HD>;
  using TV = Tile<DV>;
  static constexpr int KEYS = HD <= 128 ? BWD_KEY_TILE : BWD_KEY_TILE_HD256;
  static constexpr int SUBS = KEYS / TILE;
  static constexpr bool SPLIT_COLS = KEYS == TILE;   // two warpgroups, one
                                                     //   key tile
  // warpgroup w's dK blocks NKw from KBw and dV blocks NVw from VBw
  static constexpr int NK0 = SPLIT_COLS ? (T::NCB + 1) / 2 : T::NCB;
  static constexpr int NK1 = SPLIT_COLS ? T::NCB / 2 : T::NCB;
  static constexpr int NV0 = SPLIT_COLS ? (TV::NCB + 1) / 2 : TV::NCB;
  static constexpr int NV1 = SPLIT_COLS ? TV::NCB / 2 : TV::NCB;
  static constexpr int KB1 = SPLIT_COLS ? NK0 : 0;
  static constexpr int VB1 = SPLIT_COLS ? NV0 : 0;
  static constexpr int NST = HD >= 256 ? 2 : 3;
  static constexpr int K_BYTES = SUBS * T::BYTES;
  static constexpr int V_BYTES = SUBS * TV::BYTES;
  static constexpr int STAGE = T::BYTES + TV::BYTES;  // Q and dO
  static constexpr int STAT = 2 * TILE * 4;          // lse and D of a stage
  static constexpr int STATS = K_BYTES + V_BYTES + NST * STAGE;
  static constexpr int BARS = STATS + NST * STAT;
  static constexpr int SMEM = BARS + 8 * (1 + 2 * NST) + 1024;
  static_assert(SUBS * TILE == KEYS && NK1 >= 1 && NV1 >= 1, "key tile");
  static_assert(T::SWB == TV::SWB, "one column block geometry");
};

// The dQ kernel's shared memory: Q and dO, then the forward's ring of K/V
// stages and its barriers, then Q/dO's barrier.
template <int HD, int DV>
struct DqPlan {
  using R = Ring<HD, DV>;
  static constexpr int QD = Tile<HD>::BYTES + Tile<DV>::BYTES;
  static constexpr int BARS = QD + R::NST * R::STAGE;
  static constexpr int SMEM = BARS + 8 * (1 + 2 * R::NST) + 1024;
};

__device__ __forceinline__ float neg_inf_f() {
  return __int_as_float(0xff800000);
}

// Zero the rows n_rows .. 63 of n_blocks consecutive 64-row column blocks
// from shared address first (the rows no box of a row tile writes), by
// `threads` threads, then make the zeros visible to TMA and wgmma.
template <int SWB>
__device__ __forceinline__ void zero_tail_rows(uint8_t* smem0, uint32_t first,
                                               int n_blocks, int n_rows,
                                               int threads) {
  if (n_rows >= TILE) return;
  const int per = (TILE - n_rows) * SWB / 16;
  for (int idx = threadIdx.x; idx < n_blocks * per; idx += threads) {
    const int blk = idx / per, rest = idx - blk * per;
    *reinterpret_cast<uint4*>(smem0 + first + blk * TILE * SWB +
                              n_rows * SWB + rest * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
}

// the row index into lse / delta, and whether it exists, of row i of the
// row tile (s0, g0): query s0 + i / gt, head g0 + i % gt
__device__ __forceinline__ bool tile_row(const BwdParams& p, int b, int kvh,
                                         int s0, int g0, int i,
                                         int64_t& row) {
  const int sq = i / p.gt, s = s0 + sq, g = g0 + i - sq * p.gt;
  row = (((int64_t)b * p.S + s) * p.KV + kvh) * p.G + g;
  return i < p.nq * p.gt && s < p.S && g < p.G;
}

// Q and dO boxes of the row tile (s0, g0) into q_s and do_s, lanes 0 ..
// NCB(Q) + NCB(dO) - 1 of the producer warp, completing `full` (whose
// expected bytes the caller set)
template <int HD, int DV>
__device__ __forceinline__ void load_rows_tma(const CUtensorMap* qmap,
                                              const CUtensorMap* dmap, int b,
                                              int kvh, int s0, int g0,
                                              uint32_t q_s, uint32_t do_s,
                                              uint32_t full, int lane) {
  using T = Tile<HD>;
  using TV = Tile<DV>;
  if (lane < T::NCB)
    tma_load_5d(q_s + lane * T::BLOCK, qmap, full, lane * T::BW, g0, kvh, s0,
                b);
  else if (lane < T::NCB + TV::NCB)
    tma_load_5d(do_s + (lane - T::NCB) * TV::BLOCK, dmap, full,
                (lane - T::NCB) * TV::BW, g0, kvh, s0, b);
}

// the hi + lo A fragments, KK k-steps of 16, of a 64 x 16 KK accumulator
// x (the forward's P fragments)
template <int KK>
__device__ __forceinline__ void split_frags(const float (&x)[8 * KK],
                                            uint32_t (&hi)[KK][4],
                                            uint32_t (&lo)[KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j0 = 4 * (2 * kk + (a >> 1)) + 2 * (a & 1);
      split_bf2(x[j0], x[j0 + 1], hi[kk][a], lo[kk][a]);
    }
}

// X (64 x HD, K-major at a_s) times Y^T (Y N x HD, K-major at b_s) into
// d, or added to d with `add`, HD / 16 k-steps of ss wgmma (the forward's
// S = Q K^T); not committed
template <int HD, int N>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint32_t a_s,
                                           uint32_t b_s, bool add = false) {
  using T = Tile<HD>;
  constexpr uint32_t SBO = 8 * T::SWB;
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const int cb = kc * 16 / T::BW, in = (kc * 16 - cb * T::BW) * 2;
    Wgmma<N>::ss(d, smem_desc(a_s + cb * T::BLOCK + in, SBO, T::SWIZZLE),
                 smem_desc(b_s + cb * T::BLOCK + in, SBO, T::SWIZZLE),
                 add || kc > 0);
  }
}

// acc[c] += A B for the column blocks cb0 .. cb0 + N - 1 of the MN-major B
// whose 16 KK rows start at b_s, with A = hi + lo (the forward's P V); not
// committed
template <int HD, int N, int KK>
__device__ __forceinline__ void rs_product(float (&acc)[N][Tile<HD>::BW / 2],
                                           const uint32_t (&hi)[KK][4],
                                           const uint32_t (&lo)[KK][4],
                                           uint32_t b_s, int cb0) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const uint64_t db =
          smem_desc(b_s + (cb0 + c) * T::BLOCK + kk * 16 * T::SWB,
                    8 * T::SWB, T::SWIZZLE);
      Wgmma<T::BW>::rs(acc[c], lo[kk], db);
      Wgmma<T::BW>::rs(acc[c], hi[kk], db);
    }
}

// The consumer warpgroup's walk of the dK / dV kernel over its n_tiles
// row tiles: NK column blocks of dK from KB and NV of dV from VB (KvPlan),
// for keys kw0 .. kw0 + 63, K and V of those keys at kw_s and vw_s; then
// its rows of dK (scaled) and dV.  Consumer thread (warp, gq, tq) holds
// keys kw0 + 16 warp + gq + 8 h (h = 0, 1) of the accumulators, and of
// S^T and dP^T the rows 8 c8 + 2 tq + e (c8 < 8, e = 0, 1) of the row
// tile.  CAP: the accumulators of S^T start at 0, the capped score s'
// takes the rows' -lse / scale from the stage after the product, and dS^T
// carries 1 - (s' / C)^2.
template <int HD, int DV, int NK, int NV, bool CAP>
__device__ __forceinline__ void dkdv_consume(
    const BwdArgs<CAP>& p, uint8_t* smem0, uint32_t kw_s, uint32_t vw_s,
    uint32_t stage0, uint32_t stats0, uint32_t bars, int b, int kvh,
    int kw0, int qt0, int n_tiles, int KB, int VB) {
  using L = KvPlan<HD, DV>;
  using T = Tile<HD>;
  constexpr int ON = T::BW / 2;          // accumulator floats per block
  auto q_s = [&](int st) { return stage0 + L::STAGE * st; };
  auto do_s = [&](int st) { return q_s(st) + T::BYTES; };
  auto full = [&](int st) { return bars + 8 + 8 * st; };
  auto empty = [&](int st) { return bars + 8 + 8 * (L::NST + st); };
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int my_key = kw0 + warp * 16 + gq;   // + 8 h
  const float qscale = p.scale * LOG2E;
  float dk[NK][ON], dv[NV][ON];
#pragma unroll
  for (int c = 0; c < NK; ++c)
#pragma unroll
    for (int j = 0; j < ON; ++j) dk[c][j] = 0.f;
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int j = 0; j < ON; ++j) dv[c][j] = 0.f;
  mbar_wait(bars, 0);                        // K and V

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % L::NST;
    const int s0 = (qt0 + i / p.ngb) * p.nq;
    const int s1 = min(s0 + p.nq, p.S) - 1;   // the tile's last query
    mbar_wait(full(st), (i / L::NST) & 1);
    // Masks only where some pair of the tile is not visible.  Key t sees
    // the rows n (query s0 + n / gt, at key position s0 + n / gt + T - S)
    // with from <= n < to: causal, n >= (t - s0 - qoff) gt; a window, n
    // < (t - s0 - qoff + window) gt; keys >= T none.  Held as from - 2 tq
    // and to - 2 tq, against the thread's row offsets, which are
    // constants
    const bool masked = kw0 < DenseSrc::bounds(p, b, s1).x ||
                        kw0 + TILE - 1 > DenseSrc::bounds(p, b, s0).y;
    int from[2] = {0, 0}, to[2] = {0, 0};
    if (masked) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = my_key + 8 * h, d = key - s0 - p.qoff;
        from[h] = (p.causal ? d * p.gt
                            : key < p.T ? 0 : TILE) - 2 * tq;
        to[h] = (p.window ? min(d + p.window, TILE) * p.gt : TILE * TILE) -
                2 * tq;
      }
    }
    const float* stat =
        reinterpret_cast<const float*>(smem0 + stats0 + L::STAT * st);

    // the row tile in two halves of 32 rows, so that the P / dS phase
    // holds 16 + 16 values beside dK and dV
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r0 = HALF * hf;
      // S^T - lse / scale = K Q^T and dP^T - D = V dO^T: the accumulators
      // start at the rows' -lse / scale and -D, so those take no
      // registers beside them.  sc[4 c8 + j] is key my_key + 8 (j >> 1),
      // row r0 + 8 c8 + 2 tq + (j & 1)
      float sc[HALF / 2], dp[HALF / 2];
#pragma unroll
      for (int c8 = 0; c8 < HALF / 8; ++c8) {
        const float2 nl = *reinterpret_cast<const float2*>(
            stat + r0 + 8 * c8 + 2 * tq);
        const float2 nd = *reinterpret_cast<const float2*>(
            stat + TILE + r0 + 8 * c8 + 2 * tq);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[4 * c8 + j] = CAP ? 0.f : j & 1 ? nl.y : nl.x;
          dp[4 * c8 + j] = j & 1 ? nd.y : nd.x;
        }
      }
      pin(sc);
      pin(dp);
      wgmma_fence();
      ss_product<HD, HALF>(sc, kw_s, q_s(st) + r0 * T::SWB, true);
      ss_product<DV, HALF>(dp, vw_s, do_s(st) + r0 * T::SWB, true);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);

      // P^T = 2^((S^T - lse / scale) scale log2e), dS^T = P^T (dP^T - D)
#pragma unroll
      for (int c8 = 0; c8 < HALF / 8; ++c8) {
        float2 nl = make_float2(0.f, 0.f);
        if constexpr (CAP)
          nl = *reinterpret_cast<const float2*>(stat + r0 + 8 * c8 + 2 * tq);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int x = 4 * c8 + j, h = j >> 1, n = r0 + 8 * c8 + (j & 1);
          if constexpr (CAP) {
            const float th = tanh_ex2(sc[x] * p.cap_inv);
            float pr = ex2(fmaf(p.cap, th, j & 1 ? nl.y : nl.x) * qscale);
            if (masked && (n < from[h] || n >= to[h])) pr = 0.f;
            sc[x] = pr;
            dp[x] *= pr * fmaf(-th, th, 1.f);
          } else {
            float pr = ex2(sc[x] * qscale);
            if (masked && (n < from[h] || n >= to[h])) pr = 0.f;
            sc[x] = pr;
            dp[x] *= pr;
          }
        }
      }
      uint32_t ph[HALF / 16][4], pl[HALF / 16][4];
      uint32_t dh[HALF / 16][4], dl[HALF / 16][4];
      split_frags<HALF / 16>(sc, ph, pl);
      split_frags<HALF / 16>(dp, dh, dl);

      // dV += P^T dO, dK += dS^T Q over the half's rows
#pragma unroll
      for (int c = 0; c < NV; ++c) pin(dv[c]);
#pragma unroll
      for (int c = 0; c < NK; ++c) pin(dk[c]);
      wgmma_fence();
      rs_product<DV, NV, HALF / 16>(dv, ph, pl, do_s(st) + r0 * T::SWB, VB);
      rs_product<HD, NK, HALF / 16>(dk, dh, dl, q_s(st) + r0 * T::SWB, KB);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NV; ++c) pin(dv[c]);
#pragma unroll
      for (int c = 0; c < NK; ++c) pin(dk[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // the keys' rows of dK (scaled) and dV
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = my_key + 8 * h;
    if (key >= p.T) continue;
    const int64_t at = ((int64_t)b * p.T + key) * p.KV + kvh;
    __nv_bfloat16* dkp = reinterpret_cast<__nv_bfloat16*>(p.dk) + at * HD;
    __nv_bfloat16* dvp = reinterpret_cast<__nv_bfloat16*>(p.dv) + at * DV;
#pragma unroll
    for (int c = 0; c < NK; ++c)
#pragma unroll
      for (int c8 = 0; c8 < ON / 4; ++c8)
        *reinterpret_cast<uint32_t*>(dkp + (KB + c) * T::BW + 8 * c8 +
                                     2 * tq) =
            f_to_bf2(dk[c][4 * c8 + 2 * h] * p.scale,
                     dk[c][4 * c8 + 2 * h + 1] * p.scale);
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int c8 = 0; c8 < ON / 4; ++c8)
        *reinterpret_cast<uint32_t*>(dvp + (VB + c) * T::BW + 8 * c8 +
                                     2 * tq) =
            f_to_bf2(dv[c][4 * c8 + 2 * h], dv[c][4 * c8 + 2 * h + 1]);
  }
}

// dK and dV of one key tile of (b, kv head): grid (B * KV, key tiles),
// KV_THREADS threads: a producer warpgroup, then consumer warpgroups 0
// and 1 (dkdv_consume).
template <int HD, int DV, bool CAP>
__global__ void __launch_bounds__(KV_THREADS, 1) flash_bwd_dkdv_sm90_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap dmap, const BwdArgs<CAP> p) {
  using L = KvPlan<HD, DV>;
  using T = Tile<HD>;
  using TV = Tile<DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem0 = smem_raw - raw;
  const uint32_t k_s = base, v_s = base + L::K_BYTES;
  const uint32_t stage0 = base + L::K_BYTES + L::V_BYTES;
  auto q_s = [&](int st) { return stage0 + L::STAGE * st; };
  auto do_s = [&](int st) { return q_s(st) + T::BYTES; };
  auto stat_s = [&](int st) { return base + L::STATS + L::STAT * st; };
  const uint32_t bars = base + L::BARS, kv_full = bars;
  auto full = [&](int st) { return bars + 8 + 8 * st; };
  auto empty = [&](int st) { return bars + 8 + 8 * (L::NST + st); };

  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv - b * p.KV;
  const int key0 = blockIdx.y * L::KEYS;
  const int key_end = min(key0 + L::KEYS, p.T);
  // the queries [sq.x, sq.y] that see a key of the tile, none where sq.y
  // < sq.x (the tile's dK and dV are then zeros)
  const int2 sq = key_queries(p, key0, key_end);
  const int qt0 = sq.x / p.nq;
  const int n_tiles = sq.y >= sq.x ? (sq.y / p.nq - qt0 + 1) * p.ngb : 0;
  const int rows_used = p.nq * p.gt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, L::SUBS);
    for (int st = 0; st < L::NST; ++st) {
      mbar_init(full(st), 1 + 32);       // the bytes, and every lane's stats
      mbar_init(empty(st), 2 * CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  zero_tail_rows<T::SWB>(smem0, q_s(0), L::NST * (T::NCB + TV::NCB),
                         rows_used, KV_THREADS);
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  if (wg == 0) {
    // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    // K and V once; a 64-key part past T reads from T - 1 (its keys are
    // masked), so no box lies wholly outside the tensor
#pragma unroll
    for (int sub = 0; sub < L::SUBS; ++sub)
      DenseSrc::load_tile<HD, DV>(p, &kmap, &vmap, b, kvh,
                                  min(key0 + TILE * sub, p.T - 1),
                                  k_s + sub * T::BYTES, v_s + sub * TV::BYTES,
                                  kv_full, smem0, lane);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % L::NST, qi = i / p.ngb;
      const int s0 = (qt0 + qi) * p.nq, g0 = (i - qi * p.ngb) * p.gt;
      mbar_wait(empty(st), ((i / L::NST) & 1) ^ 1);
      if (lane == 0)
        mbar_expect_tx(full(st),
                       (T::NCB + TV::NCB) * rows_used * T::SWB);
      __syncwarp();
      load_rows_tma<HD, DV>(&qmap, &dmap, b, kvh, s0, g0, q_s(st), do_s(st),
                            full(st), lane);
      // -lse / scale and -D of the rows, the accumulators' first values;
      // -inf and 0 where no row is
      float* stat = reinterpret_cast<float*>(smem0 + stat_s(st));
      for (int r = lane; r < TILE; r += 32) {
        int64_t row;
        const bool ok = tile_row(p, b, kvh, s0, g0, r, row);
        stat[r] = ok ? -p.lse[row] / p.scale : neg_inf_f();
        stat[TILE + r] = ok ? -p.delta[row] : 0.f;
      }
      mbar_arrive(full(st));
    }
    return;
  }

  // consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  const int w = wg - 1;
  const int kw0 = L::SPLIT_COLS ? key0 : key0 + TILE * w;
  const uint32_t kw_s = k_s + (L::SPLIT_COLS ? 0 : w * T::BYTES);
  const uint32_t vw_s = v_s + (L::SPLIT_COLS ? 0 : w * TV::BYTES);
  if constexpr (L::NK0 == L::NK1 && L::NV0 == L::NV1) {
    dkdv_consume<HD, DV, L::NK0, L::NV0, CAP>(
        p, smem0, kw_s, vw_s, stage0, base + L::STATS, bars, b, kvh, kw0,
        qt0, n_tiles, w ? L::KB1 : 0, w ? L::VB1 : 0);
  } else if (w == 0) {
    dkdv_consume<HD, DV, L::NK0, L::NV0, CAP>(
        p, smem0, kw_s, vw_s, stage0, base + L::STATS, bars, b, kvh, kw0,
        qt0, n_tiles, 0, 0);
  } else {
    dkdv_consume<HD, DV, L::NK1, L::NV1, CAP>(
        p, smem0, kw_s, vw_s, stage0, base + L::STATS, bars, b, kvh, kw0,
        qt0, n_tiles, L::KB1, L::VB1);
  }
}

// dQ of one row tile of (b, kv head): grid (B * KV, row tiles), THREADS
// threads.  Consumer thread (warp, gq, tq) holds rows 16 warp + gq + 8 h
// (h = 0, 1) of the row tile.
template <int HD, int DV, bool CAP>
__global__ void __launch_bounds__(THREADS, HD > 128 ? 1 : 2)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap dmap,
                             const BwdArgs<CAP> p) {
  using Q = DqPlan<HD, DV>;
  using R = typename Q::R;
  using T = Tile<HD>;
  using TV = Tile<DV>;
  constexpr int ON = T::BW / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem0 = smem_raw - raw;
  const uint32_t q_s = base, do_s = base + T::BYTES;
  auto k_s = [&](int st) { return base + Q::QD + R::STAGE * st; };
  auto v_s = [&](int st) { return k_s(st) + T::BYTES; };
  const uint32_t bars = base + Q::BARS, qd_full = bars;
  auto full = [&](int st) { return bars + 8 + 8 * st; };
  auto empty = [&](int st) { return bars + 8 + 8 * (R::NST + st); };

  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv - b * p.KV;
  const int rt = p.n_row_tiles - 1 - blockIdx.y;   // heaviest tiles first
  const int qi = rt / p.ngb;
  const int s0 = qi * p.nq, g0 = (rt - qi * p.ngb) * p.gt;
  const int s1 = min(s0 + p.nq, p.S) - 1;
  const int rows_used = p.nq * p.gt;
  // the keys any row of the tile sees: [beg, end)
  const int beg = DenseSrc::bounds(p, b, s0).x;
  const int end = DenseSrc::bounds(p, b, s1).y + 1;
  const int t0 = beg & ~(TILE - 1);
  const int n_tiles = end > beg ? (end - t0 + TILE - 1) / TILE : 0;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int st = 0; st < R::NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  zero_tail_rows<T::SWB>(smem0, q_s, T::NCB + TV::NCB, rows_used, THREADS);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == CONSUMERS / 32) {
    // producer: the rows' Q and dO, then keep the ring full
    if (lane == 0)
      mbar_expect_tx(qd_full, (T::NCB + TV::NCB) * rows_used * T::SWB);
    __syncwarp();
    load_rows_tma<HD, DV>(&qmap, &dmap, b, kvh, s0, g0, q_s, do_s, qd_full,
                          lane);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % R::NST;
      if (lane == 0) mbar_wait(empty(st), ((i / R::NST) & 1) ^ 1);
      __syncwarp();
      DenseSrc::load_tile<HD, DV>(p, &kmap, &vmap, b, kvh, t0 + TILE * i,
                                  k_s(st), v_s(st), full(st), smem0, lane);
    }
    return;
  }

  // consumers: the rows' -lse log2e, D and key bounds
  const int gq = lane >> 2, tq = lane & 3;
  float neg[2], dd[2];
  int lo[2], hi[2];
  int64_t row[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = warp * 16 + gq + 8 * h;
    ok[h] = tile_row(p, b, kvh, s0, g0, i, row[h]);
    const int2 kb = DenseSrc::bounds(p, b, s0 + i / p.gt);
    neg[h] = ok[h] ? -p.lse[row[h]] * LOG2E : neg_inf_f();
    dd[h] = ok[h] ? p.delta[row[h]] : 0.f;
    lo[h] = ok[h] ? kb.x : INT_MAX;
    hi[h] = ok[h] ? kb.y : -1;
  }
  // the keys every query of the tile sees: no mask inside them
  const int all_lo = DenseSrc::bounds(p, b, s1).x;
  const int all_hi = DenseSrc::bounds(p, b, s0).y;
  const float qscale = p.scale * LOG2E;
  float dq[T::NCB][ON];
#pragma unroll
  for (int cb = 0; cb < T::NCB; ++cb)
#pragma unroll
    for (int j = 0; j < ON; ++j) dq[cb][j] = 0.f;
  mbar_wait(qd_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % R::NST, key0 = t0 + TILE * i;
    mbar_wait(full(st), (i / R::NST) & 1);

    // S = Q K^T, dP = dO V^T
    float sc[32], dp[32];
    wgmma_fence();
    ss_product<HD, TILE>(sc, q_s, k_s(st));
    ss_product<DV, TILE>(dp, do_s, v_s(st));
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    pin(dp);

    // dS = P * (dP - D); sc[4 c8 + j] is row gq + 8 (j >> 1), key key0 +
    // 8 c8 + 2 tq + (j & 1)
    const bool masked = key0 < all_lo || key0 + TILE - 1 > all_hi;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1, x = 4 * c8 + j;
        float th = 0.f;
        if constexpr (CAP) {
          th = tanh_ex2(sc[x] * p.cap_inv);
          sc[x] = p.cap * th;
        }
        float pr = ex2(fmaf(sc[x], qscale, neg[h]));
        if (masked) {
          const int key = key0 + 8 * c8 + 2 * tq + (j & 1);
          if (key < lo[h] || key > hi[h]) pr = 0.f;
        }
        if constexpr (CAP)
          dp[x] = pr * (dp[x] - dd[h]) * fmaf(-th, th, 1.f);
        else
          dp[x] = pr * (dp[x] - dd[h]);
      }
    uint32_t dh[4][4], dl[4][4];
    split_frags<4>(dp, dh, dl);

    // dQ += dS K
#pragma unroll
    for (int cb = 0; cb < T::NCB; ++cb) pin(dq[cb]);
    wgmma_fence();
    rs_product<HD, T::NCB, 4>(dq, dh, dl, k_s(st), 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < T::NCB; ++cb) pin(dq[cb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
    __nv_bfloat16* dqp = reinterpret_cast<__nv_bfloat16*>(p.dq) + row[h] * HD;
#pragma unroll
    for (int cb = 0; cb < T::NCB; ++cb)
#pragma unroll
      for (int c8 = 0; c8 < ON / 4; ++c8)
        *reinterpret_cast<uint32_t*>(dqp + cb * T::BW + 8 * c8 + 2 * tq) =
            f_to_bf2(dq[cb][4 * c8 + 2 * h] * p.scale,
                     dq[cb][4 * c8 + 2 * h + 1] * p.scale);
  }
}

// ---------------------------------------------------------------------
// launches
template <typename T, int HD>
int launch_delta(const BwdParams& p, int B, cudaStream_t stream) {
  const int64_t n_rows = (int64_t)B * p.S * p.KV * p.G;
  flash_bwd_delta_kernel<T, HD>
      <<<(unsigned)((n_rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
          reinterpret_cast<const T*>(p.out),
          reinterpret_cast<const T*>(p.dout), const_cast<float*>(p.delta),
          n_rows);
  return (int)cudaGetLastError();
}

// fp32: the CUDA-core kernels
template <int HD, int DV, bool CAP>
int launch_fp32(const BwdArgs<CAP>& p, int B, cudaStream_t stream) {
  int rc = launch_delta<float, DV>(p, B, stream);
  if (rc != 0) return rc;
  rc = launch_with_smem<Smem<HD, DV>::BYTES>(
      flash_bwd_dkdv_kernel<HD, DV, CAP>,
      dim3(B * p.KV, (p.T + BT - 1) / BT), NT, stream, p);
  if (rc != 0) return rc;
  return launch_with_smem<Smem<HD, DV>::BYTES>(
      flash_bwd_dq_kernel<HD, DV, CAP>,
      dim3(B * p.KV, (p.S * p.G + BT - 1) / BT), NT, stream, p);
}

template <typename Kernel, class P>
int launch_sm90_kernel(Kernel kernel, dim3 grid, int threads, int smem,
                       cudaStream_t stream, const CUtensorMap& kmap,
                       const CUtensorMap& vmap, const CUtensorMap& qmap,
                       const CUtensorMap& dmap, const P& p) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, stream>>>(kmap, vmap, qmap, dmap, p);
  return (int)cudaGetLastError();
}

// bf16: the row-tile plan, the tensor maps, then the three launches
template <int HD, int DV, bool CAP>
int launch_bf16(BwdArgs<CAP> p, int B, cudaStream_t stream) {
  p.gt = min(p.G, BWD_ROW_TILE);
  p.nq = BWD_ROW_TILE / p.gt;
  p.ngb = (p.G + p.gt - 1) / p.gt;
  p.n_row_tiles = (p.S + p.nq - 1) / p.nq * p.ngb;
  CUtensorMap kmap, vmap, qmap, dmap;
  const uint64_t rows[4] = {(uint64_t)p.G, (uint64_t)p.KV, (uint64_t)p.S,
                            (uint64_t)B};
  const uint32_t box[4] = {(uint32_t)p.gt, 1, (uint32_t)p.nq, 1};
  using L = KvPlan<HD, DV>;
  int rc = encode_map<HD>(&kmap, p.k, p.KV, p.T, B, TILE);
  if (rc == 0) rc = encode_map<DV>(&vmap, p.v, p.KV, p.T, B, TILE);
  if (rc == 0) rc = encode_tiled<HD, 5>(&qmap, p.q, rows, box);
  if (rc == 0) rc = encode_tiled<DV, 5>(&dmap, p.dout, rows, box);
  if (rc == 0) rc = launch_delta<__nv_bfloat16, DV>(p, B, stream);
  if (rc == 0)
    rc = launch_sm90_kernel(
        flash_bwd_dkdv_sm90_kernel<HD, DV, CAP>,
        dim3(B * p.KV, (p.T + L::KEYS - 1) / L::KEYS), KV_THREADS, L::SMEM,
        stream, kmap, vmap, qmap, dmap, p);
  if (rc == 0)
    rc = launch_sm90_kernel(flash_bwd_dq_sm90_kernel<HD, DV, CAP>,
                            dim3(B * p.KV, p.n_row_tiles), THREADS,
                            DqPlan<HD, DV>::SMEM, stream, kmap, vmap, qmap,
                            dmap, p);
  return rc;
}

// bf16 at the widths the tensor-core kernels take (multiples of 16),
// fp32 at every width built, capped (CAP) or not
template <int HD, int DV, bool CAP>
int launch_dtype_cap(int dtype, const BwdArgs<CAP>& p, int B,
                     cudaStream_t stream) {
  if constexpr (HD % 16 == 0 && DV % 16 == 0) {
    if (dtype == 1) return launch_bf16<HD, DV, CAP>(p, B, stream);
  } else {
    if (dtype == 1) return -1;
  }
  return launch_fp32<HD, DV, CAP>(p, B, stream);
}

// the capped kernels where p.cap > 0 (-1 at head dims without them),
// else the uncapped ones on p's BwdParams
template <int HD, int DV = HD>
int launch_dtype(int dtype, const CapBwdParams& p, int B,
                 cudaStream_t stream) {
  if (p.cap > 0.f) {
    if constexpr (softcap_dims(HD, DV))
      return launch_dtype_cap<HD, DV, true>(dtype, p, B, stream);
    return -1;
  }
  return launch_dtype_cap<HD, DV, false>(dtype, p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: q/k's head dim, 16 to 256; hd_v:
// v's, hd or a pair of the forward's (192, 128) in both dtypes and (24,
// 16) in fp32; q, dq (B, S, H, hd), out, dout (B, S, H, hd_v), k, dk (B,
// T, KV, hd), v, dv (B, T, KV, hd_v); lse: the forward's (B, S, H) fp32
// log-sum-exp; delta: (B, S, H) fp32 scratch; dq, dk, dv: outputs in the
// inputs' dtype; S: queries, T: keys (T >= S under a mask, query s at key
// position s + T - S; any T with causal = window = 0); causal: 0 or 1;
// window: 0 for none; scale, softcap: the forward's (softcap 0 for none).
// Launches three kernels on ``stream``: bf16 the tensor-core kernels, fp32
// the CUDA-core ones.  Returns cudaGetLastError() after the first that
// fails (0 on success), -1 for a dtype or head dims it has no kernel for,
// -2 if cuTensorMapEncodeTiled cannot be found, -3 if it refuses a tensor
// map.
extern "C" int repro_flash_attention_bwd(
    int dtype, int hd, int hd_v, const void* q, const void* k,
    const void* v, const void* out, const void* dout, const float* lse,
    float* delta, void* dq, void* dk, void* dv, int B, int S, int T, int KV,
    int G, int causal, int window, float scale, float softcap,
    void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const BwdParams base = {q, k, v, out, dout, lse, delta, dq, dk, dv,
                          S, KV, G, causal, window, scale, T, T - S};
  CapBwdParams p;
  static_cast<BwdParams&>(p) = base;
  p.cap = softcap / scale;                   // raw units
  p.cap_inv = softcap > 0.f ? scale / softcap : 0.f;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 192 && hd_v == 128)
    return launch_dtype<192, 128>(dtype, p, B, st);
  if (hd == 24 && hd_v == 16) return launch_dtype<24, 16>(dtype, p, B, st);
  if (hd_v != hd) return -1;
  switch (hd) {
    case 16: return launch_dtype<16>(dtype, p, B, st);
    case 32: return launch_dtype<32>(dtype, p, B, st);
    case 64: return launch_dtype<64>(dtype, p, B, st);
    case 128: return launch_dtype<128>(dtype, p, B, st);
    case 256: return launch_dtype<256>(dtype, p, B, st);
    default: return -1;
  }
}

// The dynamic shared memory of the bf16 dK / dV (which = 0) and dQ (1)
// kernels at head dims (hd, hd_v), for the build report and
// kernels/flash_bwd_plan.py; 0 for a pair it has no bf16 kernel for.
extern "C" int repro_flash_bwd_smem(int hd, int hd_v, int which) {
  if (hd == 192 && hd_v == 128)
    return which ? DqPlan<192, 128>::SMEM : KvPlan<192, 128>::SMEM;
  if (hd != hd_v) return 0;
  switch (hd) {
    case 16: return which ? DqPlan<16, 16>::SMEM : KvPlan<16, 16>::SMEM;
    case 32: return which ? DqPlan<32, 32>::SMEM : KvPlan<32, 32>::SMEM;
    case 64: return which ? DqPlan<64, 64>::SMEM : KvPlan<64, 64>::SMEM;
    case 128: return which ? DqPlan<128, 128>::SMEM : KvPlan<128, 128>::SMEM;
    case 256: return which ? DqPlan<256, 256>::SMEM : KvPlan<256, 256>::SMEM;
    default: return 0;
  }
}
