// Paged attention for Hopper (sm_90a): single-query decode and suffix
// extend over a block-pooled KV cache, read through per-sequence block
// tables.  Hand-written CUDA C++; built by repro_torch/kernels/build.py
// into a shared library with a plain C interface and bound with ctypes.
//
// Replaces the TPU kernels
//   src/repro/kernels/paged_attention.py:paged_decode_attention_bkgd
//     (body _paged_decode_kernel)  -> repro_paged_decode_attention
//   src/repro/kernels/paged_attention.py:paged_extend_attention_bkgd
//     (body _paged_extend_kernel)  -> repro_paged_extend_attention
//
// Both compute the same thing: rows (query s, head g of one kv head) at
// absolute position pos0 + s attend to every key at virtual position
// p <= pos0 + s, the keys living in pool block bt[b, p / bs] at row
// p % bs.  Decode is the case S = 1, pos0 = length - 1.
//
// Two kernels carry the two entry points:
//
// paged_attention_kernel (decode, all dtypes; extend in fp32), on the CUDA
// cores.  One CTA of NW warps owns GR (query, head) rows of one
// (sequence b, kv head); the grid is (B, KV, ceil(S*G / GR)), so decode
// launches one CTA per (b, kv head) whenever G <= 8.  The TPU kernel's
// sequential grid axis over blocks becomes a loop inside the CTA, which
// reads bt[b, p / bs] itself (no scalar prefetch).  A key is read by a
// group of LPK lanes (8 for the decode rows, 16 for extend's 8-row tiles;
// fewer for small head dims), each holding HD/LPK of its head dims, so a
// warp reads 32/LPK keys at once and every group streams its own keys
// straight from device memory, U keys per step in 16-byte loads, with no
// barrier inside the loop.  Each group keeps its own online softmax
// (m, l, acc) in fp32 registers for the GR rows; the dot products finish
// with shuffles inside the group.  At the end the groups of a warp merge
// by shuffles and the warps merge through shared memory, by the usual
// rescaling of (m, l, acc).
//
// paged_extend_mma_kernel (extend in bf16), on the tensor cores; see its
// own comment below.  As in the TPU kernel, P stays fp32 for P.V: the
// bf16 mma takes it as a bf16 pair hi + lo (relative error <= 2^-18), and
// everything accumulates in fp32.
//
// In both, the loop stops at the last key any row of the CTA can see,
// which skips the fully masked blocks the TPU kernel walked through with
// pl.when.  Masked scores are the finite NEG_INF = -2e38 and masked keys
// add p = 0, so a row that sees no key gives 0, never a NaN.  The output
// is acc / max(l, 1e-30), as on the TPU.
//
// Bound on the card: memory bandwidth.  Decode costs ~4 * G * hd flops
// per key against 2 * hd * sizeof(T) bytes of K and V, far below the
// ~295 flops per byte where an H100 turns compute-bound, so the least
// time is the K/V bytes the sequences need over 3.35 TB/s.  Extend at
// the main path's shapes (S = 256 after a cached prefix) sits at the bf16
// ridge: its bytes (q, K/V, out) and its tensor-core operations give about
// the same least time, the bytes slightly more; the fp32 variant on the
// CUDA cores is bound by its instructions.
//
// Left for later: no TMA and no cp.async staging (each K/V tile is
// loaded, then used), no wgmma (mma.sync reaches only part of the tensor
// cores' rate), and no split-K across CTAs, so a long context with few
// sequences leaves most SMs idle.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NW = 8;          // warps per CTA
constexpr int NT = NW * 32;    // threads per CTA

// Rows row0 .. row0+GR-1 of the S*G rows of (b, kvh).  Row r = s*G + g
// reads q[b, s, kvh, g, :] and writes out[b, s, kvh, g, :]; both are
// (B, S, KV, G, HD) contiguous.  Pools are (n_pool_rows, bs, KV, HD)
// contiguous; bt is (B, nb).  idx is lengths (decode) or pos0 (extend).
// Scores live in the log2 domain (q is scaled by scale * log2 e) so the
// softmax runs on exp2f; the result is the same softmax.
template <typename T, int HD, int GR>
__global__ void __launch_bounds__(NT) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ bt,
    const int* __restrict__ idx, T* __restrict__ out, int decode, int S,
    int KV, int G, int nb, int bs, int n_pool_rows, float scale) {
  constexpr int LPK = lanes_per_key<HD, GR>();  // lanes per key
  constexpr int VEC = HD / LPK;                 // head dims per lane
  constexpr int KPW = 32 / LPK;                 // keys a warp reads at once
  // keys per lane group per step, as many as ~200 registers allow
  constexpr int UR = (200 - 2 * GR * VEC) / (2 * VEC + GR);
  constexpr int U = UR < 1 ? 1 : (UR > 8 ? 8 : UR);
  constexpr int STEP = KPW * U;                 // keys per warp step
  static_assert(VEC % 4 == 0 && 32 % LPK == 0, "head_dim");

  const int b = blockIdx.x, kvh = blockIdx.y, row0 = blockIdx.z * GR;
  const int rows = min(GR, S * G - row0);
  const int pos0 = decode ? idx[b] - 1 : idx[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPK, gi = lane / LPK, d0 = sub * VEC;
  const int* bt_row = bt + (int64_t)b * nb;
  const float qscale = scale * LOG2E;

  float qr[GR][VEC], acc[GR][VEC], m[GR], l[GR];
  int lim[GR];                                  // last key a row may see
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    if (i < rows) {
      const int r = row0 + i, s = r / G, g = r - s * G;
      Vec<T, VEC>::load(
          q + ((((int64_t)b * S + s) * KV + kvh) * G + g) * HD + d0, qr[i]);
      lim[i] = pos0 + s;
    } else {
      lim[i] = -1;
#pragma unroll
      for (int d = 0; d < VEC; ++d) qr[i][d] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < VEC; ++d) {
      qr[i][d] *= qscale;
      acc[i][d] = 0.f;
    }
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  // the last key any row here may see, capped at the table's span
  const int n_keys = min(pos0 + (row0 + rows - 1) / G + 1, nb * bs);
  const int64_t key_stride = (int64_t)KV * HD;

  // warp-uniform loop: group gi of warp w reads keys base + gi*U + u
  for (int base = warp * STEP; base < n_keys; base += NW * STEP) {
    float kx[U][VEC], vx[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + gi * U + u;
      if (key < n_keys) {
        const int j = key / bs;
        // out-of-range table entries clamp, as a gather does in JAX
        const int phys = min(max(bt_row[j], 0), n_pool_rows - 1);
        const int64_t off = ((int64_t)phys * bs + (key - j * bs)) * key_stride
                            + (int64_t)kvh * HD + d0;
        Vec<T, VEC>::load(k_pool + off, kx[u]);
        Vec<T, VEC>::load(v_pool + off, vx[u]);
      } else {
#pragma unroll
        for (int d = 0; d < VEC; ++d) kx[u][d] = vx[u][d] = 0.f;
      }
    }
    float sc[U][GR];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < GR; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < VEC; ++d) dot += qr[i][d] * kx[u][d];
        sc[u][i] = dot;
      }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < GR; ++i)
          sc[u][i] += __shfl_xor_sync(0xffffffffu, sc[u][i], o);
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = base + gi * U + u;
        if (key >= n_keys || key > lim[i]) sc[u][i] = NEG_INF;
        mx = fmaxf(mx, sc[u][i]);
      }
      if (mx > m[i]) {                  // rescale only when the max grows
        const float corr = exp2f(m[i] - mx);
        l[i] *= corr;
#pragma unroll
        for (int d = 0; d < VEC; ++d) acc[i][d] *= corr;
        m[i] = mx;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = base + gi * U + u;
        const float p = (key < n_keys && key <= lim[i])
                            ? exp2f(sc[u][i] - mx) : 0.f;
        l[i] += p;
#pragma unroll
        for (int d = 0; d < VEC; ++d) acc[i][d] += p * vx[u][d];
      }
    }
  }

  // merge the groups of a warp
  merge_lane_groups<GR, VEC, LPK>(m, l, acc);

  // merge the warps through shared memory and write the rows
  __shared__ float m_s[NW][GR], l_s[NW][GR];
  __shared__ float a_s[NW][GR][HD];
  if (lane < LPK) {
#pragma unroll
    for (int i = 0; i < GR; ++i) {
#pragma unroll
      for (int d = 0; d < VEC; ++d) a_s[warp][i][d0 + d] = acc[i][d];
      if (sub == 0) {
        m_s[warp][i] = m[i];
        l_s[warp][i] = l[i];
      }
    }
  }
  __syncthreads();
  constexpr int OV = 4;                         // dims per output store
  for (int e = threadIdx.x; e < rows * (HD / OV); e += NT) {
    const int i = e / (HD / OV), dv = (e - i * (HD / OV)) * OV;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w][i]);
    float li = 0.f, o[OV] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = exp2f(m_s[w][i] - mx);
      li += l_s[w][i] * c;
#pragma unroll
      for (int d = 0; d < OV; ++d) o[d] += a_s[w][i][dv + d] * c;
    }
    const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int d = 0; d < OV; ++d) o[d] *= inv;
    const int r = row0 + i, s = r / G, g = r - s * G;
    Vec<T, OV>::store(
        out + ((((int64_t)b * S + s) * KV + kvh) * G + g) * HD + dv, o);
  }
}

// ---------------------------------------------------------------------
// bf16 extend on the tensor cores (mma.sync m16n8k16, fp32 accumulate).
// One CTA of XW warps owns XR = 16 * XW consecutive (query, head) rows of
// one (b, kv head); each warp owns 16 of them and keeps their Q fragments
// and the fp32 output accumulator in registers.  The CTA walks the keys
// the rows can see in tiles of XK keys: all threads copy the tile's K and
// V rows from the pool (through the block table) into shared memory with
// 16-byte loads, then each warp computes S = Q K^T for its rows, applies
// the causal mask key <= pos0 + s, updates its online softmax (m, l) in
// the log2 domain and accumulates P V.  The mma takes bf16 operands, so
// the fp32 P goes in as two parts, hi = bf16(P) and lo = bf16(P - hi),
// each multiplied into the same fp32 accumulator: P keeps ~16 of its 24
// bits (the TPU kernel's p @ v is fp32), at twice the mma of a bf16 P.
// V is bf16 in the pool and exact as an operand.  Rows padded to
// 8 extra bf16 per shared-memory row keep the fragment loads free of
// bank conflicts.  A warp whose rows see no key of a tile skips it.
constexpr int XW = 4;            // warps per CTA
constexpr int XR = 16 * XW;      // rows per CTA
constexpr int XK = 32;           // keys per shared-memory tile

template <int HD>
__global__ void __launch_bounds__(XW * 32) paged_extend_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ bt,
    const int* __restrict__ pos0s, __nv_bfloat16* __restrict__ out, int S,
    int KV, int G, int nb, int bs, int n_pool_rows, float scale) {
  constexpr int KS = HD / 16;              // k-steps of Q K^T
  constexpr int ND = HD / 8;               // n-tiles of P V
  constexpr int LD = HD + 8;               // padded shared row (bf16)
  constexpr int CH = HD / 8;               // 16-byte chunks per key row
  __shared__ __align__(16) __nv_bfloat16 ks[XK][LD];
  __shared__ __align__(16) __nv_bfloat16 vs[XK][LD];

  const int b = blockIdx.x, kvh = blockIdx.y, row0 = blockIdx.z * XR;
  const int n_rows = S * G;
  const int rows = min(XR, n_rows - row0);
  const int pos0 = pos0s[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma group / thread in group
  const int* bt_row = bt + (int64_t)b * nb;
  const float qscale = scale * LOG2E;

  // this thread's two rows: gq and gq + 8 of the warp's 16
  int lim[2];
  bool ok[2];
  int64_t qoff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + gq + 8 * h;
    ok[h] = r < n_rows;
    const int rr = ok[h] ? r : 0, s = rr / G, g = rr - s * G;
    lim[h] = ok[h] ? pos0 + s : -1;
    qoff[h] = ((((int64_t)b * S + s) * KV + kvh) * G + g) * HD;
  }
  uint32_t qa[KS][4];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j & 1, col = kc * 16 + 2 * tq + 8 * (j >> 1);
      qa[kc][j] = ok[h] ? *reinterpret_cast<const uint32_t*>(q + qoff[h] + col)
                        : 0u;
    }
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nd][j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // the last key any row here may see, capped at the table's span
  const int n_keys = min(pos0 + (row0 + rows - 1) / G + 1, nb * bs);
  // the last key any row of this warp may see (max over the 8 groups)
  int warp_last = max(lim[0], lim[1]);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
    warp_last = max(warp_last, __shfl_xor_sync(0xffffffffu, warp_last, o));
  const int64_t key_stride = (int64_t)KV * HD;

  for (int kb = 0; kb < n_keys; kb += XK) {
    __syncthreads();                       // the last tile is consumed
    for (int c = threadIdx.x; c < XK * CH; c += XW * 32) {
      const int t = c / CH, d = (c - t * CH) * 8, key = kb + t;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (key < n_keys) {
        const int j = key / bs;
        const int phys = min(max(bt_row[j], 0), n_pool_rows - 1);
        const int64_t off = ((int64_t)phys * bs + (key - j * bs)) * key_stride
                            + (int64_t)kvh * HD + d;
        kv4 = *reinterpret_cast<const uint4*>(k_pool + off);
        vv4 = *reinterpret_cast<const uint4*>(v_pool + off);
      }
      *reinterpret_cast<uint4*>(&ks[t][d]) = kv4;
      *reinterpret_cast<uint4*>(&vs[t][d]) = vv4;
    }
    __syncthreads();
    if (kb > warp_last) continue;          // no row of this warp sees it

    // S = Q K^T over the tile: XK / 8 n-tiles of 8 keys
    float sc[XK / 8][4];
#pragma unroll
    for (int nt = 0; nt < XK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
      const __nv_bfloat16* krow = &ks[nt * 8 + gq][2 * tq];
#pragma unroll
      for (int kc = 0; kc < KS; ++kc)
        mma_bf16(sc[nt], qa[kc],
                 *reinterpret_cast<const uint32_t*>(krow + kc * 16),
                 *reinterpret_cast<const uint32_t*>(krow + kc * 16 + 8));
    }
    // mask, running max, rescale
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < XK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1, key = kb + nt * 8 + 2 * tq + (j & 1);
        const bool vis = key < n_keys && key <= lim[h];
        sc[nt][j] = vis ? sc[nt][j] * qscale : NEG_INF;
        mx[h] = fmaxf(mx[h], sc[nt][j]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= corr[0]; o[nd][1] *= corr[0];
      o[nd][2] *= corr[1]; o[nd][3] *= corr[1];
    }
    // P V with P = hi + lo: XK / 16 k-steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < XK / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = j >> 1;
          const float x = sc[2 * kk + half][j];
          const float e = x > NEG_INF ? exp2f(x - m[h]) : 0.f;
          p[half][j] = e;
          l[h] += e;
        }
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_bf2(p[j >> 1][2 * (j & 1)], p[j >> 1][2 * (j & 1) + 1], ph[j],
                  pl[j]);
      const int k0 = kk * 16 + 2 * tq;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int d = nd * 8 + gq;
        const uint32_t b0 =
            (uint32_t)__bfloat16_as_ushort(vs[k0][d]) |
            ((uint32_t)__bfloat16_as_ushort(vs[k0 + 1][d]) << 16);
        const uint32_t b1 =
            (uint32_t)__bfloat16_as_ushort(vs[k0 + 8][d]) |
            ((uint32_t)__bfloat16_as_ushort(vs[k0 + 9][d]) << 16);
        mma_bf16(o[nd], pl, b0, b1);
        mma_bf16(o[nd], ph, b0, b1);
      }
    }
  }

  // finish: the quad's partial sums of l, then acc / max(l, 1e-30)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(out + qoff[h] + nd * 8 + 2 * tq) =
          f_to_bf2(o[nd][2 * h] * inv[h], o[nd][2 * h + 1] * inv[h]);
  }
}

template <int HD>
int launch_extend_mma(const void* q, const void* k_pool, const void* v_pool,
                      const void* bt, const void* pos0, void* out, int B,
                      int S, int KV, int G, int nb, int bs, int n_pool_rows,
                      float scale, cudaStream_t stream) {
  const dim3 grid(B, KV, (S * G + XR - 1) / XR);
  paged_extend_mma_kernel<HD><<<grid, XW * 32, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)bt, (const int*)pos0,
      (__nv_bfloat16*)out, S, KV, G, nb, bs, n_pool_rows, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD, int GR>
int launch(int decode, const void* q, const void* k_pool, const void* v_pool,
           const void* bt, const void* idx, void* out, int B, int S, int KV,
           int G, int nb, int bs, int n_pool_rows, float scale,
           cudaStream_t stream) {
  const dim3 grid(B, KV, (S * G + GR - 1) / GR);
  paged_attention_kernel<T, HD, GR><<<grid, NT, 0, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)bt,
      (const int*)idx, (T*)out, decode, S, KV, G, nb, bs, n_pool_rows, scale);
  return (int)cudaGetLastError();
}

// bf16 extend goes to the tensor cores; otherwise rows per CTA are the G
// heads of one kv head for decode (the smallest instantiated count that
// holds them) and 8 rows for fp32 extend
template <typename T, int HD>
int launch_rows(int decode, const void* q, const void* k_pool,
                const void* v_pool, const void* bt, const void* idx, void* out,
                int B, int S, int KV, int G, int nb, int bs, int n_pool_rows,
                float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (!decode)
      return launch_extend_mma<HD>(q, k_pool, v_pool, bt, idx, out, B, S, KV,
                                   G, nb, bs, n_pool_rows, scale, stream);
  }
  const int want = decode ? G : 8;
#define REPRO_LAUNCH(GR_)                                                    \
  return launch<T, HD, GR_>(decode, q, k_pool, v_pool, bt, idx, out, B, S,  \
                            KV, G, nb, bs, n_pool_rows, scale, stream)
  if (want <= 1) REPRO_LAUNCH(1);
  if (want <= 2) REPRO_LAUNCH(2);
  if (want <= 4) REPRO_LAUNCH(4);
  REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
}

template <typename T>
int launch_hd(int hd, int decode, const void* q, const void* k_pool,
              const void* v_pool, const void* bt, const void* idx, void* out,
              int B, int S, int KV, int G, int nb, int bs, int n_pool_rows,
              float scale, cudaStream_t stream) {
#define REPRO_HD(HD_)                                                        \
  return launch_rows<T, HD_>(decode, q, k_pool, v_pool, bt, idx, out, B, S, \
                             KV, G, nb, bs, n_pool_rows, scale, stream)
  switch (hd) {
    case 16: REPRO_HD(16);
    case 32: REPRO_HD(32);
    case 64: REPRO_HD(64);
    case 128: REPRO_HD(128);
    default: return -1;
  }
#undef REPRO_HD
}

int dispatch(int dtype, int hd, int decode, const void* q, const void* k_pool,
             const void* v_pool, const void* bt, const void* idx, void* out,
             int B, int S, int KV, int G, int nb, int bs, int n_pool_rows,
             float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(hd, decode, q, k_pool, v_pool, bt, idx, out, B,
                            S, KV, G, nb, bs, n_pool_rows, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, decode, q, k_pool, v_pool, bt, idx,
                                    out, B, S, KV, G, nb, bs, n_pool_rows,
                                    scale, st);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success), or -1 for a dtype / head_dim it has no kernel for.
extern "C" int repro_paged_decode_attention(
    int dtype, int hd, const void* q, const void* k_pool, const void* v_pool,
    const void* bt, const void* lengths, void* out, int B, int KV, int G,
    int nb, int bs, int n_pool_rows, float scale, void* stream) {
  return dispatch(dtype, hd, 1, q, k_pool, v_pool, bt, lengths, out, B, 1,
                  KV, G, nb, bs, n_pool_rows, scale, stream);
}

extern "C" int repro_paged_extend_attention(
    int dtype, int hd, const void* q, const void* k_pool, const void* v_pool,
    const void* bt, const void* pos0, void* out, int B, int S, int KV, int G,
    int nb, int bs, int n_pool_rows, float scale, void* stream) {
  return dispatch(dtype, hd, 0, q, k_pool, v_pool, bt, pos0, out, B, S, KV,
                  G, nb, bs, n_pool_rows, scale, stream);
}
