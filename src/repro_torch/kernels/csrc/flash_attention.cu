// Flash attention for Hopper (sm_90a): blocked online-softmax attention
// over a whole sequence (the dense prefill of every admit).  Hand-written
// CUDA C++; built by repro_torch/kernels/build.py into a shared library
// with a plain C interface and bound with ctypes.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention.py:flash_attention_bhsd
//     (body _flash_kernel)  -> repro_flash_attention
//
// q and out are (B, S, H, hd), k and v (B, S, KV, hd), all contiguous: the
// kernels read the model's layout directly, with no transposes and no pad
// copies.  Query s of head h = kvh * G + g sees key t iff t < S, t <= s when
// causal, and t > s - window when window > 0 (the TPU kernel's masks).
// Rows are the (query, head) pairs r = s * G + g of one (b, kv head), so the
// G heads that share a K/V head share every K/V tile a CTA loads.  A CTA
// walks only the key tiles its rows can see (the TPU kernel's `needed`
// skip), keys >= S are never read and rows >= S never written.  Masked
// scores are the finite NEG_INF and masked keys add p = 0; the output is
// acc / max(l, 1e-30), as on the TPU.
//
// Two kernels:
//
// flash_mma_kernel (bf16), on the tensor cores with mma.sync.m16n8k16, the
// design of paged_extend_mma_kernel (paged_attention.cu) without the block
// table.  A CTA of XW warps owns XR = 16 * XW rows; each warp keeps the Q
// fragments and the fp32 output accumulator of its 16 rows in registers.
// The CTA copies XK-key K/V tiles into padded shared memory with 16-byte
// loads; each warp computes S = Q K^T, masks, updates its online softmax
// in the log2 domain and accumulates P V.  As in the TPU kernel P stays
// fp32: it enters the bf16 mma as hi = bf16(P) plus lo = bf16(P - hi)
// (relative error <= 2^-18), both into the same fp32 accumulator.
//
// flash_simt_kernel (fp32), on the CUDA cores, the design of
// paged_attention_kernel without the block table: lane groups of LPK
// lanes each stream their own keys from device memory, hold GR rows'
// online softmax in registers, and merge by shuffles and through shared
// memory at the end.
//
// Bound on the card: at the main path's shapes (bf16, B = 3, S = 512
// causal, H = 16, KV = 8, hd = 128) the least time from the bytes (q, k, v
// read once, out written once: 19 MB, 5.6 us at 3.35 TB/s) and from the
// tensor-core operations (3.2 GFLOP, 3.3 us at 989 TFLOP/s) are close,
// the bytes slightly ahead: a prefill this short sits just below the bf16
// ridge (~295 flops per byte), longer ones above it.  The design reaches
// neither: mma.sync instead of wgmma, no TMA or cp.async, so each tile is
// loaded and then used, and P V runs two mma (hi and lo) per step.  fp32
// on the CUDA cores is bound by its instructions.
#include <limits.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------
// bf16 on the tensor cores
constexpr int XW = 4;            // warps per CTA
constexpr int XR = 16 * XW;      // rows per CTA
constexpr int XK = 32;           // keys per shared-memory tile

template <int HD>
__global__ void __launch_bounds__(XW * 32) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int S, int KV, int G, int causal, int window, float scale) {
  constexpr int KS = HD / 16;              // k-steps of Q K^T
  constexpr int ND = HD / 8;               // n-tiles of P V
  constexpr int LD = HD + 8;               // padded shared row (bf16)
  constexpr int CH = HD / 8;               // 16-byte chunks per key row
  __shared__ __align__(16) __nv_bfloat16 ks[XK][LD];
  __shared__ __align__(16) __nv_bfloat16 vs[XK][LD];

  const int b = blockIdx.x, kvh = blockIdx.y, row0 = blockIdx.z * XR;
  const int n_rows = S * G;
  const int rows = min(XR, n_rows - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma group / thread in group
  const float qscale = scale * LOG2E;

  // this thread's two rows: gq and gq + 8 of the warp's 16; each sees the
  // keys lo[h] <= t <= hi[h]
  int hi[2], lo[2];
  bool ok[2];
  int64_t qoff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + gq + 8 * h;
    ok[h] = r < n_rows;
    const int rr = ok[h] ? r : 0, s = rr / G, g = rr - s * G;
    hi[h] = ok[h] ? (causal ? s : S - 1) : -1;
    lo[h] = ok[h] ? (window ? max(s - window + 1, 0) : 0) : INT_MAX;
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

  // the keys any row of the CTA can see: [k_lo, n_keys)
  const int s_first = row0 / G, s_last = (row0 + rows - 1) / G;
  const int n_keys = causal ? s_last + 1 : S;
  const int k_lo = window ? max(s_first - window + 1, 0) : 0;
  // the keys any row of this warp can see (over the 8 mma groups)
  int warp_hi = max(hi[0], hi[1]), warp_lo = min(lo[0], lo[1]);
#pragma unroll
  for (int sh = 4; sh < 32; sh <<= 1) {
    warp_hi = max(warp_hi, __shfl_xor_sync(0xffffffffu, warp_hi, sh));
    warp_lo = min(warp_lo, __shfl_xor_sync(0xffffffffu, warp_lo, sh));
  }
  const int64_t key_stride = (int64_t)KV * HD;
  const int64_t base_kv = (int64_t)b * S * key_stride + (int64_t)kvh * HD;

  for (int kb = k_lo - k_lo % XK; kb < n_keys; kb += XK) {
    __syncthreads();                       // the last tile is consumed
    for (int c = threadIdx.x; c < XK * CH; c += XW * 32) {
      const int t = c / CH, d = (c - t * CH) * 8, key = kb + t;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (key < n_keys) {
        const int64_t off = base_kv + (int64_t)key * key_stride + d;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[t][d]) = kv4;
      *reinterpret_cast<uint4*>(&vs[t][d]) = vv4;
    }
    __syncthreads();
    // no row of this warp sees the tile
    if (kb > warp_hi || kb + XK - 1 < warp_lo) continue;

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
        const bool vis = key < n_keys && key <= hi[h] && key >= lo[h];
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

// ---------------------------------------------------------------------
// fp32 on the CUDA cores
constexpr int NW = 8;            // warps per CTA
constexpr int NT = NW * 32;      // threads per CTA
constexpr int GR = 8;            // rows per CTA

template <int HD>
__global__ void __launch_bounds__(NT) flash_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S, int KV,
    int G, int causal, int window, float scale) {
  constexpr int LPK = lanes_per_key<HD, GR>();  // lanes per key
  constexpr int VEC = HD / LPK;                   // head dims per lane
  constexpr int KPW = 32 / LPK;                   // keys a warp reads at once
  // keys per lane group per step, as many as ~200 registers allow
  constexpr int UR = (200 - 2 * GR * VEC) / (2 * VEC + GR);
  constexpr int U = UR < 1 ? 1 : (UR > 8 ? 8 : UR);
  constexpr int STEP = KPW * U;                   // keys per warp step
  static_assert(VEC % 4 == 0 && 32 % LPK == 0, "head_dim");

  const int b = blockIdx.x, kvh = blockIdx.y, row0 = blockIdx.z * GR;
  const int rows = min(GR, S * G - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPK, gi = lane / LPK, d0 = sub * VEC;
  const float qscale = scale * LOG2E;

  float qr[GR][VEC], acc[GR][VEC], m[GR], l[GR];
  int hi[GR], lo[GR];                           // keys a row may see
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    if (i < rows) {
      const int r = row0 + i, s = r / G, g = r - s * G;
      Vec<float, VEC>::load(
          q + ((((int64_t)b * S + s) * KV + kvh) * G + g) * HD + d0, qr[i]);
      hi[i] = causal ? s : S - 1;
      lo[i] = window ? max(s - window + 1, 0) : 0;
    } else {
      hi[i] = -1;
      lo[i] = INT_MAX;
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
  // the keys any row of the CTA can see: [k_lo, n_keys)
  const int s_first = row0 / G, s_last = (row0 + rows - 1) / G;
  const int n_keys = causal ? s_last + 1 : S;
  const int k_lo = window ? max(s_first - window + 1, 0) : 0;
  const int64_t key_stride = (int64_t)KV * HD;
  const int64_t base_kv =
      (int64_t)b * S * key_stride + (int64_t)kvh * HD + d0;

  // warp-uniform loop: group gi of warp w reads keys base + gi*U + u
  for (int base = k_lo + warp * STEP; base < n_keys; base += NW * STEP) {
    float kx[U][VEC], vx[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + gi * U + u;
      if (key < n_keys) {
        const int64_t off = base_kv + (int64_t)key * key_stride;
        Vec<float, VEC>::load(k + off, kx[u]);
        Vec<float, VEC>::load(v + off, vx[u]);
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
    for (int sh = LPK / 2; sh > 0; sh >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < GR; ++i)
          sc[u][i] += __shfl_xor_sync(0xffffffffu, sc[u][i], sh);
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      float mx = m[i];
      bool vis[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = base + gi * U + u;
        vis[u] = key < n_keys && key <= hi[i] && key >= lo[i];
        if (!vis[u]) sc[u][i] = NEG_INF;
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
        const float p = vis[u] ? exp2f(sc[u][i] - mx) : 0.f;
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
    Vec<float, OV>::store(
        out + ((((int64_t)b * S + s) * KV + kvh) * G + g) * HD + dv, o);
  }
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           void* out, int B, int S, int KV, int G, int causal, int window,
           float scale, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid(B, KV, (S * G + XR - 1) / XR);
    flash_mma_kernel<HD><<<grid, XW * 32, 0, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, KV, G, causal,
        window, scale);
  } else {
    const dim3 grid(B, KV, (S * G + GR - 1) / GR);
    flash_simt_kernel<HD><<<grid, NT, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, S,
        KV, G, causal, window, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; causal: 0 or 1; window: 0 for none.
// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// dtype / head_dim it has no kernel for.
extern "C" int repro_flash_attention(int dtype, int hd, const void* q,
                                     const void* k, const void* v, void* out,
                                     int B, int S, int KV, int G, int causal,
                                     int window, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, out, B, S, KV, G, causal,
                               window, scale, st);
    case 32: return launch<32>(dtype, q, k, v, out, B, S, KV, G, causal,
                               window, scale, st);
    case 64: return launch<64>(dtype, q, k, v, out, B, S, KV, G, causal,
                               window, scale, st);
    case 128: return launch<128>(dtype, q, k, v, out, B, S, KV, G, causal,
                                 window, scale, st);
    default: return -1;
  }
}
