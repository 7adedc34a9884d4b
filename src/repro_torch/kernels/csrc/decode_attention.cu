// Split-K flash-decode for Hopper (sm_90a): one query per sequence over a
// dense KV cache, the cache length split across CTAs.  Hand-written CUDA
// C++; built by repro_torch/kernels/build.py into a shared library with a
// plain C interface and bound with ctypes.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention.py:decode_attention_bhd
//     (body _decode_kernel, merge in the wrapper)  -> repro_decode_attention
//
// q and out are (B, H, hd), k and v the caches (B, L, KV, hd), all
// contiguous; row b sees keys t < lengths[b].  Two launches:
//
// decode_split_kernel, grid (B, KV * row groups, n_splits): the CTA
// (b, kv head, split) reads only its share of the live keys, the split-th
// of n_splits chunks of ceil(length / n_splits) keys, so no key at or
// past lengths[b] is read (the TPU kernel walks all L rows and masks
// them).  It serves the G query heads that share one K/V head (GR >= G
// rows, or several row groups when G > 8), so each K/V row is read once
// per split.  Lane groups of LPK lanes stream their own keys from device
// memory with 16-byte loads and keep each row's online softmax (m, l, acc)
// in fp32 registers, with scores in the log2 domain; the groups merge by
// shuffles and the warps through shared memory (the design of
// paged_attention_kernel without the block table).  The CTA writes its
// fp32 partial (m, l, acc) to a workspace.
//
// decode_merge_kernel, grid (B, H): the log-sum-exp merge of the splits,
// out = sum_s acc_s * 2^(m_s - m) / max(sum_s l_s * 2^(m_s - m), 1e-30).
// A split with no live key writes nothing and is left out of the merge;
// the TPU kernel gives it m = NEG_INF and weight 2^(NEG_INF - m) = 0, so
// both give the same result for every length >= 1.  A row of length 0
// sees no key: every score of the TPU kernel is then NEG_INF, its softmax
// is uniform over all L rows and it returns the mean of V, as the plain
// versions do; the merge computes that mean from V for such a row (the
// engine never asks for one: lengths = pos + 1).
//
// Bound on the card: memory bandwidth.  One query costs ~4 * G * hd flops
// per key against 2 * hd * sizeof(T) bytes of K and V, far below the ~295
// flops per byte where an H100 turns compute-bound, so the least time is
// the live K/V bytes over 3.35 TB/s.  Split-K gives B * KV * n_splits
// CTAs (512 at the main path's 8 slots, 8 kv heads, 8 splits) to keep
// enough loads in flight; the merge is a second, small launch.
#include "common.cuh"

namespace {

constexpr int DW = 4;            // warps per split CTA
constexpr int DT = DW * 32;      // threads per split CTA

// the keys [k0, k1) of split `split` of a row of `length` live keys
__device__ __forceinline__ void split_range(int length, int n_splits,
                                            int split, int& k0, int& k1) {
  const int chunk = (length + n_splits - 1) / n_splits;
  k0 = split * chunk;
  k1 = min(length, k0 + chunk);
}

__device__ __forceinline__ int live_length(const int* lengths, int b, int L) {
  return min(max(lengths[b], 0), L);
}

template <typename T, int HD, int GR>
__global__ void __launch_bounds__(DT) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml, int L, int KV,
    int G, int n_splits, float scale) {
  constexpr int LPK = lanes_per_key<HD, GR>();  // lanes per key
  constexpr int VEC = HD / LPK;                 // head dims per lane
  constexpr int KPW = 32 / LPK;                 // keys a warp reads at once
  // keys per lane group per step, as many as ~200 registers allow
  constexpr int UR = (200 - 2 * GR * VEC) / (2 * VEC + GR);
  constexpr int U = UR < 1 ? 1 : (UR > 8 ? 8 : UR);
  constexpr int STEP = KPW * U;                 // keys per warp step
  static_assert(VEC % 4 == 0 && 32 % LPK == 0, "head_dim");

  const int n_rg = (G + GR - 1) / GR;           // row groups per kv head
  const int b = blockIdx.x, kvh = blockIdx.y / n_rg;
  const int g0 = (blockIdx.y - kvh * n_rg) * GR, split = blockIdx.z;
  const int rows = min(GR, G - g0);
  int k0, k1;
  split_range(live_length(lengths, b, L), n_splits, split, k0, k1);
  if (k0 >= k1) return;                         // no live key: no partial

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPK, gi = lane / LPK, d0 = sub * VEC;
  const float qscale = scale * LOG2E;
  const int H = KV * G;

  float qr[GR][VEC], acc[GR][VEC], m[GR], l[GR];
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    if (i < rows)
      Vec<T, VEC>::load(q + ((int64_t)b * H + kvh * G + g0 + i) * HD + d0,
                        qr[i]);
    else
#pragma unroll
      for (int d = 0; d < VEC; ++d) qr[i][d] = 0.f;
#pragma unroll
    for (int d = 0; d < VEC; ++d) {
      qr[i][d] *= qscale;
      acc[i][d] = 0.f;
    }
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  const int64_t key_stride = (int64_t)KV * HD;
  const int64_t base_kv =
      (int64_t)b * L * key_stride + (int64_t)kvh * HD + d0;

  // warp-uniform loop: group gi of warp w reads keys base + gi*U + u
  for (int base = k0 + warp * STEP; base < k1; base += DW * STEP) {
    float kx[U][VEC], vx[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + gi * U + u;
      if (key < k1) {
        const int64_t off = base_kv + (int64_t)key * key_stride;
        Vec<T, VEC>::load(k + off, kx[u]);
        Vec<T, VEC>::load(v + off, vx[u]);
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
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (base + gi * U + u >= k1) sc[u][i] = NEG_INF;
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
        const float p = base + gi * U + u < k1 ? exp2f(sc[u][i] - mx) : 0.f;
        l[i] += p;
#pragma unroll
        for (int d = 0; d < VEC; ++d) acc[i][d] += p * vx[u][d];
      }
    }
  }

  // merge the groups of a warp
  merge_lane_groups<GR, VEC, LPK>(m, l, acc);

  // merge the warps through shared memory; write the split's partials
  __shared__ float m_s[DW][GR], l_s[DW][GR];
  __shared__ float a_s[DW][GR][HD];
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
  for (int e = threadIdx.x; e < rows * HD; e += DT) {
    const int i = e / HD, d = e - i * HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < DW; ++w) mx = fmaxf(mx, m_s[w][i]);
    float li = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const float c = exp2f(m_s[w][i] - mx);
      li += l_s[w][i] * c;
      o += a_s[w][i][d] * c;
    }
    const int64_t row = ((int64_t)b * H + kvh * G + g0 + i) * n_splits + split;
    ws_acc[row * HD + d] = o;
    if (d == 0) {
      ws_ml[2 * row] = mx;
      ws_ml[2 * row + 1] = li;
    }
  }
}

// one CTA per (b, head), HD / 4 threads of 4 dims each
template <typename T, int HD>
__global__ void __launch_bounds__(HD / 4) decode_merge_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    const int* __restrict__ lengths, const T* __restrict__ v,
    T* __restrict__ out, int L, int KV, int G, int n_splits) {
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x * 4;
  const int length = live_length(lengths, b, L), H = KV * G;
  if (length == 0) {                  // the mean of V over all L rows
    float o[4] = {0.f, 0.f, 0.f, 0.f}, x[4];
    for (int t = 0; t < L; ++t) {
      Vec<T, 4>::load(v + (((int64_t)b * L + t) * KV + h / G) * HD + d, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] += x[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] /= (float)max(L, 1);
    Vec<T, 4>::store(out + ((int64_t)b * H + h) * HD + d, o);
    return;
  }
  const int64_t row0 = ((int64_t)b * H + h) * n_splits;
  float mx = NEG_INF;
  for (int s = 0; s < n_splits; ++s) {
    int k0, k1;
    split_range(length, n_splits, s, k0, k1);
    if (k0 < k1) mx = fmaxf(mx, ws_ml[2 * (row0 + s)]);
  }
  float li = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < n_splits; ++s) {
    int k0, k1;
    split_range(length, n_splits, s, k0, k1);
    if (k0 >= k1) continue;
    const float c = exp2f(ws_ml[2 * (row0 + s)] - mx);
    li += ws_ml[2 * (row0 + s) + 1] * c;
    const float4 a =
        *reinterpret_cast<const float4*>(ws_acc + (row0 + s) * HD + d);
    o[0] += a.x * c; o[1] += a.y * c; o[2] += a.z * c; o[3] += a.w * c;
  }
  const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] *= inv;
  Vec<T, 4>::store(out + ((int64_t)b * H + h) * HD + d, o);
}

template <typename T, int HD, int GR_>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, float* ws_acc, float* ws_ml, int B, int L, int KV,
           int G, int n_splits, float scale, cudaStream_t stream) {
  const dim3 grid(B, KV * ((G + GR_ - 1) / GR_), n_splits);
  decode_split_kernel<T, HD, GR_><<<grid, DT, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, ws_acc,
      ws_ml, L, KV, G, n_splits, scale);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  decode_merge_kernel<T, HD><<<dim3(B, KV * G), HD / 4, 0, stream>>>(
      ws_acc, ws_ml, (const int*)lengths, (const T*)v, (T*)out, L, KV, G,
      n_splits);
  return (int)cudaGetLastError();
}

// rows per CTA: the smallest instantiated count that holds the G heads
template <typename T, int HD>
int launch_rows(const void* q, const void* k, const void* v,
                const void* lengths, void* out, float* ws_acc, float* ws_ml,
                int B, int L, int KV, int G, int n_splits, float scale,
                cudaStream_t stream) {
#define REPRO_LAUNCH(GR_)                                                  \
  return launch<T, HD, GR_>(q, k, v, lengths, out, ws_acc, ws_ml, B, L,   \
                            KV, G, n_splits, scale, stream)
  if (G <= 1) REPRO_LAUNCH(1);
  if (G <= 2) REPRO_LAUNCH(2);
  if (G <= 4) REPRO_LAUNCH(4);
  REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* lengths, void* out, float* ws_acc, float* ws_ml,
              int B, int L, int KV, int G, int n_splits, float scale,
              cudaStream_t stream) {
#define REPRO_HD(HD_)                                                      \
  return launch_rows<T, HD_>(q, k, v, lengths, out, ws_acc, ws_ml, B, L,  \
                             KV, G, n_splits, scale, stream)
  switch (hd) {
    case 16: REPRO_HD(16);
    case 32: REPRO_HD(32);
    case 64: REPRO_HD(64);
    case 128: REPRO_HD(128);
    default: return -1;
  }
#undef REPRO_HD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ws is an fp32 workspace of
// B * H * n_splits * (hd + 2) floats: the partial acc (B, H, n_splits, hd),
// then (m, l) (B, H, n_splits, 2).  Returns cudaGetLastError() after the
// launches (0 on success), or -1 for a dtype / head_dim it has no kernel
// for.
extern "C" int repro_decode_attention(int dtype, int hd, const void* q,
                                      const void* k, const void* v,
                                      const void* lengths, void* out,
                                      void* ws, int B, int L, int KV, int G,
                                      int n_splits, float scale,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* ws_acc = (float*)ws;
  float* ws_ml = ws_acc + (int64_t)B * KV * G * n_splits * hd;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, lengths, out, ws_acc, ws_ml, B, L,
                            KV, G, n_splits, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, lengths, out, ws_acc,
                                    ws_ml, B, L, KV, G, n_splits, scale, st);
  return -1;
}
