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
// contiguous; row b sees keys t < lengths[b].  The kernel is
// decode_sm90_kernel (decode_sm90.cuh), the split-key design shared with
// the paged decode: keys split over CTAs in chunks of DECODE_CHUNK, K/V
// rows brought in by TMA boxes of 16 rows into an mbarrier ring, the
// chunks merged by log-sum-exp in the same launch, so it reads only the
// live keys (the TPU kernel walks all L rows and masks them).  DenseRows below
// says where key row t lives, (b, t, kv head) of the stripe, and how many
// keys are live, min(max(lengths[b], 0), L).
//
// The TPU kernel's splits of L / n_splits rows are not kept: a split with
// no live key gets m = NEG_INF there and weight 2^(NEG_INF - m) = 0 in
// the merge, so both give the same result for every length >= 1.  A row
// of length 0 sees no key: every score of the TPU kernel is then NEG_INF,
// its softmax is uniform over all L rows and it returns the mean of V, as
// the plain versions do; DenseRows::no_keys computes that mean from V for
// such a row (the engine never asks for one: lengths = pos + 1).
//
// Bound on the card: memory bandwidth (decode_sm90.cuh).
#include "decode_sm90.cuh"

namespace {

struct DenseRows {
  static __device__ __forceinline__ int live(const DecodeParams& p, int b) {
    return min(max(p.lengths[b], 0), p.L);
  }
  // the (row, sequence) of the box starting at key t: a stage's rows of
  // the stripe, rows past L read as zeros
  static __device__ __forceinline__ int2 box(const DecodeParams&, int b,
                                             int t) {
    return make_int2(t, b);
  }
  // the element offset of key row t of kv head kvh in a cache
  template <int HD>
  static __device__ __forceinline__ int64_t row(const DecodeParams& p, int b,
                                                int kvh, int t) {
    return (((int64_t)b * p.L + t) * p.KV + kvh) * HD;
  }
  // a row of length 0: the mean of V over all L rows
  template <typename T, int HD>
  static __device__ void no_keys(const DecodeParams& p, int b, int kvh,
                                 int g0, int rows) {
    for (int d = 4 * threadIdx.x; d < HD; d += 4 * blockDim.x) {
      float o[4] = {0.f, 0.f, 0.f, 0.f}, x[4];
      for (int t = 0; t < p.L; ++t) {
        Vec<T, 4>::load((const T*)p.v + row<HD>(p, b, kvh, t) + d, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] += x[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] /= (float)max(p.L, 1);
      for (int r = 0; r < rows; ++r)
        Vec<T, 4>::store(
            (T*)p.out + ((int64_t)b * p.KV * p.G + kvh * p.G + g0 + r) * HD +
                d,
            o);
    }
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ws is an fp32 workspace of
// B * H * n_chunks * (hd + 2) floats and tickets B * KV * ceil(G / 8)
// int32 counters, zero before the first call (the kernel leaves them
// zero); n_chunks = ceil(L / DECODE_CHUNK).  Returns cudaGetLastError()
// after the launch (0 on success), -1 for a dtype / head_dim it has no
// kernel for, -2 if cuTensorMapEncodeTiled cannot be found, -3 if it
// refuses a tensor map.
extern "C" int repro_decode_attention(int dtype, int hd, const void* q,
                                      const void* k, const void* v,
                                      const void* lengths, void* out,
                                      void* ws, void* tickets, int B, int L,
                                      int KV, int G, int n_chunks,
                                      float scale, void* stream) {
  DecodeParams p = {};
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.lengths = (const int*)lengths;
  p.ws = (float*)ws;
  p.tickets = (int*)tickets;
  p.B = B; p.KV = KV; p.G = G; p.n_chunks = n_chunks;
  p.L = L;
  p.scale = scale;
  return launch_decode<DenseRows>(dtype, hd, p, L, B, 0, stream);
}
