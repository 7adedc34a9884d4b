// Diagonal selective-scan recurrence for Hopper (sm_90a):
//   h_t = a_t * h_{t-1} + b_t,   t = 0 .. S-1,   h_{-1} = h0,
// over every channel (b, d, n) of a_bar and b_bar (B, S, D, N), writing
// h_seq (B, S, D, N) and h_final (B, D, N); all fp32, contiguous.
// Hand-written CUDA C++; built by repro_torch/kernels/build.py into a
// shared library with a plain C interface and bound with ctypes.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssm_scan.py:ssm_scan_blocked
//     (body _scan_kernel)                                -> repro_ssm_scan
//
// Design.  The TPU grid is (B, D / block_d, S / chunk) with the chunk axis
// sequential: each grid step loads a (chunk, block_d, N) block into VMEM,
// closes the recurrence inside it with an associative scan and carries h
// to the next chunk in VMEM scratch.  CTAs carry nothing from one to the
// next, and the serve's shapes hold enough channels (D N = 131,072 a row)
// to give each thread of the card its own.  So one thread owns V = 4
// neighbouring channels (one float4) of one row and walks S in order with
// h in registers: no associative scan, no chunks, no carry through
// memory.  The sequential depth is S, but a step is one FMA per channel,
// and the time goes to memory.  At every step a warp's loads and stores
// cover 512 contiguous bytes, since neighbouring threads own neighbouring
// (d, n).  The loads do not depend on h, so they are issued ahead: two
// register buffers of U = 4 steps each, used in turn, so that the loads of
// one are in flight while the FMAs of the other run.  Ragged S needs no
// padding: steps t >= S are skipped (the TPU pads with a = 1, b = 0,
// which leaves every t < S unchanged).  Each element is touched once, so
// the loads take the evict-first hint (__ldcs) and the stores the
// streaming one (__stcs).  Where D N is not a multiple of 4, or a pointer
// is not 16-byte aligned, a thread owns V = 1 channel instead.
//
// Bound on the card: bytes.  12 bytes an element (a and b read, h_seq
// written) and 8 a channel (h0 read, h_final written) against 2 flops an
// element: at (4, 512, 8192, 16), 3.2 GB, 0.96 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;    // threads per CTA
constexpr int U = 4;            // steps per register buffer

template <int V>
struct Lanes;

template <>
struct Lanes<4> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  }
};

template <>
struct Lanes<1> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    x[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    __stcs(p, x[0]);
  }
};

// steps t0 .. t0 + U - 1 (those below S) of a thread's channels; a and b
// point at step 0 of them, C is the channel count of a row (D N)
template <int V>
__device__ __forceinline__ void load_steps(const float* a, const float* b,
                                           int64_t C, int t0, int S,
                                           float (&ra)[U][V],
                                           float (&rb)[U][V]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (t0 + u < S) {
      const int64_t off = (int64_t)(t0 + u) * C;
      Lanes<V>::load(a + off, ra[u]);
      Lanes<V>::load(b + off, rb[u]);
    }
  }
}

template <int V>
__device__ __forceinline__ void scan_steps(float* hs, int64_t C, int t0,
                                           int S, const float (&ra)[U][V],
                                           const float (&rb)[U][V],
                                           float (&h)[V]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (t0 + u < S) {
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = fmaf(ra[u][v], h[v], rb[u][v]);
      Lanes<V>::store(hs + (int64_t)(t0 + u) * C, h);
    }
  }
}

// grid (ceil(C / V / THREADS), B): thread -> channels c .. c + V - 1 of
// row blockIdx.y
template <int V>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ h0, float* __restrict__ hs,
                    float* __restrict__ hT, int S, int64_t C) {
  const int64_t c = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * V;
  if (c >= C) return;
  const int64_t first = (int64_t)blockIdx.y * S * C + c;    // step 0
  a += first;
  b += first;
  hs += first;
  const int64_t state = (int64_t)blockIdx.y * C + c;
  float h[V];
  Lanes<V>::load(h0 + state, h);
  float a0[U][V], b0[U][V], a1[U][V], b1[U][V];
  load_steps<V>(a, b, C, 0, S, a0, b0);
  for (int t = 0; t < S; t += 2 * U) {
    load_steps<V>(a, b, C, t + U, S, a1, b1);
    scan_steps<V>(hs, C, t, S, a0, b0, h);
    load_steps<V>(a, b, C, t + 2 * U, S, a0, b0);
    scan_steps<V>(hs, C, t + U, S, a1, b1, h);
  }
  Lanes<V>::store(hT + state, h);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// a, b, hs: (B, S, D, N) fp32; h0, hT: (B, D, N) fp32; all contiguous.
// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// shape the kernel does not take (B, S, D or N below 1, B above the grid's
// 65,535 rows).
extern "C" int repro_ssm_scan(const void* a, const void* b, const void* h0,
                              void* hs, void* hT, int B, int S, int D, int N,
                              void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || N < 1) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t C = (int64_t)D * N;
  const bool vec = C % 4 == 0 && aligned16(a) && aligned16(b) &&
                   aligned16(h0) && aligned16(hs) && aligned16(hT);
  const int64_t threads = vec ? C / 4 : C;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS), B);
  if (vec)
    ssm_scan_kernel<4><<<grid, THREADS, 0, st>>>(
        (const float*)a, (const float*)b, (const float*)h0, (float*)hs,
        (float*)hT, S, C);
  else
    ssm_scan_kernel<1><<<grid, THREADS, 0, st>>>(
        (const float*)a, (const float*)b, (const float*)h0, (float*)hs,
        (float*)hT, S, C);
  return (int)cudaGetLastError();
}
