// Phase-2 pair scoring for Hopper (sm_90a): the bilinear link score of
// every (claim, evidence) pair,
//   score[i, j] = c_i^T W e_j + w_c . c_i + w_e . e_j + b.
// Hand-written CUDA C++; built by repro_torch/kernels/build.py into a
// shared library with a plain C interface and bound with ctypes.
//
// Replaces the TPU kernel
//   src/repro/kernels/pair_score.py:pair_score_blocked
//     (body _pair_kernel)        -> repro_pair_score_sm90, repro_pair_score
//
// claims C (N, d), evidence E (M, d), W (d, d), w_c and w_e (d,), each
// contiguous, fp32 or bf16 (C and E share one type; W, w_c and w_e
// another); bias is one fp32 value in device memory; out (N, M) is fp32.
// The TPU kernel keeps CW = C_blk W in VMEM across its sequential
// evidence axis; CTAs cannot carry it from one to the next, so here the
// projection P = C W is one launch into an fp32 workspace (N x d, then
// lin = [C w_c ; E w_e], N + M), and out = P E^T + lin + b a second.
// kernels/pair_plan.py picks the route from the shapes and dtypes:
//
// 1. fp32 inputs with d % 4 == 0 (MARGOT's batch and stream, d = 1024):
//    3xTF32 on wgmma with a TMA ring and the depth split over a cluster,
//    pair_sm90.cuh (repro_pair_score_sm90).  Bound on the card:
//    operations, 2 N d (d + M) + 2 (N + M) d flops as three TF32 products
//    each at 495 TFLOP/s against (N d + M d + d^2 + 2 d + N M) * 4 bytes
//    at 3.35 TB/s: at N = 256, M = 512, d = 1024, 3 x 0.807 GFLOP, 0.0049
//    ms (7.9 MB, 0.0023 ms); at 1024^3, 0.0260 ms (16.8 MB, 0.0050 ms).
//    (On the CUDA cores, the fp32 peak of 67 TFLOP/s, the same work would
//    take 0.0120 and 0.0641 ms.)  One TF32 product keeps about three
//    decimal digits, which moves scores near 0 across it and so changes
//    which links exist; three (hi and lo parts of both operands) keep
//    fp32's.
// 2. bf16 inputs, or d % 4 != 0 (TMA needs 16-byte rows): the kernels
//    below on the CUDA cores (repro_pair_score).  Every element is
//    converted to fp32 on load and every product and sum is an fp32 FMA,
//    as _pair_kernel casts to fp32 and accumulates in fp32.
//      project_kernel: P = C W into the workspace; the CTAs past the tiles
//        compute lin, one warp per row with a shuffle reduction;
//      score_kernel: out = P E^T + lin[i] + lin[N + j] + b.
//    A tile is a 32 x 32 block of outputs for one CTA of 256 threads: four
//    depth groups of 64 threads, each thread holding 4 x 4 outputs in
//    registers.  Group g walks the depth steps g, g + 4, g + 8, ... of 32,
//    staging both operand tiles in its own shared memory, k-major, so that
//    a thread reads its 4 rows and its 4 columns as two float4 per step
//    (the transposed writes hit 32 distinct banks), and holding the next
//    step's elements in registers while it computes on the current one; at
//    the end the groups' partial sums are added in shared memory.  Loads
//    are scalar, neighbouring threads on neighbouring addresses, and the
//    ragged edges (any N, M, d >= 1) are masked on load and on store, so
//    nothing is padded and no alignment beyond the element's is needed.
#include "common.cuh"
#include "pair_sm90.cuh"

namespace {

constexpr int TM = 32;          // output rows per tile
constexpr int TN = 32;          // output columns per tile
constexpr int TK = 32;          // depth per shared-memory step
constexpr int GT = 64;          // threads per depth group: 8 x 8, 4 x 4 outputs each
constexpr int KS = 4;           // depth groups per CTA
constexpr int PT = GT * KS;     // threads per CTA
constexpr int PAD = 4;          // row padding that keeps float4 reads aligned

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// acc = A[i0:i0+TM, :K] B[:K, j0:j0+TN] in the threads of depth group 0
// (threadIdx.x < GT).  A is (rows, K) row-major.  B is (K, cols)
// row-major (B_ROWS false: W), or given by the rows of B^T, a (cols, K)
// row-major matrix (B_ROWS true: E).  Rows, columns and depth past the
// edges load as 0.
template <typename TA, typename TB, bool B_ROWS>
__device__ __forceinline__ void tile_product(const TA* __restrict__ A,
                                             const TB* __restrict__ B,
                                             int rows, int cols, int K,
                                             int i0, int j0,
                                             float (&acc)[4][4]) {
  constexpr int LA = TM * TK / GT, LB = TN * TK / GT;   // loads a thread
  static_assert(TM == 32 && TN == 32 && TK == 32 && GT == 64, "mapping");
  __shared__ __align__(16) float As[KS][TK][TM + PAD];
  __shared__ __align__(16) float Bs[KS][TK][TN + PAD];
  const int g = threadIdx.x / GT, tid = threadIdx.x % GT;
  const int tx = tid % 8, ty = tid / 8;
  float ra[LA], rb[LB];
  // A tile element l of a thread: row tr(l), depth tc(l).  A warp reads 8
  // neighbouring depths of 4 rows (four 32-byte sectors) and writes them
  // transposed, As[depth][row], to 32 distinct banks (a row of As is 36
  // floats: bank 4 * depth + row).  B's element l: depth l * 2 + tid / 32
  // and column tid % 32 (a warp reads 128 neighbouring bytes of W), or,
  // with B_ROWS, column tr(l) and depth tc(l) as for A.
  const int lane = tid % 32, w = tid / 32;
  auto tr = [&](int l) { return lane / 8 + 4 * ((w + 2 * l) / 4); };
  auto tc = [&](int l) { return lane % 8 + 8 * ((w + 2 * l) % 4); };
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int i = i0 + tr(l), k = k0 + tc(l);
      ra[l] = (i < rows && k < K) ? to_f(A[(int64_t)i * K + k]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      if constexpr (B_ROWS) {
        const int j = j0 + tr(l), k = k0 + tc(l);
        rb[l] = (j < cols && k < K) ? to_f(B[(int64_t)j * K + k]) : 0.f;
      } else {
        const int k = k0 + 2 * l + w, j = j0 + lane;
        rb[l] = (k < K && j < cols) ? to_f(B[(int64_t)k * cols + j]) : 0.f;
      }
    }
  };
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  const int steps = cdiv(K, KS * TK);          // the same for every group
  load(g * TK);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int l = 0; l < LA; ++l) As[g][tc(l)][tr(l)] = ra[l];
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      if constexpr (B_ROWS) Bs[g][tc(l)][tr(l)] = rb[l];
      else Bs[g][2 * l + w][lane] = rb[l];
    }
    __syncthreads();
    if (s + 1 < steps) load(((s + 1) * KS + g) * TK);   // in flight now
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[g][k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[g][k][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
  // add groups 1..KS-1's partial sums into group 0's, through As
  static_assert((KS - 1) * GT * 16 <= KS * TK * (TM + PAD), "reduction");
  float* red = &As[0][0][0];
  if (g > 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        red[((g - 1) * GT + tid) * 16 + a * 4 + b] = acc[a][b];
  }
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int o = 1; o < KS; ++o)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] += red[((o - 1) * GT + tid) * 16 + a * 4 + b];
  }
}

// grid: tiles_i * tiles_j tile CTAs (P = C W), then cdiv(N + M, PT / 32)
// CTAs of one row per warp (lin)
template <typename T, typename U>
__global__ void __launch_bounds__(PT) project_kernel(
    const T* __restrict__ C, const T* __restrict__ E, const U* __restrict__ W,
    const U* __restrict__ w_c, const U* __restrict__ w_e,
    float* __restrict__ P, float* __restrict__ lin, int N, int M, int d,
    int n_tiles, int tiles_j) {
  if ((int)blockIdx.x < n_tiles) {            // CTA-uniform branch
    const int i0 = (blockIdx.x / tiles_j) * TM;
    const int j0 = (blockIdx.x % tiles_j) * TN;
    float acc[4][4];
    tile_product<T, U, false>(C, W, N, d, d, i0, j0, acc);
    if (threadIdx.x >= GT) return;              // group 0 holds the sums
    const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
      if (i >= N) break;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = j0 + tx * 4 + b;
        if (j < d) P[(int64_t)i * d + j] = acc[a][b];
      }
    }
    return;
  }
  const int row = (blockIdx.x - n_tiles) * (PT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= N + M) return;                   // warp-uniform
  const T* x = row < N ? C + (int64_t)row * d : E + (int64_t)(row - N) * d;
  const U* w = row < N ? w_c : w_e;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s = fmaf(to_f(x[k]), to_f(w[k]), s);
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) s += __shfl_xor_sync(0xffffffffu, s, sh);
  if (lane == 0) lin[row] = s;
}

// grid: tiles_i * tiles_j tile CTAs of out = P E^T + lin_c + lin_e + b
template <typename T>
__global__ void __launch_bounds__(PT) score_kernel(
    const float* __restrict__ P, const T* __restrict__ E,
    const float* __restrict__ lin, const float* __restrict__ bias,
    float* __restrict__ out, int N, int M, int d, int tiles_j) {
  const int i0 = (blockIdx.x / tiles_j) * TM;
  const int j0 = (blockIdx.x % tiles_j) * TN;
  float acc[4][4];
  tile_product<float, T, true>(P, E, N, M, d, i0, j0, acc);
  if (threadIdx.x >= GT) return;                // group 0 holds the sums
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const float b0 = *bias;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= N) break;
    const float lc = lin[i];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx * 4 + b;
      if (j < M) out[(int64_t)i * M + j] = acc[a][b] + lc + lin[N + j] + b0;
    }
  }
}

template <typename T, typename U>
int launch(const void* C, const void* E, const void* W, const void* w_c,
           const void* w_e, const void* bias, void* out, float* ws, int N,
           int M, int d, cudaStream_t stream) {
  float* P = ws;
  float* lin = ws + (int64_t)N * d;
  const int tiles_i = cdiv(N, TM), tiles_w = cdiv(d, TN);
  const int n_tiles = tiles_i * tiles_w;
  project_kernel<T, U><<<n_tiles + cdiv(N + M, PT / 32), PT, 0, stream>>>(
      (const T*)C, (const T*)E, (const U*)W, (const U*)w_c, (const U*)w_e, P,
      lin, N, M, d, n_tiles, tiles_w);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int tiles_e = cdiv(M, TN);
  score_kernel<T><<<tiles_i * tiles_e, PT, 0, stream>>>(
      P, (const T*)E, lin, (const float*)bias, (float*)out, N, M, d,
      tiles_e);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(int w_dtype, const void* C, const void* E, const void* W,
             const void* w_c, const void* w_e, const void* bias, void* out,
             float* ws, int N, int M, int d, cudaStream_t stream) {
  if (w_dtype == 0)
    return launch<T, float>(C, E, W, w_c, w_e, bias, out, ws, N, M, d,
                            stream);
  if (w_dtype == 1)
    return launch<T, __nv_bfloat16>(C, E, W, w_c, w_e, bias, out, ws, N, M,
                                    d, stream);
  return -1;
}

}  // namespace

// c_dtype (claims, evidence) and w_dtype (W, w_c, w_e): 0 = float32,
// 1 = bfloat16.  ws is an fp32 workspace of N * d + N + M floats: P, then
// lin.  Returns cudaGetLastError() after the launches (0 on success), or
// -1 for a dtype it has no kernel for.
extern "C" int repro_pair_score(int c_dtype, int w_dtype, const void* C,
                                const void* E, const void* W,
                                const void* w_c, const void* w_e,
                                const void* bias, void* out, void* ws, int N,
                                int M, int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (c_dtype == 0)
    return launch_w<float>(w_dtype, C, E, W, w_c, w_e, bias, out, (float*)ws,
                           N, M, d, st);
  if (c_dtype == 1)
    return launch_w<__nv_bfloat16>(w_dtype, C, E, W, w_c, w_e, bias, out,
                                   (float*)ws, N, M, d, st);
  return -1;
}

// The fp32 route (C, E, W, w_c, w_e fp32, d % 4 == 0, every base 16-byte
// aligned): ws as for repro_pair_score; the projection's and the score's
// depth splits (CTAs a cluster) and chunks (steps of PAIR_BK a CTA) come
// from kernels/pair_plan.py.  Returns 0, -1 for a plan that does not cover
// the depth once, -2 / -3 for a tensor map, or a CUDA error.
extern "C" int repro_pair_score_sm90(const void* C, const void* E,
                                     const void* W, const void* w_c,
                                     const void* w_e, const void* bias,
                                     void* out, void* ws, int N, int M, int d,
                                     int proj_split, int proj_per,
                                     int score_split, int score_per,
                                     void* stream) {
  return pair_sm90((const float*)C, (const float*)E, (const float*)W,
                   (const float*)w_c, (const float*)w_e, (const float*)bias,
                   (float*)out, (float*)ws, N, M, d, proj_split, proj_per,
                   score_split, score_per, (cudaStream_t)stream);
}

// The fp32 route's tiles, for kernels/pair_plan.py, which checks them when
// it loads the library: rows, columns and depth of a CTA's tile, the
// largest split, and the dynamic shared memory a CTA asks for.
extern "C" void repro_pair_sm90_config(int* cfg) {
  cfg[0] = PAIR_BM;
  cfg[1] = PAIR_BN;
  cfg[2] = PAIR_BK;
  cfg[3] = PAIR_MAX_SPLIT;
  cfg[4] = PAIR_SMEM;
}
