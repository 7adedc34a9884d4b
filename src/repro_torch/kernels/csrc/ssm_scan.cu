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
// The TPU grid is (B, D / block_d, S / chunk) with the chunk axis
// sequential: each grid step loads a (chunk, block_d, N) block into VMEM,
// closes the recurrence inside it with an associative scan and carries h
// to the next chunk in VMEM scratch.  CTAs carry nothing from one to the
// next, so the port has two designs, picked by the wrapper's plan
// (repro_torch/kernels/scan_plan.py) from the shapes alone.
//
// The single walk (ssm_scan_kernel), for calls with many channels (the
// Mamba serve's D N = 131,072 a row).  One thread owns V = 4 neighbouring
// channels (one float4) of one row and walks S in order with h in
// registers: no associative scan, no chunks, no carry through memory.  A
// step is one FMA a channel, and the time goes to memory.  At every step
// a warp's loads and stores cover 512 contiguous bytes.  The loads do not
// depend on h, so they are issued ahead: two register buffers of U = 4
// steps each, used in turn.  Ragged S needs no padding: steps t >= S are
// skipped (the TPU pads with a = 1, b = 0, which leaves every t < S
// unchanged).  Each element is touched once, so the loads take the
// evict-first hint (__ldcs) and the stores the streaming one (__stcs).
// Where D N is not a multiple of 4, or a pointer is not 16-byte aligned, a
// thread owns V = 1 channel instead.
//
// The chunked scan (ssm_scan_chunked_kernel), for calls whose single walk
// would leave the card idle: the RG-LRU recurrence at N = 1 has 2,560
// channels a row, 640 threads in 5 CTAs on 132 SMs, each with at most 8
// steps of loads in flight.  S is cut into chunks of at most
// SCAN_CHUNK_MAX steps and the channels into tiles of SCAN_TILE (one a
// thread), one CTA per (row, chunk, tile), so a (1, 2200, 2560) call runs
// 23 chunks x 20 tiles = 460 CTAs.  A CTA
//   1. takes a ticket (atomicAdd), which orders the CTAs: ticket ->
//      (chunk, row, tile), tile fastest, so every chunk before a CTA's own
//      holds an earlier ticket and is running or done: the look-back
//      below always makes progress;
//   2. stages its chunk of a and b in shared memory with cp.async (16
//      bytes a copy where the width and the pointers allow);
//   3. computes the chunk's aggregate per channel, A = prod a_t and H = h
//      at the chunk's end from h = 0, publishes (A, H) to scratch and
//      sets the chunk's flag to 1 (chunk 0 skips this: its carry is h0);
//   4. finds, by decoupled look-back (one warp reading 32 flags at
//      once), the nearest chunk j before it whose flag is 2, its
//      inclusive prefix P_j (h at its end) published, with every chunk
//      between at least aggregated; then goes forward: the carry is P_j,
//      then fma(A_k, carry, H_k) for each chunk k = j + 1 .. c - 1, 8
//      chunks' loads in flight at a time.  Every P_k is fma(A_k, P_{k-1},
//      H_k), whichever CTA forms it, so the carry, and h_seq, are the same
//      bits however far a walk goes: the scan is deterministic;
//   5. publishes its own P = A carry + H with flag 2 (the last chunk
//      need not), then rescans its chunk from shared memory, starting
//      from the carry, and writes h_seq once (and h_final in the last
//      chunk).
// So a and b are read once and h_seq written once: 12 bytes an element,
// plus 12 a channel and chunk for the aggregates (1% at 96 steps a
// chunk).  Three passes (aggregates, carries, rescan from device memory)
// would read a and b twice, 20 bytes an element.  The CTAs of the first
// wave all start at once and find only chunk 0's prefix published, so
// each folds in every chunk before it: long chunks (up to 96 steps of 128
// channels, 96 KiB of shared memory, two CTAs an SM) keep that walk short.  The flags and
// ticket lie in scratch that the wrapper zeroes on the same stream before
// each call; the aggregates are never read before their flag says they
// were written.
//
// Bound on the card: bytes.  12 bytes an element (a and b read, h_seq
// written) and 8 a channel (h0 read, h_final written) against 2 flops an
// element: at (4, 512, 8192, 16), 3.2 GB, 0.96 ms at 3.35 TB/s; at (1,
// 2200, 2560, 1), 67.6 MB, 0.0202 ms.
#include "scan_common.cuh"

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

// The chunked scan: see the header.  A CTA owns SCAN_TILE channels of a
// row, one a thread, and a chunk of at most SCAN_CHUNK_MAX steps.
constexpr int SCAN_TILE = THREADS;
constexpr int SCAN_CHUNK_MAX = 96;
constexpr int SCAN_SMEM_MAX = 2 * SCAN_CHUNK_MAX * SCAN_TILE * 4;
// chunks whose aggregates a thread loads at once while it folds them in
constexpr int LOOKBACK_BATCH = 8;

struct ChunkArgs {
  const float* a;
  const float* b;
  const float* h0;
  float* hs;
  float* hT;
  float* agg;      // (B, n_chunks, C) each: A, then H, then P
  int* flags;      // (B, n_chunks, n_tiles) statuses, then the ticket
  int B, S, chunk, n_chunks, n_tiles;
  int64_t C;
};

// The look-back of chunk c >= 1 over the statuses `status[k * stride]` of
// the chunks k < c of its (row, tile): warp 0 reads 32 of them at once
// (lane l reads chunk base - l) and returns the nearest chunk j whose
// prefix is published (status 2) with every chunk between j and c at
// least aggregated (status >= 1); chunk 0 always publishes its prefix.
// The result is broadcast to the CTA, and every thread fences before it
// reads what those statuses publish.  Every chunk before c holds an
// earlier ticket, so it runs or has run: a status that stays 0 for
// seconds is a fault, and the warp traps (the launch fails) rather than
// hang the card.
__device__ __forceinline__ int find_prefix(const int* status, int stride,
                                           int c) {
  __shared__ int s_from;
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    int base = c - 1, spins = 0;
    for (;;) {
      const int k = base - (int)lane;
      const int f = k >= 0 ? flag_acquire(status + (int64_t)k * stride) : 1;
      const unsigned ready = __ballot_sync(0xffffffffu, f == 2);
      const unsigned empty = __ballot_sync(0xffffffffu, f == 0);
      if (ready) {
        const int l = __ffs(ready) - 1;
        if ((empty & ((1u << l) - 1)) == 0) {
          if (lane == 0) s_from = base - l;
          break;
        }
      } else if (empty == 0) {
        base -= 32;                      // all aggregated: look further back
        continue;
      }
      if (++spins > (1 << 22)) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
  __threadfence();
  return s_from;
}

// VEC: the staging copies 16 bytes (4 channels of a step) a thread, the
// CTA's rows in turn; else each thread copies its own channel, 4 bytes a
// step (a width that is not a multiple of 4, or a misaligned view).  Then
// thread i computes channel c0 + i from the staged columns.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    ssm_scan_chunked_kernel(const ChunkArgs p) {
  extern __shared__ __align__(16) float stage[];   // a, then b: [chunk][TILE]
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(p.flags + (int64_t)p.B *
                                             p.n_chunks * p.n_tiles, 1);
  __syncthreads();
  const int tile = s_ticket % p.n_tiles;
  const int row = s_ticket / p.n_tiles % p.B;
  const int c = s_ticket / p.n_tiles / p.B;
  const int t0 = c * p.chunk;
  const int T = min(p.chunk, p.S - t0);
  const int64_t C = p.C, c0 = (int64_t)tile * SCAN_TILE;
  const int i = threadIdx.x;
  const bool live = c0 + i < C;
  float* a_s = stage;
  float* b_s = stage + p.chunk * SCAN_TILE;

  // 2. stage the chunk: step t0 + t of channel c0 + k at [t][k]
  const int64_t first = ((int64_t)row * p.S + t0) * C + c0;
  if constexpr (VEC) {
    const int q = 4 * (i % (SCAN_TILE / 4));        // channel of the copy
    if (c0 + q < C)
      for (int t = i / (SCAN_TILE / 4); t < T; t += 4 * THREADS / SCAN_TILE) {
        const int64_t g = first + (int64_t)t * C + q;
        cp_async16(a_s + t * SCAN_TILE + q, p.a + g);
        cp_async16(b_s + t * SCAN_TILE + q, p.b + g);
      }
  } else if (live) {
    for (int t = 0; t < T; ++t) {
      const int64_t g = first + (int64_t)t * C + i;
      cp_async4(a_s + t * SCAN_TILE + i, p.a + g);
      cp_async4(b_s + t * SCAN_TILE + i, p.b + g);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 3. the chunk's aggregate from h = 0
  float A = 1.f, H = 0.f;
  for (int t = 0; t < T; ++t) {
    const float at = a_s[t * SCAN_TILE + i];
    H = fmaf(at, H, b_s[t * SCAN_TILE + i]);
    A *= at;
  }

  const int64_t slab = (int64_t)p.B * p.n_chunks * C;   // one of A, H, P
  const int64_t mine = ((int64_t)row * p.n_chunks + c) * C + c0 + i;
  int* status = p.flags + ((int64_t)row * p.n_chunks + c) * p.n_tiles + tile;
  float carry = 0.f;
  if (c == 0) {
    if (live) carry = p.h0[(int64_t)row * C + c0 + i];
  } else {
    if (live) {
      p.agg[mine] = A;
      p.agg[slab + mine] = H;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) flag_release(status, 1);

    // 4. decoupled look-back (find_prefix), then forward from P_j over
    // the aggregates of j + 1 .. c - 1, LOOKBACK_BATCH chunks' loads in
    // flight at a time.  Each P_k is fma(A_k, P_{k-1}, H_k) whichever CTA
    // forms it, so the carry does not depend on how far the walk went:
    // the result is the same bits from run to run.
    int j = find_prefix(p.flags + (int64_t)row * p.n_chunks * p.n_tiles +
                        tile, p.n_tiles, c);
    if (live) {
      carry = __ldcg(p.agg + 2 * slab + mine - (int64_t)(c - j) * C);
      for (++j; j < c; j += LOOKBACK_BATCH) {
        float ra[LOOKBACK_BATCH], rh[LOOKBACK_BATCH];
#pragma unroll
        for (int u = 0; u < LOOKBACK_BATCH; ++u)
          if (j + u < c) {
            const int64_t k = mine - (int64_t)(c - j - u) * C;
            ra[u] = __ldcg(p.agg + k);
            rh[u] = __ldcg(p.agg + slab + k);
          }
#pragma unroll
        for (int u = 0; u < LOOKBACK_BATCH; ++u)
          if (j + u < c) carry = fmaf(ra[u], carry, rh[u]);
      }
    }
  }

  // 5. publish the inclusive prefix, then rescan and write h_seq
  if (c + 1 < p.n_chunks) {
    if (live) p.agg[2 * slab + mine] = fmaf(A, carry, H);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) flag_release(status, 2);
  }
  if (!live) return;
  float* hs = p.hs + first + i;
  for (int t = 0; t < T; ++t) {
    carry = fmaf(a_s[t * SCAN_TILE + i], carry, b_s[t * SCAN_TILE + i]);
    __stcs(hs + (int64_t)t * C, carry);
  }
  if (c + 1 == p.n_chunks) p.hT[(int64_t)row * C + c0 + i] = carry;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// a, b, hs: (B, S, D, N) fp32; h0, hT: (B, D, N) fp32; all contiguous.
// n_chunks == 1 runs the single walk (chunk, agg and flags unused); more
// run the chunked scan over chunks of `chunk` steps, with agg 3 B
// n_chunks D N floats and flags B n_chunks n_tiles + 1 ints zeroed on
// `stream` (scan_plan.py).  Returns cudaGetLastError() after the launch
// (0 on success), or -1 for a shape or plan the kernels do not take (B,
// S, D or N below 1, B above the single walk's 65,535 rows, chunks that
// do not cover S or exceed SCAN_CHUNK_MAX).
extern "C" int repro_ssm_scan(const void* a, const void* b, const void* h0,
                              void* hs, void* hT, int B, int S, int D, int N,
                              int chunk, int n_chunks, void* agg,
                              void* flags, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || N < 1 || n_chunks < 1)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t C = (int64_t)D * N;
  const bool vec = C % 4 == 0 && aligned16(a) && aligned16(b) &&
                   aligned16(h0) && aligned16(hs) && aligned16(hT);
  if (n_chunks > 1) {
    if (chunk < 1 || chunk > SCAN_CHUNK_MAX ||
        (int64_t)chunk * (n_chunks - 1) >= S ||
        (int64_t)chunk * n_chunks < S)
      return -1;
    const int n_tiles = (int)((C + SCAN_TILE - 1) / SCAN_TILE);
    const ChunkArgs args{(const float*)a, (const float*)b,
                         (const float*)h0, (float*)hs, (float*)hT,
                         (float*)agg, (int*)flags, B, S, chunk, n_chunks,
                         n_tiles, C};
    const int64_t ctas = (int64_t)n_chunks * B * n_tiles;
    const int smem = 2 * chunk * SCAN_TILE * 4;
    auto kernel = vec ? ssm_scan_chunked_kernel<true>
                      : ssm_scan_chunked_kernel<false>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SCAN_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)ctas, THREADS, smem, st>>>(args);
    return (int)cudaGetLastError();
  }
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

// what scan_plan.py must agree with
extern "C" int repro_scan_tile() { return SCAN_TILE; }
extern "C" int repro_scan_chunk_max() { return SCAN_CHUNK_MAX; }
