// Mamba-1's selective scan, fused, for Hopper (sm_90a):
//   a_t = exp(dt_t A),  h_t = a_t * h_{t-1} + (dt_t x_t) B_t,
//   y_t = sum_n C_{t,n} h_{t,n} + D x_t,
// for every (b, d): xc and dt (B, S, di), Bc and Cc (B, S, N) (any batch
// and step strides, unit stride over N), A (di, N), D (di,), h0 (B, di,
// N) or none (zeros); writes y (B, S, di) and h_final (B, di, N), fp32.
// Hand-written CUDA C++; built by repro_torch/kernels/build.py into a
// shared library with a plain C interface and bound with ctypes.
//
// Replaces the TPU kernel together with the op around it:
//   src/repro/kernels/ssm_scan.py:ssm_scan_blocked, called by
//   src/repro/kernels/ops.py:ssm_scan (ops.py:98-111)
//                                            -> repro_selective_scan_fused
// There, as in the port until now, the op builds a_bar = exp(dt A) and
// b_bar = (dt x) B as two (B, S, di, N) fp32 tensors, scans them into a
// third, h_seq, and contracts that with C: at (4, 512, 8192, 16) three
// tensors of 1.07 GB each, written and read again.
//
// Design.  Nothing of (B, S, di, N) reaches device memory: a channel's N
// states stay in registers for the whole sequence.  A channel (b, d) is
// G lanes of a warp, each holding 4 of its states (G = 4 at N = 16, the
// smallest power of two with 4 G >= N, at most 32; states n >= N are
// padded with A = 0, B = C = 0 and h = 0, which leaves them 0), so a
// batch-1 admit of di = 8,192 still runs 32,768 threads.  At each step a
// lane computes its 4 exponentials on the special-function unit, updates
// its 4 states with one FMA each and contracts them with C; the G partial
// sums meet by __shfl_xor_sync, and the first lane writes y.  B_t and C_t
// are the same for every channel of a row, and x and dt for the G lanes
// of a channel, so a CTA (128 threads: 128 / G channels of one row)
// stages chunks of FCHUNK = 32 steps of x, dt, B and C in shared memory
// with cp.async, two buffers in turn: the copies of the next chunk are in
// flight while the current one is scanned.  S is not split: the
// recurrence is cheap (one FMA a state and step) and a batch-1 admit
// already gives the card 256 CTAs.
//
// exp: ex2.approx.ftz.f32 of dt (A log2 e), A log2 e formed once a
// channel (PTX: ex2.approx has a maximum relative error of about 2^-22;
// the prescale adds about 2^-24 |dt A| relative).  chip_smoke.py reads the
// exponential's error on the card through h_final.
//
// Bound on the card: the larger of bytes (x, dt, y: 12 bytes a (b, s, d);
// B, C: 8 a (b, s, n); h0, h_final: 8 a state) at 3.35 TB/s, and the
// exponentials, one a (b, s, d, n), at 16 a clock on each of the 132 SMs:
// at (4, 512, 8192, 16), 0.21 GB, 0.062 ms, against 268 M exponentials,
// 0.064 ms at 1.98 GHz.
#include "scan_common.cuh"

namespace {

constexpr int FT = 128;        // threads per CTA
constexpr int FCHUNK = 32;     // steps a stage
constexpr int SPL = 4;         // states a lane
constexpr int MAX_LANES = 32;  // lanes a channel: N <= SPL * MAX_LANES

constexpr int U = 8;           // steps a group: their sums meet at once

struct FusedArgs {
  const float* x;
  const float* dt;
  const float* Bm;
  const float* Cm;
  const float* A;
  const float* Dv;
  const float* h0;      // or null: zeros
  float* y;
  float* hT;
  int64_t b_batch, b_step, c_batch, c_step;   // strides of Bc and Cc
  int S, di, N;
};

// floats of one stage: x and dt [FCHUNK][DC], then B and C [FCHUNK][4 G]
__host__ __device__ constexpr int stage_floats(int G) {
  return FCHUNK * 2 * (FT / G + SPL * G);
}

// copy steps s0 .. s0 + T - 1 of row b into a stage
template <int G>
__device__ __forceinline__ void load_stage(const FusedArgs& p, float* st,
                                           int b, int d0, int s0, int T) {
  constexpr int DC = FT / G, NP = SPL * G;
  float* xs = st;
  float* ds = st + FCHUNK * DC;
  float* bs = ds + FCHUNK * DC;
  float* cs = bs + FCHUNK * NP;
  const int dc = min(DC, p.di - d0);
  for (int i = threadIdx.x; i < T * DC; i += FT) {
    const int t = i / DC, j = i % DC;
    if (j < dc) {
      const int64_t g = ((int64_t)b * p.S + s0 + t) * p.di + d0 + j;
      cp_async4(xs + i, p.x + g);
      cp_async4(ds + i, p.dt + g);
    }
  }
  for (int i = threadIdx.x; i < T * p.N; i += FT) {
    const int t = i / p.N, n = i % p.N;
    cp_async4(bs + t * NP + n,
              p.Bm + b * p.b_batch + (int64_t)(s0 + t) * p.b_step + n);
    cp_async4(cs + t * NP + n,
              p.Cm + b * p.c_batch + (int64_t)(s0 + t) * p.c_step + n);
  }
}

// One step of a lane: its states' exponentials and updates, and their
// partial sum of C h (x, dt, B, C of the step from the stage).
template <int G>
__device__ __forceinline__ float fused_step(const float* xs, const float* ds,
                                            const float4* bs,
                                            const float4* cs, int t, int j,
                                            int lane, const float (&al2)[SPL],
                                            float (&h)[SPL], float& xv) {
  constexpr int DC = FT / G;
  xv = xs[t * DC + j];
  const float dv = ds[t * DC + j];
  const float4 Bv = bs[t * G + lane], Cv = cs[t * G + lane];
  const float dtx = dv * xv;
  const float bn[SPL] = {Bv.x, Bv.y, Bv.z, Bv.w};
  const float cn[SPL] = {Cv.x, Cv.y, Cv.z, Cv.w};
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    h[k] = fmaf(ex2(dv * al2[k]), h[k], dtx * bn[k]);
    part = fmaf(cn[k], h[k], part);
  }
  return part;
}

// grid (ceil(di / (FT / G)), B): lanes g * G .. g * G + G - 1 of the CTA
// hold channel d0 + g, states 4 l .. 4 l + 3 in lane l of the group.  A
// chunk's steps run in groups of U with no branch inside a group, so the
// exponentials, loads and sums of one step overlap the next step's (only
// h carries from step to step), and the group's partial sums meet by
// shuffles together; the last steps of the sequence that do not fill a
// group run one at a time.
template <int G>
__global__ void __launch_bounds__(FT, 8)
    ssm_scan_fused_kernel(const FusedArgs p) {
  constexpr int DC = FT / G, NP = SPL * G, SF = stage_floats(G);
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, d0 = blockIdx.x * DC;
  const int j = threadIdx.x / G, lane = threadIdx.x % G;
  const int d = d0 + j;
  const bool live = d < p.di;

  // the padded states' B and C are zero in both stages for good
  for (int i = threadIdx.x; i < 2 * FCHUNK * NP; i += FT) {
    const int s = i / (FCHUNK * NP), r = i % (FCHUNK * NP);
    if (r % NP >= p.N) {
      float* bs = smem + s * SF + 2 * FCHUNK * DC;
      bs[r] = 0.f;
      bs[FCHUNK * NP + r] = 0.f;
    }
  }
  const int n_chunks = (p.S + FCHUNK - 1) / FCHUNK;
  load_stage<G>(p, smem, b, d0, 0, min(FCHUNK, p.S));
  cp_async_commit();

  float al2[SPL], h[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int n = SPL * lane + k;
    const bool on = live && n < p.N;
    al2[k] = on ? p.A[(int64_t)d * p.N + n] * LOG2E : 0.f;
    h[k] = on && p.h0 ? p.h0[((int64_t)b * p.di + d) * p.N + n] : 0.f;
  }
  const float Dd = live ? p.Dv[d] : 0.f;
  const bool writer = lane == 0 && live;
  float* y = p.y + (int64_t)b * p.S * p.di + d;

  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * FCHUNK, T = min(FCHUNK, p.S - s0);
    if (c + 1 < n_chunks) {
      load_stage<G>(p, smem + ((c + 1) & 1) * SF, b, d0, s0 + FCHUNK,
                    min(FCHUNK, p.S - s0 - FCHUNK));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = smem + (c & 1) * SF;
    const float* ds = xs + FCHUNK * DC;
    const float4* bs = reinterpret_cast<const float4*>(ds + FCHUNK * DC);
    const float4* cs = bs + FCHUNK * G;
    int t = 0;
    for (; t + U <= T; t += U) {
      float xv[U], part[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        part[u] = fused_step<G>(xs, ds, bs, cs, t + u, j, lane, al2, h,
                                xv[u]);
#pragma unroll
      for (int sh = 1; sh < G; sh <<= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
          part[u] += __shfl_xor_sync(0xffffffffu, part[u], sh);
      if (writer)
#pragma unroll
        for (int u = 0; u < U; ++u)
          __stcs(y + (int64_t)(s0 + t + u) * p.di, fmaf(Dd, xv[u], part[u]));
    }
    for (; t < T; ++t) {
      float xv;
      float part = fused_step<G>(xs, ds, bs, cs, t, j, lane, al2, h, xv);
#pragma unroll
      for (int sh = 1; sh < G; sh <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, sh);
      if (writer) __stcs(y + (int64_t)(s0 + t) * p.di, fmaf(Dd, xv, part));
    }
    __syncthreads();          // the stage is free for the chunk after next
  }
  if (live)
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int n = SPL * lane + k;
      if (n < p.N) p.hT[((int64_t)b * p.di + d) * p.N + n] = h[k];
    }
}

template <int G>
int launch_fused(const FusedArgs& args, int B, cudaStream_t stream) {
  constexpr int smem = 2 * stage_floats(G) * 4;
  auto kernel = ssm_scan_fused_kernel<G>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((args.di + FT / G - 1) / (FT / G)), B);
  kernel<<<grid, FT, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// lanes a channel for N states: the smallest power of two G with 4 G >= N
// (0 if N is above 4 x 32)
int lanes_for(int N) {
  int G = 1;
  while (SPL * G < N) G <<= 1;
  return G <= MAX_LANES ? G : 0;
}

}  // namespace


// xc, dt, y: (B, S, di); Bc, Cc: (B, S, N) at strides (b_batch, b_step, 1)
// and (c_batch, c_step, 1); A (di, N); D (di,); h0 (B, di, N) or null;
// h_final (B, di, N); all fp32.  Returns cudaGetLastError() after the
// launch (0 on success), or -1 for a shape the kernel does not take (a
// size below 1, B above 65,535 rows, N above 128).
extern "C" int repro_selective_scan_fused(
    const void* xc, const void* dt, const void* Bc, const void* Cc,
    const void* A, const void* D, const void* h0, void* y, void* hT, int B,
    int S, int di, int N, int64_t b_batch, int64_t b_step, int64_t c_batch,
    int64_t c_step, void* stream) {
  const int G = N >= 1 ? lanes_for(N) : 0;
  if (B < 1 || B > 65535 || S < 1 || di < 1 || G == 0) return -1;
  const FusedArgs args{(const float*)xc, (const float*)dt, (const float*)Bc,
                       (const float*)Cc, (const float*)A, (const float*)D,
                       (const float*)h0, (float*)y, (float*)hT, b_batch,
                       b_step, c_batch, c_step, S, di, N};
  cudaStream_t st = (cudaStream_t)stream;
  switch (G) {
    case 1: return launch_fused<1>(args, B, st);
    case 2: return launch_fused<2>(args, B, st);
    case 4: return launch_fused<4>(args, B, st);
    case 8: return launch_fused<8>(args, B, st);
    case 16: return launch_fused<16>(args, B, st);
    default: return launch_fused<32>(args, B, st);
  }
}
