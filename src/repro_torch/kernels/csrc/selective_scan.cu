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
// and adds its gradient (below the forward) -> repro_selective_scan_bwd
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
  float* hck;           // or null: (B, n_chunks, di, N), h at each chunk's
                        //   start, for the backward
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
// group run one at a time.  KEEP (a training forward) also writes h at
// each chunk's start to p.hck for the backward; it asks for 4 CTAs an SM
// (128 registers a thread), where the serving forward's 8 leave 64.
template <int G, bool KEEP>
__global__ void __launch_bounds__(FT, KEEP ? 4 : 8)
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
    if (KEEP && live)
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int n = SPL * lane + k;
        if (n < p.N)
          p.hck[(((int64_t)b * n_chunks + c) * p.di + d) * p.N + n] = h[k];
      }
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
  auto kernel = args.hck != nullptr ? ssm_scan_fused_kernel<G, true>
                                    : ssm_scan_fused_kernel<G, false>;
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

// ---------------------------------------------------------------------
// The backward (selective_scan_bwd_kernel, then
// selective_scan_bwd_reduce_kernel): the gradients of xc, dt, Bc, Cc, A,
// D and h0 for upstream gradients gy of y and gT of h_final (port-only:
// JAX differentiates its op in plain jnp).  With a_t = exp(dt_t A) and the
// adjoint lam_t = gy_t C_t + a_{t+1} lam_{t+1} (lam_{S-1} = gy_{S-1}
// C_{S-1} + gT), state by state:
//   dC_t  = gy_t h_t                          summed over the channels
//   dB_t  = lam_t dt_t x_t                    summed over the channels
//   dx_t  = gy_t D + dt_t sum_n lam_t B_t
//   ddt_t = sum_n lam_t (x_t B_t + A a_t h_{t-1})
//   dA    = sum_t lam_t dt_t a_t h_{t-1}      summed over the rows too
//   dD    = sum_t gy_t x_t                    summed over the rows too
//   dh0   = a_0 lam_0.
// The forward writes no (B, S, di, N) tensor, and neither does this: the
// forward kernel, asked by the autograd Function, keeps h at the start of
// each FCHUNK-step chunk (hck, 1 / FCHUNK of such a tensor), and the
// backward walks the chunks from the last: it recomputes the chunk's h
// from its checkpoint with the forward's arithmetic (the same bits) into
// shared memory, then walks the chunk's steps in reverse with lam in
// registers (the carry m = a_t lam_t between steps).  a_t is recomputed,
// never inverted (exp(dt A) reaches 0 in fp32).  The layout is the
// forward's: G lanes a channel, 4 states a lane, 128 / G channels of one
// row a CTA, x, dt, gy, B and C staged by cp.async in two buffers.  The
// sums over the states meet by shuffles inside a channel's lanes; those
// over the channels by shuffles across a warp's channels, then through
// shared memory across the CTA's 4 warps in a fixed order, into per-CTA
// partials of dB and dC (B, di / (128 / G), S, N); dA and dD are per-row
// partials.  The second kernel sums the partials in a fixed order: no
// atomics, so two calls give the same bits.  It takes N <= 32 (G <= 8):
// two buffers, the chunk's h (64 KiB) and the warps' partial sums must fit
// shared memory.
// Bound on the card: bytes or exponentials.  x, dt, gy read and dx, ddt
// written (20 bytes a (b, s, d)), B, C read and dB, dC written (16 a (b,
// s, n)), the checkpoints read (4 a state a chunk), A, D, gT, h0 read, dA,
// dD, dh0 written; an exponential a (b, s, d, n) twice (the recomputed h
// and the reverse walk).
constexpr int MAX_BWD_LANES = 8;   // N <= 32 in the backward
constexpr int NW = FT / 32;        // warps a CTA
constexpr int UB = 4;              // steps a group of the reverse walk

struct BwdArgs {
  const float* x;
  const float* dt;
  const float* Bm;
  const float* Cm;
  const float* A;
  const float* Dv;
  const float* gy;      // (B, S, di) the gradient of y
  const float* gT;      // (B, di, N) the gradient of h_final
  const float* hck;     // (B, n_chunks, di, N) the forward's checkpoints
  float* dx;
  float* ddt;
  float* dBp;           // (B, n_dblk, S, N): each CTA's sums over its
  float* dCp;           //   channels
  float* dAp;           // (B, di, N): each row's sums over its steps
  float* dDp;           // (B, di)
  float* dh0;           // (B, di, N)
  int64_t b_batch, b_step, c_batch, c_step;   // strides of Bc and Cc
  int B, S, di, N, n_dblk;
};

// floats of one backward stage: x, dt and gy [FCHUNK][DC], then B and C
// [FCHUNK][4 G]
__host__ __device__ constexpr int bwd_stage_floats(int G) {
  return FCHUNK * (3 * (FT / G) + 2 * SPL * G);
}

// the backward's shared memory: two stages, the chunk's h (FCHUNK x FT
// float4), the warps' sums of dB and dC [FCHUNK][NW][2][4 G]
__host__ __device__ constexpr int bwd_smem_bytes(int G) {
  return (2 * bwd_stage_floats(G) + FCHUNK * FT * SPL +
          FCHUNK * NW * 2 * SPL * G) * 4;
}

// copy steps s0 .. s0 + T - 1 of row b into a backward stage
template <int G>
__device__ __forceinline__ void load_bwd_stage(const BwdArgs& p, float* st,
                                               int b, int d0, int s0, int T) {
  constexpr int DC = FT / G, NP = SPL * G;
  float* xs = st;
  float* ds = xs + FCHUNK * DC;
  float* gs = ds + FCHUNK * DC;
  float* bs = gs + FCHUNK * DC;
  float* cs = bs + FCHUNK * NP;
  const int dc = min(DC, p.di - d0);
  for (int i = threadIdx.x; i < T * DC; i += FT) {
    const int t = i / DC, j = i % DC;
    if (j < dc) {
      const int64_t g = ((int64_t)b * p.S + s0 + t) * p.di + d0 + j;
      cp_async4(xs + i, p.x + g);
      cp_async4(ds + i, p.dt + g);
      cp_async4(gs + i, p.gy + g);
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

__device__ __forceinline__ void unpack(float4 v, float (&x)[SPL]) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// Steps t, t - 1, .., t - NU + 1 of a lane's reverse walk over a chunk
// from s0 (its stage st, its h in hb, h before its first step in h0c):
// lam and the per-state terms, the carry m, then the sums over the
// channel's lanes (dx, ddt, written by lane 0) and over the warp's
// channels (dB, dC, written to the warp's slots of red).
template <int G, int NU>
__device__ __forceinline__ void bwd_steps(
    const BwdArgs& p, const float* st, const float4* hb,
    const float (&h0c)[SPL], int t, int s0, int j, int lane, bool live,
    const float (&al2)[SPL], const float (&Ak)[SPL], float Dd,
    float (&m)[SPL], float (&dA)[SPL], float& dD, float* red) {
  constexpr int DC = FT / G, NP = SPL * G;
  const float* xs = st;
  const float* ds = xs + FCHUNK * DC;
  const float* gs = ds + FCHUNK * DC;
  const float4* bs = reinterpret_cast<const float4*>(gs + FCHUNK * DC);
  const float4* cs = bs + FCHUNK * G;
  float sx[NU], sdt[NU], db[NU][SPL], dc[NU][SPL], xv[NU], gv[NU], dv[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int tt = t - u;
    xv[u] = live ? xs[tt * DC + j] : 0.f;
    dv[u] = live ? ds[tt * DC + j] : 0.f;
    gv[u] = live ? gs[tt * DC + j] : 0.f;
    float bn[SPL], cn[SPL], hc[SPL], hp[SPL];
    unpack(bs[tt * G + lane], bn);
    unpack(cs[tt * G + lane], cn);
    unpack(hb[tt * FT + threadIdx.x], hc);
    if (tt > 0) {
      unpack(hb[(tt - 1) * FT + threadIdx.x], hp);
    } else {
#pragma unroll
      for (int k = 0; k < SPL; ++k) hp[k] = h0c[k];
    }
    const float dtx = dv[u] * xv[u];
    sx[u] = 0.f;
    sdt[u] = 0.f;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const float a = ex2(dv[u] * al2[k]);
      const float lam = fmaf(gv[u], cn[k], m[k]);
      const float ah = a * hp[k];
      dc[u][k] = gv[u] * hc[k];
      db[u][k] = lam * dtx;
      sx[u] = fmaf(lam, bn[k], sx[u]);
      sdt[u] = fmaf(lam, fmaf(xv[u], bn[k], Ak[k] * ah), sdt[u]);
      dA[k] = fmaf(lam * dv[u], ah, dA[k]);
      m[k] = a * lam;
    }
  }
#pragma unroll
  for (int sh = 1; sh < G; sh <<= 1)
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      sx[u] += __shfl_xor_sync(0xffffffffu, sx[u], sh);
      sdt[u] += __shfl_xor_sync(0xffffffffu, sdt[u], sh);
    }
#pragma unroll
  for (int sh = G; sh < 32; sh <<= 1)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        db[u][k] += __shfl_xor_sync(0xffffffffu, db[u][k], sh);
        dc[u][k] += __shfl_xor_sync(0xffffffffu, dc[u][k], sh);
      }
  if (lane == 0 && live)
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int64_t o = ((int64_t)blockIdx.y * p.S + s0 + t - u) * p.di +
                        blockIdx.x * DC + j;
      p.dx[o] = fmaf(gv[u], Dd, dv[u] * sx[u]);
      p.ddt[o] = sdt[u];
      dD = fmaf(gv[u], xv[u], dD);
    }
  if ((threadIdx.x & 31) < G) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float* r = red + ((t - u) * NW + warp) * 2 * NP + SPL * lane;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        r[k] = db[u][k];
        r[NP + k] = dc[u][k];
      }
    }
  }
}

// grid (n_dblk = ceil(di / (FT / G)), B), the forward's layout; the
// chunks from the last to the first.
template <int G>
__global__ void __launch_bounds__(FT, G <= 4 ? 2 : 1)
    selective_scan_bwd_kernel(const BwdArgs p) {
  constexpr int DC = FT / G, NP = SPL * G, SF = bwd_stage_floats(G);
  extern __shared__ __align__(16) float smem[];
  const float4* hb = reinterpret_cast<const float4*>(smem + 2 * SF);
  float4* hw = reinterpret_cast<float4*>(smem + 2 * SF);
  float* red = smem + 2 * SF + FCHUNK * FT * SPL;
  const int b = blockIdx.y, d0 = blockIdx.x * DC;
  const int j = threadIdx.x / G, lane = threadIdx.x % G;
  const int d = d0 + j;
  const bool live = d < p.di;

  // the padded states' B and C are zero in both stages for good
  for (int i = threadIdx.x; i < 2 * FCHUNK * NP; i += FT) {
    const int s = i / (FCHUNK * NP), r = i % (FCHUNK * NP);
    if (r % NP >= p.N) {
      float* bs = smem + s * SF + 3 * FCHUNK * DC;
      bs[r] = 0.f;
      bs[FCHUNK * NP + r] = 0.f;
    }
  }
  const int n_chunks = (p.S + FCHUNK - 1) / FCHUNK;
  load_bwd_stage<G>(p, smem + ((n_chunks - 1) & 1) * SF, b, d0,
                    (n_chunks - 1) * FCHUNK, p.S - (n_chunks - 1) * FCHUNK);
  cp_async_commit();

  float al2[SPL], Ak[SPL], m[SPL], dA[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int n = SPL * lane + k;
    const bool on = live && n < p.N;
    Ak[k] = on ? p.A[(int64_t)d * p.N + n] : 0.f;
    al2[k] = Ak[k] * LOG2E;
    m[k] = on ? p.gT[((int64_t)b * p.di + d) * p.N + n] : 0.f;
    dA[k] = 0.f;
  }
  const float Dd = live ? p.Dv[d] : 0.f;
  float dD = 0.f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int s0 = c * FCHUNK, T = min(FCHUNK, p.S - s0);
    if (c > 0) {
      load_bwd_stage<G>(p, smem + ((c - 1) & 1) * SF, b, d0, s0 - FCHUNK,
                        FCHUNK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = smem + (c & 1) * SF;

    // h before the chunk (the forward's checkpoint), then after each step,
    // with the forward's arithmetic
    float h0c[SPL], h[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int n = SPL * lane + k;
      h0c[k] = live && n < p.N
                   ? p.hck[(((int64_t)b * n_chunks + c) * p.di + d) * p.N + n]
                   : 0.f;
      h[k] = h0c[k];
    }
    {
      const float* xs = st;
      const float* ds = xs + FCHUNK * DC;
      const float4* bs =
          reinterpret_cast<const float4*>(ds + 2 * FCHUNK * DC);
      for (int t = 0; t < T; ++t) {
        const float xv = live ? xs[t * DC + j] : 0.f;
        const float dv = live ? ds[t * DC + j] : 0.f;
        float bn[SPL];
        unpack(bs[t * G + lane], bn);
        const float dtx = dv * xv;
#pragma unroll
        for (int k = 0; k < SPL; ++k)
          h[k] = fmaf(ex2(dv * al2[k]), h[k], dtx * bn[k]);
        hw[t * FT + threadIdx.x] = make_float4(h[0], h[1], h[2], h[3]);
      }
    }

    // the reverse walk, UB steps a group, then one at a time
    int t = T - 1;
    for (; t >= UB - 1; t -= UB)
      bwd_steps<G, UB>(p, st, hb, h0c, t, s0, j, lane, live, al2, Ak, Dd, m,
                       dA, dD, red);
    for (; t >= 0; --t)
      bwd_steps<G, 1>(p, st, hb, h0c, t, s0, j, lane, live, al2, Ak, Dd, m,
                      dA, dD, red);
    __syncthreads();

    // the CTA's dB and dC of the chunk: its warps' sums in order
    for (int i = threadIdx.x; i < T * p.N; i += FT) {
      const int tt = i / p.N, n = i % p.N;
      const float* r = red + tt * NW * 2 * NP + n;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        sb += r[2 * w * NP];
        sc += r[(2 * w + 1) * NP];
      }
      const int64_t o =
          (((int64_t)b * p.n_dblk + blockIdx.x) * p.S + s0 + tt) * p.N + n;
      p.dBp[o] = sb;
      p.dCp[o] = sc;
    }
    __syncthreads();          // the stage and red are free again
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int n = SPL * lane + k;
      if (n < p.N) {
        const int64_t o = ((int64_t)b * p.di + d) * p.N + n;
        p.dh0[o] = m[k];
        p.dAp[o] = dA[k];
      }
    }
    if (lane == 0) p.dDp[(int64_t)b * p.di + d] = dD;
  }
}

// dB, dC (B, S, N): the partials of the n_dblk CTAs of a row in order;
// dA (di, N) and dD (di,): the rows' partials in order.  A thread an
// output element, grid-stride.
__global__ void __launch_bounds__(256)
    selective_scan_bwd_reduce_kernel(const BwdArgs p, float* __restrict__ dB,
                                     float* __restrict__ dC,
                                     float* __restrict__ dAo,
                                     float* __restrict__ dDo) {
  const int64_t sn = (int64_t)p.S * p.N;
  const int64_t nbc = p.B * sn, na = (int64_t)p.di * p.N;
  const int64_t total = nbc + na + p.di;
  for (int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * 256) {
    if (i < nbc) {
      const int64_t b = i / sn, e = i - b * sn;
      const float* pb = p.dBp + b * p.n_dblk * sn + e;
      const float* pc = p.dCp + b * p.n_dblk * sn + e;
      float sb = 0.f, sc = 0.f;
      for (int k = 0; k < p.n_dblk; ++k) {
        sb += pb[k * sn];
        sc += pc[k * sn];
      }
      dB[i] = sb;
      dC[i] = sc;
    } else if (i < nbc + na) {
      const int64_t e = i - nbc;
      float s = 0.f;
      for (int b = 0; b < p.B; ++b) s += p.dAp[b * na + e];
      dAo[e] = s;
    } else {
      const int64_t e = i - nbc - na;
      float s = 0.f;
      for (int b = 0; b < p.B; ++b) s += p.dDp[(int64_t)b * p.di + e];
      dDo[e] = s;
    }
  }
}

template <int G>
int launch_bwd(const BwdArgs& args, float* dB, float* dC, float* dA,
               float* dD, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes(G);
  auto kernel = selective_scan_bwd_kernel<G>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)args.n_dblk, args.B), FT, smem, stream>>>(args);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int64_t total = (int64_t)args.B * args.S * args.N +
                        (int64_t)args.di * args.N + args.di;
  const int64_t want = (total + 255) / 256;
  const int64_t blocks = want < 132 * 8 ? want : 132 * 8;
  selective_scan_bwd_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      args, dB, dC, dA, dD);
  return (int)cudaGetLastError();
}

}  // namespace


// xc, dt, y: (B, S, di); Bc, Cc: (B, S, N) at strides (b_batch, b_step, 1)
// and (c_batch, c_step, 1); A (di, N); D (di,); h0 (B, di, N) or null;
// h_final (B, di, N); hck null, or (B, ceil(S / 32), di, N) for h at the
// start of each 32-step chunk (the backward's checkpoints); all fp32.
// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// shape the kernel does not take (a size below 1, B above 65,535 rows, N
// above 128).
extern "C" int repro_selective_scan_fused(
    const void* xc, const void* dt, const void* Bc, const void* Cc,
    const void* A, const void* D, const void* h0, void* y, void* hT, int B,
    int S, int di, int N, int64_t b_batch, int64_t b_step, int64_t c_batch,
    int64_t c_step, void* hck, void* stream) {
  const int G = N >= 1 ? lanes_for(N) : 0;
  if (B < 1 || B > 65535 || S < 1 || di < 1 || G == 0) return -1;
  const FusedArgs args{(const float*)xc, (const float*)dt, (const float*)Bc,
                       (const float*)Cc, (const float*)A, (const float*)D,
                       (const float*)h0, (float*)y, (float*)hT, b_batch,
                       b_step, c_batch, c_step, S, di, N, (float*)hck};
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

// The backward of repro_selective_scan_fused: its inputs (Bc and Cc at
// their strides), gy (B, S, di) and gT (B, di, N) the upstream gradients,
// hck its checkpoints; writes dx, ddt (B, S, di), dB, dC (B, S, N)
// contiguous, dA (di, N), dD (di,) and dh0 (B, di, N), through ws, the
// partials: 2 B n_dblk S N + B di N + B di floats, n_dblk = ceil(di /
// (128 / G)).  Two launches.  Returns cudaGetLastError() after the first
// that fails, or -1 for a shape it does not take (N above 32).
extern "C" int repro_selective_scan_bwd(
    const void* xc, const void* dt, const void* Bc, const void* Cc,
    const void* A, const void* D, const void* gy, const void* gT,
    const void* hck, void* dx, void* ddt, void* dB, void* dC, void* dA,
    void* dD, void* dh0, void* ws, int B, int S, int di, int N,
    int64_t b_batch, int64_t b_step, int64_t c_batch, int64_t c_step,
    void* stream) {
  const int G = N >= 1 ? lanes_for(N) : 0;
  if (B < 1 || B > 65535 || S < 1 || di < 1 || G == 0 || G > MAX_BWD_LANES)
    return -1;
  const int n_dblk = (di + FT / G - 1) / (FT / G);
  float* w = (float*)ws;
  const int64_t part = (int64_t)B * n_dblk * S * N;
  const BwdArgs args{(const float*)xc, (const float*)dt, (const float*)Bc,
                     (const float*)Cc, (const float*)A, (const float*)D,
                     (const float*)gy, (const float*)gT, (const float*)hck,
                     (float*)dx, (float*)ddt, w, w + part, w + 2 * part,
                     w + 2 * part + (int64_t)B * di * N, (float*)dh0,
                     b_batch, b_step, c_batch, c_step, B, S, di, N, n_dblk};
  cudaStream_t st = (cudaStream_t)stream;
  switch (G) {
    case 1: return launch_bwd<1>(args, (float*)dB, (float*)dC, (float*)dA,
                                 (float*)dD, st);
    case 2: return launch_bwd<2>(args, (float*)dB, (float*)dC, (float*)dA,
                                 (float*)dD, st);
    case 4: return launch_bwd<4>(args, (float*)dB, (float*)dC, (float*)dA,
                                 (float*)dD, st);
    default: return launch_bwd<8>(args, (float*)dB, (float*)dC, (float*)dA,
                                  (float*)dD, st);
  }
}
