// Flash attention backward for Hopper (sm_90a), on the CUDA cores.
// Hand-written CUDA C++; built by repro_torch/kernels/build.py into a
// shared library with a plain C interface and bound with ctypes.
//
// Replaces no TPU kernel: the JAX package trains through plain jnp
// (use_kernels=False, src/repro/configs/base.py:106) and has no backward
// kernel.  It is the gradient of the port's flash forward
// (flash_attention.cu, the port of
// src/repro/kernels/flash_attention.py:flash_attention_bhsd), which every
// training step on the card runs; kernels/flash_attention.py binds the
// two as one torch.autograd.Function -> repro_flash_attention_bwd.
//
// Layouts are the forward's: q, out, dout and dq (B, S, H, hd); k, v, dk
// and dv (B, S, KV, hd); lse and delta (B, S, H) fp32; head h = kvh * G +
// g.  Rows are the (query, head) pairs r = s * G + g of one (b, kv head).
// Query s sees key t iff t < S, t <= s when causal, and t > s - window
// when window > 0 (the forward's masks).  From the forward's natural
// log-sum-exp lse of each row's scaled scores, all in fp32:
//   D  = rowsum(dO * O)                         flash_bwd_delta_kernel
//   P  = exp(s * scale - lse), 0 where masked
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dK = scale * dS^T Q                         flash_bwd_dkdv_kernel
//   dQ = scale * dS K                           flash_bwd_dq_kernel
// dK and dV sum over the G heads of their kv head.  P and dS are never
// rounded to bf16 (the forward keeps P in fp32 as the TPU kernel does);
// dq, dk and dv are rounded once, to the inputs' dtype.
//
// Three launches and no atomics, so two calls give the same bits:
// - delta: a warp a row.
// - dK / dV: grid (B * KV, key tiles of BT keys).  A CTA keeps its key
//   tile's K and V in shared memory and dK, dV in registers, and walks the
//   row tiles (BT rows) that can see any of its keys: from query k0 under
//   causal masking, up to the tile's last key + window - 1 under a window.
// - dQ: grid (B * KV, row tiles of BT rows).  A CTA keeps its rows' Q, dO,
//   lse and D in shared memory and dQ in registers, and walks the key
//   tiles its rows can see (the forward's bounds).
// Both recompute S and dP for their tile pairs, so the products run seven
// times where five would do.
//
// What bounds it: at the training shape (bf16, B 4, S 1024 causal, H 16,
// KV 8, hd 128) the five products need 43 GFLOP, 0.043 ms at 989 TFLOP/s
// on the tensor cores, against ~101 MB of inputs and outputs (0.030 ms at
// 3.35 TB/s): operations.  This first design runs them on the CUDA cores
// in fp32 (67 TFLOP/s at the most) from operands in shared memory (one
// float4 read per 4 to 8 FMAs), so shared-memory bandwidth on the CUDA
// cores bounds it, far above the tensor-core bound.  Moving the products
// to wgmma with TMA-fed tiles is later work (ROADMAP.md, Queue 2).
#include "common.cuh"

namespace {

constexpr int BT = 32;          // rows a row tile, keys a key tile
constexpr int NT = 256;         // threads a CTA (8 warps)
constexpr int PAD = 4;          // floats past each shared tile row

struct BwdParams {
  const void* q;                // (B, S, KV, G, hd)
  const void* k;                // (B, S, KV, hd)
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
};

// the keys lo <= t <= hi query s sees
__device__ __forceinline__ int key_lo(const BwdParams& p, int s) {
  return p.window ? max(s - p.window + 1, 0) : 0;
}
__device__ __forceinline__ int key_hi(const BwdParams& p, int s) {
  return p.causal ? s : p.S - 1;
}

// Shared memory of the dK/dV and dQ kernels at head dim HD, in floats:
// the Q, dO, K and V tiles (BT rows of LD floats: the pad puts the rows
// of a quarter-warp's float4 reads in distinct banks), P and dS (BT x
// PLD), then the rows' lse and D.
template <int HD>
struct Smem {
  static constexpr int LD = HD + PAD;
  static constexpr int TILE = BT * LD;
  static constexpr int PLD = BT + 1;
  static constexpr int BYTES = (4 * TILE + 2 * BT * PLD + 2 * BT) * 4;
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

// rows r0 .. r0 + BT - 1 of (b, kvh) of a (B, S, KV, G, HD) tensor into
// dst as fp32, zeros from r_end on
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const void* src,
                                          const BwdParams& p, int b, int kvh,
                                          int r0, int r_end) {
  constexpr int C = HD / 4;
  for (int e = threadIdx.x; e < BT * C; e += NT) {
    const int i = e / C, d = (e - i * C) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + i < r_end)
      Vec<T, 4>::load(reinterpret_cast<const T*>(src) +
                          row_index(p, b, kvh, r0 + i) * HD + d, x);
    *reinterpret_cast<float4*>(dst + i * Smem<HD>::LD + d) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// keys t0 .. t0 + BT - 1 of (b, kvh) of a (B, S, KV, HD) tensor into dst
// as fp32, zeros from t_end on
template <typename T, int HD>
__device__ __forceinline__ void load_keys(float* dst, const void* src,
                                          const BwdParams& p, int b, int kvh,
                                          int t0, int t_end) {
  constexpr int C = HD / 4;
  for (int e = threadIdx.x; e < BT * C; e += NT) {
    const int j = e / C, d = (e - j * C) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (t0 + j < t_end)
      Vec<T, 4>::load(reinterpret_cast<const T*>(src) +
                          (((int64_t)b * p.S + t0 + j) * p.KV + kvh) * HD + d,
                      x);
    *reinterpret_cast<float4*>(dst + j * Smem<HD>::LD + d) =
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
// 8c, c < 4; rows from r_end on and masked keys give P = dS = 0.
template <int HD>
__device__ __forceinline__ void tile_p_ds(const BwdParams& p,
                                          const float* qs, const float* dos,
                                          const float* ks, const float* vs,
                                          const float* lse_s,
                                          const float* d_s, int r0, int r_end,
                                          int t0, float* ps, float* dss) {
  using SM = Smem<HD>;
  const int i = threadIdx.x >> 3, jj = threadIdx.x & 7;
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 qv = ld4(qs + i * SM::LD + d);
    const float4 ov = ld4(dos + i * SM::LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = jj + 8 * c;
      sc[c] = dot4(sc[c], qv, ld4(ks + j * SM::LD + d));
      dp[c] = dot4(dp[c], ov, ld4(vs + j * SM::LD + d));
    }
  }
  const int r = r0 + i;
  const bool row_ok = r < r_end;
  const int s = row_ok ? r / p.G : 0;
  const int lo = key_lo(p, s), hi = min(key_hi(p, s), p.S - 1);
  const float l = lse_s[i], dd = d_s[i];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = jj + 8 * c, t = t0 + j;
    const bool vis = row_ok && t >= lo && t <= hi;
    const float pr = vis ? expf(fmaf(sc[c], p.scale, -l)) : 0.f;
    if (ps != nullptr) ps[i * SM::PLD + j] = pr;
    dss[i * SM::PLD + j] = pr * (dp[c] - dd);
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
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const BwdParams p) {
  using SM = Smem<HD>;
  float* qs = reinterpret_cast<float*>(smem_buffer<SM::BYTES>());
  float* dos = qs + SM::TILE;
  float* ks = dos + SM::TILE;
  float* vs = ks + SM::TILE;
  float* ps = vs + SM::TILE;
  float* dss = ps + BT * SM::PLD;
  float* lse_s = dss + BT * SM::PLD;
  float* d_s = lse_s + BT;

  const int b = blockIdx.x / p.KV, kvh = blockIdx.x - b * p.KV;
  const int t0 = blockIdx.y * BT, t_end = min(t0 + BT, p.S);
  load_keys<T, HD>(ks, p.k, p, b, kvh, t0, t_end);
  load_keys<T, HD>(vs, p.v, p, b, kvh, t0, t_end);
  // the rows that see any key of the tile
  const int s_lo = p.causal ? t0 : 0;
  const int s_hi = p.window ? min(p.S - 1, t_end - 1 + p.window - 1)
                            : p.S - 1;
  const int r_end = (s_hi + 1) * p.G;
  // thread (j, c0): key j, columns c0 + 32c
  const int j = threadIdx.x >> 3, c0 = (threadIdx.x & 7) * 4;
  float4 dk[Cols<HD>::N], dv[Cols<HD>::N];
#pragma unroll
  for (int c = 0; c < Cols<HD>::N; ++c) {
    dk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[c] = dk[c];
  }
  for (int r0 = s_lo * p.G; r0 < r_end; r0 += BT) {
    __syncthreads();          // the last row tile's readers are done
    load_rows<T, HD>(qs, p.q, p, b, kvh, r0, r_end);
    load_rows<T, HD>(dos, p.dout, p, b, kvh, r0, r_end);
    load_row_stats(lse_s, d_s, p, b, kvh, r0, r_end);
    __syncthreads();
    tile_p_ds<HD>(p, qs, dos, ks, vs, lse_s, d_s, r0, r_end, t0, ps, dss);
    __syncthreads();
    for (int i = 0; i < BT; ++i) {
      const float pr = ps[i * SM::PLD + j], ds = dss[i * SM::PLD + j];
#pragma unroll
      for (int c = 0; c < Cols<HD>::N; ++c) {
        const int col = c0 + 32 * c;
        if (!Cols<HD>::in(col)) continue;
        axpy4(dv[c], pr, ld4(dos + i * SM::LD + col));
        axpy4(dk[c], ds, ld4(qs + i * SM::LD + col));
      }
    }
  }
  const int t = t0 + j;
  if (t >= p.S) return;
  const int64_t at = (((int64_t)b * p.S + t) * p.KV + kvh) * HD;
#pragma unroll
  for (int c = 0; c < Cols<HD>::N; ++c) {
    const int col = c0 + 32 * c;
    if (!Cols<HD>::in(col)) continue;
    float x[4] = {dk[c].x * p.scale, dk[c].y * p.scale, dk[c].z * p.scale,
                  dk[c].w * p.scale};
    Vec<T, 4>::store(reinterpret_cast<T*>(p.dk) + at + col, x);
    float y[4] = {dv[c].x, dv[c].y, dv[c].z, dv[c].w};
    Vec<T, 4>::store(reinterpret_cast<T*>(p.dv) + at + col, y);
  }
}

// dQ of one row tile of (b, kv head): grid (B * KV, row tiles)
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const BwdParams p) {
  using SM = Smem<HD>;
  float* qs = reinterpret_cast<float*>(smem_buffer<SM::BYTES>());
  float* dos = qs + SM::TILE;
  float* ks = dos + SM::TILE;
  float* vs = ks + SM::TILE;
  float* dss = vs + SM::TILE + BT * SM::PLD;
  float* lse_s = dss + BT * SM::PLD;
  float* d_s = lse_s + BT;

  const int b = blockIdx.x / p.KV, kvh = blockIdx.x - b * p.KV;
  const int r0 = blockIdx.y * BT, r_end = min(r0 + BT, p.S * p.G);
  load_rows<T, HD>(qs, p.q, p, b, kvh, r0, r_end);
  load_rows<T, HD>(dos, p.dout, p, b, kvh, r0, r_end);
  load_row_stats(lse_s, d_s, p, b, kvh, r0, r_end);
  // the keys any row of the tile sees
  const int k_lo = key_lo(p, r0 / p.G);
  const int k_hi = min(key_hi(p, (r_end - 1) / p.G), p.S - 1);
  // thread (i, c0): row i, columns c0 + 32c
  const int i = threadIdx.x >> 3, c0 = (threadIdx.x & 7) * 4;
  float4 dq[Cols<HD>::N];
#pragma unroll
  for (int c = 0; c < Cols<HD>::N; ++c)
    dq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = k_lo; t0 <= k_hi; t0 += BT) {
    __syncthreads();          // the last key tile's readers are done
    load_keys<T, HD>(ks, p.k, p, b, kvh, t0, min(t0 + BT, p.S));
    load_keys<T, HD>(vs, p.v, p, b, kvh, t0, min(t0 + BT, p.S));
    __syncthreads();
    tile_p_ds<HD>(p, qs, dos, ks, vs, lse_s, d_s, r0, r_end, t0, nullptr,
                  dss);
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
    Vec<T, 4>::store(reinterpret_cast<T*>(p.dq) + at + c0 + 32 * c, x);
  }
}

template <typename T, int HD>
int launch(const BwdParams& p, int B, cudaStream_t stream) {
  const int64_t n_rows = (int64_t)B * p.S * p.KV * p.G;
  flash_bwd_delta_kernel<T, HD>
      <<<(unsigned)((n_rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
          reinterpret_cast<const T*>(p.out),
          reinterpret_cast<const T*>(p.dout), const_cast<float*>(p.delta),
          n_rows);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = launch_with_smem<Smem<HD>::BYTES>(
      flash_bwd_dkdv_kernel<T, HD>, dim3(B * p.KV, (p.S + BT - 1) / BT), NT,
      stream, p);
  if (rc != 0) return rc;
  return launch_with_smem<Smem<HD>::BYTES>(
      flash_bwd_dq_kernel<T, HD>,
      dim3(B * p.KV, (p.S * p.G + BT - 1) / BT), NT, stream, p);
}

template <int HD>
int launch_dtype(int dtype, const BwdParams& p, int B, cudaStream_t stream) {
  return dtype == 1 ? launch<__nv_bfloat16, HD>(p, B, stream)
                    : launch<float, HD>(p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: q/k/v's head dim, 16 to 256;
// lse: the forward's (B, S, H) fp32 log-sum-exp; delta: (B, S, H) fp32
// scratch; dq, dk, dv: outputs in the inputs' dtype; causal: 0 or 1;
// window: 0 for none; scale: the forward's.  Launches three kernels on
// ``stream``; returns cudaGetLastError() after the first that fails (0 on
// success), -1 for a dtype or head dim it has no kernel for.
extern "C" int repro_flash_attention_bwd(
    int dtype, int hd, const void* q, const void* k, const void* v,
    const void* out, const void* dout, const float* lse, float* delta,
    void* dq, void* dk, void* dv, int B, int S, int KV, int G, int causal,
    int window, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  BwdParams p = {q, k, v, out, dout, lse, delta, dq, dk, dv,
                 S, KV, G, causal, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch_dtype<16>(dtype, p, B, st);
    case 32: return launch_dtype<32>(dtype, p, B, st);
    case 64: return launch_dtype<64>(dtype, p, B, st);
    case 128: return launch_dtype<128>(dtype, p, B, st);
    case 256: return launch_dtype<256>(dtype, p, B, st);
    default: return -1;
  }
}
