// MLA's absorbed decode attention for Hopper (sm_90a): one query token a
// sequence, all H heads of it over one shared latent cache.  Hand-written
// CUDA C++; built by repro_torch/kernels/build.py into a shared library
// with a plain C interface and bound with ctypes.
//
// Replaces no TPU kernel: the JAX package computes this step in plain jnp
// (src/repro/models/attention.py:mla_decode, the einsum chain at
// :636-643), and the port runs no plain attention on the card.  The
// absorption products around it (q_nope w_uk before, ctx w_uv after) stay
// matrix products in torch, as they are in JAX.
//
// q_lat (B, H, R) is the absorbed query, q_rope (B, H, RH) its RoPE part,
// ckv (B, L, R) the latent cache and krope (B, L, RH) its RoPE key, all
// contiguous; out is (B, H, R).  Written as attention it is one kv head
// that every query head shares: a key row is ckv || krope (R + RH wide),
// its value ckv (R wide).  Row b sees keys t < min(max(lengths[b], 0), L)
// (a length past L sees every row, as JAX's mask l <= pos does for pos >=
// L).  Scores (q_lat . ckv + q_rope . krope) * scale and P in fp32 (JAX
// rounds P to the activation dtype); out = P ckv / l.  A row of length 0
// sees no key, and its plain version's softmax over the finite NEG_INF is
// uniform: the mean of ckv over all L rows, which no_keys gives (the
// engine never asks for one: lengths = pos + 1).
//
// Bound on the card: memory bandwidth.  A live key costs R + RH elements
// (1,152 bytes in bf16 at deepseek-v2-lite's 512 + 64) against 2 H (2 R +
// RH) flops, ~16 flops a byte: the least time is the live rows' bytes over
// 3.35 TB/s (B 8 over 2,048 keys: 18.9 MB, 5.6 us).
//
// Design, a simple first kernel (the split-key plan of decode_sm90.cuh,
// without its TMA ring; wgmma over the heads is later work):
// 1. The keys of a row are split over CTAs in chunks of MLA_CHUNK, from
//    the shapes alone: grid (B, ceil(L / MLA_CHUNK)), nothing reads
//    `lengths` on the host, so a CUDA graph can capture the call.  A CTA
//    whose chunk starts at or past the row's live keys exits at once.
// 2. One CTA holds all H <= MLA_HEADS heads of its (b, chunk), so each key
//    row is read from device memory once.  The queries sit in shared
//    memory in fp32, scaled into the log2 domain; each stage of
//    MLA_STAGE key rows is converted to fp32 into shared memory (rows past
//    the live keys are zeroed, never read: 0 * NaN would be NaN), at a
//    pitch whose 16-byte offset steps through every bank group.
// 3. Scores: thread (h, j) takes head h against key j (MLA_HEADS x
//    MLA_STAGE = 256 threads).  Softmax: warp w takes heads 2w and 2w+1,
//    a half-warp a head, a lane a key (an online max and sum in fp32,
//    exp2f).  P V: thread (head group, column of 4) accumulates its heads'
//    4 latent dims in registers, rescaled when a stage moves the max.
// 4. Merge in the same launch: a row with one live chunk writes its
//    output; otherwise each CTA writes its fp32 partial (acc, m, l), and
//    the last CTA of the row, found by an atomic ticket, merges the
//    chunks in chunk order (the same result every run) and resets the
//    ticket to 0 for the next call.
#include "common.cuh"

namespace {

constexpr int MLA_CHUNK = 64;       // keys a CTA owns
constexpr int MLA_STAGE = 16;       // key rows a stage
constexpr int MLA_HEADS = 16;       // query heads a CTA holds, at most
constexpr int MLA_THREADS = MLA_HEADS * MLA_STAGE;
constexpr int MLA_WARPS = MLA_THREADS / 32;
static_assert(2 * MLA_WARPS == MLA_HEADS && 2 * MLA_STAGE == 32,
              "a half-warp's softmax a head");

struct MlaParams {
  const void* q_lat;     // (B, H, R)
  const void* q_rope;    // (B, H, RH)
  const void* ckv;       // (B, L, R)
  const void* krope;     // (B, L, RH)
  const int* lengths;    // (B,)
  void* out;             // (B, H, R)
  float* ws;             // fp32 partials: acc (B, H, n_chunks, R), then
                         //   (m, l) (B, H, n_chunks, 2)
  int* tickets;          // (B,), 0 between calls
  int B, H, L, n_chunks;
  float scale;
};

// Shared memory, in floats: the queries (MLA_HEADS rows of R + RH), a
// stage (MLA_STAGE rows at pitch KP), P of a stage, and per head the
// stage's rescale, the chunk's max and sum.
template <int R, int RH>
struct MlaSmem {
  static constexpr int W = R + RH;              // a key row's width
  static constexpr int KP = W + 4;              // its pitch
  static constexpr int Q = MLA_HEADS * W;
  static constexpr int K = MLA_STAGE * KP;
  static constexpr int P = MLA_HEADS * MLA_STAGE;
  static constexpr int BYTES = (Q + K + P + 3 * MLA_HEADS) * 4;
  // 16-byte rows whose pitch is an odd multiple of 16 bytes: 8 rows read
  // at one column land in 8 distinct bank groups
  static_assert(R % 4 == 0 && RH % 4 == 0 && (KP * 4) % 32 == 16, "widths");
};

template <typename T, int R>
__device__ void no_keys(const MlaParams& p, int b) {
  // a row of length 0: the mean of ckv over all L rows, every head
  for (int c = 4 * threadIdx.x; c < R; c += 4 * MLA_THREADS) {
    float o[4] = {0.f, 0.f, 0.f, 0.f}, x[4];
    for (int t = 0; t < p.L; ++t) {
      Vec<T, 4>::load((const T*)p.ckv + ((int64_t)b * p.L + t) * R + c, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] += x[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] /= (float)max(p.L, 1);
    for (int h = 0; h < p.H; ++h)
      Vec<T, 4>::store((T*)p.out + ((int64_t)b * p.H + h) * R + c, o);
  }
}

template <typename T, int R, int RH>
__global__ void __launch_bounds__(MLA_THREADS, 2)
    mla_decode_kernel(const MlaParams p) {
  using M = MlaSmem<R, RH>;
  constexpr int W = M::W, KP = M::KP;
  // P V: a thread takes 4 latent dims (a column) of HPT heads
  constexpr int COLS = R / 4;
  constexpr int GROUPS = MLA_THREADS / COLS;
  constexpr int HPT = (MLA_HEADS + GROUPS - 1) / GROUPS;
  static_assert(MLA_THREADS % COLS == 0, "latent rank");

  extern __shared__ float4 smem4[];
  float* const q_s = reinterpret_cast<float*>(smem4);
  float* const k_s = q_s + M::Q;
  float* const p_s = k_s + M::K;
  float* const c_s = p_s + M::P;          // a stage's rescale, per head
  float* const m_s = c_s + MLA_HEADS;     // the chunk's max, per head
  float* const l_s = m_s + MLA_HEADS;     // the chunk's sum, per head
  __shared__ int last;

  const int b = blockIdx.x, chunk = blockIdx.y, H = p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = min(max(p.lengths[b], 0), p.L);
  if (live == 0) {
    if (chunk == 0) no_keys<T, R>(p, b);
    return;
  }
  const int k0 = chunk * MLA_CHUNK;
  if (k0 >= live) return;                  // no live key in this chunk
  const int k1 = min(live, k0 + MLA_CHUNK);
  const int n_live = (live + MLA_CHUNK - 1) / MLA_CHUNK;

  // the queries, q_lat || q_rope, scaled into the log2 domain; heads past
  // H are zero (their scores are 0 and enter no output)
  const float qscale = p.scale * LOG2E;
  for (int i = tid; i < MLA_HEADS * (W / 4); i += MLA_THREADS) {
    const int h = i / (W / 4), c = (i - h * (W / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (h < H) {
      const int64_t bh = (int64_t)b * H + h;
      if (c < R)
        Vec<T, 4>::load((const T*)p.q_lat + bh * R + c, x);
      else
        Vec<T, 4>::load((const T*)p.q_rope + bh * RH + (c - R), x);
    }
    *reinterpret_cast<float4*>(q_s + h * W + c) =
        make_float4(x[0] * qscale, x[1] * qscale, x[2] * qscale,
                    x[3] * qscale);
  }

  const int col = tid % COLS, hg = tid / COLS;
  float acc[HPT][4];
#pragma unroll
  for (int i = 0; i < HPT; ++i)
#pragma unroll
    for (int d = 0; d < 4; ++d) acc[i][d] = 0.f;
  // the online softmax of head 2 warp + (lane >> 4), in both half-warps
  float m_run = NEG_INF, l_run = 0.f;

  for (int key0 = k0; key0 < k1; key0 += MLA_STAGE) {
    const int nk = min(MLA_STAGE, k1 - key0);
    __syncthreads();                       // the last stage is read
    // the stage's rows, ckv || krope in fp32; rows past nk zero
    for (int i = tid; i < MLA_STAGE * (W / 4); i += MLA_THREADS) {
      const int j = i / (W / 4), c = (i - j * (W / 4)) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nk) {
        const int64_t row = (int64_t)b * p.L + key0 + j;
        if (c < R)
          Vec<T, 4>::load((const T*)p.ckv + row * R + c, x);
        else
          Vec<T, 4>::load((const T*)p.krope + row * RH + (c - R), x);
      }
      *reinterpret_cast<float4*>(k_s + j * KP + c) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();
    {
      // the score of head h against key j
      const int j = tid % MLA_STAGE, h = tid / MLA_STAGE;
      const float* qh = q_s + h * W;
      const float* kj = k_s + j * KP;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = 0; c < W; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qh + c);
        const float4 k = *reinterpret_cast<const float4*>(kj + c);
        part[0] = fmaf(a.x, k.x, part[0]);
        part[1] = fmaf(a.y, k.y, part[1]);
        part[2] = fmaf(a.z, k.z, part[2]);
        part[3] = fmaf(a.w, k.w, part[3]);
      }
      p_s[h * MLA_STAGE + j] = (part[0] + part[1]) + (part[2] + part[3]);
    }
    __syncthreads();
    {
      // the online softmax: a half-warp a head, a lane a key
      const int h = 2 * warp + (lane >> 4), j = lane & 15;
      const float s = p_s[h * MLA_STAGE + j];
      float mx = j < nk ? s : NEG_INF;
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float mn = fmaxf(m_run, mx);
      const float corr = exp2f(m_run - mn);
      const float pj = j < nk ? exp2f(s - mn) : 0.f;
      float sum = pj;
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      l_run = l_run * corr + sum;
      m_run = mn;
      p_s[h * MLA_STAGE + j] = pj;
      if (j == 0) c_s[h] = corr;
    }
    __syncthreads();
    // O = O * corr + P V over the stage's live keys
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const int h = hg * HPT + i;
      if (h >= MLA_HEADS) break;
      const float corr = c_s[h];
#pragma unroll
      for (int d = 0; d < 4; ++d) acc[i][d] *= corr;
    }
    for (int j = 0; j < nk; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(k_s + j * KP +
                                                        4 * col);
#pragma unroll
      for (int i = 0; i < HPT; ++i) {
        const int h = hg * HPT + i;
        if (h >= MLA_HEADS) break;
        const float pj = p_s[h * MLA_STAGE + j];
        acc[i][0] = fmaf(pj, v.x, acc[i][0]);
        acc[i][1] = fmaf(pj, v.y, acc[i][1]);
        acc[i][2] = fmaf(pj, v.z, acc[i][2]);
        acc[i][3] = fmaf(pj, v.w, acc[i][3]);
      }
    }
  }
  if ((lane & 15) == 0) {
    m_s[2 * warp + (lane >> 4)] = m_run;
    l_s[2 * warp + (lane >> 4)] = l_run;
  }
  __syncthreads();

  float* const ws_ml = p.ws + (int64_t)p.B * H * p.n_chunks * R;
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    const int h = hg * HPT + i;
    if (h >= H) break;
    const int64_t bh = (int64_t)b * H + h;
    if (n_live == 1) {                     // the whole row: the output
      const float inv = 1.f / fmaxf(l_s[h], 1e-30f);
      float o[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) o[d] = acc[i][d] * inv;
      Vec<T, 4>::store((T*)p.out + bh * R + 4 * col, o);
    } else {                               // the chunk's partial
      const int64_t slot = bh * p.n_chunks + chunk;
      *reinterpret_cast<float4*>(p.ws + slot * R + 4 * col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (col == 0) {
        ws_ml[2 * slot] = m_s[h];
        ws_ml[2 * slot + 1] = l_s[h];
      }
    }
  }
  if (n_live == 1) return;
  // the last CTA of the row to finish merges the chunks in order
  __threadfence();                         // release this thread's partial
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(p.tickets + b, 1) == n_live - 1;
    if (last) {
      __threadfence();                     // acquire the other partials
      p.tickets[b] = 0;                    // zero again for the next call
    }
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    const int h = hg * HPT + i;
    if (h >= H) break;
    const int64_t bh = (int64_t)b * H + h;
    float mx = NEG_INF, li = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < n_live; ++c) {
      const int64_t slot = bh * p.n_chunks + c;
      const float mc = __ldcg(ws_ml + 2 * slot);
      const float lc = __ldcg(ws_ml + 2 * slot + 1);
      const float4 a = __ldcg(
          reinterpret_cast<const float4*>(p.ws + slot * R + 4 * col));
      const float mn = fmaxf(mx, mc);
      const float wo = exp2f(mx - mn), wc = exp2f(mc - mn);
      li = li * wo + lc * wc;
      o[0] = o[0] * wo + a.x * wc; o[1] = o[1] * wo + a.y * wc;
      o[2] = o[2] * wo + a.z * wc; o[3] = o[3] * wo + a.w * wc;
      mx = mn;
    }
    const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int d = 0; d < 4; ++d) o[d] *= inv;
    Vec<T, 4>::store((T*)p.out + bh * R + 4 * col, o);
  }
}

template <typename T, int R, int RH>
int launch_mla(const MlaParams& p, cudaStream_t stream) {
  constexpr int smem = MlaSmem<R, RH>::BYTES;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel<T, R, RH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  mla_decode_kernel<T, R, RH>
      <<<dim3(p.B, p.n_chunks), MLA_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; (r, rh) the latent rank and the RoPE
// width: (512, 64) in both, (32, 8) in fp32.  ws is an fp32 workspace of B
// * H * n_chunks * (r + 2) floats and tickets B int32 counters, zero
// before the first call (the kernel leaves them zero); n_chunks =
// ceil(L / MLA_CHUNK).  Returns cudaGetLastError() after the launch (0 on
// success), -1 for a dtype, widths or head count it has no kernel for.
extern "C" int repro_mla_decode_attention(
    int dtype, int r, int rh, const void* q_lat, const void* q_rope,
    const void* ckv, const void* krope, const void* lengths, void* out,
    void* ws, void* tickets, int B, int H, int L, int n_chunks, float scale,
    void* stream) {
  if (H < 1 || H > MLA_HEADS || B < 1 || L < 1) return -1;
  MlaParams p = {};
  p.q_lat = q_lat; p.q_rope = q_rope; p.ckv = ckv; p.krope = krope;
  p.lengths = (const int*)lengths;
  p.out = out;
  p.ws = (float*)ws;
  p.tickets = (int*)tickets;
  p.B = B; p.H = H; p.L = L; p.n_chunks = n_chunks;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (r == 512 && rh == 64) {
    if (dtype == 0) return launch_mla<float, 512, 64>(p, st);
    if (dtype == 1) return launch_mla<__nv_bfloat16, 512, 64>(p, st);
  }
  if (r == 32 && rh == 8 && dtype == 0)
    return launch_mla<float, 32, 8>(p, st);
  return -1;
}

// MLA_CHUNK and MLA_HEADS, for the wrapper's plan (repro_torch/kernels/
// mla_decode.py), which checks them when it loads the library.
extern "C" int repro_mla_chunk_keys() { return MLA_CHUNK; }
extern "C" int repro_mla_max_heads() { return MLA_HEADS; }

// The dynamic shared memory the kernel asks for at (r, rh), for the build
// report; 0 for a pair it has no kernel for.
extern "C" int repro_mla_smem(int r, int rh) {
  if (r == 512 && rh == 64) return MlaSmem<512, 64>::BYTES;
  if (r == 32 && rh == 8) return MlaSmem<32, 8>::BYTES;
  return 0;
}
