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
// engine never asks for one: lengths = pos + 1).  Rows past the live keys
// may hold anything (a slot's stale rows, NaN): they enter no sum.
//
// Bound on the card: memory bandwidth.  A live key costs R + RH elements
// (1,152 bytes in bf16 at deepseek-v2-lite's 512 + 64) against 2 H (2 R +
// RH) flops, ~30 flops a byte at H 16: the least time is the live rows'
// bytes over 3.35 TB/s (B 8 over 2,048 keys: 18.9 MB, 5.6 us).  At the
// serve's ~315 keys a row the bytes are 2.9 MB (0.9 us), so what a call
// costs is latency: the launch, the first key tile's load (one SM takes
// in ~25-30 bytes a clock), two chains of tensor-core products a tile,
// the merge of the splits.
//
// The split, shared by both kernels (one plan in the wrapper,
// repro_torch/kernels/mla_decode.py, whose `splits` mirrors mla_split):
// the grid is (B, s_max) with s_max = min(ceil(L / min_keys),
// MLA_MAX_SPLITS, SMs / B), from the shapes alone, so nothing reads
// `lengths` on the host and a CUDA graph can capture the call.  CTA (b, s)
// reads lengths[b] and takes n = clamp(ceil(live / min_keys), 1, s_max)
// near-equal splits of the live keys, each a whole number of MLA_GRAIN
// keys but the last; a CTA with s >= n has no keys.  A row with one split
// writes its output from that split's CTA.  Otherwise the splits are
// merged in split order (the same result every run): by the bf16 kernel
// across its cluster, by the fp32 one through a workspace (below).
//
// bf16 at (512, 64): mla_decode_sm90_kernel, warp-specialised as the flash
// kernel is (attention_sm90.cuh), in the transposed form, keys as wgmma's
// M and the 16 heads as its N, so no row of a product is padding:
//   - warp 4, the producer, brings the split's key tiles (MLA_TILE rows of
//     ckv || krope, nine column blocks of 64 rows x 128 bytes in the 128 B
//     swizzle) by TMA into a ring of MLA_STAGES mbarrier stages: one box of
//     64 rows a column block for a full tile, else one of MLA_GRAIN rows
//     for each piece of the tile that holds a live key;
//   - warps 0-3, one consumer warpgroup, hold the queries in shared memory
//     as bf16 (16 rows x 576, the same swizzle) and for each tile compute
//     S^T = K Q^T (m64n16k16, 36 k-steps over ckv || krope, both operands
//     K-major in shared memory), mask the keys past the split, take each
//     head's max over the tile's 64 keys (shuffles, then the four warps
//     through shared memory), and write P^T as bf16 hi + lo (P = hi + lo
//     to ~2^-16, so P V keeps fp32 accuracy as the flash kernel's two
//     wgmma do) into shared memory: 32 rows, hi heads then lo heads, K-
//     major.  O^T += V^T P^T is then m64n32k16 over 8 blocks of 64 latent
//     dims and the k-steps of 16 keys that hold a live key, with V^T the
//     tile's own ckv columns read MN-major (V is the key tile: nothing is
//     loaded twice) and both halves of P in one product; the accumulator
//     is 8 x 16 fp32 a thread, and the output sums its hi and lo halves.
//     V rows of the last k-step past the split's live keys are zeroed in
//     shared memory before P V, as flash does: TMA brings whatever the
//     cache holds there, and 0 * NaN is NaN.
//   - a row's CTAs are one cluster of (1, s_max).  Each split stages its O
//     in the drained ring and sends O and (m, l) of head h, with 16-byte
//     stores into distributed shared memory, to the inbox of CTA h mod
//     s_max; after one cluster barrier each CTA merges its heads from its
//     own shared memory.  A merge on one SM through global memory (a
//     ticket, the last CTA reading every partial) was tried first and
//     measured: one SM takes in its n x 33 KB at ~25 bytes a clock, which
//     cost more than the keys at n 8-16 (PERF.md, section 6).
//
// fp32 (parity runs only) at (512, 64) and (32, 8): mla_decode_kernel on
// the CUDA cores, one CTA a split, all H <= MLA_HEADS heads of it.  The
// queries sit in shared memory in fp32, scaled into the log2 domain; each
// stage of MLA_STAGE key rows is loaded into shared memory (rows past the
// live keys zeroed, never read); thread (h, j) scores head h against key
// j, a half-warp a head runs the online softmax, and thread (head group,
// column of 4) accumulates P V in registers.  Each split writes its fp32
// partial (acc, m, l) to the workspace, and the last CTA of the row, found
// by an atomic ticket, merges them and resets the ticket to 0.
#include <mutex>
#include <unordered_map>

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace {

constexpr int MLA_GRAIN = 16;       // keys: a split boundary's multiple
constexpr int MLA_HEADS = 16;       // query heads a CTA holds, at most
// the fp32 kernel on the CUDA cores
constexpr int MLA_STAGE = 16;       // key rows a stage
constexpr int MLA_THREADS = MLA_HEADS * MLA_STAGE;
constexpr int MLA_WARPS = MLA_THREADS / 32;
static_assert(2 * MLA_WARPS == MLA_HEADS && 2 * MLA_STAGE == 32,
              "a half-warp's softmax a head");
// the bf16 wgmma kernel
constexpr int MLA_TILE = 64;        // key rows a stage (wgmma's M)
constexpr int MLA_STAGES = 2;       // stages in the ring
constexpr int MLA_MAX_SPLITS = 8;   // s_max: a cluster, at most (portable)
// inbox slots: the largest s ceil(MLA_HEADS / s) over s <= MLA_MAX_SPLITS
constexpr int mla_inbox_slots() {
  int most = 0;
  for (int s = 1; s <= MLA_MAX_SPLITS; ++s) {
    const int n = s * ((MLA_HEADS + s - 1) / s);
    most = n > most ? n : most;
  }
  return most;
}
constexpr int MLA_INBOX = mla_inbox_slots();
constexpr int MLA_CONSUMERS = 128;  // one consumer warpgroup
constexpr int MLA_SM90_THREADS = MLA_CONSUMERS + 32;  // + the producer

struct MlaParams {
  const void* q_lat;     // (B, H, R)
  const void* q_rope;    // (B, H, RH)
  const void* ckv;       // (B, L, R)
  const void* krope;     // (B, L, RH)
  const int* lengths;    // (B,)
  void* out;             // (B, H, R)
  float* ws;             // fp32 partials: acc (B, s_max, H, R), then
                         //   (m, l) (B, s_max, H, 2), m in the log2 domain
  int* tickets;          // (B,), 0 between calls
  int B, H, L, s_max, min_keys;
  float scale;
};

// The row's live keys, its split count n, and split s's keys [x, y): the
// live keys' MLA_GRAIN-key grains dealt out as evenly as integers allow
// (n <= the grains, since min_keys >= MLA_GRAIN, so no split is empty).
__device__ __forceinline__ int mla_live(const MlaParams& p, int b) {
  return min(max(p.lengths[b], 0), p.L);
}
__device__ __forceinline__ int mla_n_splits(const MlaParams& p, int live) {
  return max(1, min(p.s_max, (live + p.min_keys - 1) / p.min_keys));
}
__device__ __forceinline__ int2 mla_split(int live, int n, int s) {
  const int g = (live + MLA_GRAIN - 1) / MLA_GRAIN;
  return make_int2(MLA_GRAIN * (s * g / n),
                   min(live, MLA_GRAIN * ((s + 1) * g / n)));
}

template <typename T, int R>
__device__ void no_keys(const MlaParams& p, int b) {
  // a row of length 0: the mean of ckv over all L rows, every head
  for (int c = 4 * threadIdx.x; c < R; c += 4 * blockDim.x) {
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

// ---------------------------------------------------------------------
// fp32 on the CUDA cores

// Shared memory, in floats: the queries (MLA_HEADS rows of R + RH), a
// stage (MLA_STAGE rows at pitch KP), P of a stage, and per head the
// stage's rescale, the split's max and sum.
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
  float* const m_s = c_s + MLA_HEADS;     // the split's max, per head
  float* const l_s = m_s + MLA_HEADS;     // the split's sum, per head
  __shared__ int last;

  const int b = blockIdx.x, split = blockIdx.y, H = p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = mla_live(p, b);
  if (live == 0) {
    if (split == 0) no_keys<T, R>(p, b);
    return;
  }
  const int n_live = mla_n_splits(p, live);
  if (split >= n_live) return;             // the row has fewer splits
  const int2 ks = mla_split(live, n_live, split);
  const int k0 = ks.x, k1 = ks.y;

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

  float* const ws_ml = p.ws + (int64_t)p.B * H * p.s_max * R;
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
    } else {                               // the split's partial
      const int64_t slot = ((int64_t)b * p.s_max + split) * H + h;
      *reinterpret_cast<float4*>(p.ws + slot * R + 4 * col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (col == 0) {
        ws_ml[2 * slot] = m_s[h];
        ws_ml[2 * slot + 1] = l_s[h];
      }
    }
  }
  if (n_live == 1) return;
  // the last CTA of the row to finish merges the splits in order
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
      const int64_t slot = ((int64_t)b * p.s_max + c) * H + h;
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

// ---------------------------------------------------------------------
// bf16 on wgmma

// wgmma m64n16k16, bf16 in, fp32 accumulate: d (+)= A B with A (64 x 16)
// and B (16 x 16) both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n16_ss(float (&d)[8], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// wgmma m64n32k16, bf16 in, fp32 accumulate: d += A B with A (64 x 16)
// MN-major (transposed) and B (16 x 32) K-major, both in shared memory.
__device__ __forceinline__ void wgmma_m64n32_ss_ta(float (&d)[16],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// byte offset of (row, byte) in a 1024-aligned block of 128-byte rows in
// the 128 B swizzle, as TMA writes it and wgmma reads it
__device__ __forceinline__ uint32_t swz128(uint32_t off) {
  return off ^ ((off >> 3) & 0x70u);
}

// Shared memory of the bf16 kernel at (R, RH): the queries (NCB column
// blocks of MLA_HEADS rows x 128 bytes), MLA_STAGES key tiles (NCB column
// blocks of MLA_TILE rows x 128 bytes: R / 64 of ckv, then RH / 64 of
// krope), P^T (2 MLA_HEADS rows x MLA_TILE keys, bf16), per warp and head
// the tile's max and the sum, per head the split's (m, l), the merge's
// inbox, the barriers.  After the last tile, stage 0 holds the split's O
// (MLA_HEADS rows of R fp32 at pitch OP), which it sends to the inboxes.
template <int R, int RH>
struct MlaRing {
  static constexpr int NCB = (R + RH) / 64;     // column blocks
  static constexpr int VCB = R / 64;            // those of ckv (V)
  static constexpr int QBLOCK = MLA_HEADS * 128;
  static constexpr int KBLOCK = MLA_TILE * 128;
  static constexpr int Q = 0;
  static constexpr int STAGE0 = NCB * QBLOCK;
  static constexpr int STAGE = NCB * KBLOCK;
  static constexpr int P = STAGE0 + MLA_STAGES * STAGE;
  static constexpr int RED = P + 2 * MLA_HEADS * 128;
  static constexpr int LRED = RED + 4 * MLA_HEADS * 4;
  static constexpr int ML = LRED + 4 * MLA_HEADS * 4;
  // the merge's inbox: the splits' O of the heads this CTA merges, slot
  // (head / s_max) s_max + split, R fp32 each, and their (m, l)
  static constexpr int INBOX = ML + 2 * MLA_HEADS * 4;
  static constexpr int IN_ML = INBOX + MLA_INBOX * R * 4;
  static constexpr int BARS = IN_ML + MLA_INBOX * 8;
  static constexpr int SMEM = BARS + 16 * MLA_STAGES + 1024;  // + alignment
  static constexpr int OP = R + 4;
  static_assert(R % 64 == 0 && RH % 64 == 0 && QBLOCK % 1024 == 0 &&
                MLA_HEADS * OP * 4 <= STAGE && SMEM <= 232448, "ring");
};

// stores into another CTA's shared memory (an address from cluster_map)
__device__ __forceinline__ void st_cluster_f4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_cluster_f2(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
               ::"r"(addr), "f"(v.x), "f"(v.y) : "memory");
}

// an arrival on the cluster's barrier that orders nothing: every CTA
// arrives so when it starts, and a wait on it before the first access to
// another CTA's shared memory makes sure that CTA is running
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The consumer warpgroup's share of a split of row b: the queries into
// shared memory, then for each of the split's n_tiles tiles (n_keys keys
// in all) S^T, the online softmax and O^T += V^T P^T, and last the split's
// O (hi + lo, not yet divided by l) into stage 0 and each head's (m in the
// log2 domain, l) into ML.  Ends on the consumers' barrier.
template <int R, int RH>
__device__ __forceinline__ void mla_split_sm90(const MlaParams& p, int b,
                                               int n_tiles, int n_keys,
                                               uint8_t* smem0,
                                               uint32_t base) {
  using G = MlaRing<R, RH>;
  using T = __nv_bfloat16;
  constexpr int W = R + RH, KS = W / 16;   // k-steps of S
  const uint32_t q_s = base + G::Q, p_s = base + G::P;
  auto stage = [&](int st) { return base + G::STAGE0 + G::STAGE * st; };
  auto full = [&](int st) { return base + G::BARS + 8 * st; };
  auto empty = [&](int st) { return base + G::BARS + 8 * (MLA_STAGES + st); };
  float* const red = reinterpret_cast<float*>(smem0 + base + G::RED);
  float* const lred = reinterpret_cast<float*>(smem0 + base + G::LRED);
  float* const ml_s = reinterpret_cast<float*>(smem0 + base + G::ML);
  const int H = p.H, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the queries as wgmma's B (K-major), heads past H zero (their scores
  // are 0 and enter no output); every load issued before the first store
  constexpr int QN = MLA_HEADS * (W / 8) / MLA_CONSUMERS;
  static_assert(QN * MLA_CONSUMERS == MLA_HEADS * (W / 8), "queries");
  uint4 qv[QN];
#pragma unroll
  for (int u = 0; u < QN; ++u) {
    const int i = tid + u * MLA_CONSUMERS;
    const int h = i / (W / 8), c = (i - h * (W / 8)) * 8;
    const int64_t bh = (int64_t)b * H + h;
    qv[u] = make_uint4(0u, 0u, 0u, 0u);
    if (h < H)
      qv[u] = c < R ? *reinterpret_cast<const uint4*>((const T*)p.q_lat +
                                                      bh * R + c)
                    : *reinterpret_cast<const uint4*>((const T*)p.q_rope +
                                                      bh * RH + (c - R));
  }
#pragma unroll
  for (int u = 0; u < QN; ++u) {
    const int i = tid + u * MLA_CONSUMERS;
    const int h = i / (W / 8), c = (i - h * (W / 8)) * 8, cb = c / 64;
    *reinterpret_cast<uint4*>(smem0 + q_s + cb * G::QBLOCK +
                              swz128(h * 128 + (c - cb * 64) * 2)) = qv[u];
  }
  fence_proxy_async();
  consumer_sync();

  const int gq = lane >> 2, tq = lane & 3;
  // the thread's heads: hd(k) = 2 tq + (k & 1) + 8 (k >> 1), k = 0..3
  auto hd = [&](int k) { return 2 * tq + (k & 1) + 8 * (k >> 1); };
  const float qscale = p.scale * LOG2E;
  float o[G::VCB][16];
#pragma unroll
  for (int c = 0; c < G::VCB; ++c)
#pragma unroll
    for (int j = 0; j < 16; ++j) o[c][j] = 0.f;
  // the running max of the raw scores (the same in every thread) and this
  // thread's share of the sums, per head k
  float m[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  constexpr uint32_t SBO = 8 * 128;       // bytes between 8-row groups

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % MLA_STAGES;
    const int nk = min(MLA_TILE, n_keys - i * MLA_TILE);
    // P V's k-steps of 16 keys: those that hold a live key
    const int ksteps = (nk + MLA_GRAIN - 1) / MLA_GRAIN;
    mbar_wait(full(st), (i / MLA_STAGES) & 1);
    if (nk % MLA_GRAIN) {
      // zero the V rows of the last k-step past the split's live keys,
      // which TMA brought from the cache (whole 128-byte rows, so the
      // swizzle does not matter)
      const int per = (MLA_GRAIN * ksteps - nk) * 8;  // 16-byte chunks
      for (int idx = tid; idx < G::VCB * per; idx += MLA_CONSUMERS) {
        const int cb = idx / per, rest = idx - cb * per;
        *reinterpret_cast<uint4*>(smem0 + stage(st) + cb * G::KBLOCK +
                                  nk * 128 + rest * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      consumer_sync();
    }

    // S^T = K Q^T
    float sc[8];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      const int cb = kc / 4, in = (kc % 4) * 32;
      wgmma_m64n16_ss(sc,
                      smem_desc(stage(st) + cb * G::KBLOCK + in, SBO, 1),
                      smem_desc(q_s + cb * G::QBLOCK + in, SBO, 1), kc > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // sc[j]: key 16 warp + gq + 8 ((j >> 1) & 1), head hd(2 (j >> 2) +
    // (j & 1)); keys past the split's live ones masked (a select: a NaN
    // score from a stale row is dropped)
    if (nk < MLA_TILE) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (16 * warp + gq + 8 * ((j >> 1) & 1) >= nk) sc[j] = NEG_INF;
    }
    float mx[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * (k >> 1) + (k & 1);
      mx[k] = fmaxf(sc[j], sc[j + 2]);
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1)
        mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], sh));
      if (gq == 0) red[warp * MLA_HEADS + hd(k)] = mx[k];
    }
    consumer_sync();
    float corr[4], neg[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float mn = m[k];
#pragma unroll
      for (int w = 0; w < 4; ++w) mn = fmaxf(mn, red[w * MLA_HEADS + hd(k)]);
      corr[k] = ex2((m[k] - mn) * qscale);
      m[k] = mn;
      l[k] *= corr[k];
      neg[k] = -mn * qscale;               // mn is a live key's score
    }
    // P^T as bf16 hi (rows 0-15) and lo (rows 16-31), K-major
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 2 * (j >> 2) + (j & 1);
      const int key = 16 * warp + gq + 8 * ((j >> 1) & 1);
      const float e = ex2(fmaf(sc[j], qscale, neg[k]));
      l[k] += e;
      const __nv_bfloat16 hi = __float2bfloat16_rn(e);
      const __nv_bfloat16 lo = __float2bfloat16_rn(e - __bfloat162float(hi));
      *reinterpret_cast<__nv_bfloat16*>(smem0 + p_s +
                                        swz128(hd(k) * 128 + key * 2)) = hi;
      *reinterpret_cast<__nv_bfloat16*>(
          smem0 + p_s + swz128((MLA_HEADS + hd(k)) * 128 + key * 2)) = lo;
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f ||
                                    corr[2] != 1.f || corr[3] != 1.f)) {
      // o[c][j] is head hd(2 ((j >> 2) & 1) + (j & 1)), hi or lo
#pragma unroll
      for (int c = 0; c < G::VCB; ++c)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          o[c][j] *= corr[2 * ((j >> 2) & 1) + (j & 1)];
    }
    fence_proxy_async();
    consumer_sync();

    // O^T += V^T P^T, 16 keys a k-step, over the k-steps with a live key
    // (the V rows past them hold stale data)
#pragma unroll
    for (int c = 0; c < G::VCB; ++c) pin(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MLA_TILE / 16; ++kk) {
      if (kk >= ksteps) break;
#pragma unroll
      for (int c = 0; c < G::VCB; ++c)
        wgmma_m64n32_ss_ta(
            o[c],
            smem_desc(stage(st) + c * G::KBLOCK + kk * 16 * 128, SBO, 1),
            smem_desc(p_s + kk * 32, SBO, 1));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < G::VCB; ++c) pin(o[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // the sums over the lanes of a quad position (gq), then over the warps
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int sh = 4; sh < 32; sh <<= 1)
      l[k] += __shfl_xor_sync(0xffffffffu, l[k], sh);
  consumer_sync();                         // every warp's products done
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (gq == 0) {
      lred[warp * MLA_HEADS + hd(k)] = l[k];
      if (warp == 0) ml_s[2 * hd(k)] = m[k] * qscale;   // log2 domain
    }
  }
  // O = hi + lo into the drained stage 0, (head, dim) at pitch OP
  float* const o_s = reinterpret_cast<float*>(smem0 + stage(0));
#pragma unroll
  for (int c = 0; c < G::VCB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o_s[hd(2 * (j >> 2) + (j & 1)) * G::OP + 64 * c + 16 * warp + gq +
          8 * ((j >> 1) & 1)] = o[c][j] + o[c][j + 8];
  consumer_sync();
  if (tid < MLA_HEADS)
    ml_s[2 * tid + 1] = (lred[tid] + lred[MLA_HEADS + tid]) +
                        (lred[2 * MLA_HEADS + tid] + lred[3 * MLA_HEADS + tid]);
  consumer_sync();
}

// Grid (B, s_max), cluster (1, s_max): a row's splits are one cluster, and
// split s is the CTA of rank s.  MLA_SM90_THREADS threads.  Consumer thread
// (warp, gq = lane / 4, tq = lane % 4) holds, of S^T, keys 16 warp + gq +
// 8 i (i = 0, 1) of the tile and heads 2 tq + j + 8 k (j, k = 0, 1); of
// O^T, latent dims 64 c + 16 warp + gq + 8 i of each block c, for the same
// heads, hi and lo.
template <int R, int RH>
__global__ void __launch_bounds__(MLA_SM90_THREADS, 1)
    mla_decode_sm90_kernel(const __grid_constant__ CUtensorMap ckv_tile,
                           const __grid_constant__ CUtensorMap ckv_grain,
                           const __grid_constant__ CUtensorMap kr_tile,
                           const __grid_constant__ CUtensorMap kr_grain,
                           const MlaParams p) {
  using G = MlaRing<R, RH>;
  using T = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem0 = smem_raw - raw;   // generic address of shared 0
  auto stage = [&](int st) { return base + G::STAGE0 + G::STAGE * st; };
  auto full = [&](int st) { return base + G::BARS + 8 * st; };
  auto empty = [&](int st) { return base + G::BARS + 8 * (MLA_STAGES + st); };
  const float* const ml_s = reinterpret_cast<float*>(smem0 + base + G::ML);
  const float* const o_s = reinterpret_cast<float*>(smem0 + stage(0));

  const int b = blockIdx.x, split = blockIdx.y, H = p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = mla_live(p, b);
  if (live == 0) {                         // the whole cluster leaves
    if (split == 0) no_keys<T, R>(p, b);
    return;
  }
  const int n = mla_n_splits(p, live);
  // one split: its CTA writes the output, the others leave; more: every
  // CTA of the cluster, past the splits too, takes part in the merge
  if (n == 1 && split > 0) return;
  if (n > 1) cluster_arrive_relaxed();
  if (split < n) {
    const int2 ks = mla_split(live, n, split);
    const int k0 = ks.x, k1 = ks.y;
    const int n_tiles = (k1 - k0 + MLA_TILE - 1) / MLA_TILE;
    if (tid == 0) {
      for (int st = 0; st < MLA_STAGES; ++st) {
        mbar_init(full(st), 1);
        mbar_init(empty(st), MLA_CONSUMERS / 32);
      }
      fence_mbar_init();
    }
    __syncthreads();

    if (warp == MLA_CONSUMERS / 32) {
      // producer: the split's key tiles, one box of 64 rows a column
      // block for a full tile, else one of MLA_GRAIN rows a column block
      // for each piece that holds a live key
      if (lane == 0) {
        for (int i = 0; i < n_tiles; ++i) {
          const int st = i % MLA_STAGES, key0 = k0 + i * MLA_TILE;
          const int nk = min(MLA_TILE, k1 - key0);
          const int row = b * p.L + key0;
          if (i >= MLA_STAGES)
            mbar_wait(empty(st), ((i / MLA_STAGES) & 1) ^ 1);
          if (nk == MLA_TILE) {
            mbar_expect_tx(full(st), G::NCB * G::KBLOCK);
            for (int cb = 0; cb < G::NCB; ++cb)
              tma_load_2d(stage(st) + cb * G::KBLOCK,
                          cb < G::VCB ? &ckv_tile : &kr_tile, full(st),
                          64 * (cb < G::VCB ? cb : cb - G::VCB), row);
          } else {
            const int pieces = (nk + MLA_GRAIN - 1) / MLA_GRAIN;
            mbar_expect_tx(full(st), pieces * G::NCB * MLA_GRAIN * 128);
            for (int cb = 0; cb < G::NCB; ++cb)
              for (int pc = 0; pc < pieces; ++pc)
                tma_load_2d(
                    stage(st) + cb * G::KBLOCK + pc * MLA_GRAIN * 128,
                    cb < G::VCB ? &ckv_grain : &kr_grain, full(st),
                    64 * (cb < G::VCB ? cb : cb - G::VCB),
                    row + pc * MLA_GRAIN);
          }
        }
      }
    } else {
      mla_split_sm90<R, RH>(p, b, n_tiles, k1 - k0, smem0, base);
      if (n == 1) {
        // the whole row: O / l into the output, thread tid dims 4 tid ..
        const int d = 4 * tid;
#pragma unroll
        for (int h = 0; h < MLA_HEADS; ++h) {
          if (h >= H) break;
          const float4 v =
              *reinterpret_cast<const float4*>(o_s + h * G::OP + d);
          const float inv = 1.f / fmaxf(ml_s[2 * h + 1], 1e-30f);
          const float x[4] = {v.x * inv, v.y * inv, v.z * inv, v.w * inv};
          Vec<T, 4>::store((T*)p.out + ((int64_t)b * H + h) * R + d, x);
        }
      }
    }
  }
  if (n == 1) return;
  // the merge: CTA r merges heads r, r + s_max, ...  Each split sends its
  // O of head h (16-byte stores, thread tid dims 4 tid .. 4 tid + 3) and
  // its (m, l) into the inbox of h's CTA, then arrives on the cluster's
  // barrier (release); once every CTA has, each merges its heads over the
  // splits 0 .. n - 1 in that order from its own shared memory.  Nothing
  // reads another CTA's shared memory, so a CTA may leave once it is done.
  __syncwarp();
  cluster_wait();                          // every CTA of the cluster runs
  const int d = 4 * tid;
  const int hpc = (MLA_HEADS + p.s_max - 1) / p.s_max;   // heads a CTA
  auto slot = [&](int h, int c) { return (h / p.s_max) * p.s_max + c; };
  if (split < n && tid < MLA_CONSUMERS) {
    for (int h = 0; h < H; ++h) {
      const uint32_t to = cluster_map(
          base + G::INBOX + (uint32_t)(slot(h, split) * R + d) * 4,
          h % p.s_max);
      st_cluster_f4(to, *reinterpret_cast<const float4*>(o_s + h * G::OP +
                                                          d));
    }
    if (tid < H)
      st_cluster_f2(cluster_map(base + G::IN_ML + 8 * slot(tid, split),
                                tid % p.s_max),
                    make_float2(ml_s[2 * tid], ml_s[2 * tid + 1]));
  }
  cluster_arrive();                        // release: the inboxes are full
  cluster_wait();
  if (tid >= MLA_CONSUMERS) return;
  const float* const inbox =
      reinterpret_cast<const float*>(smem0 + base + G::INBOX);
  const float2* const in_ml =
      reinterpret_cast<const float2*>(smem0 + base + G::IN_ML);
  for (int u = 0; u < hpc; ++u) {
    const int h = split + u * p.s_max;
    if (h >= H) break;
    float2 ml[MLA_MAX_SPLITS];
    float4 v[MLA_MAX_SPLITS];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < MLA_MAX_SPLITS; ++c) {
      if (c < n) {
        ml[c] = in_ml[slot(h, c)];
        v[c] = *reinterpret_cast<const float4*>(inbox + slot(h, c) * R + d);
        mx = fmaxf(mx, ml[c].x);
      }
    }
    float li = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < MLA_MAX_SPLITS; ++c) {
      if (c < n) {
        const float w = exp2f(ml[c].x - mx);
        li = fmaf(ml[c].y, w, li);
        o[0] = fmaf(v[c].x, w, o[0]);
        o[1] = fmaf(v[c].y, w, o[1]);
        o[2] = fmaf(v[c].z, w, o[2]);
        o[3] = fmaf(v[c].w, w, o[3]);
      }
    }
    const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] *= inv;
    Vec<T, 4>::store((T*)p.out + ((int64_t)b * H + h) * R + d, o);
  }
}

// ---------------------------------------------------------------------
// Host side

// The tensor map of a contiguous bf16 (rows, cols) matrix, boxes of {64
// columns, box_rows rows} in the 128 B swizzle, rows past the end read as
// zeros.  Encoded once per (tensor, shape, box) and kept: the same tensor
// at the same shape gets the same map.  Returns 0, or ERR_NO_ENCODER /
// ERR_BAD_MAP.
int mla_map(CUtensorMap* map, const void* base, uint64_t rows,
            uint64_t cols, int box_rows) {
  struct Key {
    const void* base;
    uint64_t rows, cols;
    int box;
    bool operator==(const Key& o) const {
      return base == o.base && rows == o.rows && cols == o.cols &&
             box == o.box;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      size_t h = std::hash<const void*>()(k.base);
      for (uint64_t x : {k.rows, k.cols, (uint64_t)k.box})
        h = h * 1000003u ^ std::hash<uint64_t>()(x);
      return h;
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> kept;
  const Key key = {base, rows, cols, box_rows};
  std::lock_guard<std::mutex> hold(mu);
  const auto it = kept.find(key);
  if (it != kept.end()) {
    *map = it->second;
    return 0;
  }
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_BAD_MAP;
  if (kept.size() >= 4096) kept.clear();   // bounded: stale entries go
  kept.emplace(key, *map);
  return 0;
}

// grid (B, s_max), clusters of (1, s_max): a row's splits
template <int R, int RH>
int launch_mla_sm90(const MlaParams& p, cudaStream_t stream) {
  const uint64_t rows = (uint64_t)p.B * p.L;
  CUtensorMap maps[4];
  int rc = mla_map(&maps[0], p.ckv, rows, R, MLA_TILE);
  if (rc == 0) rc = mla_map(&maps[1], p.ckv, rows, R, MLA_GRAIN);
  if (rc == 0) rc = mla_map(&maps[2], p.krope, rows, RH, MLA_TILE);
  if (rc == 0) rc = mla_map(&maps[3], p.krope, rows, RH, MLA_GRAIN);
  if (rc != 0) return rc;
  constexpr int smem = MlaRing<R, RH>::SMEM;
  static std::once_flag once;
  static cudaError_t attr = cudaSuccess;
  std::call_once(once, [] {
    attr = cudaFuncSetAttribute(mla_decode_sm90_kernel<R, RH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  });
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B, p.s_max);
  cfg.blockDim = dim3(MLA_SM90_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = p.s_max;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, mla_decode_sm90_kernel<R, RH>, maps[0], maps[1], maps[2],
      maps[3], p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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
      <<<dim3(p.B, p.s_max), MLA_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; (r, rh) the latent rank and the RoPE
// width: (512, 64) in both, (32, 8) in fp32.  ws is an fp32 workspace of B
// * H * s_max * (r + 2) floats and tickets B int32 counters, zero before
// the first call (the kernel leaves them zero); the grid is (B, s_max),
// s_max <= MLA_MAX_SPLITS,
// and a row takes min(s_max, ceil(live / min_keys)) splits (min_keys >=
// MLA_GRAIN).  Returns cudaGetLastError() after the launch (0 on success),
// -1 for a dtype, widths, head count or plan it has no kernel for,
// ERR_NO_ENCODER or ERR_BAD_MAP for a tensor map.
extern "C" int repro_mla_decode_attention(
    int dtype, int r, int rh, const void* q_lat, const void* q_rope,
    const void* ckv, const void* krope, const void* lengths, void* out,
    void* ws, void* tickets, int B, int H, int L, int s_max, int min_keys,
    float scale, void* stream) {
  if (H < 1 || H > MLA_HEADS || B < 1 || L < 1 || s_max < 1 ||
      s_max > MLA_MAX_SPLITS || min_keys < MLA_GRAIN)
    return -1;
  MlaParams p = {};
  p.q_lat = q_lat; p.q_rope = q_rope; p.ckv = ckv; p.krope = krope;
  p.lengths = (const int*)lengths;
  p.out = out;
  p.ws = (float*)ws;
  p.tickets = (int*)tickets;
  p.B = B; p.H = H; p.L = L; p.s_max = s_max; p.min_keys = min_keys;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (r == 512 && rh == 64) {
    if (dtype == 0) return launch_mla<float, 512, 64>(p, st);
    if (dtype == 1) return launch_mla_sm90<512, 64>(p, st);
  }
  if (r == 32 && rh == 8 && dtype == 0)
    return launch_mla<float, 32, 8>(p, st);
  return -1;
}

// MLA_GRAIN, MLA_HEADS, MLA_TILE and MLA_MAX_SPLITS, for the wrapper's plan
// (repro_torch/kernels/mla_decode.py), which checks them when it loads the
// library.
extern "C" int repro_mla_grain_keys() { return MLA_GRAIN; }
extern "C" int repro_mla_max_heads() { return MLA_HEADS; }
extern "C" int repro_mla_tile_keys() { return MLA_TILE; }
extern "C" int repro_mla_max_splits() { return MLA_MAX_SPLITS; }

// The dynamic shared memory the kernel asks for at (dtype, r, rh), for the
// build report; 0 for one it has no kernel for.
extern "C" int repro_mla_smem(int dtype, int r, int rh) {
  if (dtype == 1) return r == 512 && rh == 64 ? MlaRing<512, 64>::SMEM : 0;
  if (r == 512 && rh == 64) return MlaSmem<512, 64>::BYTES;
  if (r == 32 && rh == 8) return MlaSmem<32, 8>::BYTES;
  return 0;
}
