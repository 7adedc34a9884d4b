// One attention design for Hopper (sm_90a), shared by the bf16 flash
// prefill (flash_attention.cu) and the bf16 paged extend
// (paged_attention.cu): warp-specialised, with K/V tiles brought in by TMA
// into a ring of mbarrier-guarded stages and both products on wgmma.
//
// Rows are the (query, head) pairs r = s * G + g of one (b, kv head), so
// the G heads of a KV head share every K/V tile.  A CTA owns 64 rows (one
// wgmma M) and has 160 threads:
//   - warps 0-3, the consumer warpgroup, read the CTA's Q tile once into
//     shared memory (plain 16-byte loads, swizzled as wgmma reads it), then
//     walk the key tiles: S = Q K^T by wgmma m64n64k16 with both operands
//     in shared memory (K-major); mask and online softmax in fp32 registers
//     in the log2 domain; O += P V by wgmma with P from registers (the
//     score accumulator's layout is the A fragment's) and V from shared
//     memory as an MN-major B.  P stays at fp32 accuracy as in the TPU
//     kernels (p @ v in fp32): it enters as hi = bf16(P) plus
//     lo = bf16(P - hi), two wgmma into one fp32 accumulator.
//   - warp 4, the producer, keeps NST stages of 64 keys of K and V in
//     flight: it waits on a stage's "empty" barrier, then fills it by TMA
//     (the source decides how: one 4-d box per 64-column block of a dense
//     (B, S, KV, hd) tensor, or one box per page of a block pool read
//     through the block table), which completes the stage's "full"
//     barrier.  The consumers wait on "full" and arrive on "empty".
// The producer is one warp, not a warpgroup, so no setmaxnreg.  Two CTAs
// fit an SM (the 82,976 bytes of shared memory at hd = 128, and the
// registers, which __launch_bounds__ caps at 204 a thread for two CTAs),
// so one CTA's softmax overlaps the other's wgmma.
//
// What bounds it: at hd = 128 a 64-key tile is ~768 clocks of tensor work
// (S, then P V twice for hi and lo), and the softmax on the CUDA cores
// took more than that until it was cut to ~7 instructions an element:
// masks only on tiles some row does not fully see, the max taken on raw
// scores with the scale folded into the exp2's FMA, ex2.approx, the
// rescale skipped when no row's max moved.
//
// Shared memory holds each 64-row tile (Q, or a stage's K or V) as column
// blocks of 64 rows x SWB bytes, SWB = min(2 * hd, 128), in the swizzle of
// that span (128 B for hd >= 64, 64 B at 32, 32 B at 16): TMA writes it,
// wgmma reads it, and the Q loads apply the same XOR by hand.
//
// A source (DenseSrc in flash_attention.cu, PagedSrc in paged_attention.cu)
// gives, for query s of sequence b, the keys lo <= t <= hi it may see, and
// fills a stage.  Masked scores are the finite NEG_INF, masked keys add
// p = 0, and the output is acc / max(l, 1e-30).  V rows of the last tile
// past the CTA's last visible key are zeroed before P V: a page-granular
// copy brings in whatever the pool holds there, and 0 * NaN is NaN.
// A CTA walks every key its rows see; the key range is not split over
// CTAs.
#pragma once

#include <limits.h>

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace {

// ---------------------------------------------------------------------
// PTX wrappers (the mbarrier, proxy-fence, named-barrier, exp2 and TMA
// ones are in sm90_ptx.cuh)

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers
// across the fence / wait that orders them
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A shared-memory matrix descriptor: start address, the byte stride
// between 8-row groups (given as both the leading and the stride offset:
// each wgmma here spans one swizzle atom along the other axis, so the
// field that axis would use is never read), and the swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint64_t swizzle_code) {
  const uint64_t s = (sbo >> 4) & 0x3FFF;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (s << 16) | (s << 32) |
         (swizzle_code << 62);
}

// ---------------------------------------------------------------------
// wgmma m64nNk16, bf16 in, fp32 accumulate.  ss: d (+)= A B with A
// (64 x 16, Q) and B (16 x 64, K^T) both K-major in shared memory.  rs:
// d += A B with A (64 x 16, P) in registers and B (16 x N, V) MN-major in
// shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// ---------------------------------------------------------------------
// Tile geometry for head dim HD.  A 64-row tile is NCB column blocks of
// 64 rows x SWB bytes (BW columns).
constexpr int TILE = 64;                 // rows per CTA and keys per stage
constexpr int CONSUMERS = 128;           // one consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp

template <int HD>
struct Tile {
  static constexpr int SWB = HD * 2 < 128 ? HD * 2 : 128;  // swizzle span
  static constexpr int BW = SWB / 2;          // columns per block
  static constexpr int NCB = HD / BW;         // column blocks
  static constexpr int BLOCK = TILE * SWB;    // bytes of one column block
  static constexpr int BYTES = NCB * BLOCK;   // bytes of one tile
  static constexpr int NST = HD >= 128 ? 2 : 3;  // K/V stages in the ring
  static constexpr uint64_t SWIZZLE = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;
  // Q, the ring, 2 * NST barriers, and slack to align the base to 1024
  static constexpr int SMEM = BYTES * (1 + 2 * NST) + 16 * NST + 1024;
  static_assert(HD % 16 == 0 && NCB * BW == HD, "head_dim");
};

// byte offset of (row, 16-byte chunk) inside a column block, swizzled as
// TMA writes it (Swizzle<log2(SWB/16), 4, 3>)
template <int SWB>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ ((off >> 3) & ((SWB / 16 - 1) << 4));
}

struct AttnParams {
  const __nv_bfloat16* q;            // (B, S, KV, G, hd)
  __nv_bfloat16* out;                // (B, S, KV, G, hd)
  const __nv_bfloat16* k;            // the key and value source, as the
  const __nv_bfloat16* v;            //   source reads it
  const int* bt;                     // paged: (B, nb) block table
  const int* pos0;                   // paged: (B,) first query position
  int S, KV, G;                      // queries, kv heads, heads per kv head
  int causal, window;                // dense masks
  int nb, bs, n_pool_rows, box_rows;  // paged
  int n_row_tiles;
  float scale;
};

// Grid (B * KV, row tiles), THREADS threads: rows row0 .. row0 + 63 of
// (b, kv head) over every key they see.  Consumer
// thread (warp, gq, tq) holds rows row0 + 16 * warp + gq + 8 * h (h = 0,
// 1) of the mma layout.
template <int HD, class Src>
__global__ void __launch_bounds__(THREADS, 2) attention_sm90_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const AttnParams p) {
  using T = Tile<HD>;
  constexpr int KS = HD / 16;            // k-steps of Q K^T
  constexpr int ON = T::BW / 2;          // accumulator floats per block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem0 = smem_raw - raw;   // generic address of shared 0
  const uint32_t q_s = base;
  const uint32_t bars = base + T::BYTES * (1 + 2 * T::NST);
  auto k_s = [&](int st) { return base + T::BYTES * (1 + 2 * st); };
  auto v_s = [&](int st) { return base + T::BYTES * (2 + 2 * st); };
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (T::NST + st); };

  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv - b * p.KV;
  const int rt = p.n_row_tiles - 1 - blockIdx.y;   // heaviest tiles first
  const int n_rows = p.S * p.G, row0 = rt * TILE;
  const int rows = min(TILE, n_rows - row0);
  // the keys any row of the tile may see: [beg, end); none leaves the
  // rows' output 0
  const int beg = Src::bounds(p, b, row0 / p.G).x;
  const int end = Src::bounds(p, b, (row0 + rows - 1) / p.G).y + 1;
  const int t0 = beg & ~(TILE - 1);
  const int n_tiles = end > beg ? (end - t0 + TILE - 1) / TILE : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < T::NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == CONSUMERS / 32) {
    // producer: keep the ring full
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % T::NST;
      if (lane == 0) mbar_wait(empty(st), ((i / T::NST) & 1) ^ 1);
      __syncwarp();
      Src::template load_tile<HD>(p, &kmap, &vmap, b, kvh, t0 + TILE * i,
                                  k_s(st), v_s(st), full(st), smem0,
                                  lane);
    }
    return;
  }

  // consumers: Q into shared memory, rows past the end zero
  const int64_t q_row = (int64_t)b * p.S * p.KV * p.G + (int64_t)kvh * p.G;
  for (int idx = threadIdx.x; idx < TILE * HD / 8; idx += CONSUMERS) {
    const int r = idx / (HD / 8), col = (idx - r * (HD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const int rr = row0 + r, s = rr / p.G, g = rr - s * p.G;
      val = *reinterpret_cast<const uint4*>(
          p.q + (q_row + (int64_t)s * p.KV * p.G + g) * HD + col);
    }
    const int cb = col / T::BW;
    *reinterpret_cast<uint4*>(
        smem0 + q_s + cb * T::BLOCK +
        swizzle<T::SWB>(r * T::SWB + (col - cb * T::BW) * 2)) = val;
  }
  fence_proxy_async();
  consumer_sync();

  const int gq = lane >> 2, tq = lane & 3;
  int lo[2], hi[2];
  int64_t off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + gq + 8 * h;
    const int rr = r < n_rows ? r : row0, s = rr / p.G, g = rr - s * p.G;
    const int2 kb = Src::bounds(p, b, s);
    lo[h] = r < n_rows ? kb.x : INT_MAX;
    hi[h] = r < n_rows ? kb.y : -1;
    off[h] = (q_row + (int64_t)s * p.KV * p.G + g) * HD;
  }
  // the keys every row of the CTA sees: no mask inside them
  const int all_lo =
      rows == TILE ? Src::bounds(p, b, (row0 + TILE - 1) / p.G).x : INT_MAX;
  const int all_hi = rows == TILE ? Src::bounds(p, b, row0 / p.G).y : -1;
  float o[T::NCB][ON];
#pragma unroll
  for (int cb = 0; cb < T::NCB; ++cb)
#pragma unroll
    for (int j = 0; j < ON; ++j) o[cb][j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float qscale = p.scale * LOG2E;
  constexpr uint32_t SBO = 8 * T::SWB;   // bytes between 8-row groups

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % T::NST, key0 = t0 + TILE * i;
    mbar_wait(full(st), (i / T::NST) & 1);
    if (end - key0 < TILE) {
      // zero the V rows past the last key any row here may see
      const int z0 = end - key0;
      for (int idx = threadIdx.x; idx < T::NCB * (TILE - z0) * (T::SWB / 16);
           idx += CONSUMERS) {
        const int cb = idx / ((TILE - z0) * (T::SWB / 16));
        const int rest = idx - cb * (TILE - z0) * (T::SWB / 16);
        *reinterpret_cast<uint4*>(smem0 + v_s(st) + cb * T::BLOCK +
                                  z0 * T::SWB + rest * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      consumer_sync();
    }

    // S = Q K^T
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      const int cb = kc * 16 / T::BW, in = (kc * 16 - cb * T::BW) * 2;
      Wgmma<64>::ss(sc,
                    smem_desc(q_s + cb * T::BLOCK + in, SBO, T::SWIZZLE),
                    smem_desc(k_s(st) + cb * T::BLOCK + in, SBO, T::SWIZZLE),
                    kc > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // mask where some row does not see the whole tile: sc[4 * c8 + j] is
    // row gq + 8 * (j >> 1), key key0 + 8 * c8 + 2 * tq + (j & 1); the
    // running max m is of the raw scores
    if (key0 < all_lo || key0 + TILE - 1 > all_hi) {
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = j >> 1, key = key0 + 8 * c8 + 2 * tq + (j & 1);
          if (key < lo[h] || key > hi[h]) sc[4 * c8 + j] = NEG_INF;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 32; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
    float corr[2], neg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = ex2((m[h] - mx[h]) * qscale);
      m[h] = mx[h];
      l[h] *= corr[h];
      // p = 2^(s * qscale - m * qscale); a masked score (NEG_INF) gives
      // 2^(-2.5e37) = 0, also in a row that has seen no key yet (offset 0)
      neg[h] = mx[h] > NEG_INF ? -mx[h] * qscale : 0.f;
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int cb = 0; cb < T::NCB; ++cb)
#pragma unroll
        for (int j = 0; j < ON; ++j) o[cb][j] *= corr[(j >> 1) & 1];
    }
    // P as hi + lo A fragments, 16 keys per k-step
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j0 = 4 * (2 * kk + (a >> 1)) + 2 * (a & 1), h = a & 1;
        const float e0 = ex2(fmaf(sc[j0], qscale, neg[h]));
        const float e1 = ex2(fmaf(sc[j0 + 1], qscale, neg[h]));
        l[h] += e0 + e1;
        split_bf2(e0, e1, ph[kk][a], pl[kk][a]);
      }

    // O += P V
#pragma unroll
    for (int cb = 0; cb < T::NCB; ++cb) pin(o[cb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < T::NCB; ++cb) {
        const uint64_t dv = smem_desc(
            v_s(st) + cb * T::BLOCK + kk * 16 * T::SWB, SBO, T::SWIZZLE);
        Wgmma<T::BW>::rs(o[cb], pl[kk], dv);
        Wgmma<T::BW>::rs(o[cb], ph[kk], dv);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < T::NCB; ++cb) pin(o[cb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // the quad's partial sums of l, then the rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (row0 + warp * 16 + gq + 8 * h >= n_rows) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int cb = 0; cb < T::NCB; ++cb)
#pragma unroll
      for (int c8 = 0; c8 < ON / 4; ++c8)
        *reinterpret_cast<uint32_t*>(p.out + off[h] + cb * T::BW + 8 * c8 +
                                     2 * tq) =
            f_to_bf2(o[cb][4 * c8 + 2 * h] * inv,
                     o[cb][4 * c8 + 2 * h + 1] * inv);
  }
}

// ---------------------------------------------------------------------
// Host side (the lookup of the tensor-map encoder is in sm90_ptx.cuh).
// A map over a contiguous bf16 tensor of dims (d3, d2, d1, HD), boxes of
// {BW columns, 1, box_rows, 1} in the tile's swizzle; coordinates past a
// dim's end read as zeros.
template <int HD>
int encode_map(CUtensorMap* map, const void* base, uint64_t d1, uint64_t d2,
               uint64_t d3, int box_rows) {
  using T = Tile<HD>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {HD, d1, d2, d3};
  const cuuint64_t strides[3] = {HD * 2, HD * 2 * d1, HD * 2 * d1 * d2};
  const cuuint32_t box[4] = {T::BW, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = T::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : T::SWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_BAD_MAP;
}

// grid (B * KV, row tiles) of the attention kernel
template <int HD, class Src>
int launch_attention(const CUtensorMap& kmap, const CUtensorMap& vmap,
                     const AttnParams& p, int B, cudaStream_t stream) {
  constexpr int smem = Tile<HD>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      attention_sm90_kernel<HD, Src>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  attention_sm90_kernel<HD, Src>
      <<<dim3(B * p.KV, p.n_row_tiles), THREADS, smem, stream>>>(kmap, vmap,
                                                                p);
  return (int)cudaGetLastError();
}

}  // namespace

// The dynamic shared memory the kernel asks for at head dim hd, for the
// build report; 0 for a head dim it has no kernel for.
extern "C" int repro_attention_sm90_smem(int hd) {
  switch (hd) {
    case 16: return Tile<16>::SMEM;
    case 32: return Tile<32>::SMEM;
    case 64: return Tile<64>::SMEM;
    case 128: return Tile<128>::SMEM;
    default: return 0;
  }
}
