// The fp32 pair score on Hopper's tensor cores (sm_90a): 3xTF32 on wgmma,
// fed by a TMA ring, with the depth split over the CTAs of a cluster.
// Included by pair_score.cu, which keeps the CUDA-core kernels for the
// other routes (bf16 inputs, widths d with d % 4 != 0).  The measurements
// behind each choice, on an H100, are in PERF.md, section 6.
//
// One kernel, two instantiations, one launch each per call:
//   PROJECT: P^T = W^T C^T, written to the workspace as P = C W (N x d),
//     and lin = [C w_c ; E w_e] on the CUDA cores, by the producer warp
//     between its copies;
//   SCORE:   out = P E^T + lin[i] + lin[N + j] + b, launched as a
//     programmatic dependent of PROJECT: its CTAs start on free SMs while
//     the projection's epilogue runs, copy their first evidence tiles, and
//     wait for the projection only before they read P and lin.
// Both compute D (rows x cols) = A (rows x K) B^T with B (cols x K)
// K-major: a TF32 wgmma reads a shared-memory operand K-major only (the
// transpose bits exist for 16-bit types alone), and W is (K x d) row-major,
// so the projection makes W the A operand, read from shared memory into
// registers, where the layout is free.  A is K-major in SCORE (P).
//
// 3xTF32.  Every operand x is split into hi = tf32(x) and lo = tf32(x -
// hi), rounded as cvt.rna.tf32.f32 rounds; the products lo_A hi_B,
// hi_A lo_B, then hi_A hi_B of a stage go into one fp32 accumulator,
// small terms first; lo_A lo_B (2^-22 of the product) is dropped.  A TF32
// product is exact in fp32, but the tensor cores' own fp32 sums are not
// rounded to nearest: over the 384 wgmma of a 1024-deep chunk their error
// grew to 7.8e-6 of the largest score on an H100.  So each stage's products
// start a fresh accumulator, and the stages are summed in fp32 registers
// by the CUDA cores, rounding to nearest: the tensor cores sum 12 wgmma
// at a time, and the error is ~3e-7 of the largest score.
//
// A CTA owns a 128 x 128 tile of D and one chunk of the depth, with three
// warpgroups (384 threads, so ptxas allows 168 registers a thread):
//   - warp 8 keeps PAIR_NST stages of 32 deep (one 128-byte swizzle row of
//     fp32) in flight by TMA into an mbarrier ring (A: one box of 128
//     rows, or four of 32 columns of W; B: one box of 128 rows);
//   - warps 9-11 split each stage's B as it lands: hi over the landed tile
//     in place, lo into the stage's lo tile, fence.proxy.async, then
//     "split done"; they run ahead of the products, so no accumulator is
//     live while a split runs (a consumer that split B as well spilled);
//   - warpgroups 0 and 1 (rows 0-63, 64-127) each load their A fragments
//     from the stage (split in registers), wait for "split done", issue
//     12 wgmma m64n128k8 with A from registers, wait, add the stage into
//     their sums and release the stage.  They take turns to issue, on two
//     named barriers (FA3's way), so one's products run while the other
//     loads its next A and sums; without turns they issued together, and
//     both waited for both.  No wgmma is in flight across a loop
//     iteration (ptxas serialised every wgmma of a design that kept one
//     in flight, C7515).
// One B split serves both warpgroups: at tiles of 64 rows, the split's
// shared-memory traffic, beside wgmma's own reads of B, set the time.
// The loop runs at ~1.3 us a stage against the 0.84 of the tensor cores'
// peak: a stage moves ~200 KB through the SM's shared memory (copies, the
// split, A, and both warpgroups' wgmma reading B three times), about what
// it serves in that time.
//
// The depth is split over the `split` CTAs of a cluster (grid (row tiles,
// column tiles, split), cluster (1, 1, split)), chosen from the shapes by
// kernels/pair_plan.py for as few waves of clusters as the card's GPCs
// allow: at the batch path's (256, 512, 1024), 16 projection tiles x 6 and
// 8 score tiles x 8; at 1024^3, 64 tiles x 2.  Each CTA puts its partial
// tile in its own shared memory; after a cluster barrier, CTA r sums
// slice r of the tile over the CTAs 0, 1, ..., split - 1 in that order
// through distributed shared memory (all of a thread's loads in flight at
// once) and writes it.  So the order of every sum is fixed by
// the shapes, and the same inputs give the same bits from call to call (a
// link is score > 0), with no atomics and no partials in device memory.
//
// Ragged edges: TMA reads coordinates past a tensor's end as zeros, so a
// tile past N, M or d, or a depth past d, adds nothing; stores are masked.
// TMA needs rows of a multiple of 16 bytes (d % 4 == 0) and 16-byte
// aligned bases (the wrapper checks both).
#pragma once

#include <mutex>
#include <unordered_map>
#include <utility>

#include "sm90_ptx.cuh"

namespace {

constexpr int PAIR_BM = 128;            // rows of D a CTA: a warpgroup 64
constexpr int PAIR_BN = 128;            // columns of D a CTA (wgmma N)
constexpr int PAIR_BK = 32;             // depth a stage: 128 bytes of fp32
constexpr int PAIR_NST = 4;             // stages in the ring
constexpr int PAIR_MAX_SPLIT = 8;       // CTAs a cluster, at most (portable)
constexpr int PAIR_CONSUMERS = 256;     // two warpgroups: rows 0-63, 64-127
constexpr int PAIR_SPLITTERS = 96;      // warps 9-11: B's hi / lo split
constexpr int PAIR_THREADS = PAIR_CONSUMERS + 128;  // + producer warpgroup
constexpr int PAIR_A_BYTES = PAIR_BM * PAIR_BK * 4;  // 16 KB
constexpr int PAIR_B_BYTES = PAIR_BN * PAIR_BK * 4;  // 16 KB
// a stage: A, B (hi after the split), B's lo
constexpr int PAIR_STAGE = PAIR_A_BYTES + 2 * PAIR_B_BYTES;
constexpr int PAIR_TMA_BYTES = PAIR_A_BYTES + PAIR_B_BYTES;
// the ring, SCORE's linear terms of its rows and columns, 3 * NST
// barriers, and slack to align to 1024
constexpr int PAIR_SMEM =
    PAIR_NST * PAIR_STAGE + 4 * (PAIR_BM + PAIR_BN) + 24 * PAIR_NST + 1024;
// the CTA's partial tile, over the drained ring: SCORE keeps it row-major
// (128 x 128, rows padded to 132 floats), PROJECT transposed, so that the
// epilogue reads 16 bytes along the output's contiguous axis
constexpr int PAIR_ROW = 132;
static_assert(PAIR_BM == PAIR_BN && PAIR_BM * PAIR_ROW * 4 <=
              PAIR_NST * PAIR_STAGE, "partial tile");

__host__ __device__ constexpr int pair_cdiv(int a, int b) {
  return (a + b - 1) / b;
}

struct PairParams {
  int rows, cols, K;       // D (rows x cols) = A (rows x K) B^T
  int n_steps, per_split;  // depth steps of PAIR_BK; steps a CTA's chunk
  int N, M;                // claims, evidence
  float* P;                // PROJECT: P (N x d), P[n][m] = D[m][n]
  float* lin;              // [C w_c ; E w_e], N + M
  const float* C;          // PROJECT: the rows of lin
  const float* E;
  const float* w_c;
  const float* w_e;
  float* out;              // SCORE: (N x M)
  const float* bias;       // SCORE: one value
};

// The epilogue of a CTA of a cluster of SPLIT: slice `rank` of the tile
// (float4 q, 16 bytes along the output's contiguous axis), summed over the
// partial tiles of CTAs 0, 1, ..., SPLIT - 1 in that order, then stored.
// A load from another CTA's shared memory crosses the SMs' network, so a
// thread issues all of its loads (QPT float4 of SPLIT partials, at most
// 16) before the first sum, then arrives on the cluster's barrier, which
// it waits on before leaving: no CTA leaves while its tile is read, and
// the wait is over by the time the stores are.
template <bool PROJECT, int SPLIT>
__device__ __forceinline__ void pair_reduce(const PairParams& p,
                                            uint32_t base,
                                            const uint8_t* smem0,
                                            const float* lin_s, int m0,
                                            int n0) {
  constexpr int NQ = PAIR_BM * PAIR_BN / 4;
  constexpr int QPT = pair_cdiv(pair_cdiv(NQ, SPLIT), PAIR_THREADS);
  const int rank = (int)cluster_rank();
  const int q_beg = rank * NQ / SPLIT, q_end = (rank + 1) * NQ / SPLIT;
  // the first of a float4's elements: D row r, column c
  auto row = [](int q) { return PROJECT ? (q % (PAIR_BM / 4)) * 4
                                        : q / (PAIR_BN / 4); };
  auto col = [](int q) { return PROJECT ? q / (PAIR_BM / 4)
                                        : (q % (PAIR_BN / 4)) * 4; };
  float4 w[QPT][SPLIT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int q = min(q_beg + (int)threadIdx.x + u * PAIR_THREADS,
                      q_end - 1);
    const uint32_t off = (PROJECT ? col(q) * PAIR_ROW + row(q)
                                  : row(q) * PAIR_ROW + col(q)) * 4;
#pragma unroll
    for (int s = 0; s < SPLIT; ++s)       // its own partial from its own
      w[u][s] = s == rank                 // shared memory
          ? *reinterpret_cast<const float4*>(smem0 + base + off)
          : ld_cluster_f4(cluster_map(base + off, s));
  }
  cluster_arrive();
  const float b0 = PROJECT ? 0.f : *p.bias;
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int q = q_beg + threadIdx.x + u * PAIR_THREADS;
    if (q >= q_end) break;
    float4 v = w[u][0];
#pragma unroll
    for (int s = 1; s < SPLIT; ++s) {
      v.x += w[u][s].x; v.y += w[u][s].y;
      v.z += w[u][s].z; v.w += w[u][s].w;
    }
    const int r = row(q), c = col(q), i = m0 + r, j = n0 + c;
    if (PROJECT) {              // P[j][i .. i + 3] (d % 4 == 0)
      if (i < p.rows && j < p.cols)
        *reinterpret_cast<float4*>(p.P + (int64_t)j * p.rows + i) = v;
      continue;
    }
    if (i >= p.rows) continue;
    const float lc = lin_s[r];
    float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = o[e] + lc + lin_s[PAIR_BM + c + e] + b0;
    float* dst = p.out + (int64_t)i * p.cols + j;
    if (p.cols % 4 == 0 && j < p.cols) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < p.cols) dst[e] = o[e];
    }
  }
  cluster_wait();
}

// Grid (row tiles, column tiles, split), cluster (1, 1, split),
// PAIR_THREADS threads, PAIR_SMEM bytes of dynamic shared memory.
template <bool PROJECT>
__global__ void __launch_bounds__(PAIR_THREADS, 1) pair_sm90_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap bmap, const PairParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem0 = smem_raw - raw;   // generic address of shared 0
  auto a_s = [&](int st) { return base + PAIR_STAGE * st; };
  auto b_s = [&](int st) { return a_s(st) + PAIR_A_BYTES; };
  auto lo_s = [&](int st) { return b_s(st) + PAIR_B_BYTES; };
  float* const lin_s =           // SCORE: lin[m0 + r], then lin[N + n0 + c]
      reinterpret_cast<float*>(smem0 + base + PAIR_STAGE * PAIR_NST);
  const uint32_t bars =
      base + PAIR_STAGE * PAIR_NST + 4 * (PAIR_BM + PAIR_BN);
  auto full = [&](int st) { return bars + 8 * st; };
  auto split_done = [&](int st) { return bars + 8 * (PAIR_NST + st); };
  auto empty = [&](int st) { return bars + 8 * (2 * PAIR_NST + st); };

  const int m0 = blockIdx.x * PAIR_BM, n0 = blockIdx.y * PAIR_BN;
  const int k_beg = blockIdx.z * p.per_split;
  const int n_iter = max(0, min(p.n_steps - k_beg, p.per_split));

  if (threadIdx.x == 0) {
    for (int st = 0; st < PAIR_NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(split_done(st), PAIR_SPLITTERS / 32);
      mbar_init(empty(st), 8);          // every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp > PAIR_CONSUMERS / 32) {
    // splitters: B of each stage as it lands, hi over the landed tile in
    // place and lo into the stage's lo tile (same layout); the last
    // products that read either were the stage's previous fill's, which
    // every consumer warp waited for before the producer refilled it
    const int t = threadIdx.x - PAIR_CONSUMERS - 32;
    for (int i = 0; i < n_iter; ++i) {
      const int st = i % PAIR_NST;
      mbar_wait(full(st), (i / PAIR_NST) & 1);
      for (int q = t; q < PAIR_B_BYTES / 16; q += PAIR_SPLITTERS) {
        uint4* src = reinterpret_cast<uint4*>(smem0 + b_s(st) + 16 * q);
        const float4 v = *reinterpret_cast<const float4*>(src);
        uint4 h, l;
        split_tf32(v.x, h.x, l.x);
        split_tf32(v.y, h.y, l.y);
        split_tf32(v.z, h.z, l.z);
        split_tf32(v.w, h.w, l.w);
        *src = h;
        *reinterpret_cast<uint4*>(smem0 + lo_s(st) + 16 * q) = l;
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(split_done(st));
    }
    if (PROJECT) launch_dependents();
  } else if (warp == PAIR_CONSUMERS / 32) {
    // producer: keep the ring full; PROJECT also computes the lin rows
    // cta, cta + n_cta, ... on the CUDA cores, one a stage once the ring
    // is full (the rest after its last copy), a row's loads all in flight
    // (d <= 1024 in one pass)
    const int n_cta = gridDim.x * gridDim.y * gridDim.z;
    int r = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    auto lin_row = [&]() {
      const float* x = r < p.N ? p.C + (int64_t)r * p.K
                               : p.E + (int64_t)(r - p.N) * p.K;
      const float* w = r < p.N ? p.w_c : p.w_e;
      float s = 0.f;
      for (int k0 = 0; k0 < p.K; k0 += 1024) {
        float4 xv[8], wv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int k = k0 + 128 * u + lane * 4;
          xv[u] = k < p.K ? *reinterpret_cast<const float4*>(x + k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          wv[u] = k < p.K ? *reinterpret_cast<const float4*>(w + k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          s = fmaf(xv[u].x, wv[u].x, s);
          s = fmaf(xv[u].y, wv[u].y, s);
          s = fmaf(xv[u].z, wv[u].z, s);
          s = fmaf(xv[u].w, wv[u].w, s);
        }
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, sh);
      if (lane == 0) p.lin[r] = s;
      r += n_cta;
    };
    // SCORE may start while the projection finishes (programmatic
    // dependent launch): it copies the evidence (B) of the first stages,
    // then waits for the projection before it copies P (A), and stages
    // the linear terms of the tile's rows and columns for the epilogue
    const int n_pre = PROJECT ? 0 : min(n_iter, PAIR_NST);
    if (lane == 0)
      for (int i = 0; i < n_pre; ++i) {
        mbar_expect_tx(full(i), PAIR_TMA_BYTES);
        tma_load_2d(b_s(i), &bmap, full(i), (k_beg + i) * PAIR_BK, n0);
      }
    if (!PROJECT) {
      grid_dependency_wait();
      if (lane == 0)
        for (int i = 0; i < n_pre; ++i)
          tma_load_2d(a_s(i), &amap, full(i), (k_beg + i) * PAIR_BK, m0);
      for (int t = lane; t < PAIR_BM + PAIR_BN; t += 32) {
        const bool in = t < PAIR_BM ? m0 + t < p.rows
                                    : n0 + t - PAIR_BM < p.cols;
        lin_s[t] = in ? p.lin[t < PAIR_BM ? m0 + t
                                          : p.N + n0 + t - PAIR_BM]
                      : 0.f;
      }
    }
    for (int i = n_pre; i < n_iter; ++i) {
      const int st = i % PAIR_NST, k0 = (k_beg + i) * PAIR_BK;
      if (lane == 0) {
        mbar_wait(empty(st), ((i / PAIR_NST) & 1) ^ 1);
        mbar_expect_tx(full(st), PAIR_TMA_BYTES);
        if (PROJECT) {          // W: 32 columns (m) x 32 rows (k) a box
#pragma unroll
          for (int cb = 0; cb < PAIR_BM / 32; ++cb)
            tma_load_2d(a_s(st) + cb * (PAIR_A_BYTES * 32 / PAIR_BM),
                        &amap, full(st), m0 + 32 * cb, k0);
        } else {                // P: 32 depths (k) x 128 rows
          tma_load_2d(a_s(st), &amap, full(st), k0, m0);
        }
        tma_load_2d(b_s(st), &bmap, full(st), k0, n0);
      }
      __syncwarp();
      if (PROJECT && i >= PAIR_NST - 1 && r < p.N + p.M) lin_row();
    }
    if (PROJECT) {
      while (r < p.N + p.M) lin_row();
      launch_dependents();
    }
  } else {
    const int g = warp / 4, wl = warp % 4;
    const int gq = lane >> 2, tq = lane & 3;

    // byte offset in a stage's A tile of the thread's fragment element a
    // (row 64 g + 16 wl + gq + 8 (a & 1), depth tq + 4 (a >> 1)) at k-step
    // kk, in the 128-byte swizzle TMA writes (16-byte chunk c of row r at
    // chunk c ^ (r & 7))
    auto a_off = [&](int kk, int a) -> uint32_t {
      const int r = 64 * g + 16 * wl + gq + 8 * (a & 1);
      const int c = 8 * kk + tq + 4 * (a >> 1);
      if (PROJECT)              // blocks of [32 depths][32 rows]
        return (r >> 5) * (PAIR_A_BYTES * 32 / PAIR_BM) + c * 128 +
               ((((r & 31) >> 2) ^ (c & 7)) << 4) + (r & 3) * 4;
      return r * 128 + (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
    };
    // acc sums the stages' products in fp32 registers, rounding to
    // nearest; the tensor cores' own fp32 sums (accs) run one stage only
    float acc[64], accs[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = accs[j] = 0.f;
    uint32_t ah[PAIR_BK / 8][4], al[PAIR_BK / 8][4];
    if (g == 1 && n_iter > 0)   // warpgroup 0 issues first
      asm volatile("bar.arrive 2, %0;\n" ::"n"(PAIR_CONSUMERS) : "memory");
    for (int i = 0; i < n_iter; ++i) {
      const int st = i % PAIR_NST;
      const uint32_t ph = (i / PAIR_NST) & 1;
      mbar_wait(full(st), ph);
      // A: the fragments, split in registers
#pragma unroll
      for (int kk = 0; kk < PAIR_BK / 8; ++kk)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          split_tf32(*reinterpret_cast<const float*>(smem0 + a_s(st) +
                                                     a_off(kk, a)),
                     ah[kk][a], al[kk][a]);
      mbar_wait(split_done(st), ph);     // all of B split
      // the warpgroups take turns to issue (barriers 2 and 3), so the
      // tensor cores run one's products while the other loads its next A
      asm volatile("bar.sync %0, %1;\n" ::"r"(2 + g), "n"(PAIR_CONSUMERS)
                   : "memory");
      pin(accs);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PAIR_BK / 8; ++kk) {
        const uint64_t dh = smem_desc(b_s(st) + 32 * kk, 1024, 1);
        const uint64_t dl = smem_desc(lo_s(st) + 32 * kk, 1024, 1);
        wgmma_tf32_m64n128_rs(accs, al[kk], dh, kk > 0);
        wgmma_tf32_m64n128_rs(accs, ah[kk], dl, 1);
        wgmma_tf32_m64n128_rs(accs, ah[kk], dh, 1);
      }
      wgmma_commit();
      if (g == 0 || i + 1 < n_iter)
        asm volatile("bar.arrive %0, %1;\n" ::"r"(3 - g), "n"(PAIR_CONSUMERS)
                     : "memory");
      wgmma_wait_all();
      pin(accs);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += accs[j];
    }
    // every consumer warp is past its last product
    asm volatile("bar.sync 1, %0;\n" ::"n"(PAIR_CONSUMERS) : "memory");
    // the score may launch once every thread of every projection CTA is
    // here: all of them are resident then (none waits for an SM a score
    // CTA could take), and in their epilogues
    if (PROJECT) launch_dependents();

    // the partial tile into the drained ring: acc[4 c8 + j] is row
    // 64 g + 16 wl + gq + 8 (j >> 1), column 8 c8 + 2 tq + (j & 1)
    float* part = reinterpret_cast<float*>(smem0 + base);
#pragma unroll
    for (int c8 = 0; c8 < PAIR_BN / 8; ++c8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * g + 16 * wl + gq + 8 * h;
        const int c = 8 * c8 + 2 * tq;
        const float x = acc[4 * c8 + 2 * h], y = acc[4 * c8 + 2 * h + 1];
        if (PROJECT) {
          part[c * PAIR_ROW + r] = x;
          part[(c + 1) * PAIR_ROW + r] = y;
        } else {
          *reinterpret_cast<float2*>(part + r * PAIR_ROW + c) =
              make_float2(x, y);
        }
      }
  }
  cluster_sync();               // every partial of the cluster written

  // CTA `rank` sums slice `rank` of the tile over the cluster's CTAs in
  // rank order and stores it, 16 bytes a thread
  switch (gridDim.z) {
    case 1: pair_reduce<PROJECT, 1>(p, base, smem0, lin_s, m0, n0); break;
    case 2: pair_reduce<PROJECT, 2>(p, base, smem0, lin_s, m0, n0); break;
    case 3: pair_reduce<PROJECT, 3>(p, base, smem0, lin_s, m0, n0); break;
    case 4: pair_reduce<PROJECT, 4>(p, base, smem0, lin_s, m0, n0); break;
    case 5: pair_reduce<PROJECT, 5>(p, base, smem0, lin_s, m0, n0); break;
    case 6: pair_reduce<PROJECT, 6>(p, base, smem0, lin_s, m0, n0); break;
    case 7: pair_reduce<PROJECT, 7>(p, base, smem0, lin_s, m0, n0); break;
    default: pair_reduce<PROJECT, 8>(p, base, smem0, lin_s, m0, n0); break;
  }
}

// The tensor map of a row-major fp32 matrix (outer x inner), boxes of
// {box_inner, box_outer} in the 128-byte swizzle, coordinates past the
// end read as zeros.  Encoded once per (base, shape, box) and kept, as
// decode_map does: the same tensor at the same shape gets the same map.
int pair_map(CUtensorMap* map, const void* base, uint64_t inner,
             uint64_t outer, int box_inner, int box_outer) {
  struct Key {
    const void* base;
    uint64_t inner, outer;
    int bi, bo;
    bool operator==(const Key& o) const {
      return base == o.base && inner == o.inner && outer == o.outer &&
             bi == o.bi && bo == o.bo;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      size_t h = std::hash<const void*>()(k.base);
      for (uint64_t x : {k.inner, k.outer, (uint64_t)k.bi, (uint64_t)k.bo})
        h = h * 1000003u ^ std::hash<uint64_t>()(x);
      return h;
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> kept;
  const Key key = {base, inner, outer, box_inner, box_outer};
  std::lock_guard<std::mutex> hold(mu);
  const auto it = kept.find(key);
  if (it != kept.end()) {
    *map = it->second;
    return 0;
  }
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_BAD_MAP;
  if (kept.size() >= 4096) kept.clear();   // bounded: stale entries go
  kept.emplace(key, *map);
  return 0;
}

template <bool PROJECT>
int launch_pair_sm90(const CUtensorMap& amap, const CUtensorMap& bmap,
                     const PairParams& p, int split, cudaStream_t stream) {
  static std::once_flag once;
  static cudaError_t attr = cudaSuccess;
  std::call_once(once, [] {
    attr = cudaFuncSetAttribute(pair_sm90_kernel<PROJECT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                PAIR_SMEM);
  });
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pair_cdiv(p.rows, PAIR_BM), pair_cdiv(p.cols, PAIR_BN),
                     split);
  cfg.blockDim = dim3(PAIR_THREADS);
  cfg.dynamicSmemBytes = PAIR_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = split;
  // the score overlaps the projection's epilogue (programmatic dependent
  // launch); the projection waits for whatever ran before it
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = PROJECT ? 1 : 2;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, pair_sm90_kernel<PROJECT>, amap, bmap, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The two launches of an fp32 call; the splits and chunks come from
// kernels/pair_plan.py.  Returns 0, -1 for a plan that does not cover the
// depth, ERR_NO_ENCODER / ERR_BAD_MAP, or a CUDA error.
int pair_sm90(const float* C, const float* E, const float* W,
              const float* w_c, const float* w_e, const float* bias,
              float* out, float* ws, int N, int M, int d, int proj_split,
              int proj_per, int score_split, int score_per,
              cudaStream_t stream) {
  const int n_steps = pair_cdiv(d, PAIR_BK);
  for (int s : {proj_split, score_split})
    if (s < 1 || s > PAIR_MAX_SPLIT) return -1;
  for (auto sp : {std::make_pair(proj_split, proj_per),
                  std::make_pair(score_split, score_per)})
    if (sp.second < 1 || sp.first * sp.second < n_steps ||
        (sp.first - 1) * sp.second >= n_steps)
      return -1;
  float* P = ws;
  float* lin = ws + (int64_t)N * d;
  CUtensorMap wmap, cmap, pmap, emap;
  int rc = pair_map(&wmap, W, d, d, 32, PAIR_BK);
  if (rc == 0) rc = pair_map(&cmap, C, d, N, PAIR_BK, PAIR_BN);
  if (rc == 0) rc = pair_map(&pmap, P, d, N, PAIR_BK, PAIR_BM);
  if (rc == 0) rc = pair_map(&emap, E, d, M, PAIR_BK, PAIR_BN);
  if (rc != 0) return rc;
  PairParams pp = {};
  pp.rows = d; pp.cols = N; pp.K = d;
  pp.n_steps = n_steps; pp.per_split = proj_per;
  pp.N = N; pp.M = M;
  pp.P = P; pp.lin = lin;
  pp.C = C; pp.E = E; pp.w_c = w_c; pp.w_e = w_e;
  rc = launch_pair_sm90<true>(wmap, cmap, pp, proj_split, stream);
  if (rc != 0) return rc;
  PairParams sp = {};
  sp.rows = N; sp.cols = M; sp.K = d;
  sp.n_steps = n_steps; sp.per_split = score_per;
  sp.N = N; sp.M = M;
  sp.lin = lin; sp.out = out; sp.bias = bias;
  return launch_pair_sm90<false>(pmap, emap, sp, score_split, stream);
}

}  // namespace
