// One decode design for Hopper (sm_90a), shared by the paged decode
// (paged_attention.cu, keys in pool pages read through a block table) and
// the dense split-K decode (decode_attention.cu, keys in (B, L, KV, hd)
// stripes).  Both take one query per (sequence b, head) and run an
// online softmax over that sequence's live keys; a source policy (PagedRows
// or DenseRows) says how many keys are live, where key row t lives, and
// what a row with no live key gives.
//
// Bound on the card: memory bandwidth.  At G query heads per kv head a key
// costs ~4 G hd flops against 2 hd sizeof(T) bytes of K and V, about G
// flops a byte (bf16) against the ~295 where an H100 turns compute-bound,
// so the least time is the live K/V bytes over 3.35 TB/s.  The design's
// job is to keep every SM streaming K/V with enough bytes in flight:
//
// 1. The keys are split over CTAs by shape alone.  A CTA owns one (kv
//    head and row group, sequence b, chunk of DECODE_CHUNK consecutive
//    keys); the grid is (KV * row groups, B, ceil(max_keys / DECODE_CHUNK))
//    with max_keys = nb * bs (paged) or L (dense), so nothing on the host
//    reads `lengths` and a CUDA graph can capture the launch.  A CTA whose
//    chunk starts at or past its row's live keys exits at once.  Chunks are
//    the slowest grid axis, so every row's first chunk is scheduled first.
//    DECODE_CHUNK = 128, chosen on an H100 against the two decode shapes
//    of PERF.md: at phase 2's ragged lengths (2048, 1, 1537, 300, 16,
//    977, 2000, 64; 8 kv heads) it gives 472 live CTAs and ran ~10% faster
//    than chunks of 64 (904 CTAs, twice the partials to merge); at the
//    serves' 301-329 keys it gives 192 live CTAs and ran ~5% slower than
//    64 (344).  The long rows carry the bytes, so the larger chunk wins
//    where the time is.
// 2. Copies in flight.  Warp DECODE_WARPS is a producer: it fills a
//    ring of NST stages of DECODE_STAGE key rows of K and V in shared
//    memory by TMA, each stage guarded by a "full" mbarrier (transaction
//    bytes) and an "empty" one the consumer warps arrive on.  A tensor
//    map views K (and V) as {hd, KV, rows, outer} (dense: rows L, outer
//    B; paged: rows bs, outer pool rows) with boxes of {hd, 1, box_rows,
//    1}: one box a stage for a dense stripe (rows past L read as zeros),
//    one a page piece of gcd(bs, DECODE_STAGE) rows for a pool.  A box
//    of 16 rows, not a 1-D bulk copy a key row: at 256 B a copy, the
//    number of copies, not their bytes, sets the time.  The maps are
//    encoded once per (tensor, shape) and kept (decode_map), so a call
//    adds no encoding work.  The ring holds up to decode_ring_bytes(HD)
//    bytes: 32 KiB up to hd 128, 64 keys at bf16 hd 128 (a whole chunk at
//    hd 64 and below); 64 KiB at hd 256 (64 keys in bf16, 32 in fp32),
//    dynamic shared memory there, which the launch opts into: the producer
//    refills a stage as soon as the consumers free it, so half a chunk is
//    in flight while the other half is computed.  Boxes wholly past the
//    live keys are not issued; the rows of a box past them (and past L)
//    land in the ring but are never read, so they enter no sum, not even
//    as 0 * NaN.
// 3. Consumers on the CUDA cores (tensor cores do not pay: at G = 2 a
//    wgmma M of 64 would be 97% padding).  DECODE_WARPS warps share the G
//    rows of one kv head (GR <= 8 rows a CTA, more row groups beyond
//    that); a key is read from shared memory by LPK lanes of 16 bytes
//    each (32 bytes, two loads, where a key row passes 512 bytes: fp32 at
//    hd 256, so a key still fits a warp), so every lane group of a warp
//    takes its own keys of a stage.
//    The instructions a key costs set the loop's time (it is issue-bound
//    with several CTAs an SM), so a full stage runs without per-key tests.
//    Each group keeps an online softmax (m, l, acc) per row in fp32
//    registers, scores in the log2 domain, rescaled only when the max
//    grows, p by ex2.approx; keys past the live count add nothing.  The
//    groups merge by shuffles, the warps through shared memory (the
//    drained ring).
// 4. Merge in the same launch.  A row with one live chunk writes its
//    output.  Otherwise each CTA writes its fp32 partial (m, l, acc) to
//    the workspace, and the last CTA of its (b, kv head, row group) to
//    finish, found by an atomic ticket, merges the partials in chunk order
//    (the same result from run to run) and writes the output.  It resets
//    its ticket to 0, so the counters stay zeroed across calls and graph
//    replays.
// The output is acc / max(l, 1e-30); NEG_INF is finite.
// 5. A soft-cap (DecodeParams::cap > 0, in the log2 domain of the
//    pre-scaled q: c log2 e) caps each live key's score right after its
//    dot product, before the max, in the CAP instantiations (hd 64, 128,
//    256; softcap_dims): tanhf in fp32, tanh_ex2 in bf16 (common.cuh).
//    The uncapped instantiations are unchanged.
#pragma once

#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace {

constexpr int DECODE_CHUNK = 128;     // keys a CTA owns
constexpr int DECODE_STAGE = 16;      // key rows of K (and of V) a stage
constexpr int DECODE_RING = 32768;    // bytes of the ring up to hd 128
constexpr int DECODE_WARPS = 4;       // consumer warps (128 threads)
constexpr int DECODE_THREADS = (DECODE_WARPS + 1) * 32;
constexpr int DECODE_ROWS = 8;        // query rows a CTA, at most

struct DecodeParams {
  const void* q;         // (B, H, hd), H = KV * G, a kv head's G adjacent
  const void* k;         // dense (B, L, KV, hd), or pool (n_pool_rows, bs,
  const void* v;         //   KV, hd)
  void* out;             // (B, H, hd)
  const int* lengths;    // (B,)
  const int* bt;         // paged: (B, nb) block table
  float* ws;             // fp32 partials: acc (B, H, n_chunks, hd), then
                         //   (m, l) (B, H, n_chunks, 2)
  int* tickets;          // (B, KV, row groups), 0 between calls
  int B, KV, G, n_chunks;
  int L;                 // dense: rows of a stripe
  int nb, bs, n_pool_rows;  // paged
  int box_rows;          // key rows a TMA box (divides the stage's keys)
  float scale;
  float cap, cap_inv;    // the soft-cap in log2 units (c log2 e) and its
                         //   inverse; cap 0: none
};

// The ring's bytes at most: 64 KiB at hd 256, where a 16-row bf16 stage
// is 16 KiB (two stages in 32 KiB would leave no room for the warps'
// merge) and an fp32 one 32 KiB.
constexpr int decode_ring_bytes(int hd) {
  return hd <= 128 ? DECODE_RING : 2 * DECODE_RING;
}

// A stage holds DECODE_STAGE key rows of K, then of V, as boxes of
// box_rows rows in slots of max(box_rows * ROW, 128) bytes (a TMA tile
// lands on a 128-byte boundary); ROW and box_rows are powers of two, so
// the slots of a stage fit in DECODE_STAGE * PITCH bytes.
template <typename T, int HD>
struct DecodeRing {
  static constexpr int ROW = HD * (int)sizeof(T);        // bytes a key row
  static constexpr int PITCH = ROW < 128 ? 128 : ROW;
  static constexpr int STAGE = 2 * DECODE_STAGE * PITCH;
  static constexpr int PER_CHUNK = DECODE_CHUNK / DECODE_STAGE;
  static constexpr int FIT = decode_ring_bytes(HD) / STAGE;
  static constexpr int NST = FIT < PER_CHUNK ? FIT : PER_CHUNK;
  static constexpr int BYTES = NST * STAGE;
  static_assert(NST >= 2 && (ROW & (ROW - 1)) == 0, "ring");
  // the warps' merge reuses the drained ring
  static_assert(DECODE_WARPS * DECODE_ROWS * (HD + 2) * 4 <= BYTES,
                "merge space");
};

// CTAs an SM the launch bounds promise: five (80 registers) for up to 2
// rows, the main path's G, where the 32 KiB ring lets five fit; three at
// hd 256, where the 64 KiB ring lets three fit (136 registers); one for
// more rows.
template <int HD, int GR>
constexpr int decode_min_ctas() {
  return GR > 2 ? 1 : HD <= 128 ? 5 : 3;
}

// Both launch bounds are given, so ptxas may use registers up to the limit
// they set (with the thread count alone it spills to cross an occupancy
// step).
template <typename T, int HD, int GR, class Src, bool CAP = false>
__global__ void __launch_bounds__(DECODE_THREADS, decode_min_ctas<HD, GR>())
    decode_sm90_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const DecodeParams p) {
  using R = DecodeRing<T, HD>;
  // head dims a lane loads: 16 bytes, or 32 where a key row passes 512
  // bytes (32 lanes a key at most)
  constexpr int VEC =
      (HD * (int)sizeof(T) > 512 ? 32 : 16) / (int)sizeof(T);
  constexpr int LPK = HD / VEC;              // lanes per key
  constexpr int KPW = 32 / LPK;              // keys a warp takes at once
  constexpr int GROUPS = DECODE_WARPS * KPW;  // lane groups of the CTA
  // keys a lane group takes a stage, U at a time: all at once for up to
  // 2 rows, one by one for more (registers)
  constexpr int PER = (DECODE_STAGE + GROUPS - 1) / GROUPS;
  constexpr int U = GR <= 2 ? PER : 1;
  // more lane groups than a stage has keys (small head dims): the spare
  // groups' keys lie past the stage
  constexpr bool SPARE = GROUPS * PER > DECODE_STAGE;
  static_assert(HD % VEC == 0 && 32 % LPK == 0 && GR <= DECODE_ROWS, "shape");

  uint8_t* const ring = smem_buffer<R::BYTES>();
  __shared__ __align__(8) uint64_t bars[2 * R::NST];
  __shared__ int last;

  const int n_rg = (p.G + GR - 1) / GR;
  const int kvh = blockIdx.x / n_rg, rg = blockIdx.x - kvh * n_rg;
  const int b = blockIdx.y, chunk = blockIdx.z;
  const int g0 = rg * GR, rows = min(GR, p.G - g0);
  const int live = Src::live(p, b);
  if (live == 0) {                           // the source's length-0 rule
    if (chunk == 0) Src::template no_keys<T, HD>(p, b, kvh, g0, rows);
    return;
  }
  const int k0 = chunk * DECODE_CHUNK;
  if (k0 >= live) return;                    // no live key in this chunk
  const int k1 = min(live, k0 + DECODE_CHUNK);
  const int n_live = (live + DECODE_CHUNK - 1) / DECODE_CHUNK;
  const int n_st = (k1 - k0 + DECODE_STAGE - 1) / DECODE_STAGE;

  const uint32_t ring_s = smem_u32(ring), bars_s = smem_u32(bars);
  auto full = [&](int st) { return bars_s + 8 * st; };
  auto empty = [&](int st) { return bars_s + 8 * (R::NST + st); };
  if (threadIdx.x == 0) {
    for (int st = 0; st < R::NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), DECODE_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == DECODE_WARPS) {
    // producer: the boxes of the live keys of each stage, K then V
    if (lane == 0) {
      constexpr int SV = DECODE_STAGE * R::PITCH;   // V's offset a stage
      const int slot = max(p.box_rows * R::ROW, 128);
      for (int i = 0; i < n_st; ++i) {
        const int st = i % R::NST, key0 = k0 + i * DECODE_STAGE;
        const int n_box = min(DECODE_STAGE, k1 - key0 + p.box_rows - 1) /
                          p.box_rows;
        if (i >= R::NST) mbar_wait(empty(st), ((i / R::NST) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * n_box * p.box_rows * R::ROW);
        for (int j = 0; j < n_box; ++j) {
          const int2 at = Src::box(p, b, key0 + j * p.box_rows);
          const uint32_t dst = ring_s + st * R::STAGE + j * slot;
          tma_load_4d(dst, &kmap, full(st), 0, kvh, at.x, at.y);
          tma_load_4d(dst + SV, &vmap, full(st), 0, kvh, at.x, at.y);
        }
      }
    }
    return;
  }

  // consumers: lane group gi of warp w (grp = w * KPW + gi) takes keys
  // grp * PER .. grp * PER + PER - 1 of a stage
  const int sub = lane % LPK, grp = warp * KPW + lane / LPK, d0 = sub * VEC;
  const int H = p.KV * p.G;
  const float qscale = p.scale * LOG2E;
  // key j of a stage lies in box j >> box_shift, row j & (box_rows - 1)
  const int box_shift = __ffs(p.box_rows) - 1;
  const int slot = max(p.box_rows * R::ROW, 128);
  auto key_at = [&](const uint8_t* stage, int j) {
    return reinterpret_cast<const T*>(stage + (j >> box_shift) * slot +
                                      (j & (p.box_rows - 1)) * R::ROW) + d0;
  };
  float qr[GR][VEC], acc[GR][VEC], m[GR], l[GR];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    if (r < rows)
      Vec<T, VEC>::load((const T*)p.q +
                            ((int64_t)b * H + kvh * p.G + g0 + r) * HD + d0,
                        qr[r]);
    else
#pragma unroll
      for (int d = 0; d < VEC; ++d) qr[r][d] = 0.f;
#pragma unroll
    for (int d = 0; d < VEC; ++d) {
      qr[r][d] *= qscale;
      acc[r][d] = 0.f;
    }
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  for (int i = 0; i < n_st; ++i) {
    const int st = i % R::NST;
    const int nk = min(DECODE_STAGE, k1 - (k0 + i * DECODE_STAGE));
    const uint8_t* ks = ring + st * R::STAGE;
    const uint8_t* vs = ks + DECODE_STAGE * R::PITCH;
    mbar_wait(full(st), (i / R::NST) & 1);
    // the keys of a stage, with a test of each key's place against the
    // stage's live count only where the stage is not full
    auto keys = [&](auto full_stage) {
      auto live_key = [&](int j) {
        return decltype(full_stage)::value ? !SPARE || j < DECODE_STAGE
                                           : j < nk;
      };
#pragma unroll 1
      for (int j0 = grp * PER; j0 < (grp + 1) * PER; j0 += U) {
        float sc[U][GR];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float kx[VEC];
          if (live_key(j0 + u))
            Vec<T, VEC>::load(key_at(ks, j0 + u), kx);
          else
#pragma unroll
            for (int d = 0; d < VEC; ++d) kx[d] = 0.f;
#pragma unroll
          for (int r = 0; r < GR; ++r) {
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < VEC; ++d) dot += qr[r][d] * kx[d];
            sc[u][r] = dot;
          }
        }
#pragma unroll
        for (int sh = LPK / 2; sh > 0; sh >>= 1)
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int r = 0; r < GR; ++r)
              sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], sh);
        if constexpr (CAP) {
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int r = 0; r < GR; ++r)
              sc[u][r] = soft_cap<T>(sc[u][r], p.cap, p.cap_inv);
        }
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          float mx = m[r];
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (live_key(j0 + u)) mx = fmaxf(mx, sc[u][r]);
          if (mx > m[r]) {              // rescale only when the max grows
            const float corr = ex2(m[r] - mx);
            l[r] *= corr;
#pragma unroll
            for (int d = 0; d < VEC; ++d) acc[r][d] *= corr;
            m[r] = mx;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            sc[u][r] = live_key(j0 + u) ? ex2(sc[u][r] - mx) : 0.f;
            l[r] += sc[u][r];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!live_key(j0 + u)) continue;  // never read: no 0 * NaN
          float vx[VEC];
          Vec<T, VEC>::load(key_at(vs, j0 + u), vx);
#pragma unroll
          for (int r = 0; r < GR; ++r)
#pragma unroll
            for (int d = 0; d < VEC; ++d) acc[r][d] += sc[u][r] * vx[d];
        }
      }
    };
    if constexpr (GR <= 2) {            // (more rows: registers)
      if (nk == DECODE_STAGE)
        keys(std::true_type());
      else
        keys(std::false_type());
    } else {
      keys(std::false_type());
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
  merge_lane_groups<GR, VEC, LPK>(m, l, acc);

  // merge the warps through the drained ring
  consumer_sync();
  float* m_s = reinterpret_cast<float*>(ring);
  float* l_s = m_s + DECODE_WARPS * GR;
  float* a_s = l_s + DECODE_WARPS * GR;
  if (lane < LPK) {
#pragma unroll
    for (int r = 0; r < GR; ++r) {
#pragma unroll
      for (int d = 0; d < VEC; ++d)
        a_s[(warp * GR + r) * HD + d0 + d] = acc[r][d];
      if (sub == 0) {
        m_s[warp * GR + r] = m[r];
        l_s[warp * GR + r] = l[r];
      }
    }
  }
  consumer_sync();
  float* const ws_ml = p.ws + (int64_t)p.B * H * p.n_chunks * HD;
  for (int e = threadIdx.x; e < rows * (HD / 4); e += 32 * DECODE_WARPS) {
    const int r = e / (HD / 4), dv = (e - r * (HD / 4)) * 4;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < DECODE_WARPS; ++w) mx = fmaxf(mx, m_s[w * GR + r]);
    float li = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < DECODE_WARPS; ++w) {
      const float c = exp2f(m_s[w * GR + r] - mx);
      li += l_s[w * GR + r] * c;
#pragma unroll
      for (int d = 0; d < 4; ++d) o[d] += a_s[(w * GR + r) * HD + dv + d] * c;
    }
    const int64_t h = (int64_t)b * H + kvh * p.G + g0 + r;
    if (n_live == 1) {                  // the whole row: write the output
      const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
      for (int d = 0; d < 4; ++d) o[d] *= inv;
      Vec<T, 4>::store((T*)p.out + h * HD + dv, o);
    } else {                            // the chunk's partial
      const int64_t slot = h * p.n_chunks + chunk;
      *reinterpret_cast<float4*>(p.ws + slot * HD + dv) =
          make_float4(o[0], o[1], o[2], o[3]);
      if (dv == 0) {
        ws_ml[2 * slot] = mx;
        ws_ml[2 * slot + 1] = li;
      }
    }
  }
  if (n_live == 1) return;
  // the last CTA of the row group to finish merges the chunks in order
  consumer_sync();                      // every partial of the CTA written
  if (threadIdx.x == 0) {
    int* ticket = p.tickets + ((int64_t)b * p.KV + kvh) * n_rg + rg;
    __threadfence();                    // release them before the ticket
    last = atomicAdd(ticket, 1) == n_live - 1;
    if (last) {
      __threadfence();                  // acquire the other chunks' partials
      *ticket = 0;                      // zero again for the next call
    }
  }
  consumer_sync();
  if (!last) return;
  for (int e = threadIdx.x; e < rows * (HD / 4); e += 32 * DECODE_WARPS) {
    const int r = e / (HD / 4), dv = (e - r * (HD / 4)) * 4;
    const int64_t h = (int64_t)b * H + kvh * p.G + g0 + r;
    // one pass, rescaling as the max grows; unrolled so that the L2 reads
    // of several chunks are in flight
    float mx = NEG_INF, li = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int c = 0; c < n_live; ++c) {
      const int64_t slot = h * p.n_chunks + c;
      const float mc = __ldcg(ws_ml + 2 * slot);
      const float lc = __ldcg(ws_ml + 2 * slot + 1);
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(p.ws + slot * HD + dv));
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
    Vec<T, 4>::store((T*)p.out + h * HD + dv, o);
  }
}

// The tensor map of K or V viewed as {hd, KV, rows, outer}, boxes of {hd,
// 1, box_rows, 1}, no swizzle, rows past `rows` read as zeros.  Encoded
// once per (tensor, dims, dtype, box) and kept: the same tensor at the same
// shape gets the same map, so a kept map stays right if the memory is
// reused.  Returns 0, or ERR_NO_ENCODER / ERR_BAD_MAP.
int decode_map(CUtensorMap* map, int dtype, int hd, const void* base,
               uint64_t kv, uint64_t rows, uint64_t outer, int box_rows) {
  struct Key {
    const void* base;
    uint64_t kv, rows, outer;
    int dtype, hd, box;
    bool operator==(const Key& o) const {
      return base == o.base && kv == o.kv && rows == o.rows &&
             outer == o.outer && dtype == o.dtype && hd == o.hd &&
             box == o.box;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      size_t h = std::hash<const void*>()(k.base);
      for (uint64_t x : {k.kv, k.rows, k.outer, (uint64_t)k.dtype,
                         (uint64_t)k.hd, (uint64_t)k.box})
        h = h * 1000003u ^ std::hash<uint64_t>()(x);
      return h;
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> kept;
  const Key key = {base, kv, rows, outer, dtype, hd, box_rows};
  std::lock_guard<std::mutex> hold(mu);
  const auto it = kept.find(key);
  if (it != kept.end()) {
    *map = it->second;
    return 0;
  }
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const uint64_t es = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, kv, rows, outer};
  const cuuint64_t strides[3] = {hd * es, hd * es * kv, hd * es * kv * rows};
  const cuuint32_t box[4] = {(cuuint32_t)hd, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (encode(map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             4, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_BAD_MAP;
  if (kept.size() >= 4096) kept.clear();   // bounded: stale entries go
  kept.emplace(key, *map);
  return 0;
}

// rows a CTA: the smallest instantiated count that holds the G heads
template <typename T, int HD, class Src, bool CAP>
int launch_decode_rows(const CUtensorMap& kmap, const CUtensorMap& vmap,
                       const DecodeParams& p, cudaStream_t stream) {
#define REPRO_LAUNCH(GR_)                                                  \
  {                                                                        \
    const dim3 grid(p.KV * ((p.G + GR_ - 1) / GR_), p.B, p.n_chunks);      \
    return launch_with_smem<DecodeRing<T, HD>::BYTES>(                     \
        decode_sm90_kernel<T, HD, GR_, Src, CAP>, grid, DECODE_THREADS,    \
        stream, kmap, vmap, p);                                            \
  }
  if (p.G <= 1) REPRO_LAUNCH(1);
  if (p.G <= 2) REPRO_LAUNCH(2);
  if (p.G <= 4) REPRO_LAUNCH(4);
  REPRO_LAUNCH(DECODE_ROWS);
#undef REPRO_LAUNCH
}

// dtype: 0 = float32, 1 = bfloat16; K and V (same shape) viewed as {hd,
// KV, rows, outer}; a box is a stage's keys, or for pages of page_rows
// rows (0: no pages) the largest piece of a page that divides them.
// Returns cudaGetLastError() after the launch (0 on success), -1 for a
// dtype / head_dim it has no kernel for (or p.cap > 0 at a head_dim
// without a capped kernel), ERR_NO_ENCODER or ERR_BAD_MAP for a tensor
// map.
template <class Src>
int launch_decode(int dtype, int hd, DecodeParams p, uint64_t rows,
                  uint64_t outer, int page_rows, void* stream) {
  if ((dtype != 0 && dtype != 1) ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256) ||
      (p.cap > 0.f && !softcap_dims(hd, hd)))
    return -1;
  p.box_rows = DECODE_STAGE;
  while (page_rows % p.box_rows) p.box_rows >>= 1;
  CUtensorMap kmap, vmap;
  int rc = decode_map(&kmap, dtype, hd, p.k, p.KV, rows, outer, p.box_rows);
  if (rc == 0)
    rc = decode_map(&vmap, dtype, hd, p.v, p.KV, rows, outer, p.box_rows);
  if (rc != 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_HD(T_, HD_)                                                \
  case HD_:                                                              \
    if constexpr (softcap_dims(HD_, HD_)) {                              \
      if (p.cap > 0.f)                                                   \
        return launch_decode_rows<T_, HD_, Src, true>(kmap, vmap, p, st); \
    }                                                                    \
    return launch_decode_rows<T_, HD_, Src, false>(kmap, vmap, p, st)
  if (dtype == 0) {
    switch (hd) {
      REPRO_HD(float, 16); REPRO_HD(float, 32);
      REPRO_HD(float, 64); REPRO_HD(float, 128);
      REPRO_HD(float, 256);
    }
  }
  switch (hd) {
    REPRO_HD(__nv_bfloat16, 16); REPRO_HD(__nv_bfloat16, 32);
    REPRO_HD(__nv_bfloat16, 64); REPRO_HD(__nv_bfloat16, 128);
    REPRO_HD(__nv_bfloat16, 256);
  }
  return -1;
#undef REPRO_HD
}

}  // namespace

// DECODE_CHUNK, for the wrappers' split plan (repro_torch/kernels/
// decode_plan.py), which checks it when it loads the library.
extern "C" int repro_decode_chunk_keys() { return DECODE_CHUNK; }
