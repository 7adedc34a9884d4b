// Paged attention for Hopper (sm_90a): single-query decode and suffix
// extend over a block-pooled KV cache, read through per-sequence block
// tables.  Hand-written CUDA C++; built by repro_torch/kernels/build.py
// into a shared library with a plain C interface and bound with ctypes.
//
// Replaces the TPU kernels
//   src/repro/kernels/paged_attention.py:paged_decode_attention_bkgd
//     (body _paged_decode_kernel)  -> repro_paged_decode_attention
//   src/repro/kernels/paged_attention.py:paged_extend_attention_bkgd
//     (body _paged_extend_kernel)  -> repro_paged_extend_attention
//
// Both compute the same thing: rows (query s, head g of one kv head) at
// absolute position pos0 + s attend to every key at virtual position
// p <= pos0 + s, the keys living in pool block bt[b, p / bs] at row
// p % bs.  Decode is the case S = 1, pos0 = length - 1.
//
// Three kernels carry the two entry points:
//
// decode_sm90_kernel (decode, fp32 and bf16; decode_sm90.cuh) with
// PagedRows below: the split-key design shared with the dense decode, its
// keys split over CTAs in chunks, K/V rows brought in by TMA boxes into an
// mbarrier ring, the chunks merged in the same launch.  PagedRows says
// where key t lives (pool row bt[b, t / bs], clamped, row t % bs; a box
// is a page piece of gcd(bs, 16) rows) and how many keys are live,
// min(lengths[b], nb * bs); a row of
// length 0 sees no key and gives 0, as the TPU kernel does (l = 0, so
// acc / max(l, 1e-30) = 0).
//
// attention_sm90_kernel (extend in bf16; attention_sm90.cuh) with
// PagedSrc below, on the tensor cores with wgmma, K/V tiles brought in by
// TMA into a ring of mbarrier-guarded stages.  A tensor map spans the
// pool as (n_pool_rows, bs, KV, hd); the producer warp reads bt[b, key /
// bs] (clamped) and issues one box per page of a 64-key tile (pages of 8
// rows or more; a page larger than the tile gives a 64-row box).  Pages
// whose row count is not a multiple of 8 are copied by the producer warp
// with 16-byte loads instead.  As in the TPU kernel, P stays fp32 for
// P.V: it enters as a bf16 pair hi + lo (relative error <= 2^-18), and
// everything accumulates in fp32.  A CTA walks all the keys its rows see,
// so the longest sequence of a batch sets the time.
//
// paged_attention_kernel (extend in fp32, the parity runs), on the CUDA
// cores.  One CTA of NW warps owns 8 (query, head) rows of one (sequence
// b, kv head); the grid is (B, KV, ceil(S*G / 8)).  The TPU kernel's
// sequential grid axis over blocks becomes a loop inside the CTA, which
// reads bt[b, p / bs] itself (no scalar prefetch).  A key is read by a
// group of LPK lanes, each holding HD/LPK of its head dims, so a warp
// reads 32/LPK keys at once and every group streams its own keys straight
// from device memory, U keys per step in 16-byte loads, with no barrier
// inside the loop.  Each group keeps its own online softmax (m, l, acc)
// in fp32 registers for the 8 rows; the dot products finish with shuffles
// inside the group.  At the end the groups of a warp merge by shuffles and
// the warps merge through shared memory, by the usual rescaling of
// (m, l, acc).
//
// In both extend kernels the loop stops at the last key any row of the
// CTA can see, which skips the fully masked blocks the TPU kernel walked
// through with pl.when (the bf16 extend also zeroes V rows past that key
// in its last tile: a page-granular copy reads whatever the pool holds
// there).  Masked scores are the finite NEG_INF = -2e38 and masked keys
// add p = 0, so a row that sees no key gives 0, never a NaN.  The output
// is acc / max(l, 1e-30), as on the TPU.
//
// A soft-cap c > 0 (softcap; Gemma 2's attn_logit_softcapping) turns each
// score s (scaled by 1/sqrt(hd)) into c tanh(s / c) before the mask, as
// JAX's jnp path does (its Pallas kernels take no cap).  Every kernel here
// has capped instantiations at hd 64, 128 and 256 (softcap_dims in
// common.cuh): the decode and paged_attention_kernel cap in the log2
// domain of their pre-scaled q (cap = c log2 e), the bf16 extend in raw
// units (c / scale); tanhf in fp32, tanh_ex2 in bf16.
//
// Bound on the card: memory bandwidth for the decode (decode_sm90.cuh).
// Extend at the main path's shapes (S = 256 after a cached prefix) sits
// at the bf16 ridge: its bytes (q, K/V, out) and its tensor-core
// operations give about the same least time, the bytes slightly more; the
// fp32 variant on the CUDA cores is bound by its instructions.
#include "attention_sm90.cuh"
#include "decode_sm90.cuh"

namespace {

constexpr int NW = 8;          // warps per CTA
constexpr int NT = NW * 32;    // threads per CTA

// Rows row0 .. row0+GR-1 of the S*G rows of (b, kvh).  Row r = s*G + g
// reads q[b, s, kvh, g, :] and writes out[b, s, kvh, g, :]; both are
// (B, S, KV, G, HD) contiguous.  Pools are (n_pool_rows, bs, KV, HD)
// contiguous; bt is (B, nb); query s of sequence b sits at pos0[b] + s.
// Scores live in the log2 domain (q is scaled by scale * log2 e) so the
// softmax runs on exp2f; the result is the same softmax.
template <typename T, int HD, int GR, bool CAP>
__global__ void __launch_bounds__(NT) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ bt,
    const int* __restrict__ pos0s, T* __restrict__ out, int S, int KV,
    int G, int nb, int bs, int n_pool_rows, float scale, float cap,
    float cap_inv) {
  constexpr int LPK = lanes_per_key<HD, GR>();  // lanes per key
  constexpr int VEC = HD / LPK;                 // head dims per lane
  constexpr int KPW = 32 / LPK;                 // keys a warp reads at once
  // keys per lane group per step, as many as ~200 registers allow (~176
  // beside the capped kernel's tanhf)
  constexpr int UR = ((CAP ? 176 : 200) - 2 * GR * VEC) / (2 * VEC + GR);
  constexpr int U = UR < 1 ? 1 : (UR > 8 ? 8 : UR);
  constexpr int STEP = KPW * U;                 // keys per warp step
  static_assert(VEC % 4 == 0 && 32 % LPK == 0, "head_dim");

  const int b = blockIdx.x, kvh = blockIdx.y, row0 = blockIdx.z * GR;
  const int rows = min(GR, S * G - row0);
  const int pos0 = pos0s[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPK, gi = lane / LPK, d0 = sub * VEC;
  const int* bt_row = bt + (int64_t)b * nb;
  const float qscale = scale * LOG2E;

  float qr[GR][VEC], acc[GR][VEC], m[GR], l[GR];
  int lim[GR];                                  // last key a row may see
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    if (i < rows) {
      const int r = row0 + i, s = r / G, g = r - s * G;
      Vec<T, VEC>::load(
          q + ((((int64_t)b * S + s) * KV + kvh) * G + g) * HD + d0, qr[i]);
      lim[i] = pos0 + s;
    } else {
      lim[i] = -1;
#pragma unroll
      for (int d = 0; d < VEC; ++d) qr[i][d] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < VEC; ++d) {
      qr[i][d] *= qscale;
      acc[i][d] = 0.f;
    }
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  // the last key any row here may see, capped at the table's span
  const int n_keys = min(pos0 + (row0 + rows - 1) / G + 1, nb * bs);
  const int64_t key_stride = (int64_t)KV * HD;

  // warp-uniform loop: group gi of warp w reads keys base + gi*U + u
  for (int base = warp * STEP; base < n_keys; base += NW * STEP) {
    float kx[U][VEC], vx[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + gi * U + u;
      if (key < n_keys) {
        const int j = key / bs;
        // out-of-range table entries clamp, as a gather does in JAX
        const int phys = min(max(bt_row[j], 0), n_pool_rows - 1);
        const int64_t off = ((int64_t)phys * bs + (key - j * bs)) * key_stride
                            + (int64_t)kvh * HD + d0;
        Vec<T, VEC>::load(k_pool + off, kx[u]);
        Vec<T, VEC>::load(v_pool + off, vx[u]);
      } else {
#pragma unroll
        for (int d = 0; d < VEC; ++d) kx[u][d] = vx[u][d] = 0.f;
      }
    }
    float sc[U][GR];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < GR; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < VEC; ++d) dot += qr[i][d] * kx[u][d];
        sc[u][i] = dot;
      }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < GR; ++i)
          sc[u][i] += __shfl_xor_sync(0xffffffffu, sc[u][i], o);
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = base + gi * U + u;
        if constexpr (CAP) sc[u][i] = soft_cap<T>(sc[u][i], cap, cap_inv);
        if (key >= n_keys || key > lim[i]) sc[u][i] = NEG_INF;
        mx = fmaxf(mx, sc[u][i]);
      }
      if (mx > m[i]) {                  // rescale only when the max grows
        const float corr = exp2f(m[i] - mx);
        l[i] *= corr;
#pragma unroll
        for (int d = 0; d < VEC; ++d) acc[i][d] *= corr;
        m[i] = mx;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = base + gi * U + u;
        const float p = (key < n_keys && key <= lim[i])
                            ? exp2f(sc[u][i] - mx) : 0.f;
        l[i] += p;
#pragma unroll
        for (int d = 0; d < VEC; ++d) acc[i][d] += p * vx[u][d];
      }
    }
  }

  // merge the groups of a warp
  merge_lane_groups<GR, VEC, LPK>(m, l, acc);

  // merge the warps through shared memory and write the rows (a_s is
  // dynamic shared memory at hd 256: 64 KiB)
  __shared__ float m_s[NW][GR], l_s[NW][GR];
  float(*a_s)[GR][HD] = reinterpret_cast<float(*)[GR][HD]>(
      smem_buffer<NW * GR * HD * 4>());
  if (lane < LPK) {
#pragma unroll
    for (int i = 0; i < GR; ++i) {
#pragma unroll
      for (int d = 0; d < VEC; ++d) a_s[warp][i][d0 + d] = acc[i][d];
      if (sub == 0) {
        m_s[warp][i] = m[i];
        l_s[warp][i] = l[i];
      }
    }
  }
  __syncthreads();
  constexpr int OV = 4;                         // dims per output store
  for (int e = threadIdx.x; e < rows * (HD / OV); e += NT) {
    const int i = e / (HD / OV), dv = (e - i * (HD / OV)) * OV;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w][i]);
    float li = 0.f, o[OV] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = exp2f(m_s[w][i] - mx);
      li += l_s[w][i] * c;
#pragma unroll
      for (int d = 0; d < OV; ++d) o[d] += a_s[w][i][dv + d] * c;
    }
    const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int d = 0; d < OV; ++d) o[d] *= inv;
    const int r = row0 + i, s = r / G, g = r - s * G;
    Vec<T, OV>::store(
        out + ((((int64_t)b * S + s) * KV + kvh) * G + g) * HD + dv, o);
  }
}

// ---------------------------------------------------------------------
// bf16 extend: attention_sm90_kernel (attention_sm90.cuh) with PagedSrc,
// whose key tiles are pool pages read through the block table.
struct PagedSrc {
  // query s sees keys t <= pos0 + s, capped at the table's span
  static __device__ __forceinline__ int2 bounds(const AttnParams& p, int b,
                                                int s) {
    return make_int2(0, min(p.pos0[b] + s, p.nb * p.bs - 1));
  }
  // (pool row, row in the page) of key `key`: table entries past nb
  // repeat the last (those keys are past every row's last key), and
  // out-of-range entries clamp, as a gather does in JAX
  static __device__ __forceinline__ int2 page(const AttnParams& p, int b,
                                              int key) {
    const int j = key / p.bs, jt = min(j, p.nb - 1);
    const int phys = min(max(p.bt[(int64_t)b * p.nb + jt], 0),
                         p.n_pool_rows - 1);
    return make_int2(phys, key - j * p.bs);
  }
  template <int HD, int DV>
  static __device__ __forceinline__ void load_tile(
      const AttnParams& p, const CUtensorMap* kmap, const CUtensorMap* vmap,
      int b, int kvh, int key0, uint32_t k_s, uint32_t v_s, uint32_t full,
      uint8_t* smem0, int lane) {
    static_assert(DV == HD, "the extend's K and V share one head dim");
    using T = Tile<HD>;
    if (p.box_rows) {
      // one box of box_rows keys (a page, or the part of one in the tile)
      // per 64-column block of K and of V, spread over the lanes
      const int per = TILE / p.box_rows, n = 2 * T::NCB * per;
      if (lane == 0) mbar_expect_tx(full, 2 * T::BYTES);
      __syncwarp();
      for (int i = lane; i < n; i += 32) {
        const int t = i / (T::NCB * per), rest = i - t * (T::NCB * per);
        const int cb = rest / per, bx = rest - cb * per;
        const int2 pg = page(p, b, key0 + bx * p.box_rows);
        tma_load_4d((t ? v_s : k_s) + cb * T::BLOCK + bx * p.box_rows * T::SWB,
                    t ? vmap : kmap, full, cb * T::BW, kvh, pg.y, pg.x);
      }
    } else {
      // pages whose row count is not a multiple of 8: a box of fewer rows
      // would not start on a swizzle atom, so the warp copies the tile
      for (int i = lane; i < 2 * TILE * (HD / 8); i += 32) {
        const int t = i / (TILE * (HD / 8)), rest = i - t * (TILE * (HD / 8));
        const int r = rest / (HD / 8), col = (rest - r * (HD / 8)) * 8;
        const int2 pg = page(p, b, key0 + r);
        const int cb = col / T::BW;
        *reinterpret_cast<uint4*>(
            smem0 + (t ? v_s : k_s) + cb * T::BLOCK +
            swizzle<T::SWB>(r * T::SWB + (col - cb * T::BW) * 2)) =
            *reinterpret_cast<const uint4*>(
                (t ? p.v : p.k) +
                (((int64_t)pg.x * p.bs + pg.y) * p.KV + kvh) * HD + col);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(full);
    }
  }
};

template <int HD>
int launch_extend_bf16(const void* q, const void* k_pool, const void* v_pool,
                       const void* bt, const void* pos0, void* out, int B,
                       int S, int KV, int G, int nb, int bs,
                       int n_pool_rows, float scale, float softcap,
                       cudaStream_t stream) {
  int box = TILE;                          // gcd(bs, TILE)
  while (bs % box) box >>= 1;
  box = box >= 8 ? box : 0;                // 0: the warp copies
  CUtensorMap kmap, vmap;
  int rc = encode_map<HD>(&kmap, k_pool, KV, bs, n_pool_rows, box ? box : 1);
  if (rc == 0)
    rc = encode_map<HD>(&vmap, v_pool, KV, bs, n_pool_rows, box ? box : 1);
  if (rc != 0) return rc;
  AttnParams p = {};
  p.q = (const __nv_bfloat16*)q;
  p.out = (__nv_bfloat16*)out;
  p.k = (const __nv_bfloat16*)k_pool;
  p.v = (const __nv_bfloat16*)v_pool;
  p.bt = (const int*)bt;
  p.pos0 = (const int*)pos0;
  p.S = S; p.KV = KV; p.G = G;
  p.nb = nb; p.bs = bs; p.n_pool_rows = n_pool_rows; p.box_rows = box;
  p.scale = scale;
  p.cap = softcap / scale;                   // raw units
  p.cap_inv = softcap > 0.f ? scale / softcap : 0.f;
  p.n_row_tiles = (S * G + TILE - 1) / TILE;
  return launch_attention<HD, PagedSrc>(kmap, vmap, p, B, stream);
}

// fp32 extend: paged_attention_kernel, 8 rows a CTA, capped (CAP) or not
template <int HD, bool CAP>
int launch_extend_f32_cap(const void* q, const void* k_pool,
                          const void* v_pool, const void* bt,
                          const void* pos0, void* out, int B, int S, int KV,
                          int G, int nb, int bs, int n_pool_rows,
                          float scale, float softcap, cudaStream_t stream) {
  const dim3 grid(B, KV, (S * G + 7) / 8);
  const float cap = softcap * LOG2E;
  return launch_with_smem<NW * 8 * HD * 4>(
      paged_attention_kernel<float, HD, 8, CAP>, grid, NT, stream,
      (const float*)q, (const float*)k_pool, (const float*)v_pool,
      (const int*)bt, (const int*)pos0, (float*)out, S, KV, G, nb, bs,
      n_pool_rows, scale, cap, CAP ? 1.f / cap : 0.f);
}

template <int HD>
int launch_extend_f32(const void* q, const void* k_pool, const void* v_pool,
                      const void* bt, const void* pos0, void* out, int B,
                      int S, int KV, int G, int nb, int bs, int n_pool_rows,
                      float scale, float softcap, cudaStream_t stream) {
  if (softcap > 0.f) {
    if constexpr (softcap_dims(HD, HD))
      return launch_extend_f32_cap<HD, true>(q, k_pool, v_pool, bt, pos0,
                                             out, B, S, KV, G, nb, bs,
                                             n_pool_rows, scale, softcap,
                                             stream);
    return -1;
  }
  return launch_extend_f32_cap<HD, false>(q, k_pool, v_pool, bt, pos0, out,
                                          B, S, KV, G, nb, bs, n_pool_rows,
                                          scale, 0.f, stream);
}

// ---------------------------------------------------------------------
// decode: decode_sm90_kernel (decode_sm90.cuh) with PagedRows, whose key
// rows are pool rows read through the block table.
struct PagedRows {
  // keys 0 .. min(lengths[b], nb * bs) - 1
  static __device__ __forceinline__ int live(const DecodeParams& p, int b) {
    return min(max(p.lengths[b], 0), p.nb * p.bs);
  }
  // the (row in the page, pool row) of the box starting at live key t,
  // which lies in one page (box_rows divides bs); out-of-range table
  // entries clamp, as a gather does in JAX
  static __device__ __forceinline__ int2 box(const DecodeParams& p, int b,
                                             int t) {
    const int j = t / p.bs;
    const int phys = min(max(p.bt[(int64_t)b * p.nb + j], 0),
                         p.n_pool_rows - 1);
    return make_int2(t - j * p.bs, phys);
  }
  // a row of length 0 sees no key: 0
  template <typename T, int HD>
  static __device__ void no_keys(const DecodeParams& p, int b, int kvh,
                                 int g0, int rows) {
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    T* out = (T*)p.out + ((int64_t)b * p.KV * p.G + kvh * p.G + g0) * HD;
    for (int e = 4 * threadIdx.x; e < rows * HD; e += 4 * blockDim.x)
      Vec<T, 4>::store(out + e, zero);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and out are (B, KV * G, hd); ws is
// an fp32 workspace of B * KV * G * n_chunks * (hd + 2) floats and tickets
// B * KV * ceil(G / 8) int32 counters, zero before the first call (the
// kernel leaves them zero); n_chunks = ceil(nb * bs / DECODE_CHUNK);
// softcap: 0 for none, else c of c tanh(s / c).  Returns
// cudaGetLastError() after the launch (0 on success), -1 for a dtype /
// head_dim (or a cap at a head_dim) it has no kernel for, -2 if
// cuTensorMapEncodeTiled cannot be found, -3 if it refuses a tensor map.
extern "C" int repro_paged_decode_attention(
    int dtype, int hd, const void* q, const void* k_pool, const void* v_pool,
    const void* bt, const void* lengths, void* out, void* ws, void* tickets,
    int B, int KV, int G, int nb, int bs, int n_pool_rows, int n_chunks,
    float scale, float softcap, void* stream) {
  DecodeParams p = {};
  p.q = q; p.k = k_pool; p.v = v_pool; p.out = out;
  p.lengths = (const int*)lengths;
  p.bt = (const int*)bt;
  p.ws = (float*)ws;
  p.tickets = (int*)tickets;
  p.B = B; p.KV = KV; p.G = G; p.n_chunks = n_chunks;
  p.nb = nb; p.bs = bs; p.n_pool_rows = n_pool_rows;
  p.scale = scale;
  p.cap = softcap * LOG2E;                   // the log2 domain of qscale
  p.cap_inv = softcap > 0.f ? 1.f / p.cap : 0.f;
  return launch_decode<PagedRows>(dtype, hd, p, bs, n_pool_rows, bs, stream);
}

// dtype: 0 = float32, 1 = bfloat16; softcap: 0 for none, else c of c
// tanh(s / c).  Returns cudaGetLastError() after the launch (0 on
// success), -1 for a dtype / head_dim (or a cap at a head_dim) it has no
// kernel for, -2 if cuTensorMapEncodeTiled cannot be found, -3 if it
// refuses a tensor map.
extern "C" int repro_paged_extend_attention(
    int dtype, int hd, const void* q, const void* k_pool, const void* v_pool,
    const void* bt, const void* pos0, void* out, int B, int S, int KV, int G,
    int nb, int bs, int n_pool_rows, float scale, float softcap,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_HD(HD_)                                                        \
  case HD_:                                                                  \
    return dtype == 1                                                        \
        ? launch_extend_bf16<HD_>(q, k_pool, v_pool, bt, pos0, out, B, S,    \
                                  KV, G, nb, bs, n_pool_rows, scale,         \
                                  softcap, st)                               \
        : launch_extend_f32<HD_>(q, k_pool, v_pool, bt, pos0, out, B, S, KV, \
                                 G, nb, bs, n_pool_rows, scale, softcap, st)
  if (dtype != 0 && dtype != 1) return -1;
  switch (hd) {
    REPRO_HD(16);
    REPRO_HD(32);
    REPRO_HD(64);
    REPRO_HD(128);
    REPRO_HD(256);
    default: return -1;
  }
#undef REPRO_HD
}
