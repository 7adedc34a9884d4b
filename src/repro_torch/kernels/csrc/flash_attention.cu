// Flash attention for Hopper (sm_90a): blocked online-softmax attention
// over a whole sequence (the dense prefill of every admit).  Hand-written
// CUDA C++; built by repro_torch/kernels/build.py into a shared library
// with a plain C interface and bound with ctypes.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention.py:flash_attention_bhsd
//     (body _flash_kernel)  -> repro_flash_attention
//
// q is (B, S, H, hd), k (B, T, KV, hd), v (B, T, KV, hd_v) and out (B,
// S, H, hd_v), all contiguous: the kernels read the model's layout directly,
// with no transposes and no pad copies.  hd_v is hd, or narrower for MLA's
// prefill (deepseek-v2-lite: q/k 192 = nope 128 + rope 64, v 128; its
// reduced config: 24 and 16), as the TPU kernel's jnp oracle
// (flash_attention_jnp) allows; the scale is the caller's, 1/sqrt(hd).
// T is S, or more under a mask (a sequence shard's S queries over the T
// keys up to its last one: the queries sit at key positions T - S ..
// T - 1), or any count without a mask (a cross attention: whisper's
// decoder over its encoder states).  Query s of head h = kvh * G + g sits
// at position a = s + T - S and sees key t iff t < T, t <= a when causal,
// and t > a - window when window > 0 (the TPU kernel's masks, with JAX's
// query offset).
// Rows are the (query, head) pairs r = s * G + g of one (b, kv head), so the
// G heads that share a K/V head share every K/V tile a CTA loads.  A CTA
// walks only the key tiles its rows can see (the TPU kernel's `needed`
// skip), keys >= T are never read and rows >= S never written.  Masked
// scores are the finite NEG_INF and masked keys add p = 0; the output is
// acc / max(l, 1e-30), as on the TPU.  Given an lse pointer (a training
// step's forward), each row's natural log-sum-exp of its scaled scores is
// written beside the output for the backward (flash_attention_bwd.cu);
// serving passes null and writes nothing more.  A soft-cap c > 0 (softcap;
// Gemma 2's attn_logit_softcapping) turns every score s (scaled by
// 1/sqrt(hd)) into c tanh(s / c) before the mask, as JAX's jnp path does;
// both kernels have capped instantiations at hd 64, 128 and 256
// (softcap_dims in common.cuh), and none at MLA's pairs, whose scores JAX
// does not cap.
//
// Two kernels:
//
// bf16: attention_sm90_kernel with DenseSrc (both in attention_sm90.cuh),
// on the tensor cores with wgmma, K/V tiles brought in by TMA into a ring
// of mbarrier-guarded stages.  A key tile is one 4-d box (64 columns x 1
// kv head x 64 keys x 1 sequence) per 64-column block of k and of v, from
// a tensor map over (B, T, KV, hd): the map's own T bound zero-fills keys
// >= T without reading the next sequence.  The grid launches the last row
// tiles, the heaviest under causal masking, first.
//
// flash_simt_kernel (fp32), on the CUDA cores, the design of
// paged_attention_kernel without the block table: lane groups of LPK
// lanes each stream their own keys from device memory, hold GR rows'
// online softmax in registers, and merge by shuffles and through shared
// memory at the end.
//
// Bound on the card: at the main path's shapes (bf16, B = 3, S = 512
// causal, H = 16, KV = 8, hd = 128) the least time from the bytes (q, k, v
// read once, out written once: 19 MB, 5.6 us at 3.35 TB/s) and from the
// tensor-core operations (3.2 GFLOP, 3.3 us at 989 TFLOP/s) are close,
// the bytes slightly ahead: a prefill this short sits just below the bf16
// ridge (~295 flops per byte), longer ones above it.  P V costs two wgmma
// (hi and lo) where a bf16 P would cost one, so the operations the
// kernel issues are 1.5x the bound's.  fp32 on the CUDA cores is bound by
// its instructions.  MLA's prefill (deepseek-v2-lite: B = 1, S = 512, H =
// KV = 16, q/k 192, v 128) moves 10.5 MB (3.1 us) for 1.3 GFLOP (1.4 us):
// bytes again.
#include <limits.h>

#include "attention_sm90.cuh"

namespace {

// ---------------------------------------------------------------------
// fp32 on the CUDA cores
constexpr int NW = 8;            // warps per CTA
constexpr int NT = NW * 32;      // threads per CTA
constexpr int GR = 8;            // rows per CTA

// Lanes a key takes at q/k head dim HD and v head dim DV: lanes_per_key's
// count (the same for DV == HD), halved until each lane's share of both
// dims is a multiple of 4 (four floats a load): 16 at (192, 128), 12 and 8
// dims a lane; 2 at (24, 16).
template <int HD, int DV>
__host__ __device__ constexpr int lanes_per_key_qv() {
  int lpk = lanes_per_key<HD, GR>();
  while (lpk > 1 && (HD % (4 * lpk) || DV % (4 * lpk))) lpk >>= 1;
  return lpk;
}

// Rows a CTA: GR, or GR / 2 where a key takes fewer than 4 lanes (2 at
// (24, 16): 8 rows' q and acc at 12 + 8 dims a lane spilled)
template <int HD, int DV>
__host__ __device__ constexpr int flash_rows() {
  return lanes_per_key_qv<HD, DV>() < 4 ? GR / 2 : GR;
}

// CAP: scores capped by tanhf in the log2 domain of qscale (cap = c log2 e)
template <int HD, int DV, bool CAP>
__global__ void __launch_bounds__(NT) flash_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int S, int T, int KV, int G, int causal,
    int window, float scale, float cap, float cap_inv) {
  constexpr int RW = flash_rows<HD, DV>();        // rows per CTA
  constexpr int LPK = lanes_per_key_qv<HD, DV>();  // lanes per key
  constexpr int VEC = HD / LPK;                   // q/k head dims per lane
  constexpr int VV = DV / LPK;                    // v head dims per lane
  constexpr int KPW = 32 / LPK;                   // keys a warp reads at once
  // keys per lane group per step, as many as ~200 registers allow at GR
  // rows (fewer rows keep GR's count: more keys would bring the spills
  // back); ~176 beside the capped kernel's tanhf
  constexpr int UR = ((CAP ? 176 : 200) - GR * (VEC + VV)) / (VEC + VV + GR);
  constexpr int U = UR < 1 ? 1 : (UR > 8 ? 8 : UR);
  constexpr int STEP = KPW * U;                   // keys per warp step
  static_assert(VEC % 4 == 0 && VV % 4 == 0 && 32 % LPK == 0, "head_dim");

  const int b = blockIdx.x, kvh = blockIdx.y, row0 = blockIdx.z * RW;
  const int rows = min(RW, S * G - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPK, gi = lane / LPK, d0 = sub * VEC;
  const int e0 = sub * VV;                        // the lane's v dims
  const float qscale = scale * LOG2E;
  const int shift = T - S;                        // query s at key s + shift

  float qr[RW][VEC], acc[RW][VV], m[RW], l[RW];
  int hi[RW], lo[RW];                           // keys a row may see
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (i < rows) {
      const int r = row0 + i, s = r / G, g = r - s * G;
      Vec<float, VEC>::load(
          q + ((((int64_t)b * S + s) * KV + kvh) * G + g) * HD + d0, qr[i]);
      hi[i] = causal ? s + shift : T - 1;
      lo[i] = window ? max(s + shift - window + 1, 0) : 0;
    } else {
      hi[i] = -1;
      lo[i] = INT_MAX;
#pragma unroll
      for (int d = 0; d < VEC; ++d) qr[i][d] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < VEC; ++d) qr[i][d] *= qscale;
#pragma unroll
    for (int d = 0; d < VV; ++d) acc[i][d] = 0.f;
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  // the keys any row of the CTA can see: [k_lo, n_keys)
  const int s_first = row0 / G, s_last = (row0 + rows - 1) / G;
  const int n_keys = causal ? s_last + shift + 1 : T;
  const int k_lo = window ? max(s_first + shift - window + 1, 0) : 0;
  const int64_t base_k =
      (int64_t)b * T * KV * HD + (int64_t)kvh * HD + d0;
  const int64_t base_v =
      (int64_t)b * T * KV * DV + (int64_t)kvh * DV + e0;

  // warp-uniform loop: group gi of warp w reads keys base + gi*U + u
  for (int base = k_lo + warp * STEP; base < n_keys; base += NW * STEP) {
    float kx[U][VEC], vx[U][VV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + gi * U + u;
      if (key < n_keys) {
        Vec<float, VEC>::load(k + base_k + (int64_t)key * KV * HD, kx[u]);
        Vec<float, VV>::load(v + base_v + (int64_t)key * KV * DV, vx[u]);
      } else {
#pragma unroll
        for (int d = 0; d < VEC; ++d) kx[u][d] = 0.f;
#pragma unroll
        for (int d = 0; d < VV; ++d) vx[u][d] = 0.f;
      }
    }
    float sc[U][RW];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < VEC; ++d) dot += qr[i][d] * kx[u][d];
        sc[u][i] = dot;
      }
#pragma unroll
    for (int sh = LPK / 2; sh > 0; sh >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < RW; ++i)
          sc[u][i] += __shfl_xor_sync(0xffffffffu, sc[u][i], sh);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float mx = m[i];
      bool vis[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = base + gi * U + u;
        vis[u] = key < n_keys && key <= hi[i] && key >= lo[i];
        if constexpr (CAP) sc[u][i] = soft_cap<float>(sc[u][i], cap, cap_inv);
        if (!vis[u]) sc[u][i] = NEG_INF;
        mx = fmaxf(mx, sc[u][i]);
      }
      if (mx > m[i]) {                  // rescale only when the max grows
        const float corr = exp2f(m[i] - mx);
        l[i] *= corr;
#pragma unroll
        for (int d = 0; d < VV; ++d) acc[i][d] *= corr;
        m[i] = mx;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = vis[u] ? exp2f(sc[u][i] - mx) : 0.f;
        l[i] += p;
#pragma unroll
        for (int d = 0; d < VV; ++d) acc[i][d] += p * vx[u][d];
      }
    }
  }

  // merge the groups of a warp
  merge_lane_groups<RW, VV, LPK>(m, l, acc);

  // merge the warps through shared memory and write the rows (a_s is
  // dynamic shared memory at hd 256: 64 KiB)
  __shared__ float m_s[NW][RW], l_s[NW][RW];
  float(*a_s)[RW][DV] = reinterpret_cast<float(*)[RW][DV]>(
      smem_buffer<NW * RW * DV * 4>());
  if (lane < LPK) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
#pragma unroll
      for (int d = 0; d < VV; ++d) a_s[warp][i][e0 + d] = acc[i][d];
      if (sub == 0) {
        m_s[warp][i] = m[i];
        l_s[warp][i] = l[i];
      }
    }
  }
  __syncthreads();
  constexpr int OV = 4;                         // dims per output store
  for (int e = threadIdx.x; e < rows * (DV / OV); e += NT) {
    const int i = e / (DV / OV), dv = (e - i * (DV / OV)) * OV;
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
    const int64_t row = (((int64_t)b * S + s) * KV + kvh) * G + g;
    Vec<float, OV>::store(out + row * DV + dv, o);
    // the natural log-sum-exp of the scaled scores (m and l are in the
    // log2 domain of qscale)
    if (lse != nullptr && dv == 0)
      lse[row] = (mx + log2f(fmaxf(li, 1e-30f))) * LN2;
  }
}

// the fp32 kernel, capped (CAP) or not
template <int HD, int DV, bool CAP>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int S, int T, int KV, int G, int causal,
                int window, float scale, float softcap,
                cudaStream_t stream) {
  constexpr int RW = flash_rows<HD, DV>();
  const dim3 grid(B, KV, (S * G + RW - 1) / RW);
  const float cap = softcap * LOG2E;
  return launch_with_smem<NW * RW * DV * 4>(
      flash_simt_kernel<HD, DV, CAP>, grid, NT, stream, (const float*)q,
      (const float*)k, (const float*)v, (float*)out, lse, S, T, KV, G,
      causal, window, scale, cap, CAP ? 1.f / cap : 0.f);
}

// DV == HD, or (192, 128); (24, 16) has the fp32 kernel only (24 is not
// a multiple of the bf16 wgmma's 16-deep k-step), and returns -1 in bf16;
// a soft-cap > 0 only at softcap_dims, else -1
template <int HD, int DV = HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           void* out, float* lse, int B, int S, int T, int KV, int G,
           int causal, int window, float scale, float softcap,
           cudaStream_t stream) {
  if (softcap > 0.f && !softcap_dims(HD, DV)) return -1;
  if (dtype == 1) {
    if constexpr (HD % 16 == 0 && DV % 16 == 0) {
      CUtensorMap kmap, vmap;
      int rc = encode_map<HD>(&kmap, k, KV, T, B, TILE);
      if (rc == 0) rc = encode_map<DV>(&vmap, v, KV, T, B, TILE);
      if (rc != 0) return rc;
      AttnParams p = {};
      p.q = (const __nv_bfloat16*)q;
      p.out = (__nv_bfloat16*)out;
      p.S = S; p.T = T; p.KV = KV; p.G = G;
      p.causal = causal; p.window = window; p.scale = scale;
      p.lse = lse;
      p.cap = softcap / scale;                 // raw units
      p.cap_inv = softcap > 0.f ? scale / softcap : 0.f;
      p.n_row_tiles = (S * G + TILE - 1) / TILE;
      return launch_attention<HD, DenseSrc, DV>(kmap, vmap, p, B, stream);
    } else {
      return -1;
    }
  }
  if constexpr (softcap_dims(HD, DV)) {
    if (softcap > 0.f)
      return launch_simt<HD, DV, true>(q, k, v, out, lse, B, S, T, KV, G,
                                       causal, window, scale, softcap,
                                       stream);
  }
  return launch_simt<HD, DV, false>(q, k, v, out, lse, B, S, T, KV, G,
                                    causal, window, scale, 0.f, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd_v: v's head dim (hd, or a pair
// above); S: queries, T: keys (T < S only with causal = window = 0; the
// queries sit at key positions T - S .. T - 1);
// causal: 0 or 1; window: 0 for none; lse: null, or (B, S, H)
// fp32 that receives each row's natural log-sum-exp of the scaled
// (capped) scores (the backward's input); softcap: 0 for none, else c of
// c tanh(s / c).  Returns cudaGetLastError() after the launch (0 on
// success), -1 for a dtype / head dims (or a cap at head dims) it has no
// kernel for, -2 if cuTensorMapEncodeTiled cannot be found, -3 if it
// refuses a tensor map.
extern "C" int repro_flash_attention(int dtype, int hd, int hd_v,
                                     const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     int B, int S, int T, int KV, int G,
                                     int causal, int window, float scale,
                                     float softcap, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 192 && hd_v == 128)
    return launch<192, 128>(dtype, q, k, v, out, lse, B, S, T, KV, G, causal,
                            window, scale, softcap, st);
  if (hd == 24 && hd_v == 16)
    return launch<24, 16>(dtype, q, k, v, out, lse, B, S, T, KV, G, causal,
                          window, scale, softcap, st);
  if (hd_v != hd) return -1;
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, out, lse, B, S, T, KV, G,
                               causal, window, scale, softcap, st);
    case 32: return launch<32>(dtype, q, k, v, out, lse, B, S, T, KV, G,
                               causal, window, scale, softcap, st);
    case 64: return launch<64>(dtype, q, k, v, out, lse, B, S, T, KV, G,
                               causal, window, scale, softcap, st);
    case 128: return launch<128>(dtype, q, k, v, out, lse, B, S, T, KV, G,
                                 causal, window, scale, softcap, st);
    case 256: return launch<256>(dtype, q, k, v, out, lse, B, S, T, KV, G,
                                 causal, window, scale, softcap, st);
    default: return -1;
  }
}
