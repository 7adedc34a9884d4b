// Helpers shared by the port's attention kernels (paged_attention.cu,
// flash_attention.cu, decode_attention.cu, flash_attention_bwd.cu): fp32
// <-> element loads and stores, bf16 pair packing, the hi + lo split that
// keeps P near fp32 in a bf16 wgmma, the logit soft-cap, and the
// lane-group pieces of the kernels that run on the CUDA cores.  Each .cu
// file compiles into its own shared library, so everything here has
// internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Attention logit soft-capping (Gemma 2's attn_logit_softcapping): every
// visible score s becomes c tanh(s / c) before the mask, so a masked score
// stays NEG_INF.  A kernel applies it in the units it keeps its scores in
// (raw q.k where it folds the scale into its exp2, or q.k scale log2 e
// where q is pre-scaled), as cap = c in those units and inv = 1 / cap.
// Only these (q/k, v) head dims have capped instantiations: the widths of
// the configs a cap is set on in practice (Gemma 2 at 256, and 64 and 128).
__host__ __device__ constexpr bool softcap_dims(int hd, int hd_v) {
  return hd == hd_v && (hd == 64 || hd == 128 || hd == 256);
}

// tanh x = 1 - 2 / (e^(2x) + 1), from ex2.approx (2^-22 relative) and
// rcp.approx: ~3e-7 absolute, so c tanh(s / c) is off by ~3e-7 c (c 50:
// 1.5e-5 in a score); the bf16 kernels' tanh.  tanh.approx.f32 alone is
// off by up to ~2^-11 relative, 0.024 in a score at c 50 (2.4% in p).
// e^(2x) = inf gives 1 and 0 gives -1.
__device__ __forceinline__ float tanh_ex2(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * (2.f * LOG2E)));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(e + 1.f));
  return fmaf(-2.f, r, 1.f);
}

// cap tanh(s inv): tanhf (CUDA's accurate tanh, 2 ulp) for the fp32
// kernels (T = float), tanh_ex2 for the bf16 ones
template <typename T>
__device__ __forceinline__ float soft_cap(float s, float cap, float inv) {
  if constexpr (std::is_same<T, float>::value)
    return cap * tanhf(s * inv);
  else
    return cap * tanh_ex2(s * inv);
}

// N consecutive elements <-> fp32 registers, in 16-byte (8-byte for 4
// bf16) loads and stores; N is a multiple of 4 and the address is
// aligned to the access (the wrappers check 16-byte base alignment).
template <typename T, int N>
struct Vec;

template <int N>
struct Vec<float, N> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      x[c] = v.x; x[c + 1] = v.y; x[c + 2] = v.z; x[c + 3] = v.w;
    }
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
#pragma unroll
    for (int c = 0; c < N; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
  }
};

__device__ __forceinline__ void bf2_to_f(uint32_t w, float* x) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  const float2 f = __bfloat1622float2(h);
  x[0] = f.x; x[1] = f.y;
}

__device__ __forceinline__ uint32_t f_to_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) = hi + lo with hi = bf16(a, b) and lo = bf16((a, b) - hi)
__device__ __forceinline__ void split_bf2(float a, float b, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = f_to_bf2(a - f.x, b - f.y);
}

template <int N>
struct Vec<__nv_bfloat16, N> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    if constexpr (N % 8 == 0) {
#pragma unroll
      for (int c = 0; c < N; c += 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + c);
        bf2_to_f(v.x, x + c); bf2_to_f(v.y, x + c + 2);
        bf2_to_f(v.z, x + c + 4); bf2_to_f(v.w, x + c + 6);
      }
    } else {
#pragma unroll
      for (int c = 0; c < N; c += 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(p + c);
        bf2_to_f(v.x, x + c); bf2_to_f(v.y, x + c + 2);
      }
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      uint2 v;
      v.x = f_to_bf2(x[c], x[c + 1]);
      v.y = f_to_bf2(x[c + 2], x[c + 3]);
      *reinterpret_cast<uint2*>(p + c) = v;
    }
  }
};

// Lanes that share one key in the lane-group kernels: fewer lanes per key
// mean fewer shuffles and exponentials per key, more head dims (registers)
// per lane.  At hd 256 a whole warp takes a key, 8 dims a lane, so q and
// acc of 8 rows stay at 128 registers.
template <int HD, int GR>
__host__ __device__ constexpr int lanes_per_key() {
  const int want = HD >= 256 ? 32 : GR <= 2 ? 8 : 16;
  return want < HD / 4 ? want : HD / 4;
}

// A kernel's shared buffer of BYTES bytes, 128-byte aligned: a static
// array up to STATIC_SMEM bytes (what every head dim up to 128 asks for,
// leaving room under the 48 KiB static limit for the kernel's other
// arrays), past it the kernel's dynamic shared memory, which the launch
// opts into with cudaFuncSetAttribute and passes (dyn_smem_bytes<BYTES>()).
constexpr int STATIC_SMEM = 32768;

template <int BYTES>
__host__ __device__ constexpr int dyn_smem_bytes() {
  return BYTES <= STATIC_SMEM ? 0 : BYTES + 128;
}

template <int BYTES>
__device__ __forceinline__ uint8_t* smem_buffer() {
  if constexpr (dyn_smem_bytes<BYTES>() == 0) {
    __shared__ __align__(128) uint8_t buf[BYTES];
    return buf;
  } else {
    extern __shared__ uint8_t dyn_smem[];
    const uint32_t at = (uint32_t)__cvta_generic_to_shared(dyn_smem);
    return dyn_smem + ((128u - (at & 127u)) & 127u);
  }
}

// Launch ``kernel`` with dyn_smem_bytes<BYTES>() of dynamic shared memory,
// opted in first where it passes the 48 KiB default; returns the CUDA
// error of the attribute or of the launch.
template <int BYTES, typename Kernel, typename... Args>
int launch_with_smem(Kernel kernel, dim3 grid, int threads,
                     cudaStream_t stream, Args... args) {
  constexpr int dyn = dyn_smem_bytes<BYTES>();
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, dyn, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Merge the online softmax states (m, l, acc) of the lane groups of a
// warp: lanes lane ^ sh (sh = LPK, 2 LPK, ...) hold the same head dims of
// other keys.  Scores are in the log2 domain.
template <int GR, int VEC, int LPK>
__device__ __forceinline__ void merge_lane_groups(float (&m)[GR],
                                                  float (&l)[GR],
                                                  float (&acc)[GR][VEC]) {
#pragma unroll
  for (int sh = LPK; sh < 32; sh <<= 1)
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], sh);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], sh);
      const float mn = fmaxf(m[i], mo);
      const float a = exp2f(m[i] - mn), c = exp2f(mo - mn);
      l[i] = l[i] * a + lo * c;
#pragma unroll
      for (int d = 0; d < VEC; ++d) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[i][d], sh);
        acc[i][d] = acc[i][d] * a + ao * c;
      }
      m[i] = mn;
    }
}

}  // namespace
