// What the two scan sources share (ssm_scan.cu, selective_scan.cu) beside
// common.cuh and sm90_ptx.cuh: the 4- and 16-byte cp.async copies into
// shared memory and their groups, and the status flags of the chunked
// scan's decoupled look-back, written with release and read with acquire
// semantics at GPU scope.  Internal linkage, as in common.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace {

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's committed groups are in
// flight; the copies of the others have landed in shared memory
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void flag_release(int* f, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(f), "r"(v)
               : "memory");
}

__device__ __forceinline__ int flag_acquire(const int* f) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(f)
               : "memory");
  return v;
}

}  // namespace
