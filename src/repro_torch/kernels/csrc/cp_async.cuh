// Asynchronous copies from device to shared memory (cp.async, sm_80 and
// later), for the kernels that stream tiles through a shared-memory ring
// (K5, K6). A copy with `bytes` 0 writes zeros: the ragged edge of a tile is
// zero-filled without a branch around the copy.
#pragma once

namespace repro {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device to shared memory, asynchronously; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

}  // namespace repro
