// Helpers shared by the port's CUDA sources (sfc_gemm_fused.cu,
// sfc_attention.cu): a kernel's dynamic shared-memory opt-in, once per
// device, and the 16-byte cp.async copies of their multi-stage rings.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a launch is refused unless the kernel
// opts in; do it once per device (so no attribute call lands inside a CUDA
// graph capture).  `done` is the caller's per-kernel flag array.
template <typename Kernel>
static int opt_in(Kernel kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

// 16-byte copies global -> shared that bypass L1; a copy with full = false
// writes 16 zero bytes and reads nothing.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(full ? 16 : 0));
}
static __device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
