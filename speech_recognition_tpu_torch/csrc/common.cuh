// Shared definitions of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Finite stand-in for +inf cost (utils/numerics.POS_INF); min-plus sums
// are clamped to it so no inf ever enters a cost plane.
#define SRT_POS_INF 1e30f

// Largest shared-memory carve-out a block may request on Hopper
// (227 KB of the SM's 256 KB).
#define SRT_MAX_SMEM (227 * 1024)

// Allow a kernel more than the default 48 KB of dynamic shared memory,
// then launch-check: a refused launch never runs, so report it here.
#define SRT_SET_SMEM(kernel, bytes)                                        \
  do {                                                                     \
    if ((bytes) > SRT_MAX_SMEM) return (int)cudaErrorInvalidValue;         \
    cudaError_t e_ = cudaFuncSetAttribute(                                 \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(bytes)); \
    if (e_ != cudaSuccess) return (int)e_;                                 \
  } while (0)

// cp.async copies from device to shared memory, and their groups.  Every
// asm carries the "memory" clobber, so the compiler moves no shared-memory
// access across an issue, a commit or a wait: a read of a slot after its
// wait is never hoisted above it, nor a later copy into the slot above the
// read.  A copy of fewer source bytes (`bytes` < its size) fills the rest
// with zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait for every copy, committed or not
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Hopper's bulk copies (the TMA unit, no tensor map): `bytes` (a multiple
// of 16) from 16-byte aligned global memory to 16-byte aligned shared
// memory, completion counted on an mbarrier in transaction bytes.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
