// Asynchronous copies into shared memory, for the kernels that stream
// their operands through a ring of stages (K2 dense.cu, K11
// sell_mxu_spmm.cu):
// - cp.async of 16 or 4 bytes a thread, zero-filling where the source is
//   out of range, waited for with cp.async.wait_group;
// - 1D bulk copies (one thread moves a whole contiguous slab, no tensor
//   map) that complete on an mbarrier, waited for by phase parity.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tps {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (16 or 4) from global src to shared dst, or zeros if
// !valid (src is then not read, but must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  static_assert(BYTES == 16 || BYTES == 4, "cp.async of 16 or 4 bytes");
  const int n = valid ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier with one arrival a phase (the thread that issues the copies).
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive, and expect `bytes` of bulk copies to complete this phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// One bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global src to shared dst, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace tps
