// Bulk copies from device memory into shared memory, completed on an
// mbarrier: one thread asks for a contiguous run of bytes (cp.async.bulk)
// and the copy engine counts the bytes that land against the barrier's
// expected transaction count, so no thread spends registers or
// instructions on the data. The idiom of dft_power.cu's B ring, for the
// kernels that take it from here (istft.cu).
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t bulk_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One arrival completes a phase (with its bytes); all threads of the block
// see the barrier only after the caller's next __syncthreads
__device__ __forceinline__ void bulk_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      bulk_smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16) from src to dst (both 16-byte aligned)
// and complete the barrier's current phase when they have landed. One
// thread calls it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = bulk_smem_addr(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(bulk_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Whether the barrier's phase of this parity has completed, without waiting
__device__ __forceinline__ bool bulk_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bulk_smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}

// Wait for the barrier's phase of this parity; true if it had completed at
// the first test
__device__ __forceinline__ bool bulk_wait(uint64_t* bar, uint32_t parity) {
  if (bulk_test(bar, parity)) return true;
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bulk_smem_addr(bar)), "r"(parity)
        : "memory");
  return false;
}
