// mbarriers in shared memory (CTA scope) and the copies that complete on
// them, for the kernels whose producer warps fill a ring of shared-memory
// slots: K3's select pass (catalog_topk.cu: cp.async) and K4's group maxima
// (groupmax.cu: tensor copies of rows, cp.async scales).
#pragma once

#include <stdint.h>

namespace carca {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// the initialised barriers visible to the async proxy (the bulk copies'
// complete_tx), before the barrier that publishes them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` more of bulk copies to complete on
// the barrier before its phase can complete
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival once every cp.async this thread issued before it is complete
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The box at coordinates (x: column, y: row) of the 2-D tensor map `map` (a
// __grid_constant__ kernel parameter) from global to shared memory by the
// tensor-memory accelerator, completing on `bar`'s transaction count with
// the box's bytes (elements past the tensor's edges arrive as zeros).
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int x, int y,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// a barrier of `threads` threads (a multiple of 32) under id (1 to 15; 0 is
// __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace carca
