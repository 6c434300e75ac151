// Warp-level tensor-core products (mma.sync, m16n8, fp32 accumulators) and
// the cp.async copies shared by the attention kernels (attention_tile.cuh,
// attention_bwd.cu) and the catalog scoring routine (scoring.cuh).
//
// * float32 operands: m16n8k8 TF32 with the 3xTF32 split. Each operand x is
//   hi + lo with hi = tf32(x) (cvt.rna) and lo = tf32(x - hi); the product
//   sums lo*hi + hi*lo + hi*hi in that order, dropping lo*lo (~2^-22
//   relative), which keeps float32 accuracy where one TF32 product would
//   keep ~10 bits. K2 splits by truncation instead (split_fast).
// * bfloat16 operands: m16n8k16, products exact in the fp32 accumulator.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace carca {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// The split without cvt (sm_90 lowers cvt.rna.tf32 with range checks, five
// instructions a conversion). The tensor core reads the top 19 bits of a
// TF32 operand, so adding half a TF32 unit rounds to nearest, ties away, as
// cvt.rna does: hi is x so rounded (masked, for lo = x - hi, which is
// exact), and lo is passed rounded the same way. Four instructions, the
// same products as split. Reading lo truncated (one instruction less) moved
// the item-table gradients of a data-parallel step ~3e-4 away from one
// device's on a batch that repeats an item, where split stays within 2e-7.
__device__ __forceinline__ Split split_fast(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi)) + 0x1000u};
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b to float32 accuracy: the small cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split (&a)[4], Split b0,
                                           Split b1) {
  mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over k = 8 with bf16 operands (m16n8k8): a0, a1 rows g and g + 8,
// columns 2t and 2t + 1; b0 rows 2t and 2t + 1 of column g.
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// cp.async of 16 (4) bytes from global to shared memory; src_bytes < 16
// (4) zero-fills the rest, and 0 reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace carca
