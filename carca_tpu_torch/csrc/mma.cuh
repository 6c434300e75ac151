// Warp-level tensor-core products (mma.sync, m16n8, fp32 accumulators)
// shared by the attention kernels (attention_tile.cuh) and the catalog
// scoring routine (scoring.cuh).
//
// * float32 operands: m16n8k8 TF32 with the 3xTF32 split. Each operand x is
//   hi + lo with hi = tf32(x) (cvt.rna) and lo = tf32(x - hi); the product
//   sums lo*hi + hi*lo + hi*hi in that order, dropping lo*lo (~2^-22
//   relative), which keeps float32 accuracy where one TF32 product would
//   keep ~10 bits.
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

}  // namespace carca
