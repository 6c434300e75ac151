// The catalog-scoring arithmetic shared by K3 (catalog_topk.cu) and K4
// (groupmax.cu), and repeated by the plain versions in
// carca_tpu_torch/ops/retrieval_topk.py (ordered_scores, the tournament's
// rerank). All of them must compute bit-identical scores: K3's ids agree
// with the plain sort only then, and the tournament's containment argument
// (the winner groups hold the true top-k) is exact only when K4's group
// maxima equal the rerank's scores bit for bit.
//
// score(q, row) = ((q0*e0 + q1*e1) + q2*e2) + ... over d in index order,
// each product and each sum rounded on its own, then times the row's int8
// scale (after the sum, once). The index element type picks the operands:
//   float          q as given, e as given; products rounded (__fmul_rn)
//   __nv_bfloat16  q rounded to bf16 (nearest even, as torch's
//                  .to(torch.bfloat16)), e widened; every product is exact
//                  in float32 (8 x 8 significant bits), so an FMA gives the
//                  same bits as a rounded product followed by a rounded sum
//   int8_t         q rounded to bf16, e widened (exact); products exact
//                  (8 x 7 bits), so again an FMA
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace carca {

template <typename T>
__device__ __forceinline__ float widen(T x);
template <>
__device__ __forceinline__ float widen<float>(float x) { return x; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float widen<int8_t>(int8_t x) { return (float)x; }

// the query operand against an index of element type T
template <typename T>
__device__ __forceinline__ float query_operand(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float query_operand<float>(float x) { return x; }

// s + q*e with the rounding the contract names
template <typename T>
__device__ __forceinline__ float add_term(float s, float q, float e) {
  return __fmaf_rn(q, e, s);  // q*e is exact here
}
template <>
__device__ __forceinline__ float add_term<float>(float s, float q, float e) {
  return __fadd_rn(s, __fmul_rn(q, e));
}

// index dtype codes of the C entry points (ops/retrieval_topk.py::_DTYPE_CODE)
enum IndexType { kF32 = 0, kBF16 = 1, kI8 = 2 };

}  // namespace carca
