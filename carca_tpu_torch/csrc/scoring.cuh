// The catalog-scoring arithmetic shared by K3 (catalog_topk.cu), K4
// (groupmax.cu) and the tournament's rerank (groupmax.cu,
// carca_tournament_rerank): one warp scores a tile of 16 index rows (the M
// side of mma.sync) against 8 queries (the N side) on the tensor cores
// (score_tile); K4's bf16 and int8 kernel runs the same arithmetic as a
// warpgroup product of 64 rows against up to 64 queries (groupmax.cu,
// tile_products).
//
// One arithmetic: score_tile and K4's wgmma sequence, shown bit-equal by
// the card test test_wgmma_scores_equal_score_tile (the probe,
// groupmax.cu::probe_kernel: one 64-row tile against 256 queries, bf16 and
// widened int8 rows, N(0,1), cancelling and tied inputs, d = 64 and 128; the
// raw sums equal bit for bit, sign of zero included, from a zeroed
// accumulator and from the first product alike). The wgmma sequence keeps
// score_tile's operands: the rows are A, in registers in mma.sync's
// fragment layout (load_a's values), the queries B in shared memory with
// the same column-to-k-slot map, k-steps ascending.
//
// score(q, row) is one fixed instruction sequence:
//   bf16 and int8 index  mma.sync m16n8k16, bf16 operands, f32 accumulator
//                        (K4: wgmma m64nNk16, the same sums).
//                        The query is rounded to bf16 (nearest even, as
//                        torch's .to(torch.bfloat16)); int8 rows are widened
//                        to bf16, which is exact.
//   f32 index            mma.sync m16n8k8 3xTF32 (mma.cuh: the hi/lo split
//                        and the order lo*hi, hi*lo, hi*hi of K1/K2).
// The k-steps run in ascending order from a zero accumulator over the row
// width zero-padded to kD (64 or 128, score_width); a row wider than 128
// is walked in 128-column chunks (score_chunks), its k-steps still
// ascending from zero across all chunks (score_acc carries the accumulator
// from one chunk to the next), so every kernel scores it with the same
// instruction sequence as one long walk. Inside a k-step the physical
// columns map to mma's k slots by one fixed permutation (below), the same
// for the rows and the query. An int8 row's scale multiplies the finished
// sum once (__fmul_rn), and the mask (-inf) comes after that.
//
// Why one routine: a score then depends only on (q, row) and this
// instruction sequence, not on the tile position, the other rows and
// queries, or the kernel that ran it. So K4's group maxima equal the
// rerank's scores bit for bit, which makes the tournament's containment
// argument exact (the k + 8 best groups hold the true top-k), and the
// tournament returns K3's ids and values exactly. chip_smoke.py (phase 4c)
// and the card tests check both equalities.
//
// Against the plain versions (ops/retrieval_topk.py: ordered_scores, the
// rerank's _ordered_dot), which sum the products in index order with each
// sum rounded: both add the same d products (exact in f32 for bf16/int8
// operands; within ~2^-21 relative of the true product under 3xTF32) in
// two summation orders, so a score differs by at most
//     1e-5 * sum_j |q_j * e_rj|   (times the int8 row scale)
// which is the tolerance the checks hold the kernels to; ids may differ
// only where two candidates' plain scores lie within that bound at the
// k-th place.
//
// What bounds the routine on the H100: mma.sync reaches a fraction of the
// tensor cores' wgmma peak (989 TFLOP/s bf16), and every mma needs its
// fragments from shared memory or registers; K3 and the rerank score a
// tile once, where the index's bytes or the selection bound them instead.
// K4's warpgroup products (bf16 and int8) reach the tensor cores' wgmma
// rate; its f32 kernel stays on mma.sync (3xTF32). Any other change of the
// instruction sequence must keep the probe test passing, or move all three
// kernels together.
//
// Fragment layout (lane = 4 g + t). A row's k-step s covers its physical
// columns [K s, K s + K), K = 16 (bf16) or 8 (tf32). For bf16 a lane loads
// columns 16 s + 4 t .. 16 s + 4 t + 3 of rows g and g + 8 in one load;
// they fill mma's k slots 2t, 2t+1 (a0/a1) and 2t+8, 2t+9 (a2/a3). For tf32
// it loads columns 8 s + 2 t, 8 s + 2 t + 1 into k slots t and t + 4. The
// query's fragment follows the same map, so every product pairs equal
// columns. Rows sit in shared memory in their own type, row stride
// row_stride_bytes (bank-conflict-free for these loads), staged by cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace carca {

// index dtype codes of the C entry points (ops/retrieval_topk.py::_DTYPE_CODE)
enum IndexType { kF32 = 0, kBF16 = 1, kI8 = 2 };

constexpr int kChunk = 128;  // columns of a row chunk past 128 columns

// The row width the kernels score at: d zero-padded to 64 or 128; a wider
// row is scored in 128-column chunks.
inline int score_width(int d) { return d <= 64 ? 64 : kChunk; }

// 128-column chunks of a row of d > 128 columns (the last zero-padded)
__host__ __device__ inline int score_chunks(int d) { return (d + kChunk - 1) / kChunk; }

// Shared-memory row stride: int8 rows take 32-bit loads (stride = 4 words
// mod 8), bf16/f32 rows 64-bit loads (stride = 8 words mod 16).
template <typename T>
__host__ __device__ constexpr int row_stride_bytes(int kD) {
  return kD * (int)sizeof(T) + (sizeof(T) == 1 ? 16 : 32);
}

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// columns per k-step
template <typename T>
constexpr int kStep = kIsF32<T> ? 8 : 16;

struct ABf16 {
  uint32_t x[4];
};
struct ATf32 {
  Split x[4];
};
template <typename T>
using AFrag = typename std::conditional<kIsF32<T>, ATf32, ABf16>::type;
// a query's fragment for one k-step: two packed bf16 pairs, or two floats
// (split into TF32 hi/lo when used)
template <typename T>
using QFrag = typename std::conditional<kIsF32<T>, float2, uint2>::type;

// Byte k of w as a float, exactly: its bits with the sign flipped (b + 128)
// under the exponent of 2^23 give 2^23 + b + 128, from which one exact
// subtraction leaves b. A byte permute and an add, where a conversion
// instruction runs at a quarter of the rate.
__device__ __forceinline__ float i8_to_float(uint32_t w, int k) {
  const uint32_t biased = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 + k);
  return __uint_as_float(biased) - 8388736.f;  // 2^23 + 128
}

// bytes shift / 8 and shift / 8 + 1 of w, two int8 values, as packed bf16:
// the float of an int8 has 8 significant bits, so its low 16 bits are zero
// and its high half is the bf16 (what pack_bf16's rounding would give)
__device__ __forceinline__ uint32_t pack_i8_pair(uint32_t w, int shift) {
  return __byte_perm(__float_as_uint(i8_to_float(w, shift / 8)),
                     __float_as_uint(i8_to_float(w, shift / 8 + 1)), 0x7632);
}

// The A fragments of 16 rows (row_g = row g of the tile, row g + 8 is 8
// strides on) over KS k-steps, from shared memory.
template <typename T, int KS>
__device__ __forceinline__ void load_a(AFrag<T> (&a)[KS], const char* row_g, int stride,
                                       int t) {
  const char* row_g8 = row_g + 8 * stride;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if constexpr (kIsF32<T>) {
      const float2 u = *reinterpret_cast<const float2*>(row_g + 4 * (8 * s + 2 * t));
      const float2 v = *reinterpret_cast<const float2*>(row_g8 + 4 * (8 * s + 2 * t));
      a[s].x[0] = split(u.x);
      a[s].x[1] = split(v.x);
      a[s].x[2] = split(u.y);
      a[s].x[3] = split(v.y);
    } else if constexpr (sizeof(T) == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(row_g + 2 * (16 * s + 4 * t));
      const uint2 v = *reinterpret_cast<const uint2*>(row_g8 + 2 * (16 * s + 4 * t));
      a[s].x[0] = u.x;
      a[s].x[1] = v.x;
      a[s].x[2] = u.y;
      a[s].x[3] = v.y;
    } else {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(row_g + 16 * s + 4 * t);
      const uint32_t v = *reinterpret_cast<const uint32_t*>(row_g8 + 16 * s + 4 * t);
      a[s].x[0] = pack_i8_pair(u, 0);
      a[s].x[1] = pack_i8_pair(v, 0);
      a[s].x[2] = pack_i8_pair(u, 16);
      a[s].x[3] = pack_i8_pair(v, 16);
    }
  }
}

// Query q's fragment for k-step s at lane column t (zeros past d, and for a
// null q: a padding query).
template <typename T>
__device__ __forceinline__ QFrag<T> query_frag(const float* __restrict__ q, int d, int s,
                                               int t) {
  auto at = [&](int j) { return (q != nullptr && j < d) ? __ldg(q + j) : 0.f; };
  if constexpr (kIsF32<T>) {
    return make_float2(at(8 * s + 2 * t), at(8 * s + 2 * t + 1));
  } else {
    const int j = 16 * s + 4 * t;
    return make_uint2(pack_bf16(at(j), at(j + 1)), pack_bf16(at(j + 2), at(j + 3)));
  }
}

// c = the scores of the tile's 16 rows against the 8 queries: lane (g, t)
// gets rows g (c[0], c[1]) and g + 8 (c[2], c[3]) against queries 2t
// (c[0], c[2]) and 2t + 1 (c[1], c[3]). The one scoring routine.
// score_acc adds the products of KS more k-steps to c: a chunk of a wide row.
template <typename T, int KS>
__device__ __forceinline__ void score_acc(float (&c)[4], const AFrag<T> (&a)[KS],
                                          const QFrag<T> (&b)[KS]) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if constexpr (kIsF32<T>) {
      mma_3xtf32(c, a[s].x, split(b[s].x), split(b[s].y));
    } else {
      mma_bf16(c, a[s].x, b[s].x, b[s].y);
    }
  }
}

template <typename T, int KS>
__device__ __forceinline__ void score_tile(float (&c)[4], const AFrag<T> (&a)[KS],
                                           const QFrag<T> (&b)[KS]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  score_acc<T, KS>(c, a, b);
}

// Query q [d]'s fragments for the k-steps of the 128-column chunk ch of a
// wide row (a null q: a padding query).
template <typename T, int KS>
__device__ __forceinline__ void chunk_query_frags(QFrag<T> (&b)[KS], const float* __restrict__ q,
                                                  int d, int ch, int t) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
    b[s] = query_frag<T>(q != nullptr ? q + ch * kChunk : nullptr, d - ch * kChunk, s, t);
}

// The finished score: the int8 scale after the sum, then the mask.
template <typename T>
__device__ __forceinline__ float finish(float c, float scale, bool valid) {
  if constexpr (std::is_same<T, int8_t>::value) c = __fmul_rn(c, scale);
  return valid ? c : -INFINITY;
}

// Local row r scores at all: r < lim0 (the wrapper clamps lim0 <= R), and
// not the pad row 0.
__device__ __forceinline__ bool row_valid(int r, int lim0, int mask_row0) {
  return r < lim0 && !(r == 0 && mask_row0);
}

// ---------------------------------------------------------------------------
// staging rows into shared memory
// ---------------------------------------------------------------------------

// Columns [col0, col0 + kD) of rows [row0, row0 + n) of e [R, d] into dst
// (row stride `stride` bytes), zeros past R and past d, by threads tid,
// tid + nth, ... (stage_rows: every thread of the block). With `vec` (e
// 16-byte aligned, d * sizeof(T) a multiple of 16; col0 is 0 or a multiple
// of 128) the copy is cp.async in 16-byte chunks, to be waited on with
// cp_async_wait; otherwise plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage_rows_by(int tid, int nth, char* dst,
                                              const T* __restrict__ e, long long row0, int n,
                                              long long R, int d, int kD, int stride, bool vec,
                                              int col0 = 0) {
  if (vec) {
    const int chunks = kD * (int)sizeof(T) / 16;
    const int live = (d - col0) * (int)sizeof(T) / 16;
    for (int idx = tid; idx < n * chunks; idx += nth) {
      const int r = idx / chunks, c = idx - r * chunks;
      const long long row = row0 + r;
      const bool in = row < R && c < live;
      const char* src = reinterpret_cast<const char*>(e) +
                        (in ? (row * d + col0) * sizeof(T) + 16 * c : 0);
      cp_async16(dst + r * stride + 16 * c, src, in ? 16 : 0);
    }
  } else {
    using Raw = typename std::conditional<
        sizeof(T) == 1, uint8_t, typename std::conditional<sizeof(T) == 2, uint16_t,
                                                           uint32_t>::type>::type;
    const Raw* src = reinterpret_cast<const Raw*>(e);
    for (int idx = tid; idx < n * kD; idx += nth) {
      const int r = idx / kD, j = idx - r * kD;
      const long long row = row0 + r;
      reinterpret_cast<Raw*>(dst + r * stride)[j] =
          (row < R && j < d - col0) ? src[row * d + col0 + j] : Raw(0);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_rows(char* dst, const T* __restrict__ e, long long row0,
                                           int n, long long R, int d, int kD, int stride,
                                           bool vec, int col0 = 0) {
  stage_rows_by<T>(threadIdx.x, blockDim.x, dst, e, row0, n, R, d, kD, stride, vec, col0);
}

// Whether stage_scales copies by cp.async: scales 16-byte aligned.
__device__ __forceinline__ bool async_scales(const float* scales) {
  return (reinterpret_cast<uintptr_t>(scales) & 15) == 0;
}

// Scales [row0, row0 + n) of an int8 index into dst (zeros past R), by
// threads tid, tid + nth, ... (stage_scales: every thread of the block):
// cp.async in 16-byte chunks when `scales` is 16-byte aligned (row0 and n
// are multiples of 4 at every call), else plain loads. A no-op without
// scales.
__device__ __forceinline__ void stage_scales_by(int tid, int nth, float* dst,
                                                const float* __restrict__ scales,
                                                long long row0, int n, long long R) {
  if (scales == nullptr) return;
  if (async_scales(scales)) {
    for (int c = tid; c < n / 4; c += nth) {
      const long long row = row0 + 4 * c;
      const int bytes = row >= R ? 0 : (int)min(16LL, 4 * (R - row));
      cp_async16(dst + 4 * c, scales + (bytes ? row : 0), bytes);
    }
  } else {
    for (int i = tid; i < n; i += nth) dst[i] = row0 + i < R ? scales[row0 + i] : 0.f;
  }
}

__device__ __forceinline__ void stage_scales(float* dst, const float* __restrict__ scales,
                                             long long row0, int n, long long R) {
  stage_scales_by(threadIdx.x, blockDim.x, dst, scales, row0, n, R);
}

// Whether stage_rows may use cp.async for e [R, d].
template <typename T>
inline bool vec_rows(const void* e, int d) {
  return (reinterpret_cast<uintptr_t>(e) & 15) == 0 && (d * sizeof(T)) % 16 == 0;
}

template <typename T, typename Fn>
int dispatch_width(int d, Fn&& fn) {
  if (d <= 64) return fn.template operator()<T, 64, false>();
  if (d <= kChunk) return fn.template operator()<T, kChunk, false>();
  return fn.template operator()<T, kChunk, true>();  // 128-column chunks
}

// fn.template operator()<T, kD, kWide>() for the index type and row width:
// kD = 64 or 128 columns, kWide for rows of more than 128 (in chunks).
template <typename Fn>
int dispatch_index(int dtype, int d, Fn&& fn) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return dispatch_width<float>(d, fn);
    case kBF16:
      return dispatch_width<__nv_bfloat16>(d, fn);
    case kI8:
      return dispatch_width<int8_t>(d, fn);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace carca
