// K4: the maximum masked catalog score of every 128-row group, for Hopper
// (sm_90a). Stage 1 of the tournament top-k.
//
// Replaces two TPU kernels of carca_tpu/ops/retrieval_topk.py:
// _groupmax_kernel (B4, output [G, B], group-major, the flat tournament)
// and _groupmax_bq_kernel (B5, output [B, G] with G a multiple of 128,
// query-major, the recursive tournament). They were two kernels on the TPU
// because of Mosaic's (8, 128) block rules; on Hopper they differ only in
// the output's strides, so one kernel with a layout argument ports both.
// Plain version: carca_tpu_torch/ops/retrieval_topk.py::groupmax_plain.
//
// Contract: out[g, b] (layout 0) or out[b, g] (layout 1) = max over the
// rows r in [128 g, 128 g + 128) of score(q[b], e[r]), where rows r >= R,
// r >= lim0, and row 0 when mask_row0, score -inf; groups past the index
// (layout 1 pads G up to a multiple of 128) come out -inf. score() is
// scoring.cuh's, the arithmetic of K3 and of the tournament's rerank
// (stage 3 of ops/retrieval_topk.py::_tournament_topk): group maxima equal
// the rerank's scores bit for bit, which makes the containment argument of
// the tournament exact (the k + 8 best groups, ties to the lowest group,
// hold the true top-k), so the tournament returns K3's ids and values.
//
// Design. One block of 8 warps takes a tile of 256 rows (two groups) and
// QB = 8 * TQ queries. It stages the tile's rows in shared memory as float
// (read in 16-byte vectors; rows padded to an odd stride against bank
// conflicts) and the queries as the query operand (bf16-rounded against a
// bf16 or int8 index). Each warp owns TQ queries; lane l owns rows l + 32 i (i < 8), so rows 0..127
// of the tile (i < 4) form group 0 and the rest group 1. A thread keeps a
// TQ x 8 register tile of sums, reading per step 8 row values (conflict
// free) and TQ query values (broadcast). The int8 scale is applied after
// the sum, the mask after that; each thread takes the max of its 4 rows
// per group and a warp shuffle reduces the 32 lanes.
// What bounds it on the H100: CUDA-core arithmetic, which is the price of
// bit-exact agreement with the rerank and with K3. At 10M int8 rows and
// B = 256 it is 1.6e11 multiply-adds (3.3e11 operations): >= 0.33 ms at the
// bf16 tensor-core peak, ~5 ms at the float32 FMA peak that this kernel can
// use, while its ~0.64 GB of index moves in >= 0.19 ms. At B = 1 it is
// bound by bytes (~0.2 ms). Tensor cores (wgmma on bf16/int8 operands, the
// +8-group margin absorbing the other summation order) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "scoring.cuh"

namespace {

constexpr int kGroup = 128;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerLane = 8;
constexpr int kTileRows = 32 * kRowsPerLane;          // 256 rows
constexpr int kGroupsPerTile = kTileRows / kGroup;    // 2
constexpr int kLanesRowsPerGroup = kRowsPerLane / kGroupsPerTile;  // 4

int pick_tq(int B) { return B > 32 ? 8 : B > 16 ? 4 : B > 8 ? 2 : 1; }

size_t smem_bytes(int B, int d) {
  return sizeof(float) * ((size_t)kTileRows * (d | 1) + (size_t)kWarps * pick_tq(B) * d);
}

// es[rr * ld + j] = float(e[row0 + rr, j]) for the tile's rows, zeros past
// the index. Rows are contiguous in e, so the tile is one contiguous span:
// it is read in 16-byte vectors when it is aligned and a vector never
// straddles two rows, else element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(float* es, const T* __restrict__ e, int row0,
                                           int R, int d, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int n = max(0, min(kTileRows, R - row0)) * d;  // padded groups: none
  const T* src = e + (size_t)row0 * d;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && d % kVec == 0) {
    for (int v = threadIdx.x; v < n / kVec; v += kThreads) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[v];
      const T* x = reinterpret_cast<const T*>(&raw);
      const int rr = v * kVec / d, j0 = v * kVec - rr * d;
#pragma unroll
      for (int t = 0; t < kVec; ++t) es[rr * ld + j0 + t] = carca::widen<T>(x[t]);
    }
  } else {
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int rr = idx / d;
      es[rr * ld + idx - rr * d] = carca::widen<T>(src[idx]);
    }
  }
  for (int idx = n + threadIdx.x; idx < kTileRows * d; idx += kThreads) {
    const int rr = idx / d;
    es[rr * ld + idx - rr * d] = 0.f;
  }
}

template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
groupmax_kernel(const float* __restrict__ q, const T* __restrict__ e,
                const float* __restrict__ scales, float* __restrict__ out, int B, int R, int d,
                int lim0, int mask_row0, int n_groups, int layout) {
  extern __shared__ float smem[];
  const int ld = d | 1;
  float* es = smem;                     // [kTileRows][ld]
  float* qs = smem + kTileRows * ld;    // [kWarps * TQ][d]
  const int qb = kWarps * TQ;
  const int row0 = blockIdx.x * kTileRows;
  const int b0 = blockIdx.y * qb;

  for (int idx = threadIdx.x; idx < qb * d; idx += kThreads) {
    const int qi = idx / d;
    qs[idx] = (b0 + qi < B) ? carca::query_operand<T>(q[(size_t)(b0 + qi) * d + idx % d])
                            : 0.f;
  }
  stage_rows<T>(es, e, row0, R, d, ld);
  __syncthreads();  // the only barrier: warps without queries may leave below

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = warp * TQ;  // this warp's first query within the block
  if (b0 + qw >= B) return;

  float acc[TQ][kRowsPerLane];
#pragma unroll
  for (int a = 0; a < TQ; ++a)
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) acc[a][i] = 0.f;

#pragma unroll 2
  for (int j = 0; j < d; ++j) {
    float ev[kRowsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) ev[i] = es[(lane + 32 * i) * ld + j];
#pragma unroll
    for (int a = 0; a < TQ; ++a) {
      const float qv = qs[(qw + a) * d + j];
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) acc[a][i] = carca::add_term<T>(acc[a][i], qv, ev[i]);
    }
  }

  bool valid[kRowsPerLane];
  float scale[kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int row = row0 + lane + 32 * i;
    valid[i] = row < lim0 && !(row == 0 && mask_row0);  // the wrapper clamps lim0 <= R
    scale[i] = (scales != nullptr && row < R) ? scales[row] : 1.f;
  }
#pragma unroll
  for (int a = 0; a < TQ; ++a) {
    float m[kGroupsPerTile];
#pragma unroll
    for (int g = 0; g < kGroupsPerTile; ++g) {
      m[g] = -INFINITY;
#pragma unroll
      for (int i = g * kLanesRowsPerGroup; i < (g + 1) * kLanesRowsPerGroup; ++i) {
        float s = acc[a][i];
        if (scales != nullptr) s = __fmul_rn(s, scale[i]);
        m[g] = fmaxf(m[g], valid[i] ? s : -INFINITY);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m[g] = fmaxf(m[g], __shfl_xor_sync(0xffffffffu, m[g], off));
    }
    const int b = b0 + qw + a;
    if (lane == 0 && b < B) {
#pragma unroll
      for (int g = 0; g < kGroupsPerTile; ++g) {
        const int group = blockIdx.x * kGroupsPerTile + g;
        if (group < n_groups) {
          if (layout == 0) out[(size_t)group * B + b] = m[g];
          else out[(size_t)b * n_groups + group] = m[g];
        }
      }
    }
  }
}

template <typename T, int TQ>
int launch(const void* q, const void* e, const void* scales, void* out, int B, int R, int d,
           int lim0, int mask_row0, int n_groups, int layout, cudaStream_t st) {
  const size_t smem = smem_bytes(B, d);
  cudaError_t err = cudaFuncSetAttribute(
      groupmax_kernel<T, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_groups + kGroupsPerTile - 1) / kGroupsPerTile,
                  (B + kWarps * TQ - 1) / (kWarps * TQ));
  groupmax_kernel<T, TQ><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(e),
      static_cast<const float*>(scales), static_cast<float*>(out), B, R, d, lim0, mask_row0,
      n_groups, layout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tq(const void* q, const void* e, const void* scales, void* out, int B, int R,
              int d, int lim0, int mask_row0, int n_groups, int layout, cudaStream_t st) {
  switch (pick_tq(B)) {
    case 8: return launch<T, 8>(q, e, scales, out, B, R, d, lim0, mask_row0, n_groups, layout, st);
    case 4: return launch<T, 4>(q, e, scales, out, B, R, d, lim0, mask_row0, n_groups, layout, st);
    case 2: return launch<T, 2>(q, e, scales, out, B, R, d, lim0, mask_row0, n_groups, layout, st);
    default: return launch<T, 1>(q, e, scales, out, B, R, d, lim0, mask_row0, n_groups, layout, st);
  }
}

}  // namespace

extern "C" {

size_t carca_groupmax_smem_bytes(int B, int d) { return smem_bytes(B, d); }

// q [B, d] f32; e [R, d] of the type dtype names (carca::IndexType);
// scales [R] f32 for an int8 index, else null; out [n_groups, B] (layout
// 0) or [B, n_groups] (layout 1) f32, n_groups >= ceil(R / 128).
int carca_groupmax(const void* q, const void* e, const void* scales, void* out, int B, int R,
                   int d, int lim0, int mask_row0, int n_groups, int layout, int dtype,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case carca::kF32:
      return launch_tq<float>(q, e, nullptr, out, B, R, d, lim0, mask_row0, n_groups, layout, st);
    case carca::kBF16:
      return launch_tq<__nv_bfloat16>(q, e, nullptr, out, B, R, d, lim0, mask_row0, n_groups,
                                      layout, st);
    case carca::kI8:
      return launch_tq<int8_t>(q, e, scales, out, B, R, d, lim0, mask_row0, n_groups, layout, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
