// K4: the maximum masked catalog score of every 128-row group, and the
// tournament's rerank, for Hopper (sm_90a). Stages 1 and 3 of the
// tournament top-k (ops/retrieval_topk.py::_tournament_topk).
//
// K4 replaces two TPU kernels of carca_tpu/ops/retrieval_topk.py:
// _groupmax_kernel (B4, output [G, B], group-major, the flat tournament)
// and _groupmax_bq_kernel (B5, output [B, G] with G a multiple of 128,
// query-major, the recursive tournament). They were two kernels on the TPU
// because of Mosaic's (8, 128) block rules; on Hopper they differ only in
// the output's strides, so one kernel with a layout argument ports both.
// Plain version: ops/retrieval_topk.py::groupmax_plain.
//
// Contract: out[g, b] (layout 0) or out[b, g] (layout 1) = max over the
// rows r in [128 g, 128 g + 128) of score(q[b], e[r]), where rows r >= R,
// r >= lim0, and row 0 when mask_row0, score -inf; groups past the index
// (layout 1 pads G up to a multiple of 128) come out -inf. score() is
// scoring.cuh's arithmetic, which K3 and the rerank below also run: group
// maxima equal the rerank's scores bit for bit, so the tournament's
// containment argument is exact (the k + 8 best groups, ties to the lowest
// group, hold the true top-k) and the tournament returns K3's ids and
// values.
//
// Which kernel runs (groupmax_branch; ops/retrieval_topk.py::groupmax_branch
// is the same rule): bf16 and int8 rows of up to 128 columns take
// groupmax_wg_kernel, f32 rows groupmax_kernel, wider rows
// groupmax_wide_kernel.
//
// groupmax_wg_kernel (bf16 and int8, the 10M serving and eval indexes).
// What bounds it on the H100: at B = 256 the products, 2 B R d operations
// (0.331 ms at the bf16 tensor-core peak over 10M rows), and beside them
// one maximum per score (B R of them on the ALU pipe, half the FP32 rate)
// and, at int8, one scale multiply per score; at B = 1 the index's bytes
// (0.19 ms for 10M int8 rows). Its design, per block (one an SM):
//   * a producer warpgroup: its first warp keeps one tensor copy (TMA) of
//     each 128-row group in flight into a ring of up to 16 slots, the rows
//     as 64- or 128-byte swizzled boxes (zeros past R and d), the int8
//     scales by cp.async, each slot's arrival and release on mbarriers; it
//     gives its registers up (setmaxnreg) to
//   * two consumer warpgroups that take the groups in turn. The block's
//     queries (up to 256) are staged once per call in shared memory as
//     wgmma's B operand, in score_tile's column map, so the index is read
//     once per call for B <= 256 (more queries walk it once per 256). A
//     warpgroup loads a group's rows as A fragments (int8 widened once, by
//     load_a_slot, which reads the swizzle without bank conflicts) and frees
//     the slot, then runs the group's query chunks (8 queries for B <= 8,
//     else 64; two 64-row tiles a chunk: m64nNQk16 k-steps ascending from
//     the first product, which the probe test holds bit-equal to
//     score_tile's mma.sync) pipelined over two accumulators: chunk c + 1's products are
//     issued before chunk c's epilogue. The chunk loop is unrolled (a
//     runtime loop or a branch around a product makes ptxas serialize every
//     wgmma). The epilogue finishes each score (the int8 scale, then the
//     mask, as finish()), keeps the maximum of a lane's four rows, and meets
//     the warpgroup's other 124 rows through shared memory (a transpose, one
//     barrier a chunk), and writes the chunk's maxima.
// PERF.md holds its times: at B = 256 the warpgroups' own instruction
// streams (the maxima, the row loads, the meetings), not the tensor cores,
// hold it above its bound.
//
// groupmax_kernel (f32 rows, 3xTF32): a persistent block of 8 warps walks
// stages of 128 rows copied by cp.async into a ring of two buffers; the
// queries (up to 128) sit in shared memory as mma.sync's N fragments; a
// warp loads its rows' A fragments once per stage and loops over the n8
// query tiles (mma.sync, the mask, a running maximum, a shuffle maximum over
// the 8 row lanes); the warps of a group meet in shared memory. Both
// layouts share each kernel; layout 1's stores are scattered.
//
// The rerank (carca_tournament_rerank) is stage 3: for each query b its kg
// winner groups gi[b, :] (ascending), scores [B, kg * 128] of the groups'
// rows against q[b], masked as K4 masks. It has no TPU kernel: the JAX
// package scores the winners with an einsum outside any Pallas kernel
// (carca_tpu/ops/retrieval_topk.py:497, score_slice). A winner group is 128
// contiguous index rows, so a block (8 warps, one query, 8 winner groups)
// copies each group by cp.async into a two-buffer ring and scores it with
// the same routine, the query in every column of the n8 tile. It is bound
// by the winner rows' bytes (B kg 128 d bytes at int8). Plain version:
// ops/retrieval_topk.py::tournament_rerank_plain.
//
// Rows wider than 128 columns are scored in 128-column chunks (scoring.cuh,
// score_acc: the k-steps stay ascending across the chunks, so the three
// kernels still agree bit for bit). K4 then runs groupmax_wide_kernel: one
// 128-row group per step, its chunks staged one after another, and the
// queries in chunks of kWideQC whose partial sums stay in registers; every
// query chunk restages the group. The rerank stages a winner group's chunks
// one after another. These wide paths keep no copy in flight.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "mbarrier.cuh"
#include "scoring.cuh"
#include "wgmma.cuh"

namespace {

using carca::AFrag;
using carca::QFrag;

constexpr int kGroup = 128;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRerankSlots = 8;  // winner groups per rerank block
constexpr int kWideQC = 32;      // queries per step of groupmax_wide_kernel

// groupmax_kernel (f32 rows): a 16-row tile per warp and stage, queries
// staged at once, stage buffers in flight
constexpr int kStageRows = kWarps * 16;
constexpr int kQC = 128;
constexpr int kRing = 2;

// a stage in shared memory: its rows, then their scales
template <typename T, int kD>
__host__ __device__ constexpr int stage_bytes(int rows) {
  return rows * (carca::row_stride_bytes<T>(kD) + 4);
}

template <typename T, int kD>
__host__ __device__ constexpr size_t groupmax_smem() {
  return kRing * (size_t)stage_bytes<T, kD>(kStageRows) +
         // four lanes hold each query's fragment of a k-step
         sizeof(QFrag<T>) * 4 * (size_t)kQC * (kD / carca::kStep<T>) +
         sizeof(float) * (size_t)kWarps * kQC;
}

template <typename T, int kD>
__host__ __device__ constexpr size_t rerank_smem() {
  return 2 * (size_t)stage_bytes<T, kD>(kGroup);
}

template <typename T>
__host__ __device__ constexpr size_t groupmax_wide_smem() {
  return (size_t)stage_bytes<T, carca::kChunk>(kGroup) + sizeof(float) * kWarps * kWideQC;
}

// The maxima over this warp's rows of the finished scores against one n8
// query tile: m0 for query 2t, m1 for query 2t + 1 (lane (g, t)); without
// kMasked every row is known to score.
template <typename T, int KS, int MT, bool kMasked>
__device__ __forceinline__ void tile_maxima(float& m0, float& m1, const AFrag<T> (&af)[MT][KS],
                                            const QFrag<T> (&bq)[KS], const float (&sg)[MT],
                                            const float (&sg8)[MT], const bool (&vg)[MT],
                                            const bool (&vg8)[MT]) {
  m0 = m1 = -INFINITY;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float c[4];
    carca::score_tile<T, KS>(c, af[mt], bq);
    const bool v = !kMasked || vg[mt], v8 = !kMasked || vg8[mt];
    m0 = fmaxf(m0, fmaxf(carca::finish<T>(c[0], sg[mt], v), carca::finish<T>(c[2], sg8[mt], v8)));
    m1 = fmaxf(m1, fmaxf(carca::finish<T>(c[1], sg[mt], v), carca::finish<T>(c[3], sg8[mt], v8)));
  }
}

struct GroupmaxArgs {
  const float* q;
  const void* e;
  const float* scales;
  float* out;
  int B, R, d, lim0, mask_row0, n_groups, layout, vec;
};

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
groupmax_kernel(const GroupmaxArgs a) {
  constexpr int KS = kD / carca::kStep<T>;
  static_assert(carca::kIsF32<T>, "bf16 and int8 rows take groupmax_wg_kernel");
  constexpr int MT = 1;
  constexpr int SR = kStageRows;
  constexpr int QC = kQC;
  constexpr int NT = QC / 8;
  constexpr int GPS = SR / kGroup;            // groups per stage
  constexpr int WPG = kWarps / GPS;           // warps per group
  constexpr int stride = carca::row_stride_bytes<T>(kD);
  extern __shared__ float4 smem4[];
  constexpr int NR = kRing;
  constexpr int SB = stage_bytes<T, kD>(SR);
  char* ring = reinterpret_cast<char*>(smem4);                 // [NR][SR rows, SR scales]
  QFrag<T>* qf = reinterpret_cast<QFrag<T>*>(ring + NR * SB);  // [NT][KS][32]
  float* part = reinterpret_cast<float*>(qf + NT * KS * 32);         // [kWarps][QC]

  const T* e = static_cast<const T*>(a.e);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const long long n_stages = ((long long)a.n_groups * kGroup + SR - 1) / SR;
  const int n_qc = (a.B + QC - 1) / QC;

  auto stage_queries = [&](int qc) {
    for (int idx = threadIdx.x; idx < NT * KS * 32; idx += kThreads) {
      const int j = idx / (KS * 32), s = (idx / 32) % KS, ln = idx % 32;
      const int b = qc * QC + 8 * j + ln / 4;
      qf[idx] = carca::query_frag<T>(b < a.B ? a.q + (size_t)b * a.d : nullptr, a.d, s, ln % 4);
    }
  };
  auto stage = [&](long long st, int buf) {
    carca::stage_rows<T>(ring + buf * SB, e, st * SR, SR, a.R, a.d, kD, stride, a.vec);
    carca::stage_scales(reinterpret_cast<float*>(ring + buf * SB + SR * stride), a.scales,
                        st * SR, SR, a.R);
  };

  if (n_qc == 1) stage_queries(0);
  // stage i of this block is blockIdx.x + i * gridDim.x, in buffer i % NR
#pragma unroll
  for (int i = 0; i < NR - 1; ++i) {
    const long long st = blockIdx.x + (long long)i * gridDim.x;
    if (st < n_stages) stage(st, i);
    carca::cp_async_commit();
  }
  long long st = blockIdx.x;
  for (int i = 0; st < n_stages; st += gridDim.x, ++i) {
    const long long ahead = st + (long long)(NR - 1) * gridDim.x;
    if (ahead < n_stages) stage(ahead, (i + NR - 1) % NR);
    carca::cp_async_commit();
    carca::cp_async_wait<NR - 1>();
    __syncthreads();
    const char* buf = ring + (i % NR) * SB;
    const float* scl = reinterpret_cast<const float*>(buf + SR * stride);

    // this warp's rows: A fragments, validity and scales, once per stage
    const int wrow = warp * 16 * MT;
    AFrag<T> af[MT][KS];
    bool vg[MT], vg8[MT];
    float sg[MT], sg8[MT];
    bool all_valid = true;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      carca::load_a<T, KS>(af[mt], buf + (wrow + 16 * mt + g) * stride, stride, t);
      const long long r = st * SR + wrow + 16 * mt + g;
      vg[mt] = carca::row_valid((int)min(r, (long long)a.R), a.lim0, a.mask_row0);
      vg8[mt] = carca::row_valid((int)min(r + 8, (long long)a.R), a.lim0, a.mask_row0);
      sg[mt] = a.scales != nullptr ? scl[wrow + 16 * mt + g] : 1.f;
      sg8[mt] = a.scales != nullptr ? scl[wrow + 16 * mt + g + 8] : 1.f;
      all_valid = all_valid && vg[mt] && vg8[mt];
    }
    all_valid = __all_sync(0xffffffffu, all_valid);

    for (int qc = 0; qc < n_qc; ++qc) {
      if (n_qc > 1) {
        stage_queries(qc);
        __syncthreads();
      }
      const int qn = min(QC, a.B - qc * QC);  // queries in this chunk
      const int nt = (qn + 7) / 8;
      // two query tiles at a time: independent mma chains and shuffles
      for (int j = 0; j < nt; j += 2) {
        const int j2 = min(j + 1, nt - 1);
        QFrag<T> bq[KS], bq2[KS];
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          bq[s] = qf[(j * KS + s) * 32 + lane];
          bq2[s] = qf[(j2 * KS + s) * 32 + lane];
        }
        float m[4];
        if (all_valid) {
          tile_maxima<T, KS, MT, false>(m[0], m[1], af, bq, sg, sg8, vg, vg8);
          tile_maxima<T, KS, MT, false>(m[2], m[3], af, bq2, sg, sg8, vg, vg8);
        } else {
          tile_maxima<T, KS, MT, true>(m[0], m[1], af, bq, sg, sg8, vg, vg8);
          tile_maxima<T, KS, MT, true>(m[2], m[3], af, bq2, sg, sg8, vg, vg8);
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
#pragma unroll
          for (int u = 0; u < 4; ++u) m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], off));
        if (g == 0) {
          part[warp * QC + 8 * j + 2 * t] = m[0];
          part[warp * QC + 8 * j + 2 * t + 1] = m[1];
          part[warp * QC + 8 * j2 + 2 * t] = m[2];
          part[warp * QC + 8 * j2 + 2 * t + 1] = m[3];
        }
      }
      __syncthreads();
      // the warps of each group meet; layout 0 stores run along b, layout 1
      // along the stage's groups
      for (int idx = threadIdx.x; idx < GPS * qn; idx += kThreads) {
        const int gi = a.layout == 0 ? idx / qn : idx % GPS;
        const int bq = a.layout == 0 ? idx % qn : idx / GPS;
        float m = -INFINITY;
#pragma unroll
        for (int w = gi * WPG; w < (gi + 1) * WPG; ++w) m = fmaxf(m, part[w * QC + bq]);
        const long long group = st * GPS + gi;
        const int b = qc * QC + bq;
        if (group < a.n_groups) {
          if (a.layout == 0) a.out[group * a.B + b] = m;
          else a.out[(size_t)b * a.n_groups + group] = m;
        }
      }
      __syncthreads();  // part, qf and this stage's buffer are free again
    }
  }
}

// K4 over rows of more than 128 columns (the file's header).
template <typename T>
__global__ void __launch_bounds__(kThreads) groupmax_wide_kernel(const GroupmaxArgs a) {
  constexpr int kD = carca::kChunk;
  constexpr int KS = kD / carca::kStep<T>;
  constexpr int NT = kWideQC / 8;
  constexpr int stride = carca::row_stride_bytes<T>(kD);
  extern __shared__ float4 smem4[];
  char* buf = reinterpret_cast<char*>(smem4);                      // kGroup rows, their scales
  float* scl = reinterpret_cast<float*>(buf + kGroup * stride);
  float* part = reinterpret_cast<float*>(buf + stage_bytes<T, kD>(kGroup));  // [kWarps][kWideQC]
  const T* e = static_cast<const T*>(a.e);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nch = carca::score_chunks(a.d);
  const int n_qc = (a.B + kWideQC - 1) / kWideQC;
  for (long long grp = blockIdx.x; grp < a.n_groups; grp += gridDim.x) {
    const long long r = grp * kGroup + 16 * warp + g;
    const bool v = carca::row_valid((int)min(r, (long long)a.R), a.lim0, a.mask_row0);
    const bool v8 = carca::row_valid((int)min(r + 8, (long long)a.R), a.lim0, a.mask_row0);
    for (int qc = 0; qc < n_qc; ++qc) {
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int ch = 0; ch < nch; ++ch) {
        carca::stage_rows<T>(buf, e, grp * kGroup, kGroup, a.R, a.d, kD, stride, a.vec, ch * kD);
        if (qc == 0 && ch == 0) carca::stage_scales(scl, a.scales, grp * kGroup, kGroup, a.R);
        carca::cp_async_commit();
        carca::cp_async_wait<0>();
        __syncthreads();  // the chunk is in
        AFrag<T> af[KS];
        carca::load_a<T, KS>(af, buf + (16 * warp + g) * stride, stride, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int b = qc * kWideQC + 8 * j + g;
          QFrag<T> bq[KS];
          carca::chunk_query_frags<T, KS>(bq, b < a.B ? a.q + (size_t)b * a.d : nullptr, a.d, ch,
                                          t);
          carca::score_acc<T, KS>(acc[j], af, bq);
        }
        __syncthreads();  // the buffer is free for the next chunk
      }
      const float sc = a.scales != nullptr ? scl[16 * warp + g] : 1.f;
      const float sc8 = a.scales != nullptr ? scl[16 * warp + g + 8] : 1.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float m0 = fmaxf(carca::finish<T>(acc[j][0], sc, v), carca::finish<T>(acc[j][2], sc8, v8));
        float m1 = fmaxf(carca::finish<T>(acc[j][1], sc, v), carca::finish<T>(acc[j][3], sc8, v8));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        if (g == 0) {
          part[warp * kWideQC + 8 * j + 2 * t] = m0;
          part[warp * kWideQC + 8 * j + 2 * t + 1] = m1;
        }
      }
      __syncthreads();
      const int qn = min(kWideQC, a.B - qc * kWideQC);
      for (int bq = threadIdx.x; bq < qn; bq += kThreads) {
        float m = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, part[w * kWideQC + bq]);
        const int b = qc * kWideQC + bq;
        if (a.layout == 0) a.out[grp * a.B + b] = m;
        else a.out[(size_t)b * a.n_groups + grp] = m;
      }
      __syncthreads();  // part and the scales are free again
    }
  }
}

// ---------------------------------------------------------------------------
// K4 on warpgroup products: bf16 and int8 rows of up to 128 columns
// ---------------------------------------------------------------------------

constexpr int kWgConsumers = 2;                          // consumer warpgroups of a block
constexpr int kWgThreads = 128 * (kWgConsumers + 1);     // and a producer warpgroup (the last)
constexpr int kWgProducerRegs = 40;                      // registers a thread after setmaxnreg
constexpr int kWgConsumerRegs = 232;                     // (65,536 / 384 = 168 at launch)
constexpr int kWgQueries = 256;                          // queries staged at once
constexpr int kWgMaxSlots = 16;                          // ring slots, at most
constexpr int kWgMaxNQ = 64;                             // queries a product, at most
constexpr size_t kSmemLimit = 232448;                    // dynamic shared memory of a block

// Physical column of k slot j of a 16-column k-step: score_tile's map
// (scoring.cuh), which load_a gives the rows' A fragments.
__device__ __forceinline__ int slot_col(int j) {
  return (j & 7) / 2 * 4 + (j & 1) + (j >= 8 ? 2 : 0);
}

// Queries [b0, b0 + kWgQueries) of q [B, d] into qs as wgmma's B operand:
// [kWgQueries / 8][kD / 8] core matrices of 8 queries x 8 k slots (16
// bytes, 128 a matrix), query n's k-step s in slots 16 s .. 16 s + 15 in
// score_tile's column map, rounded to bf16 (nearest even, as query_frag),
// zeros past d and past B. Threads tid, tid + nth, ...
template <int kD>
__device__ void stage_query_tiles(uint8_t* qs, const float* __restrict__ q, int B, int d, int b0,
                                  int tid, int nth) {
  constexpr int kKG = kD / 8;
  for (int idx = tid; idx < kWgQueries * kKG; idx += nth) {
    const int n = idx / (8 * kKG) * 8 + idx % 8, kg = idx / 8 % kKG;
    const float* row = b0 + n < B ? q + (size_t)(b0 + n) * d : nullptr;
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int col = kg / 2 * 16 + slot_col((kg & 1) * 8 + u);
      x[u] = row != nullptr && col < d ? __ldg(row + col) : 0.f;
    }
    *reinterpret_cast<uint4*>(qs + (size_t)idx * 16) =
        make_uint4(carca::pack_bf16(x[0], x[1]), carca::pack_bf16(x[2], x[3]),
                   carca::pack_bf16(x[4], x[5]), carca::pack_bf16(x[6], x[7]));
  }
}

// acc (NQ / 2 a lane, m64nNQ's layout) = the warpgroup's 64 rows (A: af,
// KS k-steps) against the NQ queries whose core matrices start at
// descriptor dq, k-steps ascending: score_tile's instruction sequence,
// widened to 64 rows x NQ queries, from the k-step 0 product (scale-d =
// 0). The caller fences, commits and waits.
template <int NQ, int KS>
__device__ __forceinline__ void tile_products(float* acc, const carca::ABf16 (&af)[KS],
                                              uint64_t dq) {
#pragma unroll
  for (int s = 0; s < KS; ++s)  // a k16 step spans two core matrices: 256 bytes
    carca::wg::Mma<NQ, true>::run(acc, af[s].x, dq + s * 16, s > 0);
}

// A slot's rows as the tensor copy leaves them: one box of the group's 128
// rows by kBoxBytes (64 or 128: int8 64 columns, or 128 bytes of columns),
// two at bf16 with 128 columns, each row's 16-byte chunks swizzled (64B:
// chunk ^ (r >> 1) % 4, 128B: chunk ^ r % 8, the tensor map's swizzle), so
// the A-fragment loads of 8 rows at one chunk meet distinct banks.
template <typename T, int kD>
struct SlotRows {
  static constexpr int kRowBytes = kD * (int)sizeof(T);
  static constexpr int kBoxBytes = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kBoxes = kRowBytes / kBoxBytes;
  static constexpr int kBoxCols = kBoxBytes / (int)sizeof(T);
  static constexpr int kBytes = kGroup * kRowBytes;  // a multiple of 1024
  // where byte b of row r (0 to 127) of the group lies in the slot
  static __device__ __forceinline__ int offset(int r, int b) {
    const int box = b / kBoxBytes, bb = b % kBoxBytes;
    const int swz = kBoxBytes == 64 ? (r >> 1) & 3 : r & 7;
    return box * kGroup * kBoxBytes + r * kBoxBytes + (((bb >> 4) ^ swz) << 4) + (bb & 15);
  }
};

// The A fragments of rows r and r + 8 of a slot (0 <= r < 120), as load_a
// gives them from a row-major tile: the same values in the same fragment
// registers (int8 widened to bf16 here, once per row tile).
template <typename T, int kD, int KS>
__device__ __forceinline__ void load_a_slot(carca::ABf16 (&a)[KS], const uint8_t* rows, int r,
                                            int t) {
  using S = SlotRows<T, kD>;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if constexpr (sizeof(T) == 1) {
      const int b = 16 * s + 4 * t;
      const uint32_t u = *reinterpret_cast<const uint32_t*>(rows + S::offset(r, b));
      const uint32_t v = *reinterpret_cast<const uint32_t*>(rows + S::offset(r + 8, b));
      a[s].x[0] = carca::pack_i8_pair(u, 0);
      a[s].x[1] = carca::pack_i8_pair(v, 0);
      a[s].x[2] = carca::pack_i8_pair(u, 16);
      a[s].x[3] = carca::pack_i8_pair(v, 16);
    } else {
      const int b = 2 * (16 * s + 4 * t);
      const uint2 u = *reinterpret_cast<const uint2*>(rows + S::offset(r, b));
      const uint2 v = *reinterpret_cast<const uint2*>(rows + S::offset(r + 8, b));
      a[s].x[0] = u.x;
      a[s].x[1] = v.x;
      a[s].x[2] = u.y;
      a[s].x[3] = v.y;
    }
  }
}

// A chunk's maxima on their way across the warpgroup's rows: per query
// column, one entry for each (warp, g) of its 32, at a stride that puts a
// warp's 32 stores of one k (8 g by 4 t) in 32 banks.
constexpr int kRedStride = 36;

// Shared memory past the 1024-byte alignment of the row slots: the
// staged queries, each consumer warpgroup's two buffers of chunk maxima.
template <int kD>
__host__ __device__ constexpr size_t wg_fixed_bytes() {
  return 1024 + (size_t)kWgQueries * kD * 2 +
         sizeof(float) * kWgConsumers * 2 * kWgMaxNQ * kRedStride;
}

// a slot: its rows, their scales, two mbarriers
template <typename T, int kD>
__host__ __device__ constexpr size_t wg_slot_bytes() {
  return (size_t)SlotRows<T, kD>::kBytes + 4 * kGroup + 16;
}

// ring slots: as many as fit, a multiple of kWgConsumers (slot s is always
// warpgroup s % kWgConsumers'), at most kWgMaxSlots
template <typename T, int kD>
__host__ __device__ constexpr int wg_slots() {
  const size_t fit =
      (kSmemLimit - wg_fixed_bytes<kD>()) / wg_slot_bytes<T, kD>() / kWgConsumers * kWgConsumers;
  return fit < (size_t)kWgMaxSlots ? (int)fit : kWgMaxSlots;
}

template <typename T, int kD>
__host__ __device__ constexpr size_t groupmax_wg_smem() {
  return wg_fixed_bytes<kD>() + (size_t)wg_slots<T, kD>() * wg_slot_bytes<T, kD>();
}

// The maxima of the lane's four rows (g, g + 8 of both tiles) for each of
// its NQ / 4 query columns: v[2n + u] is column 8n + 2t + u. Without
// kMasked every row is known to score.
template <typename T, int NQ, bool kMasked>
__device__ __forceinline__ void fold_rows(float (&v)[NQ / 4], const float (&acc)[2][NQ / 2],
                                          const float (&sc)[2][2], const bool (&ok)[2][2]) {
#pragma unroll
  for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float m = carca::finish<T>(acc[0][4 * n + u], sc[0][0], !kMasked || ok[0][0]);
      m = fmaxf(m, carca::finish<T>(acc[0][4 * n + 2 + u], sc[0][1], !kMasked || ok[0][1]));
      m = fmaxf(m, carca::finish<T>(acc[1][4 * n + u], sc[1][0], !kMasked || ok[1][0]));
      m = fmaxf(m, carca::finish<T>(acc[1][4 * n + 2 + u], sc[1][1], !kMasked || ok[1][1]));
      v[2 * n + u] = m;
    }
}

// K4 for bf16 and int8 rows of up to kD = 64 or 128 columns (the file's
// header), NQ queries a product (8 or kWgMaxNQ), kChunks products a group
// and query set (kChunks NQ <= kWgQueries).
template <typename T, int kD, int NQ, int kChunks>
__global__ void __launch_bounds__(kWgThreads, 1)
    groupmax_wg_kernel(const GroupmaxArgs a, const __grid_constant__ CUtensorMap rows_map) {
  using S = SlotRows<T, kD>;
  constexpr int KS = kD / 16;
  constexpr int NS = wg_slots<T, kD>();
  constexpr uint32_t kSbo = kD / 8 * 128;  // bytes between 8-query core-matrix groups
  constexpr int J = NQ / 4;                // a lane's query columns
  constexpr int kTPC = 128 / NQ;           // threads that reduce a column's 32 entries
  constexpr int kPer = 32 / kTPC;          // ... each this many
  static_assert(NS >= kWgConsumers && NQ <= kWgMaxNQ && kChunks * NQ <= kWgQueries,
                "K4's ring or chunks");
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* ring = smem + ((1024 - (carca::smem_addr(smem) & 1023)) & 1023);  // [NS][S::kBytes]
  uint8_t* qs = ring + (size_t)NS * S::kBytes;                               // the queries
  float* scl_ring = reinterpret_cast<float*>(qs + (size_t)kWgQueries * kD * 2);  // [NS][128]
  float* red = scl_ring + NS * kGroup;  // [kWgConsumers][2][kWgMaxNQ][kRedStride]
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      red + kWgConsumers * 2 * kWgMaxNQ * kRedStride);     // [NS]: a slot's rows are in
  unsigned long long* empty = full + NS;                   // [NS]: its warpgroup read them

  const T* e = static_cast<const T*>(a.e);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n_mine =
      a.n_groups > (int)blockIdx.x ? (a.n_groups - 1 - (long long)blockIdx.x) / gridDim.x + 1 : 0;
  const int n_sc = (a.B + kWgQueries - 1) / kWgQueries;  // query sets: each walks the index
  const long long items = n_mine * n_sc;                  // (query set, group) in that order

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      carca::mbar_init(full + s, 33);  // the tensor copy's lane, each lane's scales
      carca::mbar_init(empty + s, 4);  // each warp of the slot's warpgroup
    }
    carca::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kWgConsumers) {
    // the producer warpgroup gives registers up; its first warp copies item
    // i's rows (one tensor copy a box, zeros past R and d) and scales
    // (cp.async) into slot i % NS
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (warp > 4 * kWgConsumers) return;
    const bool scales16 = a.scales != nullptr && carca::async_scales(a.scales);
    for (long long i = 0; i < items; ++i) {
      const int slot = (int)(i % NS);
      if (i >= NS) carca::mbar_wait(empty + slot, (int)((i / NS - 1) & 1));
      const long long row0 = (blockIdx.x + (i % n_mine) * gridDim.x) * (long long)kGroup;
      const int rows = (int)max(0LL, min((long long)kGroup, (long long)a.R - row0));
      uint8_t* buf = ring + (size_t)slot * S::kBytes;
      if (a.vec) {
        if (lane == 0) {
          carca::mbar_arrive_expect_tx(full + slot, (uint32_t)S::kBytes);
#pragma unroll
          for (int box = 0; box < S::kBoxes; ++box)
            carca::tma_load_2d(buf + box * kGroup * S::kBoxBytes, &rows_map, box * S::kBoxCols,
                               (int)row0, full + slot);
        }
      } else {  // unaligned or ragged rows: plain copies, zeros past d and R
        using Raw = typename std::conditional<sizeof(T) == 1, uint8_t, uint16_t>::type;
        const Raw* src = reinterpret_cast<const Raw*>(e);
        for (int idx = lane; idx < kGroup * kD; idx += 32) {
          const int r = idx / kD, j = idx % kD;
          *reinterpret_cast<Raw*>(buf + S::offset(r, j * (int)sizeof(T))) =
              r < rows && j < a.d ? src[(row0 + r) * a.d + j] : Raw(0);
        }
        __syncwarp();
        if (lane == 0) carca::mbar_arrive_expect_tx(full + slot, 0u);
      }
      if (a.scales != nullptr) {
        float* dst = scl_ring + slot * kGroup;
        if (scales16) {
          const int n = min(4, max(0, rows - 4 * lane));
          carca::cp_async16(dst + 4 * lane, a.scales + (n ? row0 + 4 * lane : 0), 4 * n);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = 4 * lane + u;
            carca::cp_async4(dst + r, a.scales + (r < rows ? row0 + r : 0), r < rows ? 4 : 0);
          }
        }
      }
      carca::mbar_arrive_cp_async(full + slot);
    }
    carca::cp_async_wait<0>();
    return;
  }

  // a consumer warpgroup: wg takes items wg, wg + kWgConsumers, ... (their
  // groups), each in kChunks chunks of NQ queries. Warp wl holds rows 16 wl
  // .. 16 wl + 15 of both 64-row tiles of a group. Within an item the
  // chunks are pipelined: chunk c + 1's products are issued into the other
  // accumulator before chunk c's epilogue. The chunk loop is unrolled, so
  // ptxas sees which accumulator each wgmma and each read touches (a runtime
  // loop or a branch around a product serializes them all: C7514, C7518);
  // an item ends with no product in flight.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4;
  const int tw = threadIdx.x % 128;
  const uint64_t dq0 = carca::wg::desc(qs, 128, kSbo);
  int pb = 0;  // which of the warp's two part buffers
  struct Rows {
    carca::ABf16 af[2][KS];
    float sc[2][2];
    bool ok[2][2], all_valid;
    long long grp;
  };
  Rows cur;
  // item i's slot: its rows' A fragments (int8 widened once), scales and
  // validity into cur; then the slot is free
  auto begin_item = [&](long long i) {
    const int slot = (int)(i % NS);
    carca::mbar_wait(full + slot, (int)((i / NS) & 1));
    const uint8_t* buf = ring + (size_t)slot * S::kBytes;
    const float* scl = scl_ring + slot * kGroup;
    cur.grp = blockIdx.x + (i % n_mine) * gridDim.x;
    bool all = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int local = 64 * h + 16 * wl + g;
      load_a_slot<T, kD, KS>(cur.af[h], buf, local, t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long row = cur.grp * kGroup + local + 8 * e;
        cur.ok[h][e] = carca::row_valid((int)min(row, (long long)a.R), a.lim0, a.mask_row0);
        cur.sc[h][e] = a.scales != nullptr ? scl[local + 8 * e] : 1.f;
        all = all && cur.ok[h][e];
      }
    }
    __syncwarp();
    if (lane == 0) carca::mbar_arrive(empty + slot);
    cur.all_valid = __all_sync(0xffffffffu, all);
  };
  // chunk c's products of the item's rows into acc, committed as one group
  auto issue = [&](float (&acc)[2][NQ / 2], int c) {
    uint64_t dq = dq0 + (uint64_t)(c * (NQ / 8) * kSbo >> 4);
    carca::wg::opaque(dq);
    carca::wg::fence();
    tile_products<NQ, KS>(acc[0], cur.af[0], dq);
    tile_products<NQ, KS>(acc[1], cur.af[1], dq);
    carca::wg::commit();
  };
  // the finished scores' maxima over the lane's four rows, then over the
  // warpgroup's 128 through red (a transpose: no shuffle rounds, no
  // selects); chunk c of query set sc written. After the wait that retires
  // acc's products: no register of acc or of the A fragments is reused
  // before it.
  auto epilogue = [&](float (&acc)[2][NQ / 2], int sc, int c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < NQ / 2; ++e) carca::wg::hold(acc[h][e]);
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) carca::wg::hold(cur.af[h][s].x[e]);
    }
    float v[J];  // v[2n + u]: query column 8n + 2t + u
    if (cur.all_valid) fold_rows<T, NQ, false>(v, acc, cur.sc, cur.ok);
    else fold_rows<T, NQ, true>(v, acc, cur.sc, cur.ok);
    float* my = red + (wg * 2 + pb) * kWgMaxNQ * kRedStride;
#pragma unroll
    for (int k = 0; k < J; ++k)
      my[(8 * (k / 2) + 2 * t + k % 2) * kRedStride + 8 * wl + g] = v[k];
    carca::named_barrier(2 + wg, 128);
    // thread tw: column tw / kTPC, entries kPer (tw % kTPC) onwards
    const float* col = my + (tw / kTPC) * kRedStride + kPer * (tw % kTPC);
    float m;
    if constexpr (kPer >= 4) {
      m = -INFINITY;
#pragma unroll
      for (int k = 0; k < kPer / 4; ++k) {
        const float4 x = reinterpret_cast<const float4*>(col)[k];
        m = fmaxf(m, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
      }
    } else {
      const float2 x = *reinterpret_cast<const float2*>(col);
      m = fmaxf(x.x, x.y);
    }
#pragma unroll
    for (int off = 1; off < kTPC; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const int b = sc * kWgQueries + c * NQ + tw / kTPC;
    if (tw % kTPC == 0 && b < a.B) {
      if (a.layout == 0) a.out[cur.grp * a.B + b] = m;
      else a.out[(size_t)b * a.n_groups + cur.grp] = m;
    }
    pb ^= 1;  // the other buffer next: the barrier above orders its reuse
  };

  float acc[2][2][NQ / 2];
  for (int sc = 0; sc < n_sc; ++sc) {
    carca::named_barrier(1, 4 * 32 * kWgConsumers);  // the last set's products are done
    stage_query_tiles<kD>(qs, a.q, a.B, a.d, sc * kWgQueries, threadIdx.x, 4 * 32 * kWgConsumers);
    carca::wg::fence_smem();
    carca::named_barrier(1, 4 * 32 * kWgConsumers);
    const long long first = sc * n_mine;
    for (long long i = first + (wg - first % kWgConsumers + kWgConsumers) % kWgConsumers;
         i < first + n_mine; i += kWgConsumers) {
      begin_item(i);
      issue(acc[0], 0);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c + 1 < kChunks) {
          issue(acc[(c + 1) % 2], c + 1);
          carca::wg::wait<1>();  // chunk c's products are in
        } else {
          carca::wg::wait<0>();
        }
        epilogue(acc[c % 2], sc, c);
      }
    }
  }
}

// The probe of the scoring routine's two instruction sequences: one 64-row
// tile e [64, d] (bf16 or int8) against B <= 256 queries, by score_tile
// (mma.sync, out_mma) and by K4's warpgroup products (out_wg), both
// [B, 64] raw sums (before the int8 scale). One warpgroup; zero_acc: the
// warpgroup products start from a zeroed accumulator instead of from the
// first product (scale-d = 0).
template <typename T, int kD, bool kZero>
__global__ void __launch_bounds__(128) probe_kernel(const float* q, const void* e, float* out_mma,
                                                    float* out_wg, int B, int d) {
  constexpr int KS = kD / 16;
  constexpr int stride = carca::row_stride_bytes<T>(kD);
  constexpr uint32_t kSbo = kD / 8 * 128;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* qs = smem;
  uint8_t* rows = qs + (size_t)kWgQueries * kD * 2;
  stage_query_tiles<kD>(qs, q, B, d, 0, threadIdx.x, 128);
  using Raw = typename std::conditional<sizeof(T) == 1, uint8_t, uint16_t>::type;
  for (int idx = threadIdx.x; idx < 64 * kD; idx += 128) {
    const int r = idx / kD, j = idx % kD;
    reinterpret_cast<Raw*>(rows + r * stride)[j] =
        j < d ? reinterpret_cast<const Raw*>(e)[r * d + j] : Raw(0);
  }
  carca::wg::fence_smem();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  carca::ABf16 af[KS];
  carca::load_a<T, KS>(af, reinterpret_cast<const char*>(rows) + (16 * warp + g) * stride, stride,
                       t);
  for (int j = 0; j < kWgQueries / 8; ++j) {
    QFrag<T> bq[KS];
    const int b = 8 * j + g;
#pragma unroll
    for (int s = 0; s < KS; ++s) bq[s] = carca::query_frag<T>(b < B ? q + (size_t)b * d : nullptr, d, s, t);
    float c[4];
    carca::score_tile<T, KS>(c, af, bq);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int bb = 8 * j + 2 * t + (x & 1);
      if (bb < B) out_mma[bb * 64 + 16 * warp + g + 8 * (x >> 1)] = c[x];
    }
  }
  const uint64_t dq0 = carca::wg::desc(qs, 128, kSbo);
  for (int ch = 0; ch < kWgQueries / 128; ++ch) {
    float acc[64];
    uint64_t dq = dq0 + (uint64_t)(ch * 16 * kSbo >> 4);
    carca::wg::opaque(dq);
    carca::wg::fence();
    if constexpr (kZero) {
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) carca::wg::Mma<128, true>::run(acc, af[s].x, dq + s * 16, 1);
    } else {
      tile_products<128, KS>(acc, af, dq);
    }
    carca::wg::commit();
    carca::wg::wait<0>();
#pragma unroll
    for (int x = 0; x < 64; ++x) carca::wg::hold(acc[x]);
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      const int bb = ch * 128 + 8 * (x / 4) + 2 * t + (x & 1);
      if (bb < B) out_wg[bb * 64 + 16 * warp + g + 8 * ((x / 2) & 1)] = acc[x];
    }
  }
}

struct RerankArgs {
  const float* q;
  const void* e;
  const float* scales;
  const long long* gi;
  float* out;
  int B, R, d, kg, lim0, mask_row0, vec;
};

template <typename T, int kD, bool kWide>
__global__ void __launch_bounds__(kThreads) rerank_kernel(const RerankArgs a) {
  constexpr int KS = kD / carca::kStep<T>;
  constexpr int stride = carca::row_stride_bytes<T>(kD);
  constexpr int SB = stage_bytes<T, kD>(kGroup);
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);  // [2][kGroup rows, kGroup scales]
  const T* e = static_cast<const T*>(a.e);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int chunks = (a.kg + kRerankSlots - 1) / kRerankSlots;
  const int b = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * kRerankSlots;
  const int n = min(kRerankSlots, a.kg - c0);
  const long long* gi = a.gi + (size_t)b * a.kg + c0;

  // the query in every column of the n8 tile
  const float* my_q = a.q + (size_t)b * a.d;
  QFrag<T> bq[KS];
  if constexpr (!kWide) {
#pragma unroll
    for (int s = 0; s < KS; ++s) bq[s] = carca::query_frag<T>(my_q, a.d, s, t);
  }
  // winner group i's scores c (this warp's rows, scl their int8 scales) out
  auto write = [&](int i, const float (&c)[4], const float* scl) {
    if (t == 0) {
      const long long r = gi[i] * kGroup + 16 * warp + g;
      float* o = a.out + ((size_t)b * a.kg + c0 + i) * kGroup + 16 * warp + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r + 8 * h;
        const float sc = a.scales != nullptr ? scl[16 * warp + g + 8 * h] : 1.f;
        o[8 * h] = carca::finish<T>(c[2 * h], sc,
                                    carca::row_valid((int)min(row, (long long)a.R), a.lim0,
                                                     a.mask_row0));
      }
    }
  };
  if constexpr (kWide) {
    const int nch = carca::score_chunks(a.d);
    float* scl = reinterpret_cast<float*>(ring + kGroup * stride);
    for (int i = 0; i < n; ++i) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ch = 0; ch < nch; ++ch) {
        carca::stage_rows<T>(ring, e, gi[i] * kGroup, kGroup, a.R, a.d, kD, stride, a.vec,
                             ch * kD);
        if (ch == 0) carca::stage_scales(scl, a.scales, gi[i] * kGroup, kGroup, a.R);
        carca::cp_async_commit();
        carca::cp_async_wait<0>();
        __syncthreads();  // the chunk is in
        carca::chunk_query_frags<T, KS>(bq, my_q, a.d, ch, t);
        AFrag<T> af[KS];
        carca::load_a<T, KS>(af, ring + (16 * warp + g) * stride, stride, t);
        carca::score_acc<T, KS>(c, af, bq);
        __syncthreads();  // the buffer is free for the next chunk
      }
      write(i, c, scl);
      __syncthreads();  // the scales are free for the next group
    }
    return;
  }

  auto stage = [&](int i) {
    carca::stage_rows<T>(ring + (i & 1) * SB, e, gi[i] * kGroup, kGroup, a.R, a.d, kD, stride,
                         a.vec);
    carca::stage_scales(reinterpret_cast<float*>(ring + (i & 1) * SB + kGroup * stride), a.scales,
                        gi[i] * kGroup, kGroup, a.R);
  };
  stage(0);
  carca::cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) stage(i + 1);
    carca::cp_async_commit();
    carca::cp_async_wait<1>();
    __syncthreads();
    AFrag<T> af[KS];
    const char* buf = ring + (i & 1) * SB;
    const float* scl = reinterpret_cast<const float*>(buf + kGroup * stride);
    carca::load_a<T, KS>(af, buf + (16 * warp + g) * stride, stride, t);
    float c[4];
    carca::score_tile<T, KS>(c, af, bq);
    write(i, c, scl);
    __syncthreads();  // this buffer is free for stage i + 2
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// blocks of `kernel` the card holds at once
template <typename K>
int resident_blocks(K kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// The kernel K4 runs for an index of type dtype (carca::IndexType) and width
// d: ops/retrieval_topk.py::groupmax_branch is the same rule.
enum GroupmaxBranch { kBranchMma = 0, kBranchWgmma = 1, kBranchWide = 2 };
inline int groupmax_branch(int dtype, int d) {
  if (d > carca::kChunk) return kBranchWide;              // groupmax_wide_kernel
  return dtype == carca::kF32 ? kBranchMma : kBranchWgmma;  // groupmax_kernel (3xTF32), or
}                                                          // groupmax_wg_kernel

struct SmemBytes {
  size_t* out;
  bool rerank;
  template <typename T, int kD, bool kWide>
  int operator()() const {
    if (rerank) *out = rerank_smem<T, kD>();
    else if constexpr (kWide) *out = groupmax_wide_smem<T>();
    else if constexpr (carca::kIsF32<T>) *out = groupmax_smem<T, kD>();
    else *out = groupmax_wg_smem<T, kD>();
    return 0;
  }
};

// cuTensorMapEncodeTiled, looked up at run time by the CUDA runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// groupmax_wg_kernel at NQ queries a product, one block an SM; the rows'
// tensor map (128-row boxes, S::kBoxBytes wide, swizzled) where they are
// 16-byte aligned with 16-byte rows (a.vec), else the producer copies them
template <typename T, int kD, int NQ, int kChunks>
int launch_wg(const GroupmaxArgs& a, cudaStream_t st) {
  using S = SlotRows<T, kD>;
  constexpr size_t smem = groupmax_wg_smem<T, kD>();
  int err = set_smem(groupmax_wg_kernel<T, kD, NQ, kChunks>, smem);
  if (err != 0) return err;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (a.vec) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)a.d, (cuuint64_t)a.R};
    const cuuint64_t strides[1] = {(cuuint64_t)a.d * sizeof(T)};
    const cuuint32_t box[2] = {(cuuint32_t)S::kBoxCols, (cuuint32_t)kGroup};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult res = encode(
        &map, sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
        const_cast<void*>(a.e), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        S::kBoxBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = std::min(a.n_groups, sms);
  groupmax_wg_kernel<T, kD, NQ, kChunks><<<(unsigned)grid, kWgThreads, smem, st>>>(a, map);
  return (int)cudaGetLastError();
}

// one product of 8 queries for B <= 8 (the bucket-1 and bucket-8 requests,
// a shard's single query), else chunks of kWgMaxNQ: 1, 2 or 4 of them a
// query set (a partial last set computes the same count)
template <typename T, int kD>
int launch_wg_for_batch(const GroupmaxArgs& a, cudaStream_t st) {
  static_assert(kWgMaxNQ == 64 && kWgQueries == 256, "the products K4 instantiates");
  if (a.B <= 8) return launch_wg<T, kD, 8, 1>(a, st);
  if (a.B <= 64) return launch_wg<T, kD, 64, 1>(a, st);
  if (a.B <= 128) return launch_wg<T, kD, 64, 2>(a, st);
  return launch_wg<T, kD, 64, 4>(a, st);
}

struct GroupmaxLaunch {
  GroupmaxArgs a;
  cudaStream_t st;
  int branch;  // groupmax_branch(dtype, d)
  template <typename T, int kD, bool kWide>
  int operator()() const {
    GroupmaxArgs args = a;
    args.vec = carca::vec_rows<T>(a.e, a.d);
    if (!std::is_same<T, int8_t>::value) args.scales = nullptr;
    if constexpr (kWide) {
      if (branch != kBranchWide) return (int)cudaErrorInvalidValue;
      constexpr size_t smem = groupmax_wide_smem<T>();
      const int err = set_smem(groupmax_wide_kernel<T>, smem);
      if (err != 0) return err;
      const long long grid =
          std::min((long long)a.n_groups, (long long)resident_blocks(groupmax_wide_kernel<T>, smem));
      groupmax_wide_kernel<T><<<(unsigned)grid, kThreads, smem, st>>>(args);
      return (int)cudaGetLastError();
    } else if constexpr (carca::kIsF32<T>) {
      if (branch != kBranchMma) return (int)cudaErrorInvalidValue;
      constexpr size_t smem = groupmax_smem<T, kD>();
      const int err = set_smem(groupmax_kernel<T, kD>, smem);
      if (err != 0) return err;
      const long long n_stages =
          ((long long)a.n_groups * kGroup + kStageRows - 1) / kStageRows;
      const long long grid =
          std::min(n_stages, (long long)resident_blocks(groupmax_kernel<T, kD>, smem));
      groupmax_kernel<T, kD><<<(unsigned)grid, kThreads, smem, st>>>(args);
      return (int)cudaGetLastError();
    } else {
      if (branch != kBranchWgmma) return (int)cudaErrorInvalidValue;
      return launch_wg_for_batch<T, kD>(args, st);
    }
  }
};

struct ProbeLaunch {
  const float* q;
  const void* e;
  float* out_mma;
  float* out_wg;
  int B, d, zero_acc;
  cudaStream_t st;
  template <typename T, int kD, bool kWide>
  int operator()() const {
    if constexpr (kWide || carca::kIsF32<T>) {
      return (int)cudaErrorInvalidValue;
    } else {
      constexpr size_t smem = (size_t)kWgQueries * kD * 2 + 64 * carca::row_stride_bytes<T>(kD);
      auto kernel = zero_acc ? probe_kernel<T, kD, true> : probe_kernel<T, kD, false>;
      const int err = set_smem(kernel, smem);
      if (err != 0) return err;
      kernel<<<1, 128, smem, st>>>(q, e, out_mma, out_wg, B, d);
      return (int)cudaGetLastError();
    }
  }
};

struct RerankLaunch {
  RerankArgs a;
  cudaStream_t st;
  template <typename T, int kD, bool kWide>
  int operator()() const {
    constexpr size_t smem = rerank_smem<T, kD>();
    const int err = set_smem(rerank_kernel<T, kD, kWide>, smem);
    if (err != 0) return err;
    RerankArgs args = a;
    args.vec = carca::vec_rows<T>(a.e, a.d);
    if (!std::is_same<T, int8_t>::value) args.scales = nullptr;
    const long long grid = (long long)a.B * ((a.kg + kRerankSlots - 1) / kRerankSlots);
    rerank_kernel<T, kD, kWide><<<(unsigned)grid, kThreads, smem, st>>>(args);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

size_t carca_groupmax_smem_bytes(int d, int dtype) {
  size_t out = 0;
  carca::dispatch_index(dtype, d, SmemBytes{&out, false});
  return out;
}

// q [B, d] f32; e [R, d] of the type dtype names (carca::IndexType), any
// d >= 1; scales [R] f32 for an int8 index, else null; out [n_groups, B]
// (layout 0) or [B, n_groups] (layout 1) f32, n_groups >= ceil(R / 128).
int carca_groupmax(const void* q, const void* e, const void* scales, void* out, int B, int R,
                   int d, int lim0, int mask_row0, int n_groups, int layout, int dtype,
                   void* stream) {
  const GroupmaxArgs a{static_cast<const float*>(q), e, static_cast<const float*>(scales),
                       static_cast<float*>(out), B, R, d, lim0, mask_row0, n_groups, layout, 0};
  return carca::dispatch_index(
      dtype, d, GroupmaxLaunch{a, static_cast<cudaStream_t>(stream), groupmax_branch(dtype, d)});
}

// The kernel carca_groupmax runs for this index type and width: 0
// groupmax_kernel (mma.sync, 3xTF32: f32 rows of up to 128 columns), 1
// groupmax_wg_kernel (warpgroup products: bf16 and int8 rows of up to 128
// columns), 2 groupmax_wide_kernel (rows of more than 128 columns).
int carca_groupmax_branch(int dtype, int d) { return groupmax_branch(dtype, d); }

// The scoring routine's probe (probe_kernel): e [64, d] bf16 or int8 rows,
// q [B, d] f32 with B <= 256 and d <= 128; out_mma and out_wg [B, 64] f32,
// the raw sums by score_tile and by K4's warpgroup products (zero_acc: from
// a zeroed accumulator).
int carca_groupmax_probe(const void* q, const void* e, void* out_mma, void* out_wg, int B, int d,
                         int dtype, int zero_acc, void* stream) {
  if (B < 1 || B > kWgQueries || d > carca::kChunk || dtype == carca::kF32)
    return (int)cudaErrorInvalidValue;
  return carca::dispatch_index(
      dtype, d, ProbeLaunch{static_cast<const float*>(q), e, static_cast<float*>(out_mma),
                            static_cast<float*>(out_wg), B, d, zero_acc,
                            static_cast<cudaStream_t>(stream)});
}

size_t carca_tournament_rerank_smem_bytes(int d, int dtype) {
  size_t out = 0;
  carca::dispatch_index(dtype, d, SmemBytes{&out, true});
  return out;
}

// q [B, d] f32; e, scales as carca_groupmax; gi [B, kg] int64 winner
// groups (each < ceil(R / 128) rounded up to 128); out [B, kg * 128] f32:
// out[b, 128 i + j] = score(q[b], e[128 gi[b, i] + j]), -inf where that
// row is >= lim0 (or R) or is the pad row 0 under mask_row0.
int carca_tournament_rerank(const void* q, const void* e, const void* scales, const void* gi,
                            void* out, int B, int R, int d, int kg, int lim0, int mask_row0,
                            int dtype, void* stream) {
  const RerankArgs a{static_cast<const float*>(q), e, static_cast<const float*>(scales),
                     static_cast<const long long*>(gi), static_cast<float*>(out), B, R, d, kg,
                     lim0, mask_row0, 0};
  return carca::dispatch_index(dtype, d, RerankLaunch{a, static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
