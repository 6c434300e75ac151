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
// scoring.cuh's routine, which K3 and the rerank below also run: group
// maxima equal the rerank's scores bit for bit, so the tournament's
// containment argument is exact (the k + 8 best groups, ties to the lowest
// group, hold the true top-k) and the tournament returns K3's ids and
// values.
//
// Design. A persistent block of 8 warps walks stages of kStageRows rows
// (256 at int8: two 16-row tiles per warp; 128 at bf16 and f32: one). Each
// stage's rows (and int8 scales) are copied by cp.async, in their own
// type, into a ring of three buffers (two at f32), so the next stages'
// copies overlap this stage's products. The call's queries (up to kQC = 256 at bf16/int8, 128
// at f32) sit in shared memory as the N operand's fragments, staged once
// per block: the index is read from device memory once per call for B <=
// kQC (a larger B walks query chunks inside the stage, restaging them). A
// warp widens its rows into A fragments once per stage and then loops over
// the n8 query tiles: kMT x KS mma.sync per tile, the scale and mask, a
// running maximum over its rows, a shuffle maximum over the 8 row lanes;
// the warps of a group meet in shared memory, and the block writes the
// stage's maxima. At B = 1 the one query pads one n8 tile and every warp
// still loads and scores rows.
// What bounds it on the H100: at B = 256 the products (2 B R d operations,
// 0.33 ms at the bf16 tensor-core peak for 10M rows; mma.sync reaches a
// fraction of the wgmma peak, and each mma needs a 64-bit fragment load
// from shared memory); at B = 1 the index's bytes (0.19 ms for 10M int8
// rows). Both layouts share the kernel; layout 1's stores are 8 bytes wide.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "scoring.cuh"

namespace {

using carca::AFrag;
using carca::QFrag;

constexpr int kGroup = 128;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRerankSlots = 8;  // winner groups per rerank block
constexpr int kWideQC = 32;      // queries per step of groupmax_wide_kernel

template <typename T>
constexpr int kMT = sizeof(T) == 1 ? 2 : 1;  // 16-row tiles per warp and stage
template <typename T>
constexpr int kStageRows = kWarps * 16 * kMT<T>;
template <typename T>
constexpr int kQC = carca::kIsF32<T> ? 128 : 256;  // queries staged at once
template <typename T>
constexpr int kRing = carca::kIsF32<T> ? 2 : 3;  // stage buffers in flight

// a stage in shared memory: its rows, then their scales
template <typename T, int kD>
__host__ __device__ constexpr int stage_bytes(int rows) {
  return rows * (carca::row_stride_bytes<T>(kD) + 4);
}

template <typename T, int kD>
__host__ __device__ constexpr size_t groupmax_smem() {
  return kRing<T> * (size_t)stage_bytes<T, kD>(kStageRows<T>) +
         // four lanes hold each query's fragment of a k-step
         sizeof(QFrag<T>) * 4 * (size_t)kQC<T> * (kD / carca::kStep<T>) +
         sizeof(float) * (size_t)kWarps * kQC<T>;
}

template <typename T, int kD>
__host__ __device__ constexpr size_t rerank_smem() {
  return 2 * (size_t)stage_bytes<T, kD>(kGroup);
}

template <typename T>
__host__ __device__ constexpr size_t groupmax_wide_smem() {
  return (size_t)stage_bytes<T, carca::kChunk>(kGroup) + sizeof(float) * kWarps * kWideQC;
}

template <typename T, int kD>
constexpr int min_blocks() {
  return (kD == 64 && !carca::kIsF32<T>) ? 2 : 1;
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
__global__ void __launch_bounds__(kThreads, (min_blocks<T, kD>()))
groupmax_kernel(const GroupmaxArgs a) {
  constexpr int KS = kD / carca::kStep<T>;
  constexpr int MT = kMT<T>;
  constexpr int SR = kStageRows<T>;
  constexpr int QC = kQC<T>;
  constexpr int NT = QC / 8;
  constexpr int GPS = SR / kGroup;            // groups per stage
  constexpr int WPG = kWarps / GPS;           // warps per group
  constexpr int stride = carca::row_stride_bytes<T>(kD);
  extern __shared__ float4 smem4[];
  constexpr int NR = kRing<T>;
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

struct SmemBytes {
  size_t* out;
  bool rerank;
  template <typename T, int kD, bool kWide>
  int operator()() const {
    *out = rerank ? rerank_smem<T, kD>() : kWide ? groupmax_wide_smem<T>() : groupmax_smem<T, kD>();
    return 0;
  }
};

struct GroupmaxLaunch {
  GroupmaxArgs a;
  cudaStream_t st;
  template <typename T, int kD, bool kWide>
  int operator()() const {
    if constexpr (kWide) {
      constexpr size_t smem = groupmax_wide_smem<T>();
      const int err = set_smem(groupmax_wide_kernel<T>, smem);
      if (err != 0) return err;
      GroupmaxArgs args = a;
      args.vec = carca::vec_rows<T>(a.e, a.d);
      if (!std::is_same<T, int8_t>::value) args.scales = nullptr;
      const long long grid =
          std::min((long long)a.n_groups, (long long)resident_blocks(groupmax_wide_kernel<T>, smem));
      groupmax_wide_kernel<T><<<(unsigned)grid, kThreads, smem, st>>>(args);
      return (int)cudaGetLastError();
    }
    constexpr size_t smem = groupmax_smem<T, kD>();
    const int err = set_smem(groupmax_kernel<T, kD>, smem);
    if (err != 0) return err;
    GroupmaxArgs args = a;
    args.vec = carca::vec_rows<T>(a.e, a.d);
    if (!std::is_same<T, int8_t>::value) args.scales = nullptr;
    const long long n_stages =
        ((long long)a.n_groups * kGroup + kStageRows<T> - 1) / kStageRows<T>;
    const long long grid =
        std::min(n_stages, (long long)resident_blocks(groupmax_kernel<T, kD>, smem));
    groupmax_kernel<T, kD><<<(unsigned)grid, kThreads, smem, st>>>(args);
    return (int)cudaGetLastError();
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
  return carca::dispatch_index(dtype, d, GroupmaxLaunch{a, static_cast<cudaStream_t>(stream)});
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
