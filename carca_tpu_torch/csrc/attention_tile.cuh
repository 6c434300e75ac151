// Shared pieces of the attention kernels K1 (attention_fwd.cu) and K2
// (attention_bwd.cu): warp-level tensor-core products on 16-row tiles, the
// staging of [64, dh] row tiles into shared memory, the pair mask and the
// masked-softmax arithmetic, and K1's query-major kernel.
//
// Tiles. A block has four warps and covers 64 rows (queries; K2's second
// half, keys); each warp owns 16 of them. Keys (or queries) are walked in
// tiles of 64 as well, so shared memory holds a fixed number of
// [64, kDh + 4] float tiles whatever Lq and Lk are; kDh is the head width
// rounded up to 32, 64 or 128 (zero-padded columns). A head wider than 128
// dims runs at kDh = 128 in column chunks: the score products sum over the
// chunks, and each chunk of the output takes its own product, so shared
// memory stays fixed there too. The row stride kDh + 4 makes every fragment
// load below free of bank conflicts.
//
// Products (mma.cuh: mma.sync, m16n8, fp32 accumulators):
// * float32 compute: m16n8k8 TF32 with the 3xTF32 split (mma.cuh).
// * bfloat16 compute: m16n8k16 with bf16 operands, which rounds exactly the
//   product inputs that _bwd_kernel's and _fwd_kernel's .astype(cd) round.
// A [16, 64] score tile lives in registers in the accumulator layout: lane
// (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 8n + 2t and
// 8n + 2t + 1 of each n8 block n. It feeds the next product as its A
// operand without leaving registers (FlashAttention-2's reuse): for bf16 two
// accumulator blocks are exactly one k16 A fragment; for TF32 the k order
// inside each k8 step is permuted (k = t <-> column 2t, k = t + 4 <->
// column 2t + 1) and the B rows are read in the same permuted order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "philox.cuh"

namespace carca {
namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;  // rows of a block tile, and keys (queries) of a step
constexpr int kNT = kTile / 8;      // n8 blocks across a [16, kTile] score tile
constexpr float kNegMask = -4294967295.0f;  // -(2^32 - 1), src/carca.py:251
constexpr int kWidestTile = 128;

// The head width a kernel is built for: dh rounded up to 32/64/128; wider
// heads run at 128 in column chunks.
inline int head_tile(int dh) { return dh <= 32 ? 32 : dh <= 64 ? 64 : kWidestTile; }

// Column chunks of a head at tile kDh (more than one only at the widest
// tile), and the width of chunk c.
template <int kDh>
__device__ __forceinline__ int n_chunks(int dh) {
  return kDh == kWidestTile ? (dh + kDh - 1) / kDh : 1;
}

template <int kDh>
__device__ __forceinline__ int chunk_width(int dh, int c) {
  return min(kDh, dh - c * kDh);
}

struct Args {
  const float* q;     // [B, Lq, H * dh]
  const float* k;     // [B, Lk, H * dh]
  const float* v;     // [B, Lk, H * dh]
  const float* qm;    // [B, Lq]
  const float* km;    // [B, Lk]
  const float* dout;  // [B, Lq, H * dh], backward only
  float* out;         // forward: the output; backward: dq
  uint32_t* bits;     // dropout: keep bit of weight idx = bit idx % 32 of word idx / 32
  int B, H, Lq, Lk, dh, has_causal, causal;
  float inv_scale;  // 1 / scale, rounded once on the host
  int dropout;
  uint64_t seed;
  const uint64_t* seed_ptr;  // non-null: the seed is read here, on the device
  uint32_t threshold;
  float inv_keep;  // 1 / (1 - p)
};

// Blocks per SM the compiler must fit K1 into (registers): four 4-warp
// blocks at head tiles up to 32, so the flagship's 512 (b, h) blocks fill one
// wave. K2 has its own rule (attention_bwd.cu).
template <int kDh>
constexpr int min_blocks() {
  return kDh <= 32 ? 4 : 1;
}

// ---------------------------------------------------------------------------
// tensor-core products
// ---------------------------------------------------------------------------

// K2's products (kFast) split float32 operands by split_fast and keep the k
// loop of a score product rolled at head tiles of 64 and more (fewer
// registers); K1's split by split and unroll it whole.
template <bool kFast>
__device__ __forceinline__ Split split_as(float x) {
  if constexpr (kFast) {
    return split_fast(x);
  } else {
    return split(x);
  }
}

// acc[n] += A B^T over kDh: A is the warp's 16 rows in shared memory, rows
// a0 (fragment row g) and a1 (fragment row g + 8) of this lane; B a
// [kTile, kDh + 4] tile whose rows are the columns of acc. Blocks n >= live
// (warp-uniform) are left as they are: K2's causal tiles skip the keys past
// the warp's last row's diagonal.
template <int kDh, bool kBf16, int kN, bool kFast = false>
__device__ __forceinline__ void mma_rows_bt(float (&acc)[kN][4], const float* a0,
                                            const float* a1, const float* bt, int g, int t,
                                            int live = kN) {
  constexpr int LD = kDh + 4;
  // one k step: 16 (bf16) or 8 (TF32) columns of A and B
  auto step = [&](int kk) {
    if constexpr (kBf16) {
      const float2 x0 = *reinterpret_cast<const float2*>(a0 + kk + 2 * t);
      const float2 x1 = *reinterpret_cast<const float2*>(a1 + kk + 2 * t);
      const float2 x2 = *reinterpret_cast<const float2*>(a0 + kk + 2 * t + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(a1 + kk + 2 * t + 8);
      const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                             pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        if (n >= live) break;
        const float* br = bt + (8 * n + g) * LD + kk + 2 * t;
        const float2 y0 = *reinterpret_cast<const float2*>(br);
        const float2 y1 = *reinterpret_cast<const float2*>(br + 8);
        mma_bf16(acc[n], a, pack_bf16(y0.x, y0.y), pack_bf16(y1.x, y1.y));
      }
    } else {
      const Split a[4] = {split_as<kFast>(a0[kk + t]), split_as<kFast>(a1[kk + t]),
                          split_as<kFast>(a0[kk + t + 4]), split_as<kFast>(a1[kk + t + 4])};
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        if (n >= live) break;
        const float* br = bt + (8 * n + g) * LD + kk + t;
        mma_3xtf32(acc[n], a, split_as<kFast>(br[0]), split_as<kFast>(br[4]));
      }
    }
  };
  constexpr int kStep = kBf16 ? 16 : 8;
  if constexpr (kFast && kDh >= 64) {
#pragma unroll 1
    for (int kk = 0; kk < kDh; kk += kStep) step(kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < kDh; kk += kStep) step(kk);
  }
}

// out[n] += P B over kCols n8 blocks of columns: P is a [16, 8 kN] tile in
// registers (accumulator layout), B a [8 kN, *] tile of row stride kDh + 4
// whose rows are P's columns (b: its first column). P's k blocks outside
// [lo, hi) (warp-uniform; bf16 rounds lo down to a pair) are zero and
// skipped: K2's causal tiles.
template <int kDh, bool kBf16, int kN, int kCols = kDh / 8, bool kFast = false>
__device__ __forceinline__ void mma_regs_b(float (&out)[kCols][4], const float (&p)[kN][4],
                                           const float* b, int g, int t, int lo = 0,
                                           int hi = kN) {
  constexpr int LD = kDh + 4;
  if constexpr (kBf16) {
#pragma unroll
    for (int k2 = 0; k2 < kN / 2; ++k2) {
      if (2 * k2 + 1 < lo || 2 * k2 >= hi) continue;
      const uint32_t a[4] = {pack_bf16(p[2 * k2][0], p[2 * k2][1]),
                             pack_bf16(p[2 * k2][2], p[2 * k2][3]),
                             pack_bf16(p[2 * k2 + 1][0], p[2 * k2 + 1][1]),
                             pack_bf16(p[2 * k2 + 1][2], p[2 * k2 + 1][3])};
      const float* br = b + (16 * k2 + 2 * t) * LD + g;  // rows 2t, 2t + 1, 2t + 8, 2t + 9
#pragma unroll
      for (int n = 0; n < kCols; ++n)
        mma_bf16(out[n], a, pack_bf16(br[8 * n], br[LD + 8 * n]),
                 pack_bf16(br[8 * LD + 8 * n], br[9 * LD + 8 * n]));
    }
    if constexpr (kN % 2 == 1) {  // an odd last block of P: one k = 8 step
      constexpr int kt = kN - 1;
      if (kt < lo || kt >= hi) return;
      const uint32_t a0 = pack_bf16(p[kt][0], p[kt][1]), a1 = pack_bf16(p[kt][2], p[kt][3]);
      const float* br = b + (8 * kt + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < kCols; ++n)
        mma_bf16_k8(out[n], a0, a1, pack_bf16(br[8 * n], br[LD + 8 * n]));
    }
  } else {
#pragma unroll
    for (int kt = 0; kt < kN; ++kt) {
      if (kt < lo || kt >= hi) continue;
      // k = t <-> column 2t, k = t + 4 <-> column 2t + 1 of block kt
      const Split a[4] = {split_as<kFast>(p[kt][0]), split_as<kFast>(p[kt][2]),
                          split_as<kFast>(p[kt][1]), split_as<kFast>(p[kt][3])};
      const float* br = b + (8 * kt + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < kCols; ++n)
        mma_3xtf32(out[n], a, split_as<kFast>(br[8 * n]), split_as<kFast>(br[LD + 8 * n]));
    }
  }
}

// ---------------------------------------------------------------------------
// weight dropout: the keep bits of a call, packed
// ---------------------------------------------------------------------------

// bits[w] bit e = keep bit of weight 32 w + e (philox.cuh's mapping), for
// words [0, n_words). Lane l of a warp computes the Philox block at counter
// c = 8 w + l % 8 (weights 4c..4c+3); eight lanes OR their nibbles into one
// word. Whole warps run every step (the shuffles need all 32 lanes), so
// the loop runs to a multiple of 32 counters and only stores below n_words.
// The seed is `seed`, or *seed_ptr where that is non-null: a CUDA graph
// captures the pointer, and each replay reads the seed its caller wrote
// there, where a captured value would repeat every dropout mask.
static __global__ void keep_bits_kernel(uint32_t* __restrict__ bits, uint64_t n_words,
                                        uint64_t seed, const uint64_t* __restrict__ seed_ptr,
                                        uint32_t threshold) {
  if (seed_ptr != nullptr) seed = *seed_ptr;
  const uint64_t end = (8 * n_words + 31) / 32 * 32;
  for (uint64_t c = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; c < end;
       c += (uint64_t)gridDim.x * blockDim.x) {
    const uint4 r = philox_block(seed, c);
    uint32_t x = (uint32_t)(r.x < threshold) | (uint32_t)(r.y < threshold) << 1 |
                 (uint32_t)(r.z < threshold) << 2 | (uint32_t)(r.w < threshold) << 3;
    x <<= 4 * (c % 8);
    x |= __shfl_xor_sync(0xffffffffu, x, 1);
    x |= __shfl_xor_sync(0xffffffffu, x, 2);
    x |= __shfl_xor_sync(0xffffffffu, x, 4);
    if (c % 8 == 0 && c / 8 < n_words) bits[c / 8] = x;
  }
}

// Fill bits for n weights.
inline cudaError_t launch_keep_bits(uint32_t* bits, uint64_t n, uint64_t seed,
                                   const uint64_t* seed_ptr, uint32_t threshold,
                                   cudaStream_t stream) {
  const uint64_t n_words = (n + 31) / 32;
  if (n_words == 0) return cudaSuccess;
  const uint64_t blocks = (8 * n_words + 255) / 256;
  keep_bits_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(
      bits, n_words, seed, seed_ptr, threshold);
  return cudaGetLastError();
}

// Fill a.bits for the call's B * H * Lq * Lk weights (a no-op without dropout).
inline cudaError_t launch_keep_bits(const Args& a, cudaStream_t stream) {
  if (!a.dropout) return cudaSuccess;
  return launch_keep_bits(a.bits, (uint64_t)a.B * a.H * a.Lq * a.Lk, a.seed, a.seed_ptr,
                          a.threshold, stream);
}

// The keep bits of weights idx .. idx + 63 (bit e of the pair), from three
// independent loads; idx lies within the call's weights, and the scratch
// holds two words past the last one (keep_bits_words), so the window never
// leaves it. Bits past the call's weights are garbage: their weights are
// padding, which the mask zeroes.
__device__ __forceinline__ uint2 keep_window(const uint32_t* __restrict__ bits, uint64_t idx) {
  const uint32_t e = (uint32_t)(idx & 31);
  const uint32_t* p = bits + (idx >> 5);
  const uint32_t w0 = __ldg(p), w1 = __ldg(p + 1), w2 = __ldg(p + 2);
  return make_uint2(__funnelshift_r(w0, w1, e), __funnelshift_r(w1, w2, e));
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
}

// ---------------------------------------------------------------------------
// tiles in shared memory
// ---------------------------------------------------------------------------

// Rows [0, rows) of a [*, d] tensor (src = row 0 at the head's offset), dh
// columns, into a [kTile, kDh + 4] tile; zeros everywhere else. `vec`: 16-byte
// loads (src 16-byte aligned, dh and d multiples of 4).
template <int kDh>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                                          int d, int dh, bool vec) {
  constexpr int LD = kDh + 4;
  if (vec) {
    for (int idx = threadIdx.x; idx < kTile * (kDh / 4); idx += kThreads) {
      const int r = idx / (kDh / 4), e = 4 * (idx % (kDh / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && e < dh) x = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * d + e));
      *reinterpret_cast<float4*>(dst + r * LD + e) = x;
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * kDh; idx += kThreads) {
      const int r = idx / kDh, e = idx % kDh;
      dst[r * LD + e] = (r < rows && e < dh) ? __ldg(src + (size_t)r * d + e) : 0.f;
    }
  }
}

// The reverse: rows [0, rows) and dh columns of a tile to a [*, d] tensor.
template <int kDh>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* src, int rows,
                                           int d, int dh, bool vec) {
  constexpr int LD = kDh + 4;
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * (kDh / 4); idx += kThreads) {
      const int r = idx / (kDh / 4), e = 4 * (idx % (kDh / 4));
      if (e < dh)
        *reinterpret_cast<float4*>(dst + (size_t)r * d + e) =
            *reinterpret_cast<const float4*>(src + r * LD + e);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * kDh; idx += kThreads) {
      const int r = idx / kDh, e = idx % kDh;
      if (e < dh) dst[(size_t)r * d + e] = src[r * LD + e];
    }
  }
}

// n values of a [B, L] mask from `src`, zeros up to kTile
__device__ __forceinline__ void load_mask(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) dst[i] = i < n ? __ldg(src + i) : 0.f;
}

// Accumulators [16, kDh] (rows r0 and r1 of this lane) into a tile.
template <int kDh>
__device__ __forceinline__ void put_rows(float* tile, const float (&acc)[kDh / 8][4], int r0,
                                         int r1, int t) {
  constexpr int LD = kDh + 4;
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n) {
    *reinterpret_cast<float2*>(tile + r0 * LD + 8 * n + 2 * t) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(tile + r1 * LD + 8 * n + 2 * t) = make_float2(acc[n][2], acc[n][3]);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// the masked-softmax arithmetic, in the plain version's order
// ---------------------------------------------------------------------------

// m = q_mask[i] * k_mask[j], zeroed where j > i + causal (absolute rows)
__device__ __forceinline__ float pair_mask(const Args& a, float qmi, float kmj, int i, int j) {
  return (a.has_causal && j > i + a.causal) ? 0.f : qmi * kmj;
}

// z = (s + (m > 0 ? 0 : -(2^32 - 1))) / scale, as a product with the
// rounded reciprocal (as _weights_block does); keys beyond Lk weigh nothing
__device__ __forceinline__ float logit(const Args& a, float s, float m, int j) {
  return j < a.Lk ? (s + (m > 0.f ? 0.f : kNegMask)) * a.inv_scale : -INFINITY;
}

// exp of a logit minus its row max (x <= 0, or -inf): ex2.approx, exact at
// 0 (so a row with one live key, or a fully masked row, weighs exactly as
// in the plain version); elsewhere its error of ~|x| 2^-24 relative stays
// below 2.2e-8 absolute on a weight in [0, 1].
__device__ __forceinline__ float exp_shifted(float x) { return __expf(x); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int kDh>
constexpr size_t rows_smem_bytes() {
  return sizeof(float) * (3 * kTile * (kDh + 4) + 2 * kTile);
}

// ---------------------------------------------------------------------------
// K1's query-major kernel
// ---------------------------------------------------------------------------
//
// Block (q-tile, h, b): 64 query rows, warp w owns rows 16w..16w+15. Pass 1
// walks the key tiles: S = Q K^T into registers, the logits, and the online
// row max m and sum l; pass 2 walks them again with the final m and l:
// w = exp(z - m) / l exactly as the plain softmax, and
// O += (keep ? w m / (1 - p) : 0) V. With one key tile (Lk <= 64: every
// serving and training shape but men) pass 2 reuses pass 1's registers: K
// and V are staged once, S is computed once and exp runs once per weight.
// A head wider than 128 dims (kDh = 128, nch > 1 chunks): S sums over the
// chunks, staged with the rows, and pass 2 runs once per chunk of the output.
template <int kDh, bool kBf16>
__global__ void __launch_bounds__(kThreads, min_blocks<kDh>()) rows_kernel(const Args a) {
  constexpr int LD = kDh + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][LD] q rows, then the output
  float* ks = qs + kTile * LD;                   // [kTile][LD] key tile
  float* vs = ks + kTile * LD;                   // [kTile][LD] value tile
  float* qms = vs + kTile * LD;                  // [kTile]
  float* kms = qms + kTile;                      // [kTile]

  const int row0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int d = a.H * a.dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rows = min(kTile, a.Lq - row0);
  const bool vec_dims = a.dh % 4 == 0 && d % 4 == 0;
  const size_t qoff = ((size_t)b * a.Lq + row0) * d + (size_t)h * a.dh;
  const int nch = n_chunks<kDh>(a.dh);
  const bool vec_q = vec_dims && aligned16(a.q);
  // the Q columns of chunk c
  auto stage_rows = [&](int c) {
    load_tile<kDh>(qs, a.q + qoff + c * kDh, rows, d, chunk_width<kDh>(a.dh, c), vec_q);
  };
  if (nch == 1) stage_rows(0);
  const int nkt = (a.Lk + kTile - 1) / kTile;
  load_mask(qms, a.qm + (size_t)b * a.Lq + row0, rows);

  const int r0 = 16 * warp + g;  // this lane's tile rows r0 and r0 + 8
  const int i0 = row0 + r0;      // ... and absolute query rows
  const float* a_r0 = qs + r0 * LD;
  const uint64_t bh = (uint64_t)b * a.H + h;
  const bool vec_k = vec_dims && aligned16(a.k), vec_v = vec_dims && aligned16(a.v);

  float s[kNT][4];  // logits, then weights
  float mx[2] = {-INFINITY, -INFINITY}, inv_l[2];

  // Stage key tile kt (K, and V when `with_v`) and compute S for it, summed
  // over the head's column chunks (staged with Q when nch > 1).
  auto scores = [&](int kt, bool with_v) {
    const int key0 = kt * kTile, keys = min(kTile, a.Lk - key0);
    const size_t koff = ((size_t)b * a.Lk + key0) * d + (size_t)h * a.dh;
    zero(s);
    for (int c = 0; c < nch; ++c) {
      const int w = chunk_width<kDh>(a.dh, c);
      __syncthreads();  // the previous tile is consumed
      if (nch > 1) stage_rows(c);
      load_tile<kDh>(ks, a.k + koff + c * kDh, keys, d, w, vec_k);
      if (with_v) load_tile<kDh>(vs, a.v + koff + c * kDh, keys, d, w, vec_v);
      if (c == 0) load_mask(kms, a.km + (size_t)b * a.Lk + key0, keys);
      __syncthreads();
      mma_rows_bt<kDh, kBf16, kNT>(s, a_r0, a_r0 + 8 * LD, ks, g, t);
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int jl = 8 * n + 2 * t, j = key0 + jl;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 8 * r;
        const float qmi = qms[r0 + 8 * r];
        s[n][2 * r] = logit(a, s[n][2 * r], pair_mask(a, qmi, kms[jl], i, j), j);
        s[n][2 * r + 1] =
            logit(a, s[n][2 * r + 1], pair_mask(a, qmi, kms[jl + 1], i, j + 1), j + 1);
      }
    }
  };

  {
    // pass 1: the row statistics
    float l[2] = {0.f, 0.f};
    for (int kt = 0; kt < nkt; ++kt) {
      scores(kt, nkt == 1 && nch == 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int n = 0; n < kNT; ++n) tmax = fmaxf(tmax, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float mnew = fmaxf(mx[r], quad_max(tmax));
        const float rescale = exp_shifted(mx[r] - mnew);  // 0 on the first tile
        float lt = 0.f;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int c = 2 * r; c < 2 * r + 2; ++c) {
            const float p = exp_shifted(s[n][c] - mnew);
            lt += p;
            if (nkt == 1) s[n][c] = p;  // pass 2 reuses it
          }
        }
        l[r] = fmaf(l[r], rescale, lt);
        mx[r] = mnew;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(l[r]);
  }

  // pass 2, once per column chunk of the output: weights, and the product
  // with V
  for (int ch = 0; ch < nch; ++ch) {
    float acc[kDh / 8][4];
    zero(acc);
    for (int kt = 0; kt < nkt; ++kt) {
      if (nkt > 1) scores(kt, nch == 1);
      const int key0 = kt * kTile;
      if (nkt > 1 || ch == 0) {  // else this tile's weights are still in registers
        uint2 kw[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};  // the keep bits
        if (a.dropout) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (i0 + 8 * r < a.Lq)
              kw[r] = keep_window(a.bits, (bh * a.Lq + i0 + 8 * r) * a.Lk + key0);
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int jl = 8 * n + 2 * t, j = key0 + jl;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = i0 + 8 * r;
            float w[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float z = s[n][2 * r + c];
              w[c] = (nkt == 1 ? z : exp_shifted(z - mx[r])) * inv_l[r];  // the softmax, w_raw
            }
            const float qmi = qms[r0 + 8 * r];
            w[0] *= pair_mask(a, qmi, kms[jl], i, j);  // the post-softmax re-mask
            w[1] *= pair_mask(a, qmi, kms[jl + 1], i, j + 1);
            if (a.dropout) {
              const uint32_t kb = (n < 4 ? kw[r].x : kw[r].y) >> (jl % 32);
              w[0] = kb & 1u ? w[0] * a.inv_keep : 0.f;
              w[1] = kb & 2u ? w[1] * a.inv_keep : 0.f;
            }
            s[n][2 * r] = w[0];
            s[n][2 * r + 1] = w[1];
          }
        }
      }
      if (nch > 1) {  // chunk ch's columns of V
        const size_t koff = ((size_t)b * a.Lk + key0) * d + (size_t)h * a.dh + ch * kDh;
        __syncthreads();
        load_tile<kDh>(vs, a.v + koff, min(kTile, a.Lk - key0), d, chunk_width<kDh>(a.dh, ch),
                       vec_v);
        __syncthreads();
      }
      mma_regs_b<kDh, kBf16, kNT>(acc, s, vs, g, t);
    }

    // a warp reads and writes only its own rows of qs
    put_rows<kDh>(qs, acc, r0, r0 + 8, t);
    __syncthreads();
    store_tile<kDh>(a.out + qoff + ch * kDh, qs, rows, d, chunk_width<kDh>(a.dh, ch),
                    vec_dims && aligned16(a.out));
  }
}

// Launch K1's query-major kernel at head tile kDh.
template <int kDh, bool kBf16>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = rows_smem_bytes<kDh>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rows_kernel<kDh, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.Lq + kTile - 1) / kTile, a.H, a.B);
  rows_kernel<kDh, kBf16><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Calls fn.template operator()<kDh, kBf16>() for the head tile of dh.
template <typename Fn>
cudaError_t dispatch(int dh, int bf16, Fn&& fn) {
  switch (head_tile(dh)) {
    case 32: return bf16 ? fn.template operator()<32, true>() : fn.template operator()<32, false>();
    case 64: return bf16 ? fn.template operator()<64, true>() : fn.template operator()<64, false>();
    case 128:
      return bf16 ? fn.template operator()<128, true>() : fn.template operator()<128, false>();
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the whole-row kernels' shared pieces (K1's whole_row_kernel, K2's
// whole_row_bwd_kernel): the key row in chunks of one wgmma m64n40 each
// ---------------------------------------------------------------------------

constexpr int kRowKeys = 40;  // keys of one score chunk: one wgmma m64n40
constexpr int kRowNB = kRowKeys / 8;

// Score chunks a thread holds: 5, 200 keys in 100 registers (men's L). At
// 64-dim heads in float32 K and V^T, hi and lo, take 1 KB a key of the
// 227 KB of shared memory, so 200 keys is also all that fits there.
constexpr int kRowChunks = 5;

// fn(std::integral_constant<int, n>) for n in kMin..kMax (n clamped to that
// range): each count's products are straight-line code. Under a branch per
// chunk ptxas serialized every float32 wgmma (C7512: a wait after each
// product).
template <int kMax, int kMin = 0, typename Fn>
__device__ __forceinline__ void with_count(int n, Fn&& fn) {
  if constexpr (kMax == kMin) {
    fn(std::integral_constant<int, kMin>{});
  } else {
    if (n >= kMax) {
      fn(std::integral_constant<int, kMax>{});
    } else {
      with_count<kMax - 1, kMin>(n, fn);
    }
  }
}

// Named barriers of `threads` threads (id 0 is __syncthreads'): sync waits
// for all of them, arrive counts this warp in and goes on.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// z = (s + (m > 0 ? 0 : -(2^32 - 1))) / scale, as s / scale + neg where neg
// = -(2^32 - 1) / scale: a live logit is rounded as logit() rounds it; a
// masked one differs, and weighs nothing either way: in a row with a live
// key its exp underflows to exactly 0, and a row with none is re-masked to
// 0. Staged keys past Lk have a zero key mask, so they are masked alike.
__device__ __forceinline__ float masked_logit(float s, float m, float inv_scale, float neg) {
  return fmaf(s, inv_scale, m > 0.f ? 0.f : neg);
}

// f32: the TF32 k step reads keys 8s..8s+7 of V^T in the order its A
// fragment (P in accumulator layout) holds them: position k <-> key 2k
// (k < 4), key 2(k - 4) + 1 (k >= 4). So key j sits at position vpos(j).
__device__ __forceinline__ int vpos(int j) {
  const int r = j & 7;
  return (j & ~7) | ((r & 1) ? 4 + (r >> 1) : (r >> 1));
}

// x[i] for a lane-dependent i in 0..3, without indexing registers
__device__ __forceinline__ float pick4(const float* x, int i) {
  return i < 2 ? (i == 0 ? x[0] : x[1]) : (i == 2 ? x[2] : x[3]);
}

// Four columns e..e+3 of one row (zeros past dh); `vec`: one 16-byte load.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int e, int dh, bool vec) {
  if (vec) return e < dh ? __ldg(reinterpret_cast<const float4*>(row + e)) : make_float4(0, 0, 0, 0);
  float x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] = e + c < dh ? __ldg(row + e + c) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

}  // namespace attn
}  // namespace carca
