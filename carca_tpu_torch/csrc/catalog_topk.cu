// K3: streaming catalog top-k over an f32 index, for Hopper (sm_90a).
//
// Replaces the TPU kernel carca_tpu/ops/retrieval_topk.py::_kernel (the
// f32 branch: _extract_topk_inplace plus the running-list merge), reached
// from catalog_topk(method="stream"). Plain version:
// carca_tpu_torch/ops/retrieval_topk.py::catalog_topk_plain.
//
// Contract: vals/ids [B, k] = the top-k of s[b, r] = q[b] . e[r] over the
// index rows r in [0, R), ordered by value descending and, on equal
// values, by lowest row id first (lax.top_k's order). Rows r >= lim0, and
// row 0 when mask_row0, score -inf. Returned ids are r + id_offset, and a
// -inf slot (k beyond the valid rows) returns id 0.
//
// Exact order, not just exact values: each score is the fp32 sum
// ((q0*e0 + q1*e1) + q2*e2) + ... with every product and sum rounded on
// its own (__fmul_rn / __fadd_rn, no FMA contraction). The plain version
// adds the products in the same order with separate rounding, so both
// compute bit-identical scores and the ids agree exactly even on
// near-ties. Each candidate is ordered by one 64-bit key: the
// order-preserving integer of the score (the _float_key trick of the JAX
// package, sign bit flipped to make it unsigned) in the high word and the
// complemented row id in the low word. Keys are unique per row, ties go
// to the lowest id, and no id bit ever enters a float (the flush-to-zero
// trap of packing ids into mantissas, which a zero query would hit).
//
// Design. The TPU kernel extracts k winners per chunk by k rounds of
// max-and-suppress; at the serving k = 562 that is 562 passes over every
// tile, so it is not carried over. Instead:
//   1. chunk_topk_kernel: one block per (catalog chunk of C rows, QB
//      queries). The block stages its queries and, tile by tile, the
//      chunk's rows in shared memory (rows padded to d+1 floats against
//      bank conflicts), scores every (query, row) pair, and keeps the
//      [QB, C] keys in shared memory (64 KB). A bitonic sort of each
//      query's C keys (descending) yields the chunk's top k, written to a
//      scratch [B, n_chunks, k]. C is the power of two >= max(k, 1024)
//      and QB = min(8192 / C, B), so the keys fill at most 64 KB.
//   2. merge_kernel, log2(n_chunks) launches: pairs of sorted k-lists
//      merge into one. Each candidate finds its merged rank by a binary
//      search in the other list (strictly-greater for the left list,
//      greater-or-equal for the right, so ranks are a permutation) and
//      writes itself if the rank is below k.
//   3. decode_kernel: keys -> (value, id + id_offset), -inf -> id 0.
// What bounds it on the H100: scoring is B*R*d FMAs over shared memory
// (2 loads per FMA) and the bitonic sort is O(C log^2 C) compare-swaps per
// (query, chunk); the catalog itself (R*d*4 bytes, 25.6 MB at 100k rows
// and d = 64) is read once per query block and stays in the 50 MB L2.
// Tensor cores, a radix select in place of the full sort, and fewer
// catalog re-reads are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;  // catalog tile in shared memory: 32 KB

__device__ __forceinline__ u64 make_key(float s, int row) {
  if (s == 0.f) s = 0.f;  // -0.0 and +0.0 compare equal: one key
  const int b = __float_as_int(s);
  const unsigned int u = (unsigned int)(b < 0 ? (b ^ 0x7FFFFFFF) : b) ^ 0x80000000u;
  return ((u64)u << 32) | (u64)(~(unsigned int)row);
}

int tile_rows(int d) { return kTileFloats / (d + 1) > 0 ? kTileFloats / (d + 1) : 1; }

size_t phase1_smem(int C, int QB, int d) {
  return sizeof(u64) * (size_t)QB * C + sizeof(float) * ((size_t)QB * d +
                                                         (size_t)tile_rows(d) * (d + 1));
}

// cand[b, chunk, :k] = the chunk's top-k keys for query b, descending.
__global__ void __launch_bounds__(kThreads)
chunk_topk_kernel(const float* __restrict__ q, const float* __restrict__ e,
                  u64* __restrict__ cand, int B, int R, int d, int k, int C, int QB,
                  int lim0, int mask_row0, int tile) {
  extern __shared__ u64 keys[];                            // [QB][C]
  float* qs = reinterpret_cast<float*>(keys + QB * C);     // [QB][d]
  float* es = qs + QB * d;                                 // [tile][d + 1]
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int c0 = chunk * C;
  const int b0 = blockIdx.y * QB;
  const int ld = d + 1;

  for (int idx = threadIdx.x; idx < QB * d; idx += blockDim.x) {
    const int qi = idx / d;
    qs[idx] = (b0 + qi < B) ? q[(size_t)(b0 + qi) * d + idx % d] : 0.f;
  }
  for (int t0 = 0; t0 < C; t0 += tile) {
    const int rows = min(tile, C - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
      const int rr = idx / d, j = idx % d;
      const int row = c0 + t0 + rr;
      es[rr * ld + j] = row < R ? e[(size_t)row * d + j] : 0.f;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < QB * rows; p += blockDim.x) {
      const int qi = p / rows, rr = p % rows;
      const int row = c0 + t0 + rr;
      u64 key = 0;  // rows past the index sort below every real key
      if (row < R) {
        if (row >= lim0 || (row == 0 && mask_row0)) {
          key = make_key(-INFINITY, row);
        } else {
          const float* qv = qs + qi * d;
          const float* ev = es + rr * ld;
          float s = 0.f;
          for (int j = 0; j < d; ++j) s = __fadd_rn(s, __fmul_rn(qv[j], ev[j]));
          key = make_key(s, row);
        }
      }
      keys[qi * C + t0 + rr] = key;
    }
  }
  __syncthreads();

  // bitonic sort of each query's C keys, descending
  const int half = C / 2;
  for (int size = 2; size <= C; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < QB * half; p += blockDim.x) {
        const int qi = p / half, t = p % half;
        const int i = 2 * t - (t & (stride - 1));
        u64* row = keys + qi * C;
        const u64 a = row[i], b = row[i + stride];
        const bool desc = (i & size) == 0;
        if ((a < b) == desc) {
          row[i] = b;
          row[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int p = threadIdx.x; p < QB * k; p += blockDim.x) {
    const int qi = p / k, t = p % k;
    if (b0 + qi < B) cand[((size_t)(b0 + qi) * n_chunks + chunk) * k + t] = keys[qi * C + t];
  }
}

// number of entries of the descending list a[0:n] that are > x (or >= x)
__device__ __forceinline__ int count_above(const u64* a, int n, u64 x, bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (a[mid] > x || (or_equal && a[mid] == x)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// out[b, p, :] = top-k of the merge of in[b, 2p, :] and in[b, 2p+1, :]
__global__ void __launch_bounds__(kThreads)
merge_kernel(const u64* __restrict__ in, u64* __restrict__ out, int n_in, int k) {
  const int pair = blockIdx.x;
  const int n_out = gridDim.x;
  const int b = blockIdx.y;
  const u64* left = in + ((size_t)b * n_in + 2 * pair) * k;
  const bool has_right = 2 * pair + 1 < n_in;
  const u64* right = left + k;
  u64* dst = out + ((size_t)b * n_out + pair) * k;
  for (int p = threadIdx.x; p < 2 * k; p += blockDim.x) {
    u64 x;
    int rank;
    if (p < k) {
      x = left[p];
      rank = p + (has_right ? count_above(right, k, x, false) : 0);
    } else {
      if (!has_right) break;
      x = right[p - k];
      rank = (p - k) + count_above(left, k, x, true);
    }
    if (rank < k) dst[rank] = x;
  }
}

__global__ void decode_kernel(const u64* __restrict__ keys, float* __restrict__ vals,
                              long long* __restrict__ ids, int total, int id_offset) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const u64 key = keys[p];
  const unsigned int u = (unsigned int)(key >> 32);
  if (u <= 0x007FFFFFu) {  // -inf (masked row) or a slot past the index
    vals[p] = -INFINITY;
    ids[p] = 0;
    return;
  }
  const int k32 = (int)(u ^ 0x80000000u);
  vals[p] = __int_as_float(k32 < 0 ? (k32 ^ 0x7FFFFFFF) : k32);
  ids[p] = (long long)(~(unsigned int)(key & 0xFFFFFFFFull)) + id_offset;
}

}  // namespace

extern "C" {

size_t carca_catalog_topk_smem_bytes(int C, int QB, int d) { return phase1_smem(C, QB, d); }

// buf0: [B, n_chunks, k] u64, buf1: [B, ceil(n_chunks / 2), k] u64 scratch,
// n_chunks = ceil(R / C). vals [B, k] f32, ids [B, k] int64.
int carca_catalog_topk(const void* q, const void* e, void* vals, void* ids, void* buf0,
                       void* buf1, int B, int R, int d, int k, int C, int QB, int lim0,
                       int mask_row0, int id_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = phase1_smem(C, QB, d);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int n = (R + C - 1) / C;
  chunk_topk_kernel<<<dim3(n, (B + QB - 1) / QB), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(e),
      static_cast<u64*>(buf0), B, R, d, k, C, QB, lim0, mask_row0, tile_rows(d));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  u64* src = static_cast<u64*>(buf0);
  u64* dst = static_cast<u64*>(buf1);
  while (n > 1) {
    const int n_out = (n + 1) / 2;
    merge_kernel<<<dim3(n_out, B), kThreads, 0, st>>>(src, dst, n, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    u64* tmp = src;
    src = dst;
    dst = tmp;
    n = n_out;
  }
  const int total = B * k;
  decode_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      src, static_cast<float*>(vals), static_cast<long long*>(ids), total, id_offset);
  return (int)cudaGetLastError();
}

}  // extern "C"
