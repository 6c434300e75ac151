// K3: streaming catalog top-k over an f32, bf16 or int8 index, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel carca_tpu/ops/retrieval_topk.py::_kernel (the
// f32 branch with _extract_topk_inplace, and the packed bf16/int8 branch
// with _extract_topk_packed and _float_key, plus the running-list merge),
// reached from catalog_topk(method="stream"). Plain version:
// carca_tpu_torch/ops/retrieval_topk.py::catalog_topk_plain.
//
// Contract: vals/ids [B, k] = the top-k of s[b, r] = score(q[b], e[r])
// over the index rows r in [0, R), ordered by value descending and, on
// equal values, by lowest row id first (lax.top_k's order). Rows r >=
// lim0, and row 0 when mask_row0, score -inf. Returned ids are r +
// id_offset, and a -inf slot (k beyond the valid rows) returns id 0.
// score() is scoring.cuh's tensor-core routine, the one K4 and the
// tournament's rerank run, so the tournament returns exactly this kernel's
// ids and values.
//
// Keys. Each candidate is ordered by one 64-bit key: the order-preserving
// integer of the score (the _float_key trick of the JAX package, sign bit
// flipped to make it unsigned) in the high word and the complemented row id
// in the low word. Keys are unique per row, ties go to the lowest id, and
// no id bit ever enters a float (the flush-to-zero trap of packing ids
// into mantissas, which a zero query would hit). For bf16 and int8 indexes
// the TPU kernel packs a 12-bit lane id into the low bits of a 32-bit key,
// so its values come back truncated (by at most 2^-11 relative) and its
// near-tie order is unspecified; this kernel keeps the full key for every
// index type, so its values are the true float32 scores and its ids exact.
//
// Design. The TPU kernel extracts k winners per chunk by k rounds of
// max-and-suppress; that is not carried over. Instead:
//   1. select_kernel<T>: one block of 8 warps per (QB <= 8 queries, row
//      split); the splits cut the rows into ranges of a multiple of 128
//      rows, as many as fill the card about two waves deep. The block walks
//      its range in 128-row tiles (rows and int8 scales) copied by cp.async
//      into a ring of two buffers; each warp scores 16 rows against the block's queries (one n8
//      tile, scoring.cuh) and offers each (row, query) key to the query's
//      running list: a key above the query's threshold takes a slot by a
//      shared-memory atomic. A list holds k + slack slots (slack 256 to
//      2048, as shared memory allows); before a tile
//      could overflow it, the query's warp selects the k largest keys by a
//      radix select (8-bit digits from the top; keys are unique, so exactly
//      k keys are >= the k-th), compacts them into the first k slots in
//      place, and raises the threshold to the k-th key. No list is ever
//      sorted here: work grows with the keys that beat the threshold, not
//      with the rows. Each (query, split) writes its k keys, unsorted, to
//      the scratch [B, splits, k] (zeros for empty slots).
//   2. final_kernel: one block per query streams its splits * k keys
//      through the same running list, then sorts the <= k survivors
//      (bitonic, in shared memory) and decodes keys -> (value, id +
//      id_offset), -inf -> id 0.
// The selection is exactly the first k of a full sort of the keys: the
// radix select finds the k-th key exactly and every key above it is kept.
// The scratch is B * splits * k * 8 bytes with splits <= ceil(528 QB / B)
// + 1, independent of R (~20 MB at B = 256, k = 562; the merge tree it
// replaces took B * ceil(R / 1024) * k * 12 bytes, ~17 GB at 10M rows).
// What bounds it on the H100: the products at large B (2 B R d operations,
// on the tensor cores), the index's bytes at small B (R d bytes at int8,
// read once per QB queries; the query blocks of one split run side by
// side and meet in L2), and at small R the threshold's warm-up (the first
// k rows of every split all enter the list).
// Rows wider than 128 columns (kWide) are scored in 128-column chunks: a
// tile's chunks are staged one after another into the first buffer and the
// scores accumulate across them (scoring.cuh, score_acc) before the keys
// are offered; this path keeps no copy in flight.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "scoring.cuh"

namespace {

using carca::AFrag;
using carca::QFrag;
typedef unsigned long long u64;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16 * kWarps;  // rows per tile: one 16-row mma tile per warp
constexpr int kFinalSlack = 2048;      // list slots beyond k in the final pass
constexpr int kMaxQB = kWarps;          // queries per select block: one n8 tile
// below every real key: the key of -inf at the highest row id. Masked rows
// never enter a list, and an empty slot (key 0) decodes as -inf, id 0.
constexpr u64 kFloor = 0x007FFFFFFFFFFFFFull;

__device__ __forceinline__ u64 make_key(float s, long long row) {
  if (s == 0.f) s = 0.f;  // -0.0 and +0.0 compare equal: one key
  const int b = __float_as_int(s);
  const unsigned int u = (unsigned int)(b < 0 ? (b ^ 0x7FFFFFFF) : b) ^ 0x80000000u;
  return ((u64)u << 32) | (u64)(~(unsigned int)row);
}

// The k largest of the n > k distinct keys arr[0..n) into arr[0..k) (any
// order), by one warp; returns the k-th largest. hist: 256 words of this
// warp's shared memory.
__device__ u64 warp_select(u64* arr, int n, int k, unsigned* hist) {
  const int lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  u64 prefix = 0, pmask = 0, kth = 0;
  int want = k;  // rank of the k-th key among the keys matching prefix
  bool found = false;
  for (int shift = 56; shift >= 0 && !found; shift -= 8) {
    for (int u = lane; u < 256; u += 32) hist[u] = 0;
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const u64 x = arr[i];
      if ((x & pmask) == prefix) atomicAdd(hist + ((x >> shift) & 255), 1u);
    }
    __syncwarp();
    // lane l holds bins 255 - 8l - u, u < 8: the digits from the top
    unsigned cnt[8], sum = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) sum += (cnt[u] = hist[255 - 8 * lane - u]);
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const unsigned excl = incl - sum;
    const unsigned owner = __ballot_sync(0xffffffffu, excl < (unsigned)want && (unsigned)want <= incl);
    const int src = __ffs(owner) - 1;
    unsigned bin = 0, above = excl, in_bin = 0;
    if (lane == src) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (in_bin == 0 && above + cnt[u] >= (unsigned)want) {
          bin = 255 - 8 * lane - u;
          in_bin = cnt[u];
        } else if (in_bin == 0) {
          above += cnt[u];
        }
      }
    }
    bin = __shfl_sync(0xffffffffu, bin, src);
    above = __shfl_sync(0xffffffffu, above, src);
    in_bin = __shfl_sync(0xffffffffu, in_bin, src);
    prefix |= (u64)bin << shift;
    pmask |= 0xFFull << shift;
    want -= (int)above;
    if (in_bin == 1 && shift > 0) {  // one key left under the prefix: it is the k-th
      u64 mine = 0;
      for (int i = lane; i < n; i += 32) {
        const u64 x = arr[i];
        if ((x & pmask) == prefix) mine = x;
      }
      const unsigned has = __ballot_sync(0xffffffffu, mine != 0);
      kth = __shfl_sync(0xffffffffu, mine, __ffs(has) - 1);
      found = true;
    }
    __syncwarp();
  }
  if (!found) kth = prefix;
  // keepers beyond k to the front of the tail, in order (writes never pass reads)
  int m = 0;
  for (int base = k; base < n; base += 32) {
    const int i = base + lane;
    const u64 x = i < n ? arr[i] : 0;
    const bool keep = i < n && x >= kth;
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    __syncwarp();
    if (keep) arr[k + m + __popc(bal & lt)] = x;
    m += __popc(bal);
    __syncwarp();
  }
  // then into the holes (keys below the k-th) of the first k slots
  int h = 0;
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    const bool hole = i < k && arr[i] < kth;
    const unsigned bal = __ballot_sync(0xffffffffu, hole);
    if (hole) arr[i] = arr[k + h + __popc(bal & lt)];
    h += __popc(bal);
  }
  __syncwarp();
  return kth;
}

constexpr int kRing = 2;  // tiles in flight (deeper rings cost more than they hid: fewer blocks fit)

// a tile in shared memory: its rows, then their scales
template <typename T, int kD>
__host__ __device__ constexpr int tile_bytes() {
  return kTileRows * (carca::row_stride_bytes<T>(kD) + 4);
}

template <typename T, int kD>
__host__ __device__ constexpr size_t ring_bytes() {
  return kRing * (size_t)tile_bytes<T, kD>();
}

// select_kernel's shared memory: the ring, the lists, thresholds, counts,
// one histogram per warp
size_t lists_bytes(int k, int QB, int slack) {
  return sizeof(u64) * ((size_t)QB * (k + slack) + QB) + sizeof(int) * kMaxQB +
         sizeof(unsigned) * 256 * kWarps;
}

size_t final_bytes(int kpad) {
  return sizeof(u64) * ((size_t)kpad + kFinalSlack + 1) + sizeof(int) * 4 + sizeof(unsigned) * 256;
}

struct SelectArgs {
  const float* q;
  const void* e;
  const float* scales;
  u64* scratch;
  int B, R, d, k, QB, slack, splits, rows_per_split, lim0, mask_row0, vec;
};

template <typename T, int kD, bool kWide>
__global__ void __launch_bounds__(kThreads) select_kernel(const SelectArgs a) {
  constexpr int KS = kD / carca::kStep<T>;
  constexpr int stride = carca::row_stride_bytes<T>(kD);
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  const int cap = a.k + a.slack;
  u64* lists = reinterpret_cast<u64*>(ring + ring_bytes<T, kD>());  // [QB][cap]
  u64* thr = lists + (size_t)a.QB * cap;                              // [QB]
  int* cnt = reinterpret_cast<int*>(thr + a.QB);                      // [kMaxQB]
  unsigned* hist = reinterpret_cast<unsigned*>(cnt + kMaxQB);         // [kWarps][256]

  const T* e = static_cast<const T*>(a.e);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qblocks = (a.B + a.QB - 1) / a.QB;
  const int b0 = (blockIdx.x % qblocks) * a.QB;
  const int split = blockIdx.x / qblocks;
  const int nq = min(a.QB, a.B - b0);
  const long long r_begin = (long long)split * a.rows_per_split;
  const long long r_end = min((long long)a.R, r_begin + a.rows_per_split);
  const int n_tiles = (int)((r_end - r_begin + kTileRows - 1) / kTileRows);

  if (threadIdx.x < a.QB) {
    cnt[threadIdx.x] = 0;
    thr[threadIdx.x] = kFloor;
  }
  // column g: query b0 + g (a padding query past nq)
  const float* my_q = g < nq ? a.q + (size_t)(b0 + g) * a.d : nullptr;
  QFrag<T> bq[KS];
  if constexpr (!kWide) {
#pragma unroll
    for (int s = 0; s < KS; ++s) bq[s] = carca::query_frag<T>(my_q, a.d, s, t);
  }

  constexpr int NR = kRing;
  constexpr int TB = tile_bytes<T, kD>();
  auto stage = [&](int i) {  // tile i into buffer i % NR
    char* buf = ring + (i % NR) * TB;
    const long long row0 = r_begin + (long long)i * kTileRows;
    carca::stage_rows<T>(buf, e, row0, kTileRows, a.R, a.d, kD, stride, a.vec);
    carca::stage_scales(reinterpret_cast<float*>(buf + kTileRows * stride), a.scales, row0,
                        kTileRows, a.R);
  };
  // offer tile i's scores c (this warp's rows, scl their int8 scales) to the lists
  auto offer = [&](int i, const float (&c)[4], const float* scl) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r_begin + (long long)i * kTileRows + 16 * warp + g + 8 * h;
      const bool live = row < r_end && carca::row_valid((int)row, a.lim0, a.mask_row0);
      const float sc = a.scales != nullptr ? scl[16 * warp + g + 8 * h] : 1.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int qi = 2 * t + u;
        if (!live || qi >= nq) continue;
        const u64 key = make_key(carca::finish<T>(c[2 * h + u], sc, true), row);
        if (key > thr[qi]) lists[(size_t)qi * cap + atomicAdd(cnt + qi, 1)] = key;
      }
    }
  };
  auto select_own = [&](int keep_above) {  // the warp of query `warp` trims its list
    if (warp < nq && cnt[warp] > keep_above) {
      const u64 kth = warp_select(lists + (size_t)warp * cap, cnt[warp], a.k, hist + 256 * warp);
      if (lane == 0) {
        cnt[warp] = a.k;
        thr[warp] = kth;
      }
    }
  };

  if constexpr (kWide) {
    const int nch = carca::score_chunks(a.d);
    const float* scl = reinterpret_cast<const float*>(ring + kTileRows * stride);
    for (int i = 0; i < n_tiles; ++i) {
      const long long row0 = r_begin + (long long)i * kTileRows;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ch = 0; ch < nch; ++ch) {
        carca::stage_rows<T>(ring, e, row0, kTileRows, a.R, a.d, kD, stride, a.vec, ch * kD);
        if (ch == 0)
          carca::stage_scales(reinterpret_cast<float*>(ring + kTileRows * stride), a.scales,
                              row0, kTileRows, a.R);
        carca::cp_async_commit();
        carca::cp_async_wait<0>();
        __syncthreads();  // the chunk is in
        carca::chunk_query_frags<T, KS>(bq, my_q, a.d, ch, t);
        AFrag<T> af[KS];
        carca::load_a<T, KS>(af, ring + (16 * warp + g) * stride, stride, t);
        carca::score_acc<T, KS>(c, af, bq);
        __syncthreads();  // the buffer is free for the next chunk
      }
      offer(i, c, scl);
      __syncthreads();  // every key of tile i is in; the scales are free
      select_own(cap - kTileRows);
    }
  } else {
#pragma unroll
  for (int i = 0; i < NR - 1; ++i) {
    if (i < n_tiles) stage(i);
    carca::cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    if (i + NR - 1 < n_tiles) stage(i + NR - 1);  // the buffer tile i - 1 used
    carca::cp_async_commit();
    carca::cp_async_wait<NR - 1>();
    __syncthreads();  // tile i is in; the lists' merges of tile i - 1 are done
    const char* buf = ring + (i % NR) * TB;
    const float* scl = reinterpret_cast<const float*>(buf + kTileRows * stride);
    AFrag<T> af[KS];
    carca::load_a<T, KS>(af, buf + (16 * warp + g) * stride, stride, t);
    float c[4];
    carca::score_tile<T, KS>(c, af, bq);
    offer(i, c, scl);
    __syncthreads();              // every key of tile i is in; its buffer is free
    select_own(cap - kTileRows);  // the next tile must fit
  }
  }
  __syncthreads();
  select_own(a.k);
  __syncwarp();
  if (warp < nq) {
    const u64* list = lists + (size_t)warp * cap;
    u64* out = a.scratch + ((size_t)(b0 + warp) * a.splits + split) * a.k;
    const int n = cnt[warp];
    for (int j = lane; j < a.k; j += 32) out[j] = j < n ? list[j] : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
final_kernel(const u64* __restrict__ scratch, float* __restrict__ vals,
             long long* __restrict__ ids, int k, int splits, int kpad, long long id_offset) {
  extern __shared__ float4 smem4[];
  u64* keys = reinterpret_cast<u64*>(smem4);  // [kpad + kFinalSlack]
  u64* thr = keys + kpad + kFinalSlack;
  int* cnt = reinterpret_cast<int*>(thr + 1);
  unsigned* hist = reinterpret_cast<unsigned*>(cnt + 4);
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const u64* src = scratch + (size_t)b * splits * k;
  const int total = splits * k;
  const int cap = k + kFinalSlack;
  auto trim = [&](int keep_above) {
    if (warp == 0 && *cnt > keep_above) {
      const u64 kth = warp_select(keys, *cnt, k, hist);
      if (threadIdx.x == 0) {
        *cnt = k;
        *thr = kth;
      }
    }
  };
  if (threadIdx.x == 0) {
    *cnt = 0;
    *thr = kFloor;
  }
  for (int base = 0; base < total; base += kThreads) {
    __syncthreads();
    trim(cap - kThreads);
    __syncthreads();
    const int i = base + threadIdx.x;
    const u64 key = i < total ? src[i] : 0;
    const bool in = key > *thr;
    const unsigned ins = __ballot_sync(0xffffffffu, in);  // one atomic per warp
    int slot = 0;
    if (ins != 0 && lane == __ffs(ins) - 1) slot = atomicAdd(cnt, __popc(ins));
    slot = __shfl_sync(0xffffffffu, slot, ins ? __ffs(ins) - 1 : 0) +
           __popc(ins & ((1u << lane) - 1u));
    if (in) keys[slot] = key;
  }
  __syncthreads();
  trim(k);
  __syncthreads();
  const int n = *cnt;
  for (int i = n + threadIdx.x; i < kpad; i += kThreads) keys[i] = 0;
  __syncthreads();
  // bitonic sort of the kpad keys, descending
  const int half = kpad / 2;
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < half; p += kThreads) {
        const int i = 2 * p - (p & (stride - 1));
        const u64 x = keys[i], y = keys[i + stride];
        if ((x < y) == ((i & size) == 0)) {
          keys[i] = y;
          keys[i + stride] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const u64 key = keys[j];
    const unsigned int u = (unsigned int)(key >> 32);
    const size_t o = (size_t)b * k + j;
    if (u <= 0x007FFFFFu) {  // -inf (masked row) or an empty slot
      vals[o] = -INFINITY;
      ids[o] = 0;
    } else {
      const int k32 = (int)(u ^ 0x80000000u);
      vals[o] = __int_as_float(k32 < 0 ? (k32 ^ 0x7FFFFFFF) : k32);
      ids[o] = (long long)(~(unsigned int)(key & 0xFFFFFFFFull)) + id_offset;
    }
  }
}

int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

struct SelectSmem {
  int k, QB, slack;
  size_t* out;
  template <typename T, int kD, bool kWide>
  int operator()() const {
    *out = ring_bytes<T, kD>() + lists_bytes(k, QB, slack);
    return 0;
  }
};

struct Launch {
  SelectArgs a;
  float* vals;
  long long* ids;
  long long id_offset;
  cudaStream_t st;
  template <typename T, int kD, bool kWide>
  int operator()() const {
    const size_t smem = ring_bytes<T, kD>() + lists_bytes(a.k, a.QB, a.slack);
    int kpad = 1;
    while (kpad < a.k) kpad <<= 1;
    const size_t fsmem = final_bytes(kpad);
    int err = set_smem((const void*)select_kernel<T, kD, kWide>, smem);
    if (err == 0) err = set_smem((const void*)final_kernel, fsmem);
    if (err != 0) return err;
    SelectArgs args = a;
    args.vec = carca::vec_rows<T>(a.e, a.d);
    if (!std::is_same<T, int8_t>::value) args.scales = nullptr;
    const long long qblocks = (a.B + a.QB - 1) / a.QB;
    select_kernel<T, kD, kWide><<<(unsigned)(qblocks * a.splits), kThreads, smem, st>>>(args);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    final_kernel<<<(unsigned)a.B, kThreads, fsmem, st>>>(a.scratch, vals, ids, a.k, a.splits,
                                                          kpad, id_offset);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// shared memory of the select pass (the final pass takes (pow2(k) + 2049) *
// 8 bytes and 1 KB more)
size_t carca_catalog_topk_smem_bytes(int k, int QB, int slack, int d, int dtype) {
  size_t out = 0;
  carca::dispatch_index(dtype, d, SelectSmem{k, QB, slack, &out});
  return out;
}

// q [B, d] f32; e: [R, d] of the type dtype names (carca::IndexType), any
// d >= 1; scales: [R] f32 for an int8 index, else null. scratch: [B, splits,
// k] u64, splits = ceil(R / rows_per_split), rows_per_split a multiple of
// 128; 1 <= QB <= 8; slack >= 256 list slots beyond k. vals [B, k] f32, ids [B, k] int64.
int carca_catalog_topk(const void* q, const void* e, const void* scales, void* vals,
                       void* ids, void* scratch, int B, int R, int d, int k, int QB,
                       int slack, int splits, int rows_per_split, int lim0, int mask_row0,
                       long long id_offset, int dtype, void* stream) {
  if (QB < 1 || QB > kMaxQB || slack < 2 * kTileRows || rows_per_split % kTileRows != 0)
    return (int)cudaErrorInvalidValue;
  const SelectArgs a{static_cast<const float*>(q), e, static_cast<const float*>(scales),
                     static_cast<u64*>(scratch), B, R, d, k, QB, slack, splits, rows_per_split,
                     lim0, mask_row0, 0};
  return carca::dispatch_index(
      dtype, d, Launch{a, static_cast<float*>(vals), static_cast<long long*>(ids), id_offset,
                       static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
