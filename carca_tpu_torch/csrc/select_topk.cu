// The select kernel: lax.top_k's counterpart on the card, for Hopper
// (sm_90a).
//
// Replaces no pallas_call: the JAX package's tournament selects with
// jax.lax.top_k (carca_tpu/ops/retrieval_topk.py:481, the k + 8 best of the
// [B, G] group maxima; :520, the final k of the reranked scores; the
// recursive branch :444 and :453), which XLA runs there. Reached from
// carca_tpu_torch/ops/retrieval_topk.py::select_topk (the tournament's
// stage 2 and final top-k). Plain version: select_topk_plain (a stable sort
// by the same keys).
//
// Contract: for each of B rows of v (float32 at v[b * sb + n * sn], any
// strides), the k largest of its N values by the 64-bit key of select.cuh
// (value, then the lowest position): values in lax.top_k's total order
// (-0.0 below +0.0), so the selection is exactly the first k of lax.top_k.
//   value mode: vals [B, k] descending and ids [B, k]; position p's id is
//     gi[b, p / 128] * 128 + p % 128 + id_offset, gi [B, N / 128] int64 (the
//     tournament's winner groups), or p + id_offset without gi; a -inf value
//     gets id 0, and k > N pads with (-inf, 0).
//   position mode: ids [B, k] = the selected positions, ascending (k <= N).
//
// Design. A block of 256 threads streams keys through one running list in
// shared memory (k + 4,096 slots) with a threshold, 2,048 keys a step (8
// loads a thread issued together): a key above the threshold is appended,
// one shared atomic per warp. Before a step could overflow the list, the
// whole block trims it by a radix select (select.cuh, block_select: 8-bit
// digits from the highest bit where the keys differ, every thread counting
// into one histogram) to its k largest keys and at most 1,024 more (half
// the room a step may need left free, so trims stay rare), and the
// threshold rises to their bound. At the end the list is trimmed to exactly
// its k largest (the keys are unique, so the k largest are exactly those
// at or above the last bound). A long row is cut into splits
// (ops/retrieval_topk.py, select_plan): pass 1, a block per (row, split),
// writes each split's k largest keys, unsorted, to a scratch [B, splits, k]
// (0 = empty); pass 2, a block per row, streams the row's splits * k keys
// the same way. A row of one split runs one pass. The last pass sorts the k
// keys (bitonic, in shared memory), by key or by position, and writes them.
// What bounds it: the bytes of v, read once (B * N * 4: 80 MB at the 10M
// serving shape, 24 us at 3.35 TB/s), once the threshold turns most values
// away; a split of n values inserts about k (1 + ln(n / k)) of them, and
// each trim reads the list a few times. Each step's loads are issued a step
// ahead, so their latency overlaps the step before. A row read across a
// column-major matrix (K4's [G, B] as [B, G]) uses 4 bytes of every 32-byte
// sector a load touches: that read moves eight times the bytes through L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "select.cuh"

namespace {

using carca::u64;

constexpr int kThreads = 256;
constexpr int kPer = 8;                    // keys a thread loads a step
constexpr int kStep = kThreads * kPer;     // keys a block takes a step
constexpr int kSlack = 2 * kStep;          // list slots beyond k
constexpr int kGroup = 128;                // rows of a tournament group
constexpr int kMaxK = 16384;               // the list and the final sort fit shared memory

struct Args {
  const float* v;
  long long sb, sn;
  int B, N, k, splits, per_split, kpad, positions, kg;
  u64* scratch;        // [B, splits, k] when splits > 1
  float* vals;         // [B, k], value mode
  long long* ids;      // [B, k]
  const long long* gi; // [B, kg] or null
  long long id_offset;
};

struct Control {
  u64 thr;
  int cnt;
  carca::BlockSelectShared sel;
};

__host__ __device__ inline int list_cap(int k, int kpad) {
  return k + kSlack > kpad ? k + kSlack : kpad;
}

size_t smem_bytes(int k, int kpad) { return sizeof(u64) * list_cap(k, kpad) + sizeof(Control); }

// kFromScratch: the row's splits * k keys of pass 1 (else the values of
// split blockIdx.x % splits of row blockIdx.x / splits); kLast: sort and
// write the answer (else the split's k largest keys to the scratch).
template <bool kFromScratch, bool kLast>
__global__ void __launch_bounds__(kThreads) select_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int cap = list_cap(a.k, a.kpad);
  u64* keys = reinterpret_cast<u64*>(smem4);
  Control* c = reinterpret_cast<Control*>(keys + cap);
  const int parts = kFromScratch ? 1 : a.splits;
  const int b = blockIdx.x / parts, split = blockIdx.x % parts;
  const long long n0 = (long long)split * a.per_split;
  const int total = kFromScratch ? a.splits * a.k
                                 : (int)(a.N - n0 < a.per_split ? a.N - n0 : a.per_split);
  const u64* src = a.scratch + (size_t)b * a.splits * a.k;
  const float* row = a.v + (long long)b * a.sb;

  // down to the k largest keys and at most `loose` more (all threads)
  auto trim = [&](int loose) {
    int kept;
    const u64 lo = carca::block_select<kThreads>(keys, c->cnt, a.k, loose, &c->sel, &kept);
    if (threadIdx.x == 0) {
      c->cnt = kept;
      c->thr = lo - 1;
    }
  };
  if (threadIdx.x == 0) {
    c->cnt = 0;
    c->thr = 0;  // every real key is above 0; an empty scratch slot is 0
  }
  // a step's loads: the scratch keys, or the values, at base + u * kThreads
  // + threadIdx.x, u < kPer
  typedef typename std::conditional<kFromScratch, u64, float>::type Raw;
  auto fetch = [&](Raw* raw, int base) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if constexpr (kFromScratch)
        raw[u] = i < total ? src[i] : 0;
      else
        raw[u] = i < total ? row[(n0 + i) * a.sn] : 0.f;
    }
  };
  Raw next[kPer];
  fetch(next, 0);
  for (int base = 0; base < total; base += kStep) {
    Raw cur[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) cur[u] = next[u];
    if (base + kStep < total) fetch(next, base + kStep);  // in flight during this step
    __syncthreads();
    if (c->cnt > cap - kStep) trim((cap - kStep - a.k) / 2);  // half the room left free
    __syncthreads();
    const u64 th = c->thr;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      u64 key;
      if constexpr (kFromScratch)
        key = cur[u];
      else
        key = i < total ? carca::make_key(cur[u], n0 + i) : 0;
      carca::offer_key(key, th, keys, &c->cnt);
    }
  }
  __syncthreads();
  if (c->cnt > a.k) trim(0);
  __syncthreads();
  const int n = c->cnt;  // min(k, the keys offered)

  if (!kLast) {
    u64* out = a.scratch + ((size_t)b * a.splits + split) * a.k;
    for (int j = threadIdx.x; j < a.k; j += kThreads) out[j] = j < n ? keys[j] : 0;
    return;
  }
  const size_t o = (size_t)b * a.k;
  if (a.positions) {  // by position: ~position descending, empty slots (0) last
    for (int j = threadIdx.x; j < a.kpad; j += kThreads)
      keys[j] = j < n ? (keys[j] & 0xFFFFFFFFull) : 0;
    __syncthreads();
    carca::bitonic_sort_desc<kThreads>(keys, a.kpad);
    for (int j = threadIdx.x; j < a.k; j += kThreads) a.ids[o + j] = carca::key_pos(keys[j]);
    return;
  }
  for (int j = n + threadIdx.x; j < a.kpad; j += kThreads) keys[j] = 0;
  __syncthreads();
  carca::bitonic_sort_desc<kThreads>(keys, a.kpad);
  for (int j = threadIdx.x; j < a.k; j += kThreads) {
    const u64 key = keys[j];
    const float v = key == 0 ? -INFINITY : carca::key_value(key);
    long long id = 0;
    if (v > -INFINITY) {
      const long long p = carca::key_pos(key);
      id = (a.gi != nullptr ? a.gi[(size_t)b * a.kg + p / kGroup] * kGroup + p % kGroup : p) +
           a.id_offset;
    }
    a.vals[o + j] = v;
    a.ids[o + j] = id;
  }
}

int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// shared memory of a block of either pass at this k
size_t carca_select_topk_smem_bytes(int k) { return smem_bytes(k, pow2_at_least(k)); }

// v: float32 at v[b * sb + n * sn] (b < B, n < N), 1 <= k <= 16,384;
// splits blocks a row in pass 1, per_split values each (splits * per_split
// >= N); scratch [B, splits, k] u64 when splits > 1. positions = 1: ids [B,
// k] int64 the ascending positions (k <= N; vals, gi unused); positions =
// 0: vals [B, k] float32 and ids [B, k] int64 (gi [B, kg] int64 with N = kg
// * 128, or null).
int carca_select_topk(const void* v, long long sb, long long sn, int B, int N, int k,
                      int splits, int per_split, int positions, const void* gi, int kg,
                      long long id_offset, void* scratch, void* vals, void* ids, void* stream) {
  if (B < 1 || N < 1 || k < 1 || k > kMaxK || splits < 1 || per_split < 1 ||
      (long long)splits * per_split < N || (long long)(splits - 1) * per_split >= N ||
      (positions && k > N) || (gi != nullptr && (long long)kg * kGroup != N) ||
      (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(v), sb, sn, B, N, k, splits, per_split, pow2_at_least(k),
         positions, kg, static_cast<u64*>(scratch), static_cast<float*>(vals),
         static_cast<long long*>(ids), static_cast<const long long*>(gi), id_offset};
  const size_t smem = smem_bytes(k, a.kpad);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (splits == 1) {
    err = set_smem((const void*)select_kernel<false, true>, smem);
    if (err != 0) return err;
    select_kernel<false, true><<<(unsigned)B, kThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  err = set_smem((const void*)select_kernel<false, false>, smem);
  if (err == 0) err = set_smem((const void*)select_kernel<true, true>, smem);
  if (err != 0) return err;
  select_kernel<false, false><<<(unsigned)((long long)B * splits), kThreads, smem, st>>>(a);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  select_kernel<true, true><<<(unsigned)B, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
