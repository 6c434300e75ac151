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
// Design: one launch a call. A block takes QB rows ("queries": 1, 2, 4 or
// 8) over one split of their positions; a query group's splits (at most 8)
// are one thread-block cluster. Plan: ops/retrieval_topk.py, select_plan
// (queries a block and splits from the clusters an H100 holds at once).
// - The read. A producer warp keeps a ring of up to 24 slots of 16 KB
//   (4,096 values: QB queries x 4,096 / QB positions) in flight under
//   mbarriers, each slot one to sixteen tensor copies (TMA) of 256
//   positions x QB queries. Over K4's group-major [G, B] read as [B, G]
//   (stage 2: sb = 1) a box is [256 positions][QB = 8 or 4 queries], a
//   whole or half 32-byte sector a row (at 8, a 32-byte swizzle, so that a
//   warp reading its query's column meets 4-way bank conflicts, not 8);
//   over rows (sn = 1: the final top-k) a box is [QB rows][256 positions].
//   Where a tensor map cannot describe the view (a pointer or stride not a
//   multiple of 16 bytes, overlapping rows, other strides) the producer's
//   lanes copy the same slots with plain loads. Positions past the split's
//   end and rows past B are never offered (a box's out-of-bounds zeros are
//   real keys).
// - The lists. 16 consumer warps, G = 16 / QB a query, each reading its
//   256 positions of every slot (8 keys a lane, all loaded before any is
//   compared, the 64-bit compare done on the 32-bit value word first, one
//   ballot per key). Each query has a running list of cap = k + slack keys
//   and a threshold: a key above it is appended (one atomic per warp and
//   slot where G > 1). After releasing a slot, the query's group trims its
//   list if the next slot could overflow it, by a radix select
//   (select.cuh, group_select: loads batched ahead of the histogram
//   atomics; a named barrier a group) to its k largest and half the free
//   room more, and the threshold rises to their bound; at the split's end
//   an exact trim leaves the split's k largest keys.
// - The merge. After a cluster barrier, rank r merges the queries r, r +
//   splits, ...: the whole block a query at a time, or one warp a query
//   where every merge is small (at most 256 keys). Each query's lists of
//   every split are gathered into the ring (distributed shared memory),
//   the k largest selected exactly and sorted (select.cuh, sort_desc_regs:
//   in registers and shuffles, unrolled at kpad 128 and 1,024; by position
//   on the 32-bit low words; past 8 keys a thread in shared memory), and
//   the answer written. A second cluster barrier keeps every block's lists
//   alive until they are read. No global scratch, no second launch.
// Shared memory a block (smem_bytes; ops/retrieval_topk.py::_select_smem is
// the same formula): 1 KB of alignment, slots x 16 KB of ring, QB x (cap x
// 8 + 1,280) of lists and their controls, 16 bytes a slot of mbarriers;
// slack = max(1,024, 512 G), cap at least kpad. At k + 8 = 570, QB = 4
// (the 10M bucket-256 stage 2): 4 x (2,618 x 8 + 1,280) = 88,896 bytes of
// lists and 8 slots, 221,120 bytes in all, one block an SM; at QB = 8, 7
// slots (228,080 bytes); at k = 16,384 and QB = 1, 197,888 bytes of list
// and 2 slots (231,712 of the 232,448 a block may have).
// What bounds it: the bytes of v, read once (B * N * 4: 80 MB at the 10M
// serving shape, 24 us at 3.35 TB/s). A split of n values inserts about
// k (1 + ln(n / k)) of them, each trim reads its list a few times, and the
// merge is a chain of its own; one block an SM and at most 30 clusters of
// 4 (15 of 8) resident bound the launch's parallelism (PERF.md §6).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "mbarrier.cuh"
#include "select.cuh"

namespace {

namespace cg = cooperative_groups;
using carca::u64;

constexpr int kConsumers = 16;                    // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);   // and the producer warp
constexpr int kSortThreads = 32 * kConsumers;     // sort_desc_regs's threads
constexpr int kBox = 256;                         // positions a tensor copy
constexpr int kSlotValues = kBox * kConsumers;    // values a ring slot
constexpr int kSlotBytes = kSlotValues * 4;
constexpr int kMaxSlots = 24;
constexpr int kCtlBytes = 1280;                   // a query's control block
constexpr int kGroup = 128;                       // rows of a tournament group
constexpr int kMaxK = 16384;
constexpr int kMaxSplits = 8;                     // a portable cluster
constexpr int kSortBarrier = 9;                   // named barriers 1-8: the query groups
constexpr int kWarpMergeKeys = 256;               // merges of at most this many keys: a warp a query

struct Args {
  const float* v;
  long long sb, sn;
  int B, N, k, splits, per_split, kpad, slots, positions, kg, tma;
  float* vals;          // [B, k], value mode
  long long* ids;       // [B, k]
  const long long* gi;  // [B, kg] or null
  long long id_offset;
};

// a query's list: its threshold, its count and its select scratch
struct Ctl {
  u64 thr;
  int cnt;
  int pad;
  carca::BlockSelectShared sel;
};
static_assert(sizeof(Ctl) <= kCtlBytes, "a query's control block");

// list slots beyond k: two slots' keys of a query's group, at least 1,024
__host__ __device__ inline int slack_of(int qb) {
  const int slot = kBox * (kConsumers / qb);
  return 2 * slot > 1024 ? 2 * slot : 1024;
}

__host__ __device__ inline int list_cap(int k, int kpad, int qb) {
  return k + slack_of(qb) > kpad ? k + slack_of(qb) : kpad;
}

size_t smem_bytes(int k, int kpad, int qb, int slots) {
  return 1024 + (size_t)slots * kSlotBytes +
         (size_t)qb * ((size_t)list_cap(k, kpad, qb) * 8 + kCtlBytes) + 16 * (size_t)slots;
}

// where a ring slot keeps query q's value at position pl of the slot
template <int QB, bool kCol>
__device__ __forceinline__ int slot_at(int q, int pl) {
  if constexpr (kCol) {
    const int e = pl * QB + q;                           // boxes of [256][QB]
    return QB == 8 ? e ^ (((e >> 5) & 1) << 2) : e;      // the 32-byte swizzle
  } else {
    return pl / kBox * (kBox * QB) + q * kBox + pl % kBox;  // boxes of [QB][256]
  }
}

// the kpad slots of keys, sorted descending (kPos: by the complemented
// positions of the low words) by a team of TT threads: in registers and
// shuffles (sort_desc_regs) up to 8 keys a thread, unrolled at the
// tournament's kpad (128: k + 8 = 68 and k = 60; 1,024: k + 8 = 570 and k =
// 562); past that through shared memory
template <int TT, bool kPos, typename Sync>
__device__ __forceinline__ void sort_kept(u64* keys, int kpad, int tid, Sync sync) {
  if (kpad > 8 * TT) {
    if (kPos) {
      for (int t = tid; t < kpad; t += TT) keys[t] &= 0xFFFFFFFFull;
      sync();
    }
    carca::bitonic_sort_desc<TT>(keys, kpad, tid, sync);
    sync();
    return;
  }
  const int per = kpad / TT;  // keys a thread holds: 0 (fewer than TT), 1-8
  if constexpr (1024 / TT >= 1 && 1024 / TT <= 8)
    if (kpad == 1024) return carca::sort_desc_regs<1024 / TT, kPos, 10>(keys, kpad, tid, sync);
  if constexpr (128 / TT >= 1 && 128 / TT <= 8)
    if (kpad == 128) return carca::sort_desc_regs<128 / TT, kPos, 7>(keys, kpad, tid, sync);
  if (per <= 1) carca::sort_desc_regs<1, kPos, -1>(keys, kpad, tid, sync);
  else if (per == 2) carca::sort_desc_regs<2, kPos, -1>(keys, kpad, tid, sync);
  else if (per == 4) carca::sort_desc_regs<4, kPos, -1>(keys, kpad, tid, sync);
  else carca::sort_desc_regs<8, kPos, -1>(keys, kpad, tid, sync);
}

// the sorted keys[0..k) of row b as the answer, by `threads` threads
// (tid < threads)
__device__ __forceinline__ void write_kept(const Args& a, const u64* keys, int b, int tid,
                                           int threads) {
  const size_t o = (size_t)b * a.k;
  for (int t = tid; t < a.k; t += threads) {
    const u64 key = keys[t];
    if (a.positions) {
      a.ids[o + t] = carca::key_pos(key);
      continue;
    }
    const float v = key == 0 ? -INFINITY : carca::key_value(key);
    long long id = 0;
    if (v > -INFINITY) {
      const long long p = carca::key_pos(key);
      id = (a.gi != nullptr ? a.gi[(size_t)b * a.kg + p / kGroup] * kGroup + p % kGroup : p) +
           a.id_offset;
    }
    a.vals[o + t] = v;
    a.ids[o + t] = id;
  }
}

// The small merges of a cluster's lists (at most kWarpMergeKeys keys a
// query): rank r takes queries r, r + splits, ..., consumer warp w every
// kConsumers-th of them, in a ring region of its own: the query's lists of
// every split gathered there (distributed shared memory; one split: its
// own list), the k largest selected exactly, sorted in registers and
// shuffles, written. Not inlined: its registers stay out of the streaming
// loop's.
template <int QB>
__device__ __noinline__ void merge_queries(const Args& a, u64* lists, int cap, uint8_t* ctls,
                                           u64* ring, int q0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)blockIdx.x;
  const int warp = (int)threadIdx.x / 32, lane = (int)threadIdx.x % 32;
  auto sync = [] { __syncwarp(); };
  u64* region = ring + (size_t)warp * kWarpMergeKeys;
  for (int q = split + warp * a.splits; q < QB && q0 + q < a.B; q += kConsumers * a.splits) {
    Ctl* c = reinterpret_cast<Ctl*>(ctls + (size_t)q * kCtlBytes);
    u64* keys = a.splits == 1 ? lists + (size_t)q * cap : region;
    int n = c->cnt;
    if (a.splits > 1) {
      n = 0;
      for (int r = 0; r < a.splits; ++r) {
        const u64* src = cluster.map_shared_rank(lists + (size_t)q * cap, r);
        const int m = cluster.map_shared_rank(c, r)->cnt;
        for (int t = lane; t < m; t += 32) keys[n + t] = src[t];
        n += m;
      }
      sync();
      if (n > a.k) {  // exactly the k largest (the keys are distinct)
        int kept;
        carca::group_select<32>(keys, n, a.k, 0, &c->sel, &kept, lane, sync);
        n = kept;
      }
    }
    for (int t = n + lane; t < a.kpad; t += 32) keys[t] = 0;  // empty: last
    sync();
    if (a.positions)
      sort_kept<32, true>(keys, a.kpad, lane, sync);
    else
      sort_kept<32, false>(keys, a.kpad, lane, sync);
    write_kept(a, keys, q0 + q, lane, 32);
    sync();
  }
}

// kCol: v read as a column-major matrix (sn != 1: K4's [G, B] as [B, G]),
// boxes of [256 positions][QB queries]; else as rows (sn = 1), boxes of
// [QB rows][256 positions]. Grid (splits, query groups), clusters of
// (splits, 1, 1).
template <int QB, bool kCol>
__global__ void __launch_bounds__(kThreads, 1)
    select_kernel(const __grid_constant__ Args a, const __grid_constant__ CUtensorMap map) {
  constexpr int G = kConsumers / QB;  // warps a query
  constexpr int P = kBox * G;         // positions a slot
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* base = smem + ((1024 - (carca::smem_addr(smem) & 1023)) & 1023);
  float* ring = reinterpret_cast<float*>(base);
  const int cap = list_cap(a.k, a.kpad, QB);
  u64* lists = reinterpret_cast<u64*>(base + (size_t)a.slots * kSlotBytes);
  uint8_t* ctls = reinterpret_cast<uint8_t*>(lists + (size_t)QB * cap);
  auto ctl = [&](int q) { return reinterpret_cast<Ctl*>(ctls + (size_t)q * kCtlBytes); };
  unsigned long long* full = reinterpret_cast<unsigned long long*>(ctls + QB * kCtlBytes);
  unsigned long long* empty = full + a.slots;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)blockIdx.x;  // the block's rank in its cluster
  const int q0 = (int)blockIdx.y * QB;
  const long long n0 = (long long)split * a.per_split;
  const long long n_end = min((long long)a.N, n0 + a.per_split);
  const int n_slots = (int)((n_end - n0 + P - 1) / P);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.slots; ++s) {
      carca::mbar_init(full + s, 1);               // the producer's lane 0
      carca::mbar_init(empty + s, kConsumers);     // each consumer warp
    }
    carca::mbar_init_fence();
  }
  if (threadIdx.x < QB) {
    ctl(threadIdx.x)->cnt = 0;
    ctl(threadIdx.x)->thr = 0;  // every real key is above 0
  }
  __syncthreads();

  if (warp == kConsumers) {
    // the producer: slot i holds positions n0 + i P .. of queries q0 ..
    for (int i = 0; i < n_slots; ++i) {
      const int s = i % a.slots;
      if (i >= a.slots) carca::mbar_wait(empty + s, (i / a.slots - 1) & 1);
      float* slot = ring + (size_t)s * kSlotValues;
      const long long ps = n0 + (long long)i * P;
      if (a.tma) {
        if (lane == 0) {
          const int boxes = (int)min((long long)G, (n_end - ps + kBox - 1) / kBox);
          carca::mbar_arrive_expect_tx(full + s, (uint32_t)(boxes * kBox * QB * 4));
          for (int j = 0; j < boxes; ++j) {
            if constexpr (kCol)
              carca::tma_load_2d(slot + j * kBox * QB, &map, q0, (int)(ps + j * kBox), full + s);
            else
              carca::tma_load_2d(slot + j * kBox * QB, &map, (int)(ps + j * kBox), q0, full + s);
          }
        }
      } else {  // plain loads, eight a lane in flight
        for (int e0 = 0; e0 < kSlotValues; e0 += 32 * 8) {
          float x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + 32 * u + lane;
            const int q = kCol ? e % QB : e / P, pl = kCol ? e / QB : e % P;
            const long long p = ps + pl;
            x[u] = p < n_end && q0 + q < a.B ? a.v[(long long)(q0 + q) * a.sb + p * a.sn] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + 32 * u + lane;
            const int q = kCol ? e % QB : e / P, pl = kCol ? e / QB : e % P;
            slot[slot_at<QB, kCol>(q, pl)] = x[u];
          }
        }
        __syncwarp();
        if (lane == 0) carca::mbar_arrive(full + s);
      }
    }
  } else {
    // consumer warp j of query q's group: box j of every slot (positions
    // 256 j .. 256 j + 255), 8 keys a lane. One warp (G = 1) keeps its
    // list's count and threshold in registers; a group keeps them in its
    // control block, and a warp adds a slot's keys with one atomic.
    const int q = warp / G, j = warp % G;
    const bool live = q0 + q < a.B;
    Ctl* c = ctl(q);
    u64* list = lists + (size_t)q * cap;
    const unsigned lt = (1u << lane) - 1u;
    int cnt = 0;  // G = 1: the list's count and threshold
    u64 thr = 0;
    auto gsync = [&] {
      if constexpr (G == 1)
        __syncwarp();
      else
        carca::named_barrier(1 + q, 32 * G);
    };
    // down to the k largest keys and at most `loose` more (the group)
    auto trim = [&](int loose) {
      int kept;
      const u64 lo = carca::group_select<32 * G>(list, G == 1 ? cnt : c->cnt, a.k, loose,
                                                 &c->sel, &kept, (int)threadIdx.x - 32 * G * q,
                                                 gsync);
      if constexpr (G == 1) {
        cnt = kept;
        thr = lo - 1;
      } else if (j == 0 && lane == 0) {
        c->cnt = kept;
        c->thr = lo - 1;
      }
    };
    static_assert(kSlotValues / (kBox * G) == QB, "a slot: QB queries x G boxes");
    for (int i = 0; i < n_slots; ++i) {
      const int s = i % a.slots;
      carca::mbar_wait(full + s, (i / a.slots) & 1);
      if (live) {
        const u64 th = G == 1 ? thr : c->thr;  // a group's: settled by the last slot's barriers
        const float* slot = ring + (size_t)s * kSlotValues;
        const int p0 = (int)(n0 + (long long)i * P) + kBox * j + lane;  // positions < 2^31
        // a key is above th where its value word is above th's, or equal
        // with its position word above th's; the slot's values are all
        // loaded first, and no branch sits between them and the ballots
        const unsigned th_hi = (unsigned)(th >> 32), th_lo = (unsigned)th;
        const bool whole = n0 + (long long)(i + 1) * P <= n_end;  // no position past the split
        unsigned word[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          word[u] = __float_as_uint(slot[slot_at<QB, kCol>(q, kBox * j + 32 * u + lane)]);
        unsigned in[8];
        int add = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          word[u] = carca::value_word(__uint_as_float(word[u]));
          bool above =
              (word[u] > th_hi) | ((word[u] == th_hi) & (~(unsigned)(p0 + 32 * u) > th_lo));
          if (!whole) above &= p0 + 32 * u < n_end;
          in[u] = __ballot_sync(carca::kFullMask, above);
          add += __popc(in[u]);
        }
        if (add != 0) {  // the warp's keys above the threshold, appended in order
          int at;
          if constexpr (G == 1) {
            at = cnt;
            cnt += add;
          } else {
            if (lane == 0) at = atomicAdd(&c->cnt, add);
            at = __shfl_sync(carca::kFullMask, at, 0);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if ((in[u] >> lane) & 1u)
              list[at + __popc(in[u] & lt)] =
                  ((u64)word[u] << 32) | (u64)(~(unsigned)(p0 + 32 * u));
            at += __popc(in[u]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) carca::mbar_arrive(empty + s);
      if (live) {  // room for the next slot, trimmed with this one released
        if constexpr (G == 1) {
          if (cnt > cap - P) trim((cap - P - a.k) / 2);  // half the room left free
        } else {
          gsync();
          if (c->cnt > cap - P) trim((cap - P - a.k) / 2);
          gsync();
        }
      }
    }
    if (live) {
      if constexpr (G == 1) {
        if (cnt > a.k) trim(0);  // the split's k largest (the keys are distinct)
        if (lane == 0) c->cnt = cnt;
      } else {
        gsync();
        if (c->cnt > a.k) trim(0);
        gsync();
      }
    }
  }

  cluster.sync();  // every list of the cluster is final
  // The merge: rank `split` takes queries split, split + splits, ... Where
  // every merge is small, a warp a query (merge_queries); else the whole
  // block, a query at a time: the query's lists of every split gathered
  // into the ring (distributed shared memory; one split: its own list),
  // the k largest selected exactly, sorted by the consumer warps, written.
  const int ring_keys = a.slots * kSlotValues / 2;
  if (max(a.splits * a.k, a.kpad) <= kWarpMergeKeys && kConsumers * kWarpMergeKeys <= ring_keys) {
    if (warp < kConsumers)
      merge_queries<QB>(a, lists, cap, ctls, reinterpret_cast<u64*>(ring), q0);
  } else {
    for (int q = split; q < QB && q0 + q < a.B; q += a.splits) {
      Ctl* c = ctl(q);
      u64* keys = a.splits == 1 ? lists + (size_t)q * cap : reinterpret_cast<u64*>(ring);
      int n = c->cnt;
      if (a.splits > 1) {
        n = 0;
        for (int r = 0; r < a.splits; ++r) {
          const u64* src = cluster.map_shared_rank(lists + (size_t)q * cap, r);
          const int m = cluster.map_shared_rank(c, r)->cnt;
          for (int t0 = 0; t0 < m; t0 += 4 * kThreads) {  // four remote loads a thread in flight
            u64 x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int t = t0 + u * kThreads + (int)threadIdx.x;
              x[u] = t < m ? src[t] : 0;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int t = t0 + u * kThreads + (int)threadIdx.x;
              if (t < m) keys[n + t] = x[u];
            }
          }
          n += m;
        }
        __syncthreads();
        if (n > a.k) {  // exactly the k largest (the keys are distinct)
          int kept;
          carca::group_select<kThreads>(keys, n, a.k, 0, &c->sel, &kept, (int)threadIdx.x,
                                        [] { __syncthreads(); });
          n = kept;
        }
      }
      for (int t = n + (int)threadIdx.x; t < a.kpad; t += kThreads) keys[t] = 0;  // empty: last
      __syncthreads();
      if (warp < kConsumers) {
        auto sync = [] { carca::named_barrier(kSortBarrier, kSortThreads); };
        if (a.positions)
          sort_kept<kSortThreads, true>(keys, a.kpad, (int)threadIdx.x, sync);
        else
          sort_kept<kSortThreads, false>(keys, a.kpad, (int)threadIdx.x, sync);
      }
      __syncthreads();
      write_kept(a, keys, q0 + q, (int)threadIdx.x, kThreads);
      __syncthreads();
    }
  }
  cluster.sync();  // the other ranks have read this block's lists
}

int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

// v as rows (sn = 1) or as a column-major matrix (sn != 1, N > 1)
bool column_of(long long sn, int N) { return sn != 1 && N > 1; }

// whether a 2-D tensor map describes the view: a 16-byte-aligned pointer,
// the map's row stride a multiple of 16 bytes and no shorter than a row,
// and (column-major) boxes of at least 16 bytes
bool tma_fits(const void* v, long long sb, long long sn, int B, int N, int qb) {
  if ((reinterpret_cast<uintptr_t>(v) & 15) != 0) return false;
  long long stride, inner;
  if (column_of(sn, N)) {
    if ((sb != 1 && B != 1) || qb * 4 % 16 != 0) return false;
    stride = sn;
    inner = B;
  } else {
    if (sn != 1 && N != 1) return false;
    stride = B == 1 ? (N + 3) / 4 * 4 : sb;
    inner = N;
  }
  return stride >= inner && stride * 4 % 16 == 0 && stride * 4 < (1LL << 40);
}

// cuTensorMapEncodeTiled, looked up at run time by the CUDA runtime (no
// link against libcuda; groupmax.cu looks it up the same way)
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

template <int QB, bool kCol>
int launch(const Args& a, int groups, size_t smem, cudaStream_t st) {
  auto kernel = select_kernel<QB, kCol>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err != 0) return err;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (a.tma) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    cuuint64_t dims[2];
    cuuint64_t strides[1];
    cuuint32_t box[2];
    if (kCol) {
      dims[0] = (cuuint64_t)a.B, dims[1] = (cuuint64_t)a.N;
      strides[0] = (cuuint64_t)a.sn * 4;
      box[0] = QB, box[1] = kBox;
    } else {
      dims[0] = (cuuint64_t)a.N, dims[1] = (cuuint64_t)a.B;
      strides[0] = (cuuint64_t)(a.B == 1 ? (a.N + 3) / 4 * 4 : a.sb) * 4;
      box[0] = kBox, box[1] = QB;
    }
    const cuuint32_t unit[2] = {1, 1};
    const CUresult res = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a.v), dims, strides, box,
        unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        kCol && QB == 8 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3((unsigned)a.splits, (unsigned)groups, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, a, map);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

template <int QB>
int launch_qb(const Args& a, int groups, size_t smem, cudaStream_t st) {
  return column_of(a.sn, a.N) ? launch<QB, true>(a, groups, smem, st)
                              : launch<QB, false>(a, groups, smem, st);
}

}  // namespace

extern "C" {

// shared memory of a block at this k, qb queries a block and ring slots
size_t carca_select_topk_smem_bytes(int k, int qb, int slots) {
  return smem_bytes(k, pow2_at_least(k), qb, slots);
}

// 1 where the select kernel reads this view by tensor copies at qb queries
// a block, 0 where its producer copies it with plain loads
int carca_select_topk_tma(const void* v, long long sb, long long sn, int B, int N, int qb) {
  return tma_fits(v, sb, sn, B, N, qb) ? 1 : 0;
}

// v: float32 at v[b * sb + n * sn] (b < B, n < N), 1 <= k <= 16,384; qb
// (1, 2, 4 or 8) queries a block, splits (1-8: the cluster) blocks a query
// group of per_split values each (splits * per_split >= N), slots (2-8)
// ring slots. positions = 1: ids [B, k] int64 the ascending positions (k
// <= N; vals, gi unused); positions = 0: vals [B, k] float32 and ids [B, k]
// int64 (gi [B, kg] int64 with N = kg * 128, or null).
int carca_select_topk(const void* v, long long sb, long long sn, int B, int N, int k, int qb,
                      int splits, int per_split, int slots, int positions, const void* gi,
                      int kg, long long id_offset, void* vals, void* ids, void* stream) {
  const int groups = B > 0 && qb > 0 ? (B + qb - 1) / qb : 0;
  if (B < 1 || N < 1 || k < 1 || k > kMaxK || (qb != 1 && qb != 2 && qb != 4 && qb != 8) ||
      splits < 1 || splits > kMaxSplits || per_split < 1 ||
      (long long)splits * per_split < N || (long long)(splits - 1) * per_split >= N ||
      slots < 2 || slots > kMaxSlots || groups > 65535 || (positions && k > N) ||
      (splits > 1 && splits * k > slots * kSlotValues / 2) ||
      (gi != nullptr && (long long)kg * kGroup != N))
    return (int)cudaErrorInvalidValue;
  const int kpad = pow2_at_least(k);
  const size_t smem = smem_bytes(k, kpad, qb, slots);
  Args a{static_cast<const float*>(v), sb, sn, B, N, k, splits, per_split, kpad, slots,
         positions, kg, tma_fits(v, sb, sn, B, N, qb) ? 1 : 0, static_cast<float*>(vals),
         static_cast<long long*>(ids), static_cast<const long long*>(gi), id_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (qb) {
    case 1: return launch_qb<1>(a, groups, smem, st);
    case 2: return launch_qb<2>(a, groups, smem, st);
    case 4: return launch_qb<4>(a, groups, smem, st);
    default: return launch_qb<8>(a, groups, smem, st);
  }
}

}  // extern "C"
