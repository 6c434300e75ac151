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
// Keys. Each candidate is ordered by one 64-bit key (select.cuh, shared
// with the select kernel): the order-preserving integer of the score (the
// _float_key trick of the JAX package, sign bit flipped to make it
// unsigned) in the high word and the complemented row id in the low word,
// so -0.0 ranks below +0.0 as in lax.top_k. Keys are unique per row, ties
// go to the lowest id, and no id bit ever enters a float (the
// flush-to-zero trap of packing ids into mantissas, which a zero query
// would hit). For bf16 and int8 indexes
// the TPU kernel packs a 12-bit lane id into the low bits of a 32-bit key,
// so its values come back truncated (by at most 2^-11 relative) and its
// near-tie order is unspecified; this kernel keeps the full key for every
// index type, so its values are the true float32 scores and its ids exact.
//
// Design. The TPU kernel extracts k winners per chunk by k rounds of
// max-and-suppress; that is not carried over. Instead:
//   1. select_kernel<T>: one block per (query block, row split); the splits
//      cut the rows into ranges of a multiple of 128 rows (stream_plan: one
//      wave of the blocks the card holds, four at k >= 256, at most 528
//      blocks; ranges as short as 256 rows where few blocks would leave the
//      card idle). A block is two
//      producer warps and up to 8 consumer warps. The producers copy the
//      split's rows (and int8 scales) by cp.async, 64 rows a slot, into a
//      ring of 2 to 16 slots (32 KB, 64 KB where an SM holds one block
//      anyway); mbarriers say when a slot is full and when
//      its consumers have read it, so no __syncthreads follows the set-up
//      and a consumer waits for no other. The consumers are `groups` query
//      groups, a warp each: a warp scores its group's n8 tile (per_warp <= 8
//      queries, fragments in registers) against the four 16-row mma tiles
//      of every slot, and frees the slot once the scores are in registers.
//      At B >= 64 a block holds 64 queries, so the index is read once per 64
//      queries. Where the plan leaves fewer than 264 consumer warps on the
//      card (few queries, few rows against k), a warp takes fewer queries:
//      more warps share a block's rows, then more query blocks read them.
//      Each warp keeps its own list per query (k + slack keys, the slack 64
//      + 2k as shared memory allows) and in registers each query's
//      threshold (its key and value) and its list's count. A tile's 16
//      scores a lane holds are compared with the threshold's value at once
//      (a bit mask, no branch); only a tile with a hit goes on: the hits'
//      keys against the threshold's key, each lane's place among the 8
//      lanes that hold its queries by a scan of shuffles, and the stores.
//      Before a tile could overflow a list (64 keys a query), the warp trims
//      it by a radix select (8-bit digits from the highest bit where the
//      keys differ) that stops at the first digit whose bin leaves at most
//      (slack - 64) / 2 keys beyond the k largest, keeps the keys >= that
//      bin's floor at the front, and raises the threshold to it. Only that
//      warp stops for it. At the end each list is selected exactly (the k
//      largest keys are exactly those >= the bound the walk ends at: keys
//      are unique), and each (query, split) writes its k keys,
//      unsorted, to the scratch [B, splits, k] (zeros for empty
//      slots).
//   2. final_kernel: one block per query streams its splits * k
//      keys, 2048 a step (8 loads a thread issued together: a step is bound
//      by L2's latency), through one running list (k + 4096 slots, trimmed
//      as the select pass trims), selects the k largest exactly, sorts them
//      (bitonic, in shared memory) and decodes keys -> (value, id +
//      id_offset), -inf -> id 0. stream_plan keeps a query's keys at most
//      32,768 for k <= 4096 (65,536 where fewer blocks than SMs would be
//      left).
// The selection is exactly the first k of a full sort of the keys: every
// trim keeps every key >= its bound, at least k of them, and the last one
// keeps exactly the k largest.
// The scratch is B * splits * k * 8 bytes, independent of R.
// What bounds it on the H100: not the index's bytes (at the retrieval
// monitor's shape, [256, 64] x 468,273 bf16 rows, four query blocks read
// 240 MB through L2, ~60 MB from HBM), but the work per (row, query) and
// per key that beats a threshold, on a few warps an SM (the lists take the
// shared memory): the products (2 B R d operations on mma.sync, and an int8
// row's widening to bf16 in every query group), one compare per (row,
// query), and the keys that enter the lists (about k (1 + ln(rows per
// split / k)) a list, twice that with the threshold raised only by trims)
// with the trims they cause. Where k is large against a split's rows, the
// first rows of every split all enter its lists.
// Rows wider than 128 columns (kWide) are scored in 128-column chunks: the
// producer copies a tile's chunks into consecutive slots and the warps
// accumulate the scores across them (scoring.cuh, score_acc) before the
// keys are offered.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mbarrier.cuh"
#include "scoring.cuh"
#include "select.cuh"

namespace {

using carca::AFrag;
using carca::QFrag;
using carca::mbar_arrive;
using carca::mbar_arrive_cp_async;
using carca::mbar_init;
using carca::mbar_wait;
using carca::key_value;
using carca::make_key;
using carca::u64;
using carca::warp_select;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;                  // consumer warps of a select block
constexpr int kProducers = 2;                 // producer warps of a select block
constexpr int kSelectThreads = 32 * (kMaxWarps + kProducers);
constexpr int kTileRows = 64;                 // rows of a ring slot: four 16-row mma tiles
constexpr int kMT = kTileRows / 16;
constexpr int kMinSlack = kTileRows;          // list slots beyond k, at least
constexpr int kThreads = 256;                 // final_kernel
constexpr int kFinalSlack = 4096;             // list slots beyond k in the final pass
constexpr int kFinalPer = 8;                  // keys a final-pass thread loads a step
// below every real key: the key of -inf at the highest row id. Masked rows
// never enter a list, and an empty slot (key 0) decodes as -inf, id 0.
constexpr u64 kFloor = 0x007FFFFFFFFFFFFFull;

// a ring slot in shared memory: its rows, then their scales
template <typename T, int kD>
__host__ __device__ constexpr int slot_bytes() {
  return kTileRows * (carca::row_stride_bytes<T>(kD) + 4);
}

// select_kernel's shared memory: the mbarriers, the ring's slots, each
// consumer warp's lists (per_warp x (k + slack) keys) and histogram
template <typename T, int kD>
size_t select_bytes(int k, int warps, int per_warp, int slack, int slots) {
  return 16 * (size_t)slots + slots * (size_t)slot_bytes<T, kD>() +
         sizeof(u64) * (size_t)warps * per_warp * (k + slack) + sizeof(unsigned) * 256 * warps;
}

size_t final_bytes(int kpad) {
  return sizeof(u64) * ((size_t)kpad + kFinalSlack + 1) + sizeof(int) * 4 + sizeof(unsigned) * 256;
}

struct SelectArgs {
  const float* q;
  const void* e;
  const float* scales;
  u64* scratch;
  int B, R, d, k, groups, per_warp, slack, slots, splits, rows_per_split, lim0,
      mask_row0, vec;
};

// The producers' copy of rows [row0, row0 + kTileRows), columns [col0, col0
// + kD), into a slot, by producer thread p of 32 kProducers: cp.async in
// 16-byte chunks, zeros past R and past d (e 16-byte aligned, d * sizeof(T)
// a multiple of 16).
template <typename T, int kD>
__device__ __forceinline__ void produce_rows(char* dst, const T* __restrict__ e, long long row0,
                                             long long R, int d, int col0, int p) {
  constexpr int kChunks = kD * (int)sizeof(T) / 16;  // 4 to 32 a row
  constexpr int kStride = carca::row_stride_bytes<T>(kD);
  const int c = p % kChunks;
  const bool live = c < (d - col0) * (int)sizeof(T) / 16;
  const char* base = reinterpret_cast<const char*>(e) + (size_t)col0 * sizeof(T) + 16 * c;
#pragma unroll 4
  for (int r = p / kChunks; r < kTileRows; r += 32 * kProducers / kChunks) {
    const long long row = row0 + r;
    const bool in = live && row < R;
    carca::cp_async16(dst + r * kStride + 16 * c, in ? base + row * d * (long long)sizeof(T) : base,
                      in ? 16 : 0);
  }
}

template <typename T, int kD, bool kWide>
__global__ void __launch_bounds__(kSelectThreads) select_kernel(const SelectArgs a) {
  constexpr int KS = kD / carca::kStep<T>;
  constexpr int stride = carca::row_stride_bytes<T>(kD);
  constexpr int SB = slot_bytes<T, kD>();
  // mma tiles scored at once: their A fragments stay within ~64 registers
  constexpr int kFragRegs = KS * (carca::kIsF32<T> ? 8 : 4);
  constexpr int kUnroll = kFragRegs >= 64 ? 1 : (64 / kFragRegs >= kMT ? kMT : 64 / kFragRegs);
  extern __shared__ float4 smem4[];
  const int NS = a.slots;
  u64* full = reinterpret_cast<u64*>(smem4);               // [NS]: a slot's rows are in
  u64* empty = full + NS;                                   // [NS]: its consumers read it
  char* ring = reinterpret_cast<char*>(empty + NS);         // [NS][SB]
  const int cap = a.k + a.slack;
  const int warps = a.groups;
  u64* lists = reinterpret_cast<u64*>(ring + (size_t)NS * SB);  // [warps][per_warp][cap]
  unsigned* hist = reinterpret_cast<unsigned*>(lists + (size_t)warps * a.per_warp * cap);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qb = a.groups * a.per_warp;
  const int qblocks = (a.B + qb - 1) / qb;
  const int b0 = (blockIdx.x % qblocks) * qb;
  const int split = blockIdx.x / qblocks;
  const int nq = min(qb, a.B - b0);
  const int active = (nq + a.per_warp - 1) / a.per_warp;  // groups with a real query
  const long long r_begin = (long long)split * a.rows_per_split;
  const long long r_end = min((long long)a.R, r_begin + a.rows_per_split);
  const int nch = kWide ? carca::score_chunks(a.d) : 1;
  const int n_tiles = r_end > r_begin ? (int)((r_end - r_begin + kTileRows - 1) / kTileRows) : 0;
  const T* e = static_cast<const T*>(a.e);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 32 * kProducers);  // the producers' lanes
      mbar_init(empty + s, active);     // one warp of each active group
    }
  }
  __syncthreads();

  if (warp >= warps) {  // the producers: item j = (tile j / nch, chunk j % nch) into slot j % NS
    const int p = threadIdx.x - 32 * warps;
    const bool async = a.vec && (a.scales == nullptr || carca::async_scales(a.scales));
    for (int j = 0; j < n_tiles * nch; ++j) {
      const int slot = j % NS;
      if (j >= NS) mbar_wait(empty + slot, (j / NS - 1) & 1);
      const int i = j / nch, ch = j - i * nch;
      const long long row0 = r_begin + (long long)i * kTileRows;
      char* buf = ring + (size_t)slot * SB;
      if (a.vec)
        produce_rows<T, kD>(buf, e, row0, a.R, a.d, ch * kD, p);
      else
        carca::stage_rows_by<T>(p, 32 * kProducers, buf, e, row0, kTileRows, a.R, a.d, kD, stride,
                                false, ch * kD);
      carca::stage_scales_by(p, 32 * kProducers, reinterpret_cast<float*>(buf + kTileRows * stride),
                             a.scales, row0, kTileRows, a.R);
      if (async) {
        mbar_arrive_cp_async(full + slot);
      } else {
        carca::cp_async_wait<0>();
        mbar_arrive(full + slot);
      }
    }
    carca::cp_async_wait<0>();
    return;
  }
  if (warp >= active) return;

  // a consumer: group `warp` scores every tile; lane (g, t) holds the
  // group's queries 2t and 2t + 1, and column g of the n8 tile is the
  // group's query g
  const int qw0 = warp * a.per_warp;  // the group's first query in the block
  const int nq_w = min(a.per_warp, nq - qw0);
  const float* my_q = g < nq_w ? a.q + (size_t)(b0 + qw0 + g) * a.d : nullptr;
  QFrag<T> bq[KS];
  if constexpr (!kWide) {
#pragma unroll
    for (int s = 0; s < KS; ++s) bq[s] = carca::query_frag<T>(my_q, a.d, s, t);
  }
  u64* my_lists = lists + (size_t)warp * a.per_warp * cap;
  unsigned* my_hist = hist + 256 * warp;
  // per query 2t + u: its threshold, the key and the value it holds (+inf
  // for a padding query: nothing passes), and its list's count (the same in
  // the 8 lanes of a t)
  u64 thr[2];
  float thr_v[2];
  int cnt[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    thr[u] = kFloor;
    thr_v[u] = 2 * t + u < nq_w ? -INFINITY : INFINITY;
    cnt[u] = 0;
  }

  // list qi (warp-uniform), if it holds more than keep keys, down to its
  // k largest and at most `loose` more; the threshold rises to their bound
  auto trim = [&](int qi, int keep, int loose) {
    const int n = __shfl_sync(kFull, (qi & 1) ? cnt[1] : cnt[0], qi >> 1);
    if (n <= keep) return;
    __syncwarp();
    int kept;
    const u64 lo = warp_select(my_lists + (size_t)qi * cap, n, a.k, my_hist, loose, &kept) - 1;
    if (t == qi >> 1) {
      if (qi & 1) {
        thr[1] = lo, thr_v[1] = key_value(lo), cnt[1] = kept;
      } else {
        thr[0] = lo, thr_v[0] = key_value(lo), cnt[0] = kept;
      }
    }
  };
  // room for the kTileRows keys per query that a tile can offer
  auto make_room = [&]() {
    const unsigned over0 = __ballot_sync(kFull, cnt[0] > cap - kTileRows) & 0xFu;
    const unsigned over1 = __ballot_sync(kFull, cnt[1] > cap - kTileRows) & 0xFu;
    for (unsigned over = over0 | (over1 << 4); over != 0; over &= over - 1) {
      const int b = __ffs(over) - 1;  // query 2 (b % 4) + b / 4
      trim(2 * (b & 3) + (b >> 2), cap - kTileRows, (a.slack - kTileRows) / 2);
    }
  };

  for (int i = 0; i < n_tiles; ++i) {
    float c[kMT][4], sc0[kMT], sc8[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) c[mt][0] = c[mt][1] = c[mt][2] = c[mt][3] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int j = i * nch + ch, slot = j % NS;
      mbar_wait(full + slot, (j / NS) & 1);
      const char* buf = ring + (size_t)slot * SB;
      const float* scl = reinterpret_cast<const float*>(buf + kTileRows * stride);
      if constexpr (kWide) carca::chunk_query_frags<T, KS>(bq, my_q, a.d, ch, t);
#pragma unroll(kUnroll)
      for (int mt = 0; mt < kMT; ++mt) {
        AFrag<T> af[KS];
        carca::load_a<T, KS>(af, buf + (16 * mt + g) * stride, stride, t);
        carca::score_acc<T, KS>(c[mt], af, bq);  // from zero over the chunks: score_tile's sequence
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        sc0[mt] = a.scales != nullptr ? scl[16 * mt + g] : 1.f;
        sc8[mt] = a.scales != nullptr ? scl[16 * mt + g + 8] : 1.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);  // the scores are in registers: the slot is free
    }
    // the finished scores; bit 4 mt + 2 h + u: (row 16 mt + g + 8 h, query
    // 2t + u) passes the threshold's value
    const long long row0 = r_begin + (long long)i * kTileRows;
    float sv[kMT][4];
    unsigned hit = 0;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        sv[mt][x] = carca::finish<T>(c[mt][x], x < 2 ? sc0[mt] : sc8[mt], true);
        hit |= (sv[mt][x] >= thr_v[x & 1] ? 1u : 0u) << (4 * mt + x);
      }
    // rows past the split's end or the valid rows, and the pad row
    if (row0 + kTileRows > min(r_end, (long long)a.lim0) || (row0 == 0 && a.mask_row0)) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + 16 * mt + g + 8 * h;
          if (!(row < r_end && carca::row_valid((int)row, a.lim0, a.mask_row0)))
            hit &= ~(3u << (4 * mt + 2 * h));
        }
    }
    if (!__any_sync(kFull, hit != 0)) continue;
    make_room();
    // the hits whose key beats the threshold; each lane's count per query
    // u, its place among the 8 lanes of its t (a scan over g), and the total
    u64 key[kMT][4];
    unsigned take = 0;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        key[mt][x] = make_key(sv[mt][x], row0 + 16 * mt + g + 8 * (x >> 1));
        take |= (key[mt][x] > thr[x & 1] ? 1u : 0u) << (4 * mt + x);
      }
    take &= hit;
    const int n0 = __popc(take & 0x5555u), n1 = __popc(take & 0xAAAAu);
    int s0 = n0, s1 = n1;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const int y0 = __shfl_up_sync(kFull, s0, off), y1 = __shfl_up_sync(kFull, s1, off);
      if (lane >= off) s0 += y0, s1 += y1;
    }
    u64* at0 = my_lists + (size_t)(2 * t) * cap + cnt[0] + s0 - n0;  // this lane's first slots
    u64* at1 = my_lists + (size_t)(2 * t + 1) * cap + cnt[1] + s1 - n1;
    cnt[0] += __shfl_sync(kFull, s0, 28 + t);
    cnt[1] += __shfl_sync(kFull, s1, 28 + t);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const unsigned tk = (take >> (4 * mt + x)) & 1u;
        if (x & 1) {
          if (tk) *at1 = key[mt][x];
          at1 += tk;
        } else {
          if (tk) *at0 = key[mt][x];
          at0 += tk;
        }
      }
  }
  __syncwarp();
  for (int qi = 0; qi < nq_w; ++qi) trim(qi, a.k, 0);
  __syncwarp();
  for (int qi = 0; qi < nq_w; ++qi) {
    const int n = min(a.k, __shfl_sync(kFull, (qi & 1) ? cnt[1] : cnt[0], qi >> 1));
    const u64* list = my_lists + (size_t)qi * cap;
    u64* out = a.scratch + ((size_t)(b0 + qw0 + qi) * a.splits + split) * a.k;
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
  const int warp = threadIdx.x / 32;
  const u64* src = scratch + (size_t)b * splits * k;
  const int total = splits * k;
  const int cap = k + kFinalSlack;
  // down to the k largest keys and at most `loose` more
  auto trim = [&](int keep_above, int loose) {
    if (warp == 0 && *cnt > keep_above) {
      int kept;
      const u64 lo = warp_select(keys, *cnt, k, hist, loose, &kept);
      if (threadIdx.x == 0) {
        *cnt = kept;
        *thr = lo - 1;
      }
    }
  };
  if (threadIdx.x == 0) {
    *cnt = 0;
    *thr = kFloor;
  }
  // kFinalPer keys a thread a step, their loads issued together
  for (int base = 0; base < total; base += kThreads * kFinalPer) {
    __syncthreads();
    trim(cap - kThreads * kFinalPer, kFinalSlack - kThreads * kFinalPer);
    __syncthreads();
    u64 key[kFinalPer];
#pragma unroll
    for (int u = 0; u < kFinalPer; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      key[u] = i < total ? src[i] : 0;
    }
    const u64 th = *thr;
#pragma unroll
    for (int u = 0; u < kFinalPer; ++u) carca::offer_key(key[u], th, keys, cnt);
  }
  __syncthreads();
  trim(k, 0);
  __syncthreads();
  const int n = *cnt;
  for (int i = n + threadIdx.x; i < kpad; i += kThreads) keys[i] = 0;
  __syncthreads();
  carca::bitonic_sort_desc<kThreads>(keys, kpad);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const u64 key = keys[j];
    const size_t o = (size_t)b * k + j;
    if ((unsigned int)(key >> 32) <= 0x007FFFFFu) {  // -inf (masked row) or an empty slot
      vals[o] = -INFINITY;
      ids[o] = 0;
    } else {
      vals[o] = key_value(key);
      ids[o] = carca::key_pos(key) + id_offset;
    }
  }
}

int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

struct SelectSmem {
  int k, warps, per_warp, slack, slots;
  size_t* out;
  template <typename T, int kD, bool kWide>
  int operator()() const {
    *out = select_bytes<T, kD>(k, warps, per_warp, slack, slots);
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
    const size_t smem = select_bytes<T, kD>(a.k, a.groups, a.per_warp, a.slack, a.slots);
    int kpad = 1;
    while (kpad < a.k) kpad <<= 1;
    const size_t fsmem = final_bytes(kpad);
    int err = set_smem((const void*)select_kernel<T, kD, kWide>, smem);
    if (err == 0) err = set_smem((const void*)final_kernel, fsmem);
    if (err != 0) return err;
    SelectArgs args = a;
    args.vec = carca::vec_rows<T>(a.e, a.d);
    if (!std::is_same<T, int8_t>::value) args.scales = nullptr;
    const long long qblocks = (a.B + a.groups * a.per_warp - 1) / (a.groups * a.per_warp);
    select_kernel<T, kD, kWide>
        <<<(unsigned)(qblocks * a.splits), 32 * (a.groups + kProducers), smem, st>>>(args);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    final_kernel<<<(unsigned)a.B, kThreads, fsmem, st>>>(a.scratch, vals, ids, a.k,
                                                          a.splits, kpad, id_offset);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {


// shared memory of the select pass (the final pass takes (pow2(k) + 4097) *
// 8 bytes and 1 KB more); warps = groups consumer warps
size_t carca_catalog_topk_smem_bytes(int k, int warps, int per_warp, int slack, int slots, int d,
                                     int dtype) {
  size_t out = 0;
  carca::dispatch_index(dtype, d, SelectSmem{k, warps, per_warp, slack, slots, &out});
  return out;
}

// q [B, d] f32; e: [R, d] of the type dtype names (carca::IndexType), any
// d >= 1; scales: [R] f32 for an int8 index, else null. A select block
// holds groups * per_warp queries (per_warp <= 8) in groups consumer warps
// (<= 8); slack >= 64 list slots beyond k; slots >= 2 ring slots (every
// consumer waits for every phase of every slot in turn: a parity wait cannot
// tell a phase from the one two ahead). scratch: [B, splits, k] u64,
// splits = ceil(R / rows_per_split), rows_per_split a multiple of 64. vals
// [B, k] f32, ids [B, k] int64.
int carca_catalog_topk(const void* q, const void* e, const void* scales, void* vals,
                       void* ids, void* scratch, int B, int R, int d, int k, int groups,
                       int per_warp, int slack, int slots, int splits, int rows_per_split,
                       int lim0, int mask_row0, long long id_offset, int dtype, void* stream) {
  if (groups < 1 || groups > kMaxWarps || per_warp < 1 || per_warp > 8 || slack < kMinSlack ||
      slots < 2 || rows_per_split % kTileRows != 0)
    return (int)cudaErrorInvalidValue;
  const SelectArgs a{static_cast<const float*>(q), e, static_cast<const float*>(scales),
                     static_cast<u64*>(scratch), B, R, d, k, groups, per_warp, slack,
                     slots, splits, rows_per_split, lim0, mask_row0, 0};
  return carca::dispatch_index(
      dtype, d, Launch{a, static_cast<float*>(vals), static_cast<long long*>(ids), id_offset,
                       static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
