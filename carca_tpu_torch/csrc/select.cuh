// Selecting the k largest of many 64-bit keys in shared memory: the pieces
// that K3 (catalog_topk.cu: its per-warp lists and its final pass) and the
// select kernel (select_topk.cu: lax.top_k's counterpart for the
// tournament's stage 2 and final top-k) share.
//
// A key orders one candidate: the order-preserving integer of its float32
// value in the high word (the JAX package's _float_key, sign bit flipped to
// make it unsigned) and the complemented position in the low word. Unsigned
// order of keys is lax.top_k's order: values in IEEE total order (-inf <
// ... < -0.0 < +0.0 < ... < +inf; a negative NaN below -inf, a positive one
// above +inf), equal values to the lowest position. Keys of distinct
// positions are distinct, and no real key is 0 (an empty slot).
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace carca {

typedef unsigned long long u64;
constexpr unsigned kFullMask = 0xffffffffu;

// a key's high word: the order-preserving integer of s
__device__ __forceinline__ unsigned value_word(float s) {
  const int b = __float_as_int(s);
  return (unsigned int)(b < 0 ? (b ^ 0x7FFFFFFF) : b) ^ 0x80000000u;
}

__device__ __forceinline__ u64 make_key(float s, long long pos) {
  return ((u64)value_word(s) << 32) | (u64)(~(unsigned int)pos);
}

// the value a key's high word holds (-inf for the key of -inf and below)
__device__ __forceinline__ float key_value(u64 key) {
  const unsigned int u = (unsigned int)(key >> 32);
  if (u <= 0x007FFFFFu) return -INFINITY;
  const int k32 = (int)(u ^ 0x80000000u);
  return __int_as_float(k32 < 0 ? (k32 ^ 0x7FFFFFFF) : k32);
}

// the position a key's low word holds
__device__ __forceinline__ long long key_pos(u64 key) {
  return (long long)(~(unsigned int)(key & 0xFFFFFFFFull));
}

// Of a 256-bin histogram of one radix digit, by one warp: the bin that
// holds the want-th largest key (want >= 1), the keys in the bins above it
// and in it. Lane l reads bins 255 - 8l - u, u < 8: the digits from the top.
__device__ __forceinline__ void warp_pick_bin(const unsigned* hist, int want, unsigned* bin_out,
                                              unsigned* above_out, unsigned* in_bin_out) {
  const int lane = threadIdx.x % 32;
  unsigned cnt[8], sum = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) sum += (cnt[u] = hist[255 - 8 * lane - u]);
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += y;
  }
  const unsigned excl = incl - sum;
  const unsigned owner = __ballot_sync(kFullMask, excl < (unsigned)want && (unsigned)want <= incl);
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
  *bin_out = __shfl_sync(kFullMask, bin, src);
  *above_out = __shfl_sync(kFullMask, above, src);
  *in_bin_out = __shfl_sync(kFullMask, in_bin, src);
}

// Of the n > k distinct keys arr[0..n), by one warp: a bound lo such that
// the keys >= lo are the largest, at least k and at most k + loose of them
// (exactly k for loose = 0: lo is then the k-th largest key, or its
// prefix), moved to the front of arr (any order); returns lo and writes
// their count to *kept. hist: 256 words of this warp's shared memory. A
// radix walk from the highest bit where the keys differ (they share the
// sign and most of the exponent), 8 bits a pass, that stops once the keys
// under the current prefix that rank below the k-th number at most loose.
static __device__ u64 warp_select(u64* arr, int n, int k, unsigned* hist, int loose, int* kept) {
  const int lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  const u64 first = arr[0];
  u64 diff = 0;
  for (int i = lane; i < n; i += 32) diff |= arr[i] ^ first;
  const unsigned dhi = __reduce_or_sync(kFullMask, (unsigned)(diff >> 32));
  const unsigned dlo = __reduce_or_sync(kFullMask, (unsigned)diff);
  int hi = dhi != 0 ? 63 - __clz((int)dhi) : 31 - __clz((int)dlo);  // n > 1 distinct keys
  u64 pmask = ~((2ull << hi) - 1ull);  // the bits above hi, which every key shares
  u64 prefix = first & pmask;
  int want = k;  // rank of the k-th key among the keys matching prefix
  int n_kept = k;
  for (; hi >= 0; hi -= 8) {
    const int shift = hi >= 7 ? hi - 7 : 0;
    const unsigned dmask = (2u << (hi - shift)) - 1u;  // this pass's digit: bits shift..hi
    for (int u = lane; u < 256; u += 32) hist[u] = 0;
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const u64 x = arr[i];
      if ((x & pmask) == prefix) atomicAdd(hist + ((x >> shift) & dmask), 1u);
    }
    __syncwarp();
    unsigned bin, above, in_bin;
    warp_pick_bin(hist, want, &bin, &above, &in_bin);
    prefix |= (u64)bin << shift;
    pmask |= (u64)dmask << shift;
    want -= (int)above;
    __syncwarp();
    if ((int)in_bin - want <= loose) {  // the keys >= prefix: k - want above, in_bin in the bin
      n_kept = k - want + (int)in_bin;
      break;
    }
  }
  // the keys >= prefix to the front, in order (writes never pass reads)
  int m = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const u64 x = i < n ? arr[i] : 0;
    const bool keep = i < n && x >= prefix;
    const unsigned bal = __ballot_sync(kFullMask, keep);
    __syncwarp();
    if (keep) arr[m + __popc(bal & lt)] = x;
    m += __popc(bal);
    __syncwarp();
  }
  *kept = n_kept;
  return prefix;
}

// group_select's shared memory
struct BlockSelectShared {
  unsigned hist[256];
  unsigned dhi, dlo, bin, above, in_bin;
  int warp_kept[32];
};

// warp_select by a group of kThreads threads (whole warps; tid = the
// thread's index in the group, sync = the group's barrier; all of them
// call it, with the same n). Each thread takes its keys kBatch at a time,
// all loaded before any is counted or moved (a shared atomic or store
// would otherwise hold up every later load): a radix pass counts them
// into one histogram and the group's warp 0 picks the bin; the kept keys
// move to the front, a group-wide scan a batch (a batch is read whole
// before any of it is written, and writes land below its end; their
// order changes). Returns lo to every thread and writes *kept in every
// thread; ends synchronised.
template <int kThreads, typename Sync>
__device__ u64 group_select(u64* arr, int n, int k, int loose, BlockSelectShared* s, int* kept,
                            int tid, Sync sync) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kBatch = 8;
  constexpr int kStep = kThreads * kBatch;
  const int lane = tid % 32, warp = tid / 32;
  const unsigned lt = (1u << lane) - 1u;
  const u64 first = arr[0];
  u64 diff = 0;
  for (int i = tid; i < n; i += kThreads) diff |= arr[i] ^ first;
  if (tid == 0) s->dhi = s->dlo = 0;
  sync();
  const unsigned whi = __reduce_or_sync(kFullMask, (unsigned)(diff >> 32));
  const unsigned wlo = __reduce_or_sync(kFullMask, (unsigned)diff);
  if (lane == 0) {
    atomicOr(&s->dhi, whi);
    atomicOr(&s->dlo, wlo);
  }
  sync();
  const unsigned dhi = s->dhi, dlo = s->dlo;
  int hi = dhi != 0 ? 63 - __clz((int)dhi) : 31 - __clz((int)dlo);  // n > 1 distinct keys
  u64 pmask = ~((2ull << hi) - 1ull);
  u64 prefix = first & pmask;
  int want = k;
  int n_kept = k;
  for (; hi >= 0; hi -= 8) {
    const int shift = hi >= 7 ? hi - 7 : 0;
    const unsigned dmask = (2u << (hi - shift)) - 1u;
    for (int u = tid; u < 256; u += kThreads) s->hist[u] = 0;
    sync();
    for (int base = 0; base < n; base += kStep) {
      u64 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        x[u] = i < n ? arr[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (base + u * kThreads + tid < n && (x[u] & pmask) == prefix)
          atomicAdd(s->hist + ((x[u] >> shift) & dmask), 1u);
    }
    sync();
    if (warp == 0) {
      unsigned bin, above, in_bin;
      warp_pick_bin(s->hist, want, &bin, &above, &in_bin);
      if (lane == 0) s->bin = bin, s->above = above, s->in_bin = in_bin;
    }
    sync();
    const unsigned bin = s->bin, above = s->above, in_bin = s->in_bin;
    prefix |= (u64)bin << shift;
    pmask |= (u64)dmask << shift;
    want -= (int)above;
    if ((int)in_bin - want <= loose) {
      n_kept = k - want + (int)in_bin;
      break;
    }
  }
  // the keys >= prefix to the front
  int m = 0;
  for (int base = 0; base < n; base += kStep) {
    u64 x[kBatch];
    unsigned bal[kBatch];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      x[u] = i < n ? arr[i] : 0;
      bal[u] = __ballot_sync(kFullMask, i < n && x[u] >= prefix);
      mine += __popc(bal[u]);
    }
    if (lane == 0) s->warp_kept[warp] = mine;
    sync();  // the batch is read, and every warp's count is in
    int at = m, round = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s->warp_kept[w];
      at += w < warp ? c : 0;
      round += c;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if ((bal[u] >> lane) & 1u) arr[at + __popc(bal[u] & lt)] = x[u];
      at += __popc(bal[u]);
    }
    m += round;
    sync();
  }
  *kept = n_kept;
  return prefix;
}

// One key of every lane of a warp offered to a list: the keys above th go
// to list[*cnt ..], one shared atomic per warp.
__device__ __forceinline__ void offer_key(u64 key, u64 th, u64* list, int* cnt) {
  const int lane = threadIdx.x % 32;
  const bool in = key > th;
  const unsigned ins = __ballot_sync(kFullMask, in);
  int slot = 0;
  if (ins != 0 && lane == __ffs(ins) - 1) slot = atomicAdd(cnt, __popc(ins));
  slot = __shfl_sync(kFullMask, slot, ins ? __ffs(ins) - 1 : 0) + __popc(ins & ((1u << lane) - 1u));
  if (in) list[slot] = key;
}

// Bitonic sort of keys[0..kpad), kpad a power of two, descending, by a
// group of kThreads threads (whole warps; tid = the thread's index in the
// group, sync = the group's barrier); ends synchronised. Pair p of a
// substep is (i, i + stride) with i = 2p - p % stride, and thread t takes p
// = t + j * kThreads: at strides up to 32 each warp's pairs stay inside its
// own 64-key segments, so two such substeps in a row need only the warp's
// sync.
template <int kThreads, typename Sync>
__device__ void bitonic_sort_desc(u64* keys, int kpad, int tid, Sync sync) {
  const int half = kpad / 2;
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int p = tid; p < half; p += kThreads) {
        const int i = 2 * p - (p & (stride - 1));
        const u64 x = keys[i], y = keys[i + stride];
        if ((x < y) == ((i & size) == 0)) {
          keys[i] = y;
          keys[i + stride] = x;
        }
      }
      const int next = stride > 1 ? stride / 2 : size;  // the next substep's stride
      if (stride <= 32 && next <= 32 && !(stride == 1 && size == kpad))
        __syncwarp();
      else
        sync();
    }
  }
}

// bitonic_sort_desc by a whole block of kThreads threads
template <int kThreads>
__device__ void bitonic_sort_desc(u64* keys, int kpad) {
  bitonic_sort_desc<kThreads>(keys, kpad, (int)threadIdx.x, [] { __syncthreads(); });
}

// one substep of stride S < R of sort_desc_regs inside a thread whose
// elements start at i0
template <int S, int R, typename K>
__device__ __forceinline__ void sort_step_in_thread(K (&x)[R], int i0, int size) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if ((r & S) == 0) {
      const bool desc = ((i0 + r) & size) == 0;
      const K a = x[r], b = x[r | S];
      const K hi = a > b ? a : b, lo = a > b ? b : a;
      x[r] = desc ? hi : lo;
      x[r | S] = desc ? lo : hi;
    }
  }
}

// Bitonic sort of keys[0..kpad) descending (kpad a power of two at most
// kThreads R), in registers, by kThreads threads (tid < kThreads; all of
// them call it):
// thread t holds elements tid * R .. tid * R + R - 1 (threads past kpad / R
// hold none). A substep of stride s < R runs inside each thread, s < 32 R
// across lanes by shuffles, larger strides through keys (two barriers,
// `sync`). kPos: by the low words alone (a position key's complemented
// position, written back as the whole key). kLog >= 0: kpad = 2^kLog at
// compile time, every substep unrolled (no loop or branch between two
// shuffles). Ends synchronised.
template <int R, bool kPos, int kLog, typename Sync>
__device__ void sort_desc_regs(u64* keys, int kpad, int tid, Sync sync) {
  typedef typename std::conditional<kPos, unsigned, u64>::type K;
  if constexpr (kLog >= 0) kpad = 1 << kLog;
  const int held = kpad / R;
  const bool has = tid < held;
  K x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = has ? (K)keys[tid * R + r] : K(0);
#pragma unroll
  for (int size = 2; size <= kpad; size <<= 1) {
#pragma unroll
    for (int s = size / 2; s > 0; s >>= 1) {
      if (s < R) {  // compile-time strides, so that x stays in registers
        if constexpr (R > 1) if (s == 1) sort_step_in_thread<1>(x, tid * R, size);
        if constexpr (R > 2) if (s == 2) sort_step_in_thread<2>(x, tid * R, size);
        if constexpr (R > 4) if (s == 4) sort_step_in_thread<4>(x, tid * R, size);
        continue;
      }
      K y[R];
#pragma unroll
      for (int r = 0; r < R; ++r) y[r] = x[r];
      if (s < 32 * R) {
#pragma unroll
        for (int r = 0; r < R; ++r) y[r] = __shfl_xor_sync(kFullMask, x[r], s / R);
      } else {
        sync();
        if (has) {
#pragma unroll
          for (int r = 0; r < R; ++r) keys[tid * R + r] = x[r];
        }
        sync();
        if (has) {
#pragma unroll
          for (int r = 0; r < R; ++r) y[r] = (K)keys[(tid * R + r) ^ s];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = tid * R + r;
        const bool keep_max = ((i & s) == 0) == ((i & size) == 0);
        const K a = x[r], b = y[r];
        x[r] = keep_max == (a > b) ? a : b;
      }
    }
  }
  sync();
  if (has) {
#pragma unroll
    for (int r = 0; r < R; ++r) keys[tid * R + r] = (u64)x[r];
  }
  sync();
}

}  // namespace carca
