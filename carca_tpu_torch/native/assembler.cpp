// Native batch assembler: the host pipeline's batch assembly in C++ (the
// port's own copy of the JAX package's carca_tpu/native/assembler.cpp, kept
// with the same semantics and the same splitmix64 streams, so that one seed
// gives both packages bit-equal batches, negatives included).
//
// A multithreaded whole-batch assembler over the packed CSR catalog, in place
// of the reference's per-example Python assembly and rejection-sampled
// negatives (src/data.py:90-192). Semantics match the numpy path of
// carca_tpu_torch/data/dataset.py (window formulas, right-alignment, negative
// context inheritance) and the reference's sampler contract (uniform
// [1, n_items-1], rejection against the user's FULL history and against
// duplicates, src/data.py:77-87). Every row draws from its own stream,
// seeded from the call's seed and the row's index, so the result does not
// depend on the thread count.
//
// Plain C ABI, loaded with ctypes (carca_tpu_torch/native/__init__.py). All
// output buffers are caller-allocated, caller-zeroed numpy arrays.

#include <atomic>
#include <cstdint>
#include <functional>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64 — tiny, seedable, statistically fine for negative sampling.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // uniform in [1, n-1] (inclusive), matching random.randint(1, n-1)
  int64_t uniform_id(int64_t n) {
    return 1 + static_cast<int64_t>(next() % static_cast<uint64_t>(n - 1));
  }
};

// Open-addressing hash set for int32 ids (0 = empty slot; ids are >= 1).
struct IdSet {
  std::vector<int32_t> slots;
  uint64_t mask;
  explicit IdSet(size_t capacity) {
    size_t n = 16;
    while (n < capacity * 2) n <<= 1;
    slots.assign(n, 0);
    mask = n - 1;
  }
  static uint64_t hash(int32_t v) {
    uint64_t z = static_cast<uint64_t>(v) * 0x9e3779b97f4a7c15ULL;
    return z ^ (z >> 29);
  }
  bool contains(int32_t v) const {
    uint64_t i = hash(v) & mask;
    while (slots[i] != 0) {
      if (slots[i] == v) return true;
      i = (i + 1) & mask;
    }
    return false;
  }
  void insert(int32_t v) {
    uint64_t i = hash(v) & mask;
    while (slots[i] != 0) {
      if (slots[i] == v) return;
      i = (i + 1) & mask;
    }
    slots[i] = v;
  }
};

inline void run_rows(int64_t batch, int64_t n_threads,
                     const std::function<void(int64_t)>& fn) {
  if (n_threads <= 1 || batch < 2 * n_threads) {
    for (int64_t b = 0; b < batch; ++b) fn(b);
    return;
  }
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(n_threads));
  for (int64_t t = 0; t < n_threads; ++t) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t b = next.fetch_add(1);
        if (b >= batch) return;
        fn(b);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Train batch (src/data.py:90-137 semantics; see BatchBuilder.train_batch).
// Outputs (pre-zeroed): p_x [B,L] i32, p_c [B,L,C] f32, o_x [B,2L] i32,
// o_c [B,2L,C] f32, y [B,2L] f32. Returns number of alive rows.
int64_t carca_train_batch(
    const int32_t* items, const int64_t* offsets, const float* ctx,
    int64_t n_ctx, const int64_t* win_start, const int64_t* win_end,
    const int64_t* user_rows, int64_t batch, int64_t L, int64_t n_items,
    uint64_t seed, int64_t n_threads,
    int32_t* p_x, float* p_c, int32_t* o_x, float* o_c, float* y) {
  std::atomic<int64_t> alive{0};
  run_rows(batch, n_threads, [&](int64_t b) {
    int64_t u = user_rows[b];
    if (u < 0) return;
    int64_t s = win_start[u], e = win_end[u];
    if (e <= s) return;
    alive.fetch_add(1);
    int64_t off = offsets[u];
    int64_t prof_len = offsets[u + 1] - off;

    IdSet forbid(static_cast<size_t>(prof_len) + static_cast<size_t>(L));
    for (int64_t i = 0; i < prof_len; ++i) forbid.insert(items[off + i]);

    Rng rng(seed ^ (0x517cc1b727220a95ULL * static_cast<uint64_t>(b + 1)));
    int32_t* px = p_x + b * L;
    float* pc = p_c + b * L * n_ctx;
    int32_t* ox = o_x + b * 2 * L;
    float* oc = o_c + b * 2 * L * n_ctx;
    float* yb = y + b * 2 * L;

    for (int64_t j = 0; j < L; ++j) {
      int64_t pi = e - L - 1 + j;
      if (pi < s) continue;
      int64_t ev = off + pi;
      px[j] = items[ev];
      std::memcpy(pc + j * n_ctx, ctx + ev * n_ctx,
                  sizeof(float) * static_cast<size_t>(n_ctx));
      ox[j] = items[ev + 1];  // positive = next item
      std::memcpy(oc + j * n_ctx, ctx + (ev + 1) * n_ctx,
                  sizeof(float) * static_cast<size_t>(n_ctx));
      yb[j] = 1.0f;
      // negative in the mirrored slot, inheriting the positive's context
      // (src/data.py:130)
      int32_t neg;
      do {
        neg = static_cast<int32_t>(rng.uniform_id(n_items));
      } while (forbid.contains(neg));
      forbid.insert(neg);  // dedup within the example (src/data.py:84-86)
      ox[L + j] = neg;
      std::memcpy(oc + (L + j) * n_ctx, ctx + (ev + 1) * n_ctx,
                  sizeof(float) * static_cast<size_t>(n_ctx));
    }
  });
  return alive.load();
}

// Eval batch (src/data.py:140-192): candidate 0 = held-out positive at
// window end, slots 1..T = negatives, all sharing the positive's context.
// Outputs (pre-zeroed): p_x [B,L], p_c [B,L,C], o_x [B,T+1], o_c [B,T+1,C],
// y [B,T+1]. Returns number of alive rows.
int64_t carca_eval_batch(
    const int32_t* items, const int64_t* offsets, const float* ctx,
    int64_t n_ctx, const int64_t* win_start, const int64_t* win_end,
    const int64_t* user_rows, int64_t batch, int64_t L, int64_t T,
    int64_t n_items, uint64_t seed, int64_t n_threads,
    int32_t* p_x, float* p_c, int32_t* o_x, float* o_c, float* y) {
  std::atomic<int64_t> alive{0};
  run_rows(batch, n_threads, [&](int64_t b) {
    int64_t u = user_rows[b];
    if (u < 0) return;
    int64_t s = win_start[u], e = win_end[u];
    if (e <= s) return;
    alive.fetch_add(1);
    int64_t off = offsets[u];
    int64_t prof_len = offsets[u + 1] - off;

    IdSet forbid(static_cast<size_t>(prof_len) + static_cast<size_t>(T));
    for (int64_t i = 0; i < prof_len; ++i) forbid.insert(items[off + i]);

    Rng rng(seed ^ (0x2545f4914f6cdd1dULL * static_cast<uint64_t>(b + 1)));
    int32_t* px = p_x + b * L;
    float* pc = p_c + b * L * n_ctx;
    int32_t* ox = o_x + b * (T + 1);
    float* oc = o_c + b * (T + 1) * n_ctx;

    for (int64_t j = 0; j < L; ++j) {
      int64_t pi = e - L - 1 + j;
      if (pi < s) continue;
      int64_t ev = off + pi;
      px[j] = items[ev];
      std::memcpy(pc + j * n_ctx, ctx + ev * n_ctx,
                  sizeof(float) * static_cast<size_t>(n_ctx));
    }

    int64_t pos_ev = off + e - 1;
    ox[0] = items[pos_ev];
    const float* pos_ctx = ctx + pos_ev * n_ctx;
    y[b * (T + 1)] = 1.0f;
    for (int64_t t = 0; t <= T; ++t)
      std::memcpy(oc + t * n_ctx, pos_ctx,
                  sizeof(float) * static_cast<size_t>(n_ctx));
    for (int64_t t = 1; t <= T; ++t) {
      int32_t neg;
      do {
        neg = static_cast<int32_t>(rng.uniform_id(n_items));
      } while (forbid.contains(neg));
      forbid.insert(neg);
      ox[t] = neg;
    }
  });
  return alive.load();
}

}  // extern "C"
