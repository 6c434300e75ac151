// K2: masked multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel carca_tpu/ops/flash_attention.py::_bwd_kernel,
// reached from fused_attention through _attention_bwd (the custom VJP).
// Its forward is K1 (attention_fwd.cu); its plain version is autograd over
// carca_tpu_torch/models/attention.py::masked_attention.
//
// What it computes, per (b, h) and query row i (K1's notation):
//   w_raw = softmax((q_i K^T + add) / scale), m = the pair mask of row i,
//   keep  = the same Philox bits as K1 (philox.cuh), kp = 1 - p;
//   w_d   = keep ? w_raw * m / kp : 0                  (the forward's weights)
//   dW    = dO_i V^T, through dropout (keep ? dW / kp : 0) and re-mask (* m);
//   D     = sum_j dW_j w_raw_j,  dS = w_raw * (dW - D) / scale;
//   dQ_i  = dS K,   dK += dS^T q_i,   dV += w_d^T dO_i.
// No gradient flows to the masks. A fully masked row has m = 0 everywhere,
// so dW = 0, D = 0, dS = 0 and w_d = 0: its dQ row and its share of dK/dV
// are exactly zero. With bf16 compute the product inputs (q, k, v, dO, dS,
// w_d) are rounded to bf16, as _bwd_kernel's .astype(cd) do; every sum
// stays fp32.
//
// What bounds it on the H100 (3.35 TB/s; 3xTF32 at 495/3 TFLOP/s): five
// [Lq, Lk, dh] products per (b, h) against the traffic of q, dO, k, v and
// dq, dk, dv. At L = 50 bytes bind: 46 MB at the games/fashion encoder
// [256, 50, 128] (64-dim heads), 13.7 us. At L = 200 (men) operations do:
// 6.55 GFLOP at [256, 200, 64], 39.7 us.
//
// Two kernels, chosen by a rule on shapes (takes_whole_row_bwd below;
// ops/flash_attention.py::bwd_branch is the same rule, and the tests hold
// the two equal). Both own their (b, h)'s rows of dq, dk and dv: no atomics,
// no scratch but the keep bits, two runs bit-equal.
//
// * bwd_kernel: every shape but the rule's. The TPU kernel's tile walk, one
//   block of four warps per (b, h) that holds the head's keys in turn and
//   walks its query tiles (64 rows, a warp per 16), on mma.sync:
//   - per key tile, dW = dO V^T, then S = Q K^T, into registers; the row
//     max, sum and D = sum_j dW_j w_j (past 64 keys online, in a first walk
//     over the key tiles); dS and w_d in registers; dQ (+)= dS K from
//     registers;
//   - w_d^T, then dS^T, through shared memory; each warp takes 16 keys for
//     dV (+)= w_d^T dO and dK (+)= dS^T Q, adding a later tile's share to
//     the rows it wrote itself. Key tiles past a causal query tile's
//     diagonal are skipped.
//   Five products per tile pair at L <= 64, seven past it. Shared memory is
//   three slots: dO, Q, and one that holds in turn V (dW), K (S, dQ), w_d^T
//   and dS^T. At 64-dim heads that is 52.7 KB: four blocks per SM, so the
//   games encoder's 512 (b, h) run in one wave (128 registers). cp.async
//   stages every tile. Float32 products split their operands by split_fast
//   (mma.cuh). At L <= 56 (every train shape but men's) a 56-row
//   instantiation spends no product on the padding of a 64-row tile. In a
//   causal tile each warp skips the n8 blocks that hold masked pairs only:
//   the key blocks past its last row's diagonal (S, dW, dQ) and the query
//   blocks before the first row that sees its first key (dK, dV). What
//   bounds it: the latency of its mma.sync chains and tile stages at 16
//   warps per SM.
//
// * whole_row_bwd_kernel: 64 < Lk <= 200 at heads of up to 32 dims (men's
//   encoder and decoder, L = 200, and the remat batch), as the TPU kernel
//   holds the whole key row in VMEM per query block. One block of two
//   warpgroups per (b, h), one block an SM:
//   - K (for S), V (for dW) and K^T (for dQ; in P's accumulator order,
//     vpos, as K1 stages V^T) are staged once for all of the (b, h)'s query
//     tiles, float32 split into TF32 hi and lo there.
//   - The key row is cut in chunks of 40 keys (K1's); warpgroup 0 owns the
//     even chunks, warpgroup 1 the odd ones (3 + 2 at Lk = 200, 1 + 1 in a
//     causal tile that reaches 80 keys), and K, V and K^T hold each
//     warpgroup's chunks side by side. Per 64-row query tile each
//     warpgroup holds S and dW of its live chunks in registers, each one
//     wgmma per k step over all of them (m64n40, n80 or n120; A = Q or dO
//     from registers, B = K or V): a wgmma costs ~100 cycles whatever its
//     width here, and one per chunk took 51k of a block's 214k cycles where
//     one per k step takes 30k (clock64 stamps, Lk = 200). So the row's
//     statistics come in one pass and no product runs twice: five per tile
//     pair.
//   - The row max, sum and D are merged across the two warpgroups once,
//     through shared memory (each side's max, sum of exp(z - its max) and
//     sum of dW exp(z - its max)); both sides form the same sum and D, so a
//     row with one live key still gets dS = w (dW - D) = 0 exactly.
//   - dQ: each warpgroup's share dS K^T with A = dS from registers; the odd
//     warpgroup leaves its share in shared memory and goes on (bar.arrive),
//     the even one adds it to its own and writes the rows.
//   - dV = w_d^T dO and dK = dS^T Q with M = the warpgroup's keys: w_d and
//     dS go through a [64 keys][64 queries] tile of shared memory per
//     warpgroup (float32, one 64-key M tile at a time), which the products
//     read back as A fragments (split in registers); B = dO^T and Q^T,
//     staged per query tile. The warpgroup adds each tile's share to the
//     rows of dk and dv it wrote before (a key chunk's first tile writes
//     them), as bwd_kernel does.
//   - Causal tiles skip the key chunks past their last row + causal: every
//     weight there is exactly 0 (underflow in a row with a live key, the
//     re-mask in a row with none), so dS = w_d = 0 there too, which the CPU
//     tests hold bit for bit on the plain version; chunks no tile reaches
//     get zero dk and dv at the end.
//   - Every live-chunk count is straight-line code (with_count): a branch
//     around a wgmma serializes every float32 product (C7512).
//   Shared memory at Lk = 200, float32: K, V and K^T hi and lo 153.6 KB,
//   Q^T and dO^T hi and lo 32.8 KB, the two transposed tiles 34.8 KB, the
//   dQ share 8.2 KB, the statistics and key mask 2.3 KB: 231.7 of the
//   232.4 KB a block may have (bf16: 92.4 KB). Heads of 64 dims stay on
//   bwd_kernel: their K, V and K^T hi and lo alone would take 307 KB.
//   Registers (ptxas's count is in nvcc.log): S and dW of three chunks
//   take 120 a thread, the Q and dO fragments 64 more while the score
//   products run, the dQ ring 40 and a transposed tile's A fragments 64.
//   Query padding: Lq = 200 is three full tiles and one of 8 rows, whose
//   score and dQ products cost a whole 64-row tile (wgmma is 64 rows; 21 %
//   of those products for 4 % of the rows); its dK and dV products take one
//   k step of queries instead of eight.
//   Predicted before the first timed run (NVIDIA H100 80GB HBM3, 700 W,
//   keep-bits pre-pass included, ms): men encoder [256,200,64] dropout 0.5
//   0.25-0.35 (bwd_kernel 0.5219), men decoder [512,200,64]^2 causal -1
//   0.40-0.60 (0.9827), remat men encoder [2048,200,64] 1.9-2.7 (3.8227).
//
// With dropout both kernels read the packed keep bits of the pre-pass
// (attention_tile.cuh::launch_keep_bits, keep_window): the same words K1
// read, from the same seed or the same device slot under a graph.

#include <limits.h>

#include "attention_tile.cuh"
#include "wgmma.cuh"

namespace {

using carca::attn::Args;
using carca::attn::kNT;
using carca::attn::kThreads;
using carca::attn::kTile;

constexpr int kLDT = kTile + 4;  // row stride of the [keys][queries] tiles w_d^T and dS^T

// Shared memory: three slots of kTile rows and the two masks. Slot 0 holds
// the query tile's dO rows, slot 2 its Q rows; slot 1 holds in turn a key
// tile's V (for dW), its K (for S and dQ), w_d^T (for dV) and dS^T (for dK).
template <int kDh>
__host__ __device__ constexpr int slot1_stride() {
  return kDh + 4 > kLDT ? kDh + 4 : kLDT;
}

template <int kDh>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * kTile * (2 * (kDh + 4) + slot1_stride<kDh>() + 2);
}

// Blocks per SM the compiler must fit (registers), from the shared memory
// above (36.4 / 52.7 / 101.9 KB of the SM's 228 KB at kDh = 32 / 64 / 128):
// four (128 registers) up to 64, two (255) at 128.
template <int kDh>
constexpr int bwd_min_blocks() {
  return kDh <= 64 ? 4 : 2;
}

// Whether a causal tile's warps skip the n8 blocks of masked pairs: at head
// tiles of 64 and more. At 32 they cost more than they saved (the remat
// flagship's [2048,50,64], causal 0: 0.2367 -> 0.2523 ms; the games
// decoder [512,50,128]^2, causal -1, at 64: 0.1565 -> 0.1489).
template <int kDh>
__host__ __device__ constexpr bool causal_skips() {
  return kDh >= 64;
}

// Column windows of dQ, dK and dV accumulated at once: halves from kDh = 64
// (16 registers each instead of 32).
template <int kDh>
__host__ __device__ constexpr int windows() {
  return kDh >= 64 ? 2 : 1;
}

// load_tile's asynchronous twin: cp.async of 16 bytes where `vec` (src
// 16-byte aligned, dh and d multiples of 4), 4 bytes otherwise; zeros past
// `rows` and `dh` by the copies' zero fill; wait_copies() waits for them.
template <int kDh>
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ src,
                                                int rows, int d, int dh, bool vec) {
  constexpr int LD = kDh + 4;
  if (vec) {
    for (int idx = threadIdx.x; idx < kTile * (kDh / 4); idx += kThreads) {
      const int r = idx / (kDh / 4), e = 4 * (idx % (kDh / 4));
      const bool in = r < rows && e < dh;
      carca::cp_async16(dst + r * LD + e, in ? src + (size_t)r * d + e : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * kDh; idx += kThreads) {
      const int r = idx / kDh, e = idx % kDh;
      const bool in = r < rows && e < dh;
      carca::cp_async4(dst + r * LD + e, in ? src + (size_t)r * d + e : src, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void wait_copies() {
  carca::cp_async_commit();
  carca::cp_async_wait<0>();
  __syncthreads();
}

// Keys and queries a short instantiation covers (kN = 7 n8 blocks): at
// L <= 56 (every train shape but men's, L = 50) the padding of a 64-row tile
// costs no products.
constexpr int kShort = 56;

// A warp's [16, 8 kCols] accumulators (rows g and g + 8, accumulator layout)
// to rows g and g + 8 of a [*, d] tensor at dst (the warp's first row, the
// window's first column): rows below `valid`, columns below w; with `add`,
// plus what those elements hold (written earlier by this same lane).
template <int kCols>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, const float (&acc)[kCols][4],
                                          int g, int t, int valid, int d, int w, bool add,
                                          bool vec2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (g + 8 * r >= valid) continue;
    float* row = dst + (size_t)(g + 8 * r) * d;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      const int c = 8 * n + 2 * t;
      if (c >= w) continue;
      float x0 = acc[n][2 * r], x1 = acc[n][2 * r + 1];
      if (vec2) {  // w is even
        float2* p = reinterpret_cast<float2*>(row + c);
        if (add) {
          const float2 y = *p;
          x0 += y.x;
          x1 += y.y;
        }
        *p = make_float2(x0, x1);
      } else {
        row[c] = add ? x0 + row[c] : x0;
        if (c + 1 < w) row[c + 1] = add ? x1 + row[c + 1] : x1;
      }
    }
  }
}

// Block (b, h): dq, dk and dv of one head of one batch row. Tiles of 64 rows
// whose products cover kN n8 blocks of keys and queries (kNT; kShort / 8
// when Lq, Lk <= kShort).
template <int kDh, bool kBf16, int kN>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<kDh>())
bwd_kernel(const Args a, float* __restrict__ dk, float* __restrict__ dv) {
  using namespace carca::attn;
  constexpr int LD = kDh + 4;
  constexpr int kCols = kDh / 8 / windows<kDh>();  // n8 blocks of a column window
  extern __shared__ float4 smem4[];
  float* dos = reinterpret_cast<float*>(smem4);  // slot 0: [kTile][LD] dO rows
  float* s1 = dos + kTile * LD;                  // slot 1: V, K, w_d^T, dS^T
  float* qs = s1 + kTile * slot1_stride<kDh>();  // slot 2: [kTile][LD] Q rows
  float* qms = qs + kTile * LD;                  // [kTile]
  float* kms = qms + kTile;                      // [kTile]

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int d = a.H * a.dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool vec_dims = a.dh % 4 == 0 && d % 4 == 0;
  const bool vec_q = vec_dims && aligned16(a.q), vec_do = vec_dims && aligned16(a.dout);
  const bool vec_k = vec_dims && aligned16(a.k), vec_v = vec_dims && aligned16(a.v);
  const bool vec2 = a.dh % 2 == 0 && d % 2 == 0;  // dq, dk, dv come from torch.empty
  const int nch = n_chunks<kDh>(a.dh);
  const int nkt = (a.Lk + kTile - 1) / kTile, nqt = (a.Lq + kTile - 1) / kTile;
  const uint64_t bh = (uint64_t)b * a.H + h;
  const size_t head = (size_t)h * a.dh;

  // Key tiles that query tile qt reaches: those past the causal diagonal
  // of its last row hold only masked pairs, whose weights and gradients are
  // exactly 0 (a row with no live key at all comes out 0 over any tiles).
  auto key_tiles = [&](int qt) {
    if (!a.has_causal) return nkt;
    const int last = min(a.Lq, (qt + 1) * kTile) - 1 + a.causal;
    return min(nkt, max(1, last / kTile + 1));
  };

  const int r0 = 16 * warp + g;  // this lane's query rows r0, r0 + 8 of the tile
  const int k0 = 16 * warp;      // this warp's keys of the key tile for dK and dV
  int visited = 0;               // key tiles the previous query tile reached
  for (int qt = 0; qt < nqt; ++qt) {
    const int row0 = qt * kTile, rows = min(kTile, a.Lq - row0), i0 = row0 + r0;
    const size_t qoff = ((size_t)b * a.Lq + row0) * d + head;
    const int nkq = key_tiles(qt);
    __syncthreads();  // the previous query tile is consumed
    if (nch == 1) {  // dO and Q stay for the whole query tile
      load_tile_async<kDh>(dos, a.dout + qoff, rows, d, a.dh, vec_do);
      load_tile_async<kDh>(qs, a.q + qoff, rows, d, a.dh, vec_q);
    }
    load_mask(qms, a.qm + (size_t)b * a.Lq + row0, rows);

    float s[kN][4], dw[kN][4];  // S then w_d; dW then dS (queries x keys)
    uint2 kw[2];                  // keep bits of the key tile in rows i0, i0 + 8
    // Causal: the n8 key blocks of key tile kt that hold a live pair of this
    // warp's rows (none for a warp past Lq). The others hold masked pairs
    // only, whose dS and w_d are exactly 0 (as for skipped key tiles), so
    // their products are skipped: S and dW stay 0 there, which the mask
    // turns into weights of exactly 0 (or a fully masked row's).
    const int warp_last = min(a.Lq, row0 + 16 * warp + 16) - 1;  // this warp's last row
    auto live_blocks = [&](int key0) {
      if (!causal_skips<kDh>() || !a.has_causal) return kN;
      const int x = warp_last + a.causal - key0;  // the last key any of its rows sees
      return row0 + 16 * warp >= a.Lq || x < 0 ? 0 : min(kN, x / 8 + 1);
    };

    // Key tile kt: dW = dO V^T, then S = Q K^T (V's slot then takes K), each
    // summed over the column chunks; the logits, and dW through dropout and
    // re-mask. K stays in slot 1 at one chunk.
    auto scores = [&](int kt) {
      const int key0 = kt * kTile, keys = min(kTile, a.Lk - key0);
      const size_t koff = ((size_t)b * a.Lk + key0) * d + head;
      zero(s);
      zero(dw);
      for (int c = 0; c < nch; ++c) {
        const int w = chunk_width<kDh>(a.dh, c);
        __syncthreads();  // slot 1 (and at chunks slot 0) is consumed
        if (nch > 1) load_tile_async<kDh>(dos, a.dout + qoff + c * kDh, rows, d, w, vec_do);
        load_tile_async<kDh>(s1, a.v + koff + c * kDh, keys, d, w, vec_v);
        if (c == 0) {
          load_mask(kms, a.km + (size_t)b * a.Lk + key0, keys);
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // in flight beside the copies
            const int i = i0 + 8 * r;
            kw[r] = a.dropout && i < a.Lq ? keep_window(a.bits, (bh * a.Lq + i) * a.Lk + key0)
                                          : make_uint2(0u, 0u);
          }
        }
        wait_copies();
        mma_rows_bt<kDh, kBf16, kN, true>(dw, dos + r0 * LD, dos + (r0 + 8) * LD, s1, g, t,
                                          live_blocks(key0));
        __syncthreads();  // V is consumed
        if (nch > 1) load_tile_async<kDh>(qs, a.q + qoff + c * kDh, rows, d, w, vec_q);
        load_tile_async<kDh>(s1, a.k + koff + c * kDh, keys, d, w, vec_k);
        wait_copies();
        mma_rows_bt<kDh, kBf16, kN, true>(s, qs + r0 * LD, qs + (r0 + 8) * LD, s1, g, t,
                                          live_blocks(key0));
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int jl = 8 * n + 2 * t, j = key0 + jl;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + 8 * r;
          const float qmi = qms[r0 + 8 * r];
          const float m0 = pair_mask(a, qmi, kms[jl], i, j);
          const float m1 = pair_mask(a, qmi, kms[jl + 1], i, j + 1);
          s[n][2 * r] = logit(a, s[n][2 * r], m0, j);
          s[n][2 * r + 1] = logit(a, s[n][2 * r + 1], m1, j + 1);
          float d0 = dw[n][2 * r], d1 = dw[n][2 * r + 1];
          if (a.dropout) {
            const uint32_t kb = (n < 4 ? kw[r].x : kw[r].y) >> (jl % 32);
            d0 = kb & 1u ? d0 * a.inv_keep : 0.f;
            d1 = kb & 2u ? d1 * a.inv_keep : 0.f;
          }
          dw[n][2 * r] = d0 * m0;  // through the re-mask
          dw[n][2 * r + 1] = d1 * m1;
        }
      }
    };

    // The row statistics: max m, sum l and D = sum_j dW_j w_j, online over
    // key tiles. With one key tile the weights p = exp(z - m) stay in s.
    float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
    auto statistics = [&](bool keep_p) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int n = 0; n < kN; ++n) tmax = fmaxf(tmax, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float mnew = fmaxf(mx[r], quad_max(tmax));
        const float rescale = exp_shifted(mx[r] - mnew);  // 0 on the first tile
        float lt = 0.f, dt = 0.f;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
#pragma unroll
          for (int c = 2 * r; c < 2 * r + 2; ++c) {
            const float p = exp_shifted(s[n][c] - mnew);
            lt += p;
            dt = fmaf(dw[n][c], p, dt);
            if (keep_p) s[n][c] = p;
          }
        }
        l[r] = fmaf(l[r], rescale, lt);
        dsum[r] = fmaf(dsum[r], rescale, dt);
        mx[r] = mnew;
      }
    };
    if (nkq > 1) {  // a first walk for the statistics
      for (int kt = 0; kt < nkq; ++kt) {
        scores(kt);
        statistics(false);
      }
    }

    // rows k0 + g, k0 + g + 8 of the transposed tile in slot 1, in the
    // accumulator layout
    auto transposed_rows = [&](float (&p)[kN][4]) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(s1 + (k0 + g) * kLDT + 8 * n + 2 * t);
        const float2 y =
            *reinterpret_cast<const float2*>(s1 + (k0 + g + 8) * kLDT + 8 * n + 2 * t);
        p[n][0] = x.x;
        p[n][1] = x.y;
        p[n][2] = y.x;
        p[n][3] = y.y;
      }
    };
    // the transpose of a score tile into slot 1, once every warp is done
    // with what slot 1 held
    auto put_transposed = [&](const float (&x)[kN][4]) {
      __syncthreads();
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s1[(8 * n + 2 * t + c % 2) * kLDT + r0 + 8 * (c / 2)] = x[n][c];
      __syncthreads();
    };

    float inv_l[2], dd[2];
    for (int kt = 0; kt < nkq; ++kt) {
      const int key0 = kt * kTile, keys = min(kTile, a.Lk - key0);
      const size_t koff = ((size_t)b * a.Lk + key0) * d + head;
      scores(kt);
      if (nkq == 1) statistics(true);
      if (kt == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          inv_l[r] = 1.f / quad_sum(l[r]);
          dd[r] = quad_sum(dsum[r]) * inv_l[r];
        }
      }
      // w_raw, then dS = w_raw (dW - D) / scale in dw and w_d in s
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int jl = 8 * n + 2 * t, j = key0 + jl;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + 8 * r;
          const float qmi = qms[r0 + 8 * r];
          const uint32_t kb = (n < 4 ? kw[r].x : kw[r].y) >> (jl % 32);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float z = s[n][2 * r + c];
            const float w = (nkq == 1 ? z : exp_shifted(z - mx[r])) * inv_l[r];
            dw[n][2 * r + c] = w * (dw[n][2 * r + c] - dd[r]) * a.inv_scale;
            float wd = w * pair_mask(a, qmi, kms[jl + c], i, j + c);
            if (a.dropout) wd = (kb >> c) & 1u ? wd * a.inv_keep : 0.f;
            s[n][2 * r + c] = wd;
          }
        }
      }

      // dQ (+)= dS K, per column chunk and window
      for (int ch = 0; ch < nch; ++ch) {
        const int w = chunk_width<kDh>(a.dh, ch);
        if (nch > 1) {  // chunk ch's columns of K
          __syncthreads();
          load_tile_async<kDh>(s1, a.k + koff + ch * kDh, keys, d, w, vec_k);
          wait_copies();
        }
#pragma unroll
        for (int win = 0; win < windows<kDh>(); ++win) {
          float acc[kCols][4];
          zero(acc);
          mma_regs_b<kDh, kBf16, kN, kCols, true>(acc, dw, s1 + 8 * kCols * win, g, t, 0,
                                                  live_blocks(key0));
          store_acc<kCols>(a.out + qoff + (size_t)(16 * warp) * d + ch * kDh + 8 * kCols * win,
                           acc, g, t, rows - 16 * warp, d, w - 8 * kCols * win, kt > 0, vec2);
        }
      }

      // dV (+)= w_d^T dO, then dK (+)= dS^T Q, for the warp's 16 keys, per
      // column chunk and window; a key tile an earlier query tile reached
      // holds a partial sum
      const bool add = kt < visited;
      // Causal: the query blocks below the first row that sees the warp's
      // first key hold masked pairs only (dS = w_d = 0): skipped
      int first_block = 0;
      if (causal_skips<kDh>() && a.has_causal) {
        const int x = key0 + k0 - a.causal - row0;  // the first row that sees key key0 + k0
        first_block = x <= 0 ? 0 : min(kN, x / 8);
      }
      auto key_grads = [&](const float (&x)[kN][4], float* rows_src, const float* src,
                           bool vec_src, float* out) {
        put_transposed(x);
        for (int ch = 0; ch < nch; ++ch) {
          const int w = chunk_width<kDh>(a.dh, ch);
          if (nch > 1) {  // chunk ch's columns of dO (Q)
            if (ch > 0) __syncthreads();
            load_tile_async<kDh>(rows_src, src + qoff + ch * kDh, rows, d, w, vec_src);
            wait_copies();
          }
          if (k0 < keys) {
            float p[kN][4];
            transposed_rows(p);
#pragma unroll
            for (int win = 0; win < windows<kDh>(); ++win) {
              float acc[kCols][4];
              zero(acc);
              mma_regs_b<kDh, kBf16, kN, kCols, true>(acc, p, rows_src + 8 * kCols * win, g, t,
                                                      first_block);
              store_acc<kCols>(out + koff + (size_t)k0 * d + ch * kDh + 8 * kCols * win, acc, g,
                               t, keys - k0, d, w - 8 * kCols * win, add, vec2);
            }
          }
        }
      };
      key_grads(s, dos, a.dout, vec_do, dv);
      key_grads(dw, qs, a.q, vec_q, dk);
    }
    visited = nkq;
  }

  // dK and dV of the key tiles no query tile reached (or of every key, when
  // Lq = 0) are 0
  for (int idx = visited * kTile * a.dh + threadIdx.x; idx < a.Lk * a.dh; idx += kThreads) {
    const size_t at = ((size_t)b * a.Lk + idx / a.dh) * d + head + idx % a.dh;
    dk[at] = 0.f;
    dv[at] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// whole_row_bwd_kernel (64 < Lk <= 200, heads of up to 32 dims)
// ---------------------------------------------------------------------------

using carca::attn::kRowChunks;
using carca::attn::kRowKeys;
using carca::attn::kRowNB;

constexpr int kBwdThreads = 2 * kThreads;        // two warpgroups
constexpr int kLDW = kTile + 4;                  // row stride of a transposed [keys][queries] tile
constexpr int kMine = (kRowChunks + 1) / 2;      // key chunks warpgroup 0 owns at most
constexpr int kMTiles = (kRowKeys * kMine + kTile - 1) / kTile;  // its 64-key M tiles

// Whether whole_row_bwd_kernel takes key length Lk at head width dh: one
// key tile is bwd_kernel's, and so are heads wider than 32 dims.
inline bool takes_whole_row_bwd(int Lk, int dh) {
  return Lk > kTile && Lk <= kRowKeys * kRowChunks && carca::attn::head_tile(dh) <= 32;
}

// Shared memory of a block staging `chunks` key chunks (the header's list).
template <int kDh, bool kBf16>
constexpr size_t row_bwd_smem_bytes(int chunks) {
  const size_t keys = (size_t)kRowKeys * chunks;
  const size_t vkeys = kBf16 ? keys + 8 : keys;  // bf16: a chunk's last k16 step reads 8 keys on
  const size_t el = kBf16 ? 2 : 4, parts = kBf16 ? 1 : 2;
  return parts * (2 * keys + vkeys) * kDh * el + parts * 2 * kTile * kDh * el +
         sizeof(float) * (2 * kTile * kLDW + kTile * kDh + 2 * kTile * 3 + keys);
}

// Block (h, b): two warpgroups; warpgroup w owns key chunks w, w + 2, ...
template <int kDh, bool kBf16>
__global__ void __launch_bounds__(kBwdThreads, 1)
whole_row_bwd_kernel(const Args a, float* __restrict__ dk, float* __restrict__ dv) {
  using namespace carca;
  using namespace carca::attn;
  constexpr int kEl = kBf16 ? 2 : 4;             // bytes of a staged operand
  constexpr int kParts = kBf16 ? 1 : 2;          // bf16, or TF32 hi and lo
  constexpr int kKG = kDh * kEl / 16;            // K's core matrices along dh
  constexpr uint32_t kSboK = kKG * 128;          // K, V: bytes between 8-key groups
  constexpr uint32_t kSboT = kTile * kEl * 8;    // Q^T, dO^T: bytes between 8-column groups
  constexpr int kSteps = kBf16 ? kDh / 16 : kDh / 8;       // k steps over a head's columns
  constexpr int kQSteps = kBf16 ? kTile / 16 : kTile / 8;  // k steps over a tile's queries
  extern __shared__ __align__(128) uint8_t smem[];

  const int h = blockIdx.x, b = blockIdx.y;
  const int d = a.H * a.dh;
  const int wgi = threadIdx.x / kThreads;        // this warpgroup: chunks wgi, wgi + 2, ...
  const int warp = threadIdx.x / 32 % kWarps, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nc = (a.Lk + kRowKeys - 1) / kRowKeys;
  const int keys = nc * kRowKeys;
  const int vkeys = kBf16 ? keys + 8 : keys;
  const size_t kb = (size_t)keys * kDh * kEl, vb = (size_t)vkeys * kDh * kEl;
  constexpr size_t tb = (size_t)kTile * kDh * kEl;
  uint8_t* k_hi = smem;
  uint8_t* k_lo = k_hi + kb;  // float32 only (so are the other _lo)
  uint8_t* v_hi = smem + kParts * kb;
  uint8_t* v_lo = v_hi + kb;
  uint8_t* kt_hi = smem + 2 * kParts * kb;
  uint8_t* kt_lo = kt_hi + vb;
  uint8_t* qt_hi = kt_hi + kParts * vb;
  uint8_t* qt_lo = qt_hi + tb;
  uint8_t* dt_hi = qt_hi + kParts * tb;
  uint8_t* dt_lo = dt_hi + tb;
  float* tws = reinterpret_cast<float*>(dt_hi + kParts * tb);  // [2][kTile][kLDW]
  float* dqx = tws + 2 * kTile * kLDW;                          // [kTile][kDh]
  float* stat = dqx + kTile * kDh;                              // [2][kTile][3]
  float* kms = stat + 2 * kTile * 3;                            // [keys]
  float* tw = tws + wgi * kTile * kLDW;
  // K, V and K^T hold the key chunks warpgroup by warpgroup: the even
  // chunks (warpgroup 0's) in slots 0 .. h0 - 1, the odd ones after them,
  // so a warpgroup's live chunks are one [40 m, kDh] block for one wgmma
  const int h0 = (nc + 1) / 2;
  const int slot0 = wgi ? h0 : 0;  // this warpgroup's first slot
  auto row_of = [&](int j) {       // the staged row of key j
    const int c = j / kRowKeys;
    return kRowKeys * ((c % 2 ? h0 : 0) + c / 2) + j % kRowKeys;
  };

  const bool vec_dims = a.dh % 4 == 0 && d % 4 == 0;
  const size_t kvoff = (size_t)b * a.Lk * d + (size_t)h * a.dh;
  // K and V as [keys][kDh] core matrices (B of S = Q K^T and dW = dO V^T),
  // K^T as [kDh][keys] in vpos order (B of dQ = dS K), K1's staging: items
  // of kPer columns of one key, kBatch of them in flight per thread
  {
    constexpr int kPer = kBf16 ? 8 : 4;
    constexpr int kBatch = kBf16 ? 4 : 8;
    constexpr int kCG = kDh / kPer;
    auto v_item = [](int idx, int& j, int& e) {
      const int k = idx % (8 * kCG) / kCG;
      j = 8 * (idx / (8 * kCG)) + (k < 4 ? 2 * k : 2 * k - 7);
      e = kPer * (idx % kCG);
    };
    auto k_item = [](int idx, int& j, int& e) {
      j = 8 * (idx / (8 * kCG)) + idx % 8;
      e = kPer * (idx / 8 % kCG);
    };
    const bool vec_k = vec_dims && aligned16(a.k), vec_v = vec_dims && aligned16(a.v);
    auto natural = [&](uint8_t* hi, uint8_t* lo, int j, int e, const float* x) {
      const size_t off = ((size_t)(j / 8) * kKG + e * kEl / 16) * 128 + (j % 8) * 16;
      if constexpr (kBf16) {
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(
            pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
      } else {
        const Split s0 = split(x[0]), s1 = split(x[1]), s2 = split(x[2]), s3 = split(x[3]);
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
        *reinterpret_cast<uint4*>(lo + off) = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
      }
    };
    const int items = vkeys * kCG;
#pragma unroll 1
    for (int base = 0; base < items; base += kBatch * kBwdThreads) {
      float xk[kBatch][kPer], xv[kBatch][kPer], xt[kBatch][kPer];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kBwdThreads + threadIdx.x;
        int jk, ek, jt, et;
        k_item(idx, jk, ek);
        v_item(idx, jt, et);
        const bool live_k = idx < items && jk < a.Lk, live_t = idx < items && jt < a.Lk;
#pragma unroll
        for (int p = 0; p < kPer; p += 4) {
          const float4 fk = live_k ? load4(a.k + kvoff + (size_t)jk * d, ek + p, a.dh, vec_k)
                                   : make_float4(0, 0, 0, 0);
          const float4 fv = live_k ? load4(a.v + kvoff + (size_t)jk * d, ek + p, a.dh, vec_v)
                                   : make_float4(0, 0, 0, 0);
          const float4 ft = live_t ? load4(a.k + kvoff + (size_t)jt * d, et + p, a.dh, vec_k)
                                   : make_float4(0, 0, 0, 0);
          xk[u][p] = fk.x, xk[u][p + 1] = fk.y, xk[u][p + 2] = fk.z, xk[u][p + 3] = fk.w;
          xv[u][p] = fv.x, xv[u][p + 1] = fv.y, xv[u][p + 2] = fv.z, xv[u][p + 3] = fv.w;
          xt[u][p] = ft.x, xt[u][p + 1] = ft.y, xt[u][p + 2] = ft.z, xt[u][p + 3] = ft.w;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kBwdThreads + threadIdx.x;
        if (idx >= items) break;
        int j, e;
        k_item(idx, j, e);
        if (j < keys) {
          natural(k_hi, k_lo, row_of(j), e, xk[u]);
          natural(v_hi, v_lo, row_of(j), e, xv[u]);
        }
        // K^T: column n = e + p, key j at position vpos of its row (K1's V^T
        // stores; past the last chunk, bf16's 8 zero keys stay in place)
        v_item(idx, j, e);
        const int pj = j < keys ? row_of(j) : j;
        const int pos = kBf16 ? pj : vpos(pj);
        const int rot = kBf16 ? 0 : (idx % kCG) / 2 % 4;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const int pr = (p + rot) % kPer;
          const float x = kBf16 ? xt[u][p] : pick4(xt[u], pr);
          const int n = e + pr;
          const size_t off = ((size_t)(n / 8) * (vkeys * kEl / 16) + pos * kEl / 16) * 128 +
                             (n % 8) * 16 + (pos * kEl) % 16;
          if constexpr (kBf16) {
            *reinterpret_cast<__nv_bfloat16*>(kt_hi + off) = __float2bfloat16_rn(x);
          } else {
            const Split sp = split(x);
            *reinterpret_cast<uint32_t*>(kt_hi + off) = sp.hi;
            *reinterpret_cast<uint32_t*>(kt_lo + off) = sp.lo;
          }
        }
      }
    }
  }
  for (int j = threadIdx.x; j < keys; j += kBwdThreads)
    kms[j] = j < a.Lk ? __ldg(a.km + (size_t)b * a.Lk + j) : 0.f;
  wg::fence_smem();
  __syncthreads();

  const uint64_t bh = (uint64_t)b * a.H + h;
  const int nqt = (a.Lq + kTile - 1) / kTile;
  const float neg_logit = kNegMask * a.inv_scale;
  const bool vec2 = a.dh % 2 == 0 && d % 2 == 0;  // dq, dk, dv come from torch.empty
  // the operands' descriptors: a product's is its base's plus the tile's
  // offset / 16, made afresh in each query tile from the shared base
  // address (so the compiler keeps no product's descriptor across tiles)
  const uint32_t sbo_t = (uint32_t)vkeys * kEl * 8;  // K^T: bytes between 8-column groups
  auto desc_at = [&](const uint8_t* p, uint32_t sbo) {
    uint64_t x = wg::desc(smem, 128, sbo) + (uint32_t)(p - smem) / 16;
    wg::opaque(x);
    return x;
  };

  // A tile's rows of Q (or dO) as A fragments (K1's load_q): float32 [lo,
  // hi] of (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) each k8 step; bf16
  // the pairs at columns 2t and 2t + 8 of rows g, g + 8 each k16 step. With
  // `put`, the values also go to the tile's transpose (Q^T or dO^T: B of dK
  // and dV) as [kDh][kTile] core matrices: both warpgroups load both
  // tensors, warpgroup 0 writes Q^T and warpgroup 1 dO^T.
  auto load_a = [&](const float* src, uint32_t (&fa)[kBf16 ? 1 : 2][kSteps][4], int row0,
                    bool put, uint8_t* hi, uint8_t* lo) {
    const int i0 = row0 + 16 * warp + g;
    const float* rp[2];
    bool ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ok[r] = i0 + 8 * r < a.Lq;
      rp[r] = src + ((size_t)b * a.Lq + (ok[r] ? i0 + 8 * r : 0)) * d + (size_t)h * a.dh;
    }
    auto at = [&](int r, int e) { return ok[r] && e < a.dh ? __ldg(rp[r] + e) : 0.f; };
    // byte offset of element (column n, tile row q) in the transpose
    auto t_off = [](int n, int q) {
      return ((size_t)(n / 8) * (kTile * kEl / 16) + q * kEl / 16) * 128 + (n % 8) * 16 +
             (q * kEl) % 16;
    };
    float x[kSteps][kBf16 ? 8 : 4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (kBf16) {
        const int e = 16 * s + 2 * t;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c % 2, col = e + 8 * (c / 2);
          x[s][2 * c] = at(r, col), x[s][2 * c + 1] = at(r, col + 1);
        }
      } else {
        const int e = 8 * s + t;
        x[s][0] = at(0, e), x[s][1] = at(1, e), x[s][2] = at(0, e + 4), x[s][3] = at(1, e + 4);
      }
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (kBf16) {
        const int e = 16 * s + 2 * t;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          fa[0][s][c] = pack_bf16(x[s][2 * c], x[s][2 * c + 1]);
          if (put) {
            const int q = 16 * warp + g + 8 * (c % 2), col = e + 8 * (c / 2);
            *reinterpret_cast<__nv_bfloat16*>(hi + t_off(col, q)) = __float2bfloat16_rn(x[s][2 * c]);
            *reinterpret_cast<__nv_bfloat16*>(hi + t_off(col + 1, q)) =
                __float2bfloat16_rn(x[s][2 * c + 1]);
          }
        }
      } else {
        const int e = 8 * s + t;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const Split sp = split(x[s][c]);
          fa[0][s][c] = sp.lo, fa[1][s][c] = sp.hi;
          if (put) {
            const size_t off = t_off(e + 4 * (c / 2), 16 * warp + g + 8 * (c % 2));
            *reinterpret_cast<uint32_t*>(hi + off) = sp.hi;
            *reinterpret_cast<uint32_t*>(lo + off) = sp.lo;
          }
        }
      }
    }
  };

  int nl_prev = 0;  // key chunks the previous query tile reached
  for (int qt = 0; qt < nqt; ++qt) {
    const int row0 = qt * kTile, rows = min(kTile, a.Lq - row0);
    const int i0 = row0 + 16 * warp + g;  // this lane's query rows i0 and i0 + 8
    // dK and dV run one k step over a tile of at most one step's queries
    // (Lq = 200's last tile holds 8 rows), else all of them
    const bool one_step = rows <= (kBf16 ? 16 : 8);
    // key chunks the tile reaches (K1's rule): past the last row + causal
    // every weight is exactly 0; at least one
    int lim = a.Lk;
    if (a.has_causal) lim = min(lim, max(min(a.Lq, row0 + kTile) + a.causal, 1));
    const int nl = (lim + kRowKeys - 1) / kRowKeys;
    const int nm = (nl - wgi + 1) / 2;  // this warpgroup's live chunks: 2c + wgi < nl

    // the pair mask and keep bits of rows i0, i0 + 8 (loads in flight
    // beside the score products)
    float qmi[2];
    int last[2];
    uint2 kw[kMine][2];  // keep bits of each live chunk's 40 keys (a 64-key window)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      qmi[r] = i < a.Lq ? __ldg(a.qm + (size_t)b * a.Lq + i) : 0.f;
      last[r] = a.has_causal ? i + a.causal : INT_MAX;
#pragma unroll
      for (int c = 0; c < kMine; ++c)
        kw[c][r] = a.dropout && i < a.Lq && c < nm
                       ? keep_window(a.bits, (bh * a.Lq + i) * a.Lk + kRowKeys * (2 * c + wgi))
                       : make_uint2(0u, 0u);
    }

    __syncthreads();  // the previous tile's readers of Q^T, dO^T and the dQ share are done
    // S = Q K^T and dW = dO V^T over this warpgroup's live chunks
    float s[kMine][kRowNB][4], dw[kMine][kRowNB][4];
    {
      uint32_t qa[kBf16 ? 1 : 2][kSteps][4], da[kBf16 ? 1 : 2][kSteps][4];
      load_a(a.q, qa, row0, wgi == 0, qt_hi, qt_lo);
      load_a(a.dout, da, row0, wgi == 1, dt_hi, dt_lo);
      wg::fence_smem();  // Q^T, dO^T: read by the dK and dV products, after the statistics' barrier
      with_count<kMine>(nm, [&](auto count) {
        constexpr int kM = decltype(count)::value;
        if constexpr (kM > 0) {
          const uint64_t dsc[4] = {desc_at(k_hi, kSboK), desc_at(k_lo, kSboK),
                                   desc_at(v_hi, kSboK), desc_at(v_lo, kSboK)};
          const uint32_t coff = (uint32_t)slot0 * kRowNB * kSboK;
          wg::fence();
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
            for (int part = 0; part < (kBf16 ? 1 : 3); ++part) {
              const int x = kBf16 ? 0 : (part == 0 ? 0 : 1);
              const uint64_t off = (coff + ks * 256) / 16;
              wg::Mma<kRowKeys * kM, kBf16>::run(&s[0][0][0], qa[x][ks],
                                                 ((kBf16 || part != 1) ? dsc[0] : dsc[1]) + off,
                                                 ks > 0 || part > 0);
              wg::Mma<kRowKeys * kM, kBf16>::run(&dw[0][0][0], da[x][ks],
                                                 ((kBf16 || part != 1) ? dsc[2] : dsc[3]) + off,
                                                 ks > 0 || part > 0);
            }
          wg::commit();
          wg::wait<0>();
        }
      });
#pragma unroll
      for (int x = 0; x < (kBf16 ? 1 : 2); ++x)
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) wg::hold(qa[x][ks][e]), wg::hold(da[x][ks][e]);
    }
#pragma unroll
    for (int c = 0; c < kMine; ++c)
#pragma unroll
      for (int n = 0; n < kRowNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) wg::hold(s[c][n][e]), wg::hold(dw[c][n][e]);

    auto mask = [&](int r, float kmj, int j) { return j <= last[r] ? qmi[r] * kmj : 0.f; };

    // this warpgroup's share of the row statistics: its max, the sum of
    // exp(z - max) (p, kept in s) and of dW p, dW through dropout and
    // re-mask (kept in dw)
    float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kMine; ++c) {
      if (c >= nm) break;
#pragma unroll
      for (int n = 0; n < kRowNB; ++n) {
        const int jl = 8 * n + 2 * t, j = kRowKeys * (2 * c + wgi) + jl;
        const float2 km2 = *reinterpret_cast<const float2*>(kms + j);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t kbits = (n < 4 ? kw[c][r].x : kw[c][r].y) >> (jl % 32);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float m = mask(r, e ? km2.y : km2.x, j + e);
            float& z = s[c][n][2 * r + e];
            z = masked_logit(z, m, a.inv_scale, neg_logit);
            mx[r] = fmaxf(mx[r], z);
            float x = dw[c][n][2 * r + e];
            if (a.dropout) x = (kbits >> e) & 1u ? x * a.inv_keep : 0.f;
            dw[c][n][2 * r + e] = x * m;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
    for (int c = 0; c < kMine; ++c) {
      if (c >= nm) break;
#pragma unroll
      for (int n = 0; n < kRowNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp_shifted(s[c][n][e] - mx[e / 2]);
          s[c][n][e] = p;
          l[e / 2] += p;
          dsum[e / 2] = fmaf(dw[c][n][e], p, dsum[e / 2]);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      dsum[r] = quad_sum(dsum[r]);
      if (t == 0) {
        float* st = stat + (wgi * kTile + 16 * warp + g + 8 * r) * 3;
        st[0] = mx[r], st[1] = l[r], st[2] = dsum[r];
      }
    }
    __syncthreads();  // both shares written (and Q^T, dO^T staged)
    // the whole row's: sum = l0 e^(m0 - m) + l1 e^(m1 - m), D likewise over
    // the sum; both warpgroups form the same values (a + b = b + a)
    float f[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* st = stat + ((1 - wgi) * kTile + 16 * warp + g + 8 * r) * 3;
      const float mo = st[0], lo = st[1], dso = st[2];
      const float m = fmaxf(mx[r], mo);
      const float sw = exp_shifted(mx[r] - m), so = exp_shifted(mo - m);
      const float inv_l = 1.f / __fadd_rn(__fmul_rn(l[r], sw), __fmul_rn(lo, so));
      f[r] = sw * inv_l;  // w = p f
      dd[r] = __fmul_rn(__fadd_rn(__fmul_rn(dsum[r], sw), __fmul_rn(dso, so)), inv_l);
    }

    // dS = w (dW - D) / scale in dw, w_d (re-masked, through dropout) in s
#pragma unroll
    for (int c = 0; c < kMine; ++c) {
      if (c >= nm) break;
#pragma unroll
      for (int n = 0; n < kRowNB; ++n) {
        const int jl = 8 * n + 2 * t, j = kRowKeys * (2 * c + wgi) + jl;
        const float2 km2 = *reinterpret_cast<const float2*>(kms + j);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t kbits = (n < 4 ? kw[c][r].x : kw[c][r].y) >> (jl % 32);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float w = s[c][n][2 * r + e] * f[r];
            dw[c][n][2 * r + e] = w * (dw[c][n][2 * r + e] - dd[r]) * a.inv_scale;
            float wd = w * mask(r, e ? km2.y : km2.x, j + e);
            if (a.dropout) wd = (kbits >> e) & 1u ? wd * a.inv_keep : 0.f;
            s[c][n][2 * r + e] = wd;
          }
        }
      }
    }

    // dQ: this warpgroup's share dS K over its live chunks
    float dq[kDh / 8][4];
    with_count<kMine>(nm, [&](auto count) {
      constexpr int kM = decltype(count)::value;
      if constexpr (kM == 0) {
        zero(dq);
      } else if constexpr (kBf16) {
        const uint64_t kt = desc_at(kt_hi, sbo_t);
        uint32_t pa[kM][(kRowNB + 1) / 2][4];  // a chunk's k16 steps, the last one half zero
#pragma unroll
        for (int c = 0; c < kM; ++c)
#pragma unroll
          for (int k2 = 0; k2 < (kRowNB + 1) / 2; ++k2) {
            const float* p0 = dw[c][2 * k2];
            pa[c][k2][0] = pack_bf16(p0[0], p0[1]);
            pa[c][k2][1] = pack_bf16(p0[2], p0[3]);
            if (2 * k2 + 1 < kRowNB) {
              const float* p1 = dw[c][2 * k2 + 1];
              pa[c][k2][2] = pack_bf16(p1[0], p1[1]);
              pa[c][k2][3] = pack_bf16(p1[2], p1[3]);
            } else {  // the next chunk's keys (or the zeros past the last) weigh 0
              pa[c][k2][2] = pa[c][k2][3] = 0u;
            }
          }
        wg::fence();
#pragma unroll
        for (int c = 0; c < kM; ++c)
#pragma unroll
          for (int k2 = 0; k2 < (kRowNB + 1) / 2; ++k2)
            wg::Mma<kDh, true>::run(&dq[0][0], pa[c][k2],
                                    kt + ((kRowNB * (slot0 + c) + 2 * k2) * 128) / 16,
                                    c > 0 || k2 > 0);
        wg::commit();
        wg::wait<0>();
#pragma unroll
        for (int c = 0; c < kM; ++c)
#pragma unroll
          for (int k2 = 0; k2 < (kRowNB + 1) / 2; ++k2)
#pragma unroll
            for (int e = 0; e < 4; ++e) wg::hold(pa[c][k2][e]);
      } else {
        const uint64_t kth = desc_at(kt_hi, sbo_t), ktl = desc_at(kt_lo, sbo_t);
        uint32_t hi[kRowNB][4], lo[kRowNB][4];  // dS split, a ring of five k steps
#pragma unroll
        for (int c = 0; c < kM; ++c) {
#pragma unroll
          for (int n = 0; n < kRowNB; ++n) {
            if (c > 0) {  // the step that last read ring slot n has retired
              wg::wait<kRowNB - 1>();
#pragma unroll
              for (int e = 0; e < 4; ++e) wg::hold(hi[n][e]), wg::hold(lo[n][e]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const Split x = split_fast(dw[c][n][e]);
              hi[n][e] = x.hi;
              lo[n][e] = x.lo;
            }
            wg::fence();
            // k = t <-> key 2t, k = t + 4 <-> key 2t + 1 of the block (vpos)
            const uint32_t ahi[4] = {hi[n][0], hi[n][2], hi[n][1], hi[n][3]};
            const uint32_t alo[4] = {lo[n][0], lo[n][2], lo[n][1], lo[n][3]};
            const uint64_t kg = ((kRowNB * (slot0 + c) + n) * 256) / 16;
            wg::Mma<kDh, false>::run(&dq[0][0], alo, kth + kg, c > 0 || n > 0);
            wg::Mma<kDh, false>::run(&dq[0][0], ahi, ktl + kg, 1);
            wg::Mma<kDh, false>::run(&dq[0][0], ahi, kth + kg, 1);
            wg::commit();
          }
        }
        wg::wait<0>();
#pragma unroll
        for (int n = 0; n < kRowNB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) wg::hold(hi[n][e]), wg::hold(lo[n][e]);
      }
    });
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) wg::hold(dq[n][e]);
    // the odd warpgroup's share through shared memory (n8 blocks rotated by
    // g: two-way bank conflicts), the even one adds it and writes the rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* xr = dqx + (16 * warp + g + 8 * r) * kDh + 2 * t;
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        float2* p = reinterpret_cast<float2*>(xr + 8 * ((n + g) % (kDh / 8)));
        if (wgi == 1) *p = make_float2(dq[n][2 * r], dq[n][2 * r + 1]);
      }
    }
    if (wgi == 1) {
      bar_arrive(1, kBwdThreads);
    } else {
      bar_sync(1, kBwdThreads);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 8 * r;
        if (i >= a.Lq) continue;
        const float* xr = dqx + (16 * warp + g + 8 * r) * kDh + 2 * t;
        float* orow = a.out + ((size_t)b * a.Lq + i) * d + (size_t)h * a.dh;
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(xr + 8 * ((n + g) % (kDh / 8)));
          const float x0 = dq[n][2 * r] + y.x, x1 = dq[n][2 * r + 1] + y.y;
          const int e = 8 * n + 2 * t;
          if (vec2 && e + 1 < a.dh) {
            *reinterpret_cast<float2*>(orow + e) = make_float2(x0, x1);
          } else {
            if (e < a.dh) orow[e] = x0;
            if (e + 1 < a.dh) orow[e + 1] = x1;
          }
        }
      }
    }

    // dV += w_d^T dO, then dK += dS^T Q, per 64-key M tile of this
    // warpgroup's live keys (local key 40 c + x of chunk 2 c + wgi)
    auto key_grads = [&](int mt, const float (&x)[kMine][kRowNB][4], const uint8_t* bt_hi,
                         const uint8_t* bt_lo, float* out, auto prefetch) {
      // rows of dk / dv: a chunk an earlier tile reached holds a partial
      // sum, read (with `prefetch`) now so the load is in flight beside the
      // products, else after them
      float* row[2];
      bool add[2];
      float2 old[2][kDh / 8];
      auto read_old = [&]() {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int n = 0; n < kDh / 8; ++n) {
            const int e = 8 * n + 2 * t;
            old[r][n] = make_float2(0.f, 0.f);
            if (add[r] && vec2 && e + 1 < a.dh) {
              old[r][n] = *reinterpret_cast<const float2*>(row[r] + e);
            } else if (add[r]) {
              if (e < a.dh) old[r][n].x = row[r][e];
              if (e + 1 < a.dh) old[r][n].y = row[r][e + 1];
            }
          }
      };
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lk = kTile * mt + 16 * warp + g + 8 * r;
        const int cg = 2 * (lk / kRowKeys) + wgi, j = kRowKeys * cg + lk % kRowKeys;
        row[r] = lk < kRowKeys * nm && j < a.Lk
                     ? out + ((size_t)b * a.Lk + j) * d + (size_t)h * a.dh : nullptr;
        add[r] = row[r] != nullptr && cg < nl_prev;
      }
      if constexpr (decltype(prefetch)::value) read_old();
      bar_sync(2 + wgi, kThreads);  // the tile's earlier reads are done
#pragma unroll
      for (int c = 0; c < kMine; ++c) {
        if (c >= nm) break;
#pragma unroll
        for (int n = 0; n < kRowNB; ++n) {
          if ((kRowKeys * c + 8 * n) / kTile != mt) continue;
          const int k0 = kRowKeys * c + 8 * n + 2 * t - kTile * mt;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tw[(k0 + e % 2) * kLDW + 16 * warp + g + 8 * (e / 2)] = x[c][n][e];
        }
      }
      bar_sync(2 + wgi, kThreads);
      // A: keys 16 warp + g (+ 8), queries of each k step, from the tile
      const float* t0 = tw + (16 * warp + g) * kLDW;
      const float* t1 = t0 + 8 * kLDW;
      const uint64_t b_hi = desc_at(bt_hi, kSboT), b_lo = kBf16 ? b_hi : desc_at(bt_lo, kSboT);
      float acc[kDh / 8][4];
      auto products = [&](auto steps) {
        constexpr int kS = decltype(steps)::value;
        uint32_t fa[kS][kBf16 ? 1 : 2][4];
#pragma unroll
        for (int ks = 0; ks < kS; ++ks) {
          if constexpr (kBf16) {
            const int q = 16 * ks + 2 * t;
            const float2 x0 = *reinterpret_cast<const float2*>(t0 + q);
            const float2 x1 = *reinterpret_cast<const float2*>(t1 + q);
            const float2 x2 = *reinterpret_cast<const float2*>(t0 + q + 8);
            const float2 x3 = *reinterpret_cast<const float2*>(t1 + q + 8);
            fa[ks][0][0] = pack_bf16(x0.x, x0.y);
            fa[ks][0][1] = pack_bf16(x1.x, x1.y);
            fa[ks][0][2] = pack_bf16(x2.x, x2.y);
            fa[ks][0][3] = pack_bf16(x3.x, x3.y);
          } else {
            const int q = 8 * ks + t;
            const float y[4] = {t0[q], t1[q], t0[q + 4], t1[q + 4]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const Split sp = split_fast(y[e]);
              fa[ks][0][e] = sp.lo, fa[ks][1][e] = sp.hi;
            }
          }
        }
        wg::fence();
#pragma unroll
        for (int ks = 0; ks < kS; ++ks) {
          const uint64_t off = ks * 256 / 16;
          if constexpr (kBf16) {
            wg::Mma<kDh, true>::run(&acc[0][0], fa[ks][0], b_hi + off, ks > 0);
          } else {  // lo*hi, hi*lo, hi*hi
            wg::Mma<kDh, false>::run(&acc[0][0], fa[ks][0], b_hi + off, ks > 0);
            wg::Mma<kDh, false>::run(&acc[0][0], fa[ks][1], b_lo + off, 1);
            wg::Mma<kDh, false>::run(&acc[0][0], fa[ks][1], b_hi + off, 1);
          }
        }
        wg::commit();
        wg::wait<0>();
#pragma unroll
        for (int ks = 0; ks < kS; ++ks)
#pragma unroll
          for (int x2 = 0; x2 < (kBf16 ? 1 : 2); ++x2)
#pragma unroll
            for (int e = 0; e < 4; ++e) wg::hold(fa[ks][x2][e]);
      };
      if (one_step) {
        products(std::integral_constant<int, 1>{});
      } else {
        products(std::integral_constant<int, kQSteps>{});
      }
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) wg::hold(acc[n][e]);
      if constexpr (!decltype(prefetch)::value) read_old();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] == nullptr) continue;
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n) {
          const int e = 8 * n + 2 * t;
          const float x0 = acc[n][2 * r] + old[r][n].x, x1 = acc[n][2 * r + 1] + old[r][n].y;
          if (vec2 && e + 1 < a.dh) {
            *reinterpret_cast<float2*>(row[r] + e) = make_float2(x0, x1);
          } else {
            if (e < a.dh) row[r][e] = x0;
            if (e + 1 < a.dh) row[r][e + 1] = x1;
          }
        }
      }
    };
    const int nmt = (kRowKeys * nm + kTile - 1) / kTile;
    with_count<kMTiles>(nmt, [&](auto count) {
      constexpr int kT = decltype(count)::value;
#pragma unroll
      for (int mt = 0; mt < kT; ++mt)
        key_grads(mt, s, dt_hi, dt_lo, dv, std::false_type{});
#pragma unroll
      for (int mt = 0; mt < kT; ++mt) key_grads(mt, dw, qt_hi, qt_lo, dk, std::true_type{});
    });
    nl_prev = nl;
  }

  // dK and dV of the key chunks no query tile reached (of every key, when
  // Lq = 0) are 0
  __syncthreads();
  for (int idx = kRowKeys * nl_prev * a.dh + threadIdx.x; idx < a.Lk * a.dh; idx += kBwdThreads) {
    const size_t at = ((size_t)b * a.Lk + idx / a.dh) * d + (size_t)h * a.dh + idx % a.dh;
    dk[at] = 0.f;
    dv[at] = 0.f;
  }
}

template <int kDh, bool kBf16>
cudaError_t launch_whole_row_bwd(const Args& a, float* dk, float* dv, cudaStream_t stream) {
  const int chunks = (a.Lk + kRowKeys - 1) / kRowKeys;
  const size_t smem = row_bwd_smem_bytes<kDh, kBf16>(chunks);
  cudaError_t err = cudaFuncSetAttribute(whole_row_bwd_kernel<kDh, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(whole_row_bwd_kernel<kDh, kBf16>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  whole_row_bwd_kernel<kDh, kBf16><<<dim3(a.H, a.B), kBwdThreads, smem, stream>>>(a, dk, dv);
  return cudaGetLastError();
}

struct Backward {
  const Args& a;
  float* dk;
  float* dv;
  cudaStream_t stream;
  template <int kDh, bool kBf16>
  cudaError_t operator()() const {
    cudaError_t err = carca::attn::launch_keep_bits(a, stream);
    if (err != cudaSuccess) return err;
    if constexpr (kDh <= 32) {
      if (takes_whole_row_bwd(a.Lk, a.dh)) return launch_whole_row_bwd<kDh, kBf16>(a, dk, dv, stream);
    }
    if constexpr (kDh <= 64) {
      if (a.Lq <= kShort && a.Lk <= kShort) return launch<kDh, kBf16, kShort / 8>();
    }
    return launch<kDh, kBf16, kNT>();
  }
  template <int kDh, bool kBf16, int kN>
  cudaError_t launch() const {
    constexpr size_t smem = bwd_smem_bytes<kDh>();
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          bwd_kernel<kDh, kBf16, kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    bwd_kernel<kDh, kBf16, kN><<<(unsigned)(a.B * a.H), kThreads, smem, stream>>>(a, dk, dv);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// dropout = 0: seed, seed_ptr, threshold, keep and bits are ignored; a
// non-null seed_ptr (one uint64 in device memory) overrides seed. dq/dk/dv are
// written whole (every row, every head), so they need no zeroing; bits is
// scratch of ceil(B * H * Lq * Lk / 32) + 2 words. Any head width: heads
// wider than 128 dims run in 128-column chunks.
int carca_attention_bwd(const void* q, const void* k, const void* v, const void* qm,
                        const void* km, const void* dout, void* dq, void* dk, void* dv,
                        void* bits, int B, int H, int Lq, int Lk, int dh, int has_causal,
                        int causal, float scale, int bf16, int dropout, uint64_t seed,
                        const void* seed_ptr, uint32_t threshold, float keep, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(qm),
               static_cast<const float*>(km), static_cast<const float*>(dout),
               static_cast<float*>(dq), static_cast<uint32_t*>(bits), B, H, Lq, Lk, dh,
               has_causal, causal, 1.f / scale, dropout, seed,
               static_cast<const uint64_t*>(seed_ptr), threshold, 1.f / keep};
  return (int)carca::attn::dispatch(
      dh, bf16, Backward{a, static_cast<float*>(dk), static_cast<float*>(dv),
                         static_cast<cudaStream_t>(stream)});
}

// Which of K2's kernels runs at key length Lk and head width dh: 1
// whole_row_bwd_kernel, 0 bwd_kernel (flash_attention.py::bwd_branch).
int carca_attention_bwd_branch(int Lk, int dh) { return takes_whole_row_bwd(Lk, dh) ? 1 : 0; }

}  // extern "C"
