// K1: masked multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel carca_tpu/ops/flash_attention.py::_fwd_kernel
// (math in _weights_block and the post-softmax re-mask, weight dropout in
// _dropout_bits), reached from fused_attention through the _attention
// custom VJP. Plain version: carca_tpu_torch/models/attention.py::
// masked_attention.
//
// Semantics (src/carca.py:238-259): S = Q K^T with fp32 sums; pair mask
// m = q_mask[i] * k_mask[j], zeroed where j > i + causal when causal is on
// (i is the ABSOLUTE query row, so the offset survives q-tiling);
// z = (S + (m > 0 ? 0 : -(2^32 - 1))) / sqrt(d/H) in fp32 -- the additive
// constant is finite, so a fully masked row softmaxes to a uniform row
// that the re-mask w = softmax(z) * m turns into exact zeros (-inf would
// give NaN there); weight dropout keeps w / (1 - p) where the Philox bit of
// the weight allows it (philox.cuh); O = w V. With bf16 compute only the
// product inputs (q, k, w, v) are rounded to bf16; every sum stays fp32.
//
// What bounds it on the H100: at the serving and training shapes (Lk = 50)
// a (b, h) does 2 Lq Lk dh multiply-adds against (2 Lq + 2 Lk) dh * 4
// bytes of q/out/k/v traffic, ~12 per byte: far below the tensor cores'
// ridge, so the floor is device-memory traffic (13 MB read and written at
// the flagship encoder, ~4 us) plus one wave of blocks' latency. At men's
// Lk = 200 the 3xTF32 products (three TF32 products each) weigh as much as
// the bytes: ~16 us each at [256,200,64]. Neither binds in practice: the
// kernels are bound by the latency of their product chains, exp and
// shuffles, so the designs are about how much of that one SM overlaps.
//
// Two kernels, chosen by a rule on shapes (takes_whole_row below;
// ops/flash_attention.py::fwd_branch is the same rule, and the tests hold
// the two equal):
//
// * rows_kernel (attention_tile.cuh): Lk <= 64 (every serving and
//   training shape but men's), key rows longer than 200, and heads wider
//   than 64 dims. One block per (64 query rows, head, batch row), so K and
//   V reach shared memory once per block; each warp owns 16 query rows;
//   S = Q K^T in registers by mma.sync (3xTF32 for float32 compute, bf16
//   operands for bfloat16); mask, scale, row max, exp, sum, re-mask and
//   dropout in the accumulator layout with quad shuffles; P V with P
//   straight from registers. Past 64 keys it walks 64-key tiles twice (row
//   statistics, then weights), so shared memory does not grow with Lk; a
//   head wider than 128 dims sums S over 128-column chunks. Four blocks
//   share an SM at dh <= 32 (128 registers).
//
// * whole_row_kernel (below): 64 < Lk <= 200 at heads of up to 64 dims
//   (men's encoder and decoder, L = 200, and its eval's 101 candidates
//   against 200 keys), as the TPU kernel takes the whole key row into VMEM.
//   One block of one warpgroup per (b, h), two blocks an SM. K and V are
//   staged once for all the (b, h)'s query tiles: the loads of a round in
//   flight together, float32 split into TF32 hi and lo (mma.cuh::split)
//   there and then, V stored transposed ([dh][keys], the K-major B operand
//   wgmma needs for TF32) with each group of 8 keys in the order P's
//   accumulator layout hands them over (vpos). The warpgroup walks its
//   64-row query tiles; each tile holds S for all its keys in registers (5
//   chunks of 40 keys, wgmma m64n40, A = Q from registers, B = K from
//   shared memory; float32 as three TF32 products, lo*hi, hi*lo, hi*hi),
//   so the row max and sum are exact before any weight is formed and exp
//   runs once per weight; P V (wgmma m64n{dh}, A = P from the accumulator
//   registers, split again for float32) accumulates O in registers, which
//   are written once. Causal tiles skip the key chunks past their last row
//   + causal: every weight there is exactly 0 (underflow in a row with a
//   live key, the re-mask in a row with none), which the CPU tests hold
//   bit for bit on the plain version. The next tile's Q is loaded while
//   the current one runs. Query padding: Lq = 200 is four tiles, the last
//   holding 8 live rows. Its products cost a whole tile (wgmma is 64 rows):
//   5 of the 16 chunk products a (b, h) does at causal 0 (31 %), where its
//   rows are 4 % of the work; its softmax runs in one warp, the three
//   whose rows lie past Lq skip it.
//
// With dropout a pre-pass packs the call's keep bits (one Philox call per
// four weights) and either kernel reads them per row and 64 keys (three
// words). Heads are addressed in place inside [B, L, d] (offset h * dh), so
// the wrapper needs no head split or merge copies.
// carca_attention_keep_bits runs the pre-pass alone, for the checks that
// feed the bits to the plain version.

#include <limits.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "wgmma.cuh"

namespace carca {
namespace attn {

// ---------------------------------------------------------------------------
// K1's whole-row kernel (64 < Lk <= 200, heads of up to 64 dims)
// ---------------------------------------------------------------------------

// Whether the whole-row kernel takes key length Lk at head width dh: one
// key tile is rows_kernel's, and heads wider than 64 dims stay there too.
inline bool takes_whole_row(int Lk, int dh) {
  return Lk > kTile && Lk <= kRowKeys * kRowChunks && head_tile(dh) <= 64;
}

// Shared memory of a block staging `chunks` key chunks: K (bf16, or TF32
// hi and lo) in [keys / 8][kDh / (16 / el)] core matrices, V^T the same
// with its keys as K (rounded up to 16 for bf16's k16 steps), the key mask.
template <int kDh, bool kBf16>
constexpr size_t row_smem_bytes(int chunks) {
  const size_t keys = (size_t)kRowKeys * chunks;
  const size_t vkeys = kBf16 ? (keys + 15) / 16 * 16 : keys;
  const size_t el = kBf16 ? 2 : 4, parts = kBf16 ? 1 : 2;
  return parts * (keys + vkeys) * kDh * el + keys * sizeof(float);
}

// Block (h, b): K and V of the (b, h) staged once, then the block's one
// warpgroup walks the 64-row query tiles. Per tile: Q in registers, S = Q K^T
// for the key chunks the tile can reach (causal), the whole row's max and
// sum, the weights, re-mask and dropout in registers, and O = P V with P
// from the accumulators.
template <int kDh, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) whole_row_kernel(const Args a) {
  constexpr int kC = kRowChunks;
  constexpr int kEl = kBf16 ? 2 : 4;           // bytes of a staged operand
  constexpr int kKG = kDh * kEl / 16;          // K's core matrices along dh
  constexpr uint32_t kSboK = kKG * 128;        // K: bytes between 8-key groups
  constexpr int kWin = (kC * kRowKeys + 63) / 64;  // 64-key windows of keep bits
  extern __shared__ __align__(128) uint8_t smem[];

  const int h = blockIdx.x, b = blockIdx.y;
  const int d = a.H * a.dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nc = (a.Lk + kRowKeys - 1) / kRowKeys;
  const int keys = nc * kRowKeys;
  const int vkeys = kBf16 ? (keys + 15) / 16 * 16 : keys;
  const uint32_t sbo_v = (uint32_t)vkeys * kEl * 8;  // V^T: bytes between 8-column groups
  uint8_t* k_hi = smem;
  uint8_t* k_lo = k_hi + (size_t)keys * kDh * kEl;   // float32 only
  uint8_t* v_hi = smem + (size_t)(kBf16 ? 1 : 2) * keys * kDh * kEl;
  uint8_t* v_lo = v_hi + (size_t)vkeys * kDh * kEl;  // float32 only
  float* kms = reinterpret_cast<float*>(v_hi + (size_t)(kBf16 ? 1 : 2) * vkeys * kDh * kEl);

  const bool vec_dims = a.dh % 4 == 0 && d % 4 == 0;
  const size_t kvoff = (size_t)b * a.Lk * d + (size_t)h * a.dh;
  // K and V, items of kPer columns of one key (zeros past Lk and dh): a
  // thread loads kBatch items of each before it stores any, so its loads
  // are in flight together
  {
    constexpr int kPer = kBf16 ? 8 : 4;
    constexpr int kBatch = kBf16 ? 4 : 8;
    constexpr int kCG = kDh / kPer;  // column groups (items) of a key
    // Item idx of eight keys' 8 kCG items, as (key, column group), so that
    // each store of a warp meets distinct banks. V: column group idx % kCG
    // of the keys in V^T's position order (even, then odd: vpos), so a
    // warp's lanes hold every position mod 4. K: key idx % 8, column group
    // idx / 8 % kCG, so eight lanes' 16-byte rows of a core matrix (the
    // bank group is the key mod 8) make one 128-byte wavefront.
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
    const int items = vkeys * (kDh / kPer);
#pragma unroll 1
    for (int base = 0; base < items; base += kBatch * kThreads) {
      float xk[kBatch][kPer], xv[kBatch][kPer];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads + threadIdx.x;
        int jk, ek, jv, ev;
        k_item(idx, jk, ek);
        v_item(idx, jv, ev);
        const bool live_k = idx < items && jk < a.Lk, live_v = idx < items && jv < a.Lk;
#pragma unroll
        for (int p = 0; p < kPer; p += 4) {
          const float4 fk = live_k ? load4(a.k + kvoff + (size_t)jk * d, ek + p, a.dh, vec_k)
                                   : make_float4(0, 0, 0, 0);
          const float4 fv = live_v ? load4(a.v + kvoff + (size_t)jv * d, ev + p, a.dh, vec_v)
                                   : make_float4(0, 0, 0, 0);
          xk[u][p] = fk.x, xk[u][p + 1] = fk.y, xk[u][p + 2] = fk.z, xk[u][p + 3] = fk.w;
          xv[u][p] = fv.x, xv[u][p + 1] = fv.y, xv[u][p + 2] = fv.z, xv[u][p + 3] = fv.w;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads + threadIdx.x;
        if (idx >= items) break;
        int j, e;
        k_item(idx, j, e);
        if (j < keys) {  // K: one 16-byte row of a core matrix
          const size_t off = ((size_t)(j / 8) * kKG + e * kEl / 16) * 128 + (j % 8) * 16;
          const float* x = xk[u];
          if constexpr (kBf16) {
            *reinterpret_cast<uint4*>(k_hi + off) =
                make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                           pack_bf16(x[6], x[7]));
          } else {
            const Split s0 = split(x[0]), s1 = split(x[1]), s2 = split(x[2]), s3 = split(x[3]);
            *reinterpret_cast<uint4*>(k_hi + off) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
            *reinterpret_cast<uint4*>(k_lo + off) = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
          }
        }
        // V^T: column n = e + p, key j at position vpos(j)
        v_item(idx, j, e);
        const int pos = kBf16 ? j : vpos(j);
        // float32: a warp's lanes take 4 positions mod 4 (v_item) and their
        // column groups' 4 columns in rotated order, so each store's 32
        // lanes meet 32 banks
        const int rot = kBf16 ? 0 : (idx % kCG) / 2 % 4;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const int pr = (p + rot) % kPer;
          const float x = kBf16 ? xv[u][p] : pick4(xv[u], pr);
          const int n = e + pr;
          const size_t off = ((size_t)(n / 8) * (vkeys * kEl / 16) + pos * kEl / 16) * 128 +
                             (n % 8) * 16 + (pos * kEl) % 16;
          if constexpr (kBf16) {
            *reinterpret_cast<__nv_bfloat16*>(v_hi + off) = __float2bfloat16_rn(x);
          } else {
            const Split sp = split(x);
            *reinterpret_cast<uint32_t*>(v_hi + off) = sp.hi;
            *reinterpret_cast<uint32_t*>(v_lo + off) = sp.lo;
          }
        }
      }
    }
  }
  for (int j = threadIdx.x; j < keys; j += kThreads)
    kms[j] = j < a.Lk ? __ldg(a.km + (size_t)b * a.Lk + j) : 0.f;
  wg::fence_smem();
  __syncthreads();

  const uint64_t bh = (uint64_t)b * a.H + h;
  const int nqt = (a.Lq + kTile - 1) / kTile;
  const float neg_logit = kNegMask * a.inv_scale;
  // the operands' descriptors: a product's is its base's plus the tile's
  // offset / 16 (the start-address field), made afresh in each query tile
  const uint64_t desc0[4] = {wg::desc(k_hi, 128, kSboK), wg::desc(k_lo, 128, kSboK),
                             wg::desc(v_hi, 128, sbo_v), wg::desc(v_lo, 128, sbo_v)};
  // a tile's Q values in A-fragment order: float32 (g, t), (g + 8, t),
  // (g, t + 4), (g + 8, t + 4) of each k8 step; bf16 the pairs at columns
  // 2t and 2t + 8 of rows g, g + 8 of each k16 step
  constexpr int kSteps = kBf16 ? kDh / 16 : kDh / 8;
  float qn[kSteps][kBf16 ? 8 : 4];
  auto load_q = [&](int row0) {
    const int i0 = row0 + 16 * warp + g;
    const float* qr[2];
    bool ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ok[r] = i0 + 8 * r < a.Lq;
      qr[r] = a.q + ((size_t)b * a.Lq + (ok[r] ? i0 + 8 * r : 0)) * d + (size_t)h * a.dh;
    }
    auto qv = [&](int r, int e) { return ok[r] && e < a.dh ? __ldg(qr[r] + e) : 0.f; };
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (kBf16) {
        const int e = 16 * s + 2 * t;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c % 2, col = e + 8 * (c / 2);
          qn[s][2 * c] = qv(r, col), qn[s][2 * c + 1] = qv(r, col + 1);
        }
      } else {
        const int e = 8 * s + t;
        qn[s][0] = qv(0, e), qn[s][1] = qv(1, e), qn[s][2] = qv(0, e + 4), qn[s][3] = qv(1, e + 4);
      }
    }
  };
  load_q(0);
  for (int qt = 0; qt < nqt; ++qt) {
    uint64_t dk_hi = desc0[0], dk_lo = desc0[1], dv_hi = desc0[2], dv_lo = desc0[3];
    wg::opaque(dk_hi), wg::opaque(dk_lo), wg::opaque(dv_hi), wg::opaque(dv_lo);
    const int row0 = qt * kTile;
    const int i0 = row0 + 16 * warp + g;  // this lane's query rows i0 and i0 + 8
    // key chunks the tile reaches: past the last row + causal every weight
    // is exactly 0 (a row with a live key: exp(z - max) underflows; a row
    // with none: the re-mask), so those chunks are skipped; at least one
    int lim = a.Lk;
    if (a.has_causal) lim = min(lim, max(min(a.Lq, row0 + kTile) + a.causal, 1));
    const int nl = (lim + kRowKeys - 1) / kRowKeys;

    // Q rows i0, i0 + 8 as A fragments, from the values loaded a tile ahead
    uint32_t qa[kBf16 ? 1 : 2][kSteps][4];  // float32: [lo, hi]
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (kBf16) {
#pragma unroll
        for (int c = 0; c < 4; ++c) qa[0][s][c] = pack_bf16(qn[s][2 * c], qn[s][2 * c + 1]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const Split x = split(qn[s][c]);
          qa[0][s][c] = x.lo, qa[1][s][c] = x.hi;
        }
      }
    }
    // the keep bits of rows i0 and i0 + 8, 64 keys a window
    uint2 kw[2][kWin];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int w = 0; w < kWin; ++w)
        kw[r][w] = (a.dropout && i0 + 8 * r < a.Lq && 64 * w < lim)
                       ? keep_window(a.bits, (bh * a.Lq + i0 + 8 * r) * a.Lk + 64 * w)
                       : make_uint2(0u, 0u);

    // S = Q K^T, chunk by chunk (float32: lo*hi, hi*lo, hi*hi as mma.cuh)
    float s[kC][kRowNB][4];
    with_count<kRowChunks, 1>(nl, [&](auto chunks) {
      wg::fence();
#pragma unroll
      for (int c = 0; c < decltype(chunks)::value; ++c)
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
          for (int part = 0; part < (kBf16 ? 1 : 3); ++part)
            wg::Mma<kRowKeys, kBf16>::run(
                &s[c][0][0], qa[kBf16 ? 0 : (part == 0 ? 0 : 1)][ks],
                ((kBf16 || part != 1) ? dk_hi : dk_lo) + (c * kRowNB * kSboK + ks * 256) / 16,
                ks > 0 || part > 0);
      wg::commit();
      if (qt + 1 < nqt) load_q(row0 + kTile);  // in flight during this tile
      wg::wait<0>();
    });
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int n = 0; n < kRowNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) wg::hold(s[c][n][e]);
#pragma unroll
    for (int x = 0; x < (kBf16 ? 1 : 2); ++x)
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) wg::hold(qa[x][ks][e]);

    // the masked softmax over the whole row, in the accumulator layout; a
    // warp whose 16 rows all lie past Lq leaves its (zero) scores alone.
    // float32 leaves P unnormalised, exp(z - max) m where the keep bit
    // allows, and the row's 1 / sum (and 1 / (1 - p)) scales O once, at the
    // store; bf16 rounds P, so P is the plain version's weight there.
    float o_scale[2] = {1.f, 1.f}, w_scale[2] = {1.f, 1.f};
    if (row0 + 16 * warp < a.Lq) {
      float qmi[2], mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      int last[2];  // a row's last causal key
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 8 * r;
        qmi[r] = i < a.Lq ? __ldg(a.qm + (size_t)b * a.Lq + i) : 0.f;
        last[r] = a.has_causal ? i + a.causal : INT_MAX;
      }
      // m = q_mask[i] k_mask[j], zeroed past the row's last causal key
      auto mask = [&](int r, float kmj, int j) { return j <= last[r] ? qmi[r] * kmj : 0.f; };
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c >= nl) break;
#pragma unroll
        for (int n = 0; n < kRowNB; ++n) {
          const int j = kRowKeys * c + 8 * n + 2 * t;
          const float2 km2 = *reinterpret_cast<const float2*>(kms + j);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& z0 = s[c][n][2 * r];
            float& z1 = s[c][n][2 * r + 1];
            z0 = masked_logit(z0, mask(r, km2.x, j), a.inv_scale, neg_logit);
            z1 = masked_logit(z1, mask(r, km2.y, j + 1), a.inv_scale, neg_logit);
            mx[r] = fmaxf(mx[r], fmaxf(z0, z1));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c >= nl) break;
#pragma unroll
        for (int n = 0; n < kRowNB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[c][n][e] = exp_shifted(s[c][n][e] - mx[e / 2]);
            l[e / 2] += s[c][n][e];
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float inv_l = 1.f / quad_sum(l[r]);
        if constexpr (kBf16) {
          w_scale[r] = inv_l;
        } else {
          o_scale[r] = inv_l * (a.dropout ? a.inv_keep : 1.f);
        }
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c >= nl) break;
#pragma unroll
        for (int n = 0; n < kRowNB; ++n) {
          const int j = kRowKeys * c + 8 * n + 2 * t;
          const float2 km2 = *reinterpret_cast<const float2*>(kms + j);
          const int nb = kRowNB * c + n;  // n8 block of the row: keys 8 nb ..
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float w0 = s[c][n][2 * r], w1 = s[c][n][2 * r + 1];
            if constexpr (kBf16) w0 *= w_scale[r], w1 *= w_scale[r];
            w0 *= mask(r, km2.x, j);  // the post-softmax re-mask
            w1 *= mask(r, km2.y, j + 1);
            if (a.dropout) {
              const uint2 win = kw[r][nb / 8];
              const uint32_t kb = ((nb % 8) < 4 ? win.x : win.y) >> ((8 * nb + 2 * t) % 32);
              const float keep = kBf16 ? a.inv_keep : 1.f;
              w0 = kb & 1u ? w0 * keep : 0.f;
              w1 = kb & 2u ? w1 * keep : 0.f;
            }
            s[c][n][2 * r] = w0;
            s[c][n][2 * r + 1] = w1;
          }
        }
      }
    }

    // O = P V over the live chunks
    float o[kDh / 8][4];
    if constexpr (kBf16) {
      with_count<kRowChunks, 1>(nl, [&](auto chunks) {
        constexpr int kNB = decltype(chunks)::value * kRowNB;  // n8 blocks of P
        constexpr int kK2 = (kNB + 1) / 2;                     // k16 steps: two blocks each
        uint32_t pa[kK2][4];
#pragma unroll
        for (int k2 = 0; k2 < kK2; ++k2) {
          const int n0 = 2 * k2, n1 = 2 * k2 + 1;
          const float* p0 = s[n0 / kRowNB][n0 % kRowNB];
          pa[k2][0] = pack_bf16(p0[0], p0[1]);
          pa[k2][1] = pack_bf16(p0[2], p0[3]);
          if (n1 < kNB) {
            const float* p1 = s[n1 / kRowNB][n1 % kRowNB];
            pa[k2][2] = pack_bf16(p1[0], p1[1]);
            pa[k2][3] = pack_bf16(p1[2], p1[3]);
          } else {  // past the live keys (V^T holds zeros there): zero weights
            pa[k2][2] = pa[k2][3] = 0u;
          }
        }
        wg::fence();
#pragma unroll
        for (int k2 = 0; k2 < kK2; ++k2)
          wg::Mma<kDh, true>::run(&o[0][0], pa[k2], dv_hi + k2 * 256 / 16, k2 > 0);
        wg::commit();
        wg::wait<0>();
#pragma unroll
        for (int k2 = 0; k2 < kK2; ++k2)
#pragma unroll
          for (int e = 0; e < 4; ++e) wg::hold(pa[k2][e]);
      });
    } else {
      with_count<kRowChunks, 1>(nl, [&](auto chunks) {
        uint32_t lo[kRowNB][4];  // P's lo parts, a ring of five k steps
#pragma unroll
        for (int c = 0; c < decltype(chunks)::value; ++c) {
#pragma unroll
          for (int n = 0; n < kRowNB; ++n) {
            if (c > 0) {  // the step that last read lo[n] has retired
              wg::wait<kRowNB - 1>();
#pragma unroll
              for (int e = 0; e < 4; ++e) wg::hold(lo[n][e]), wg::hold(s[c - 1][n][e]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const Split x = split_fast(s[c][n][e]);  // the products of split (mma.cuh)
              s[c][n][e] = __uint_as_float(x.hi);
              lo[n][e] = x.lo;
            }
            wg::fence();
            // k = t <-> key 2t, k = t + 4 <-> key 2t + 1 of the block (vpos)
            const uint32_t ahi[4] = {__float_as_uint(s[c][n][0]), __float_as_uint(s[c][n][2]),
                                     __float_as_uint(s[c][n][1]), __float_as_uint(s[c][n][3])};
            const uint32_t alo[4] = {lo[n][0], lo[n][2], lo[n][1], lo[n][3]};
            const int kg = (kRowNB * c + n) * 256 / 16;  // 8 keys: two core matrices
            wg::Mma<kDh, false>::run(&o[0][0], alo, dv_hi + kg, c > 0 || n > 0);
            wg::Mma<kDh, false>::run(&o[0][0], ahi, dv_lo + kg, 1);
            wg::Mma<kDh, false>::run(&o[0][0], ahi, dv_hi + kg, 1);
            wg::commit();
          }
        }
        wg::wait<0>();
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int n = 0; n < kRowNB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) wg::hold(s[c][n][e]);
#pragma unroll
        for (int n = 0; n < kRowNB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) wg::hold(lo[n][e]);
      });
    }
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) wg::hold(o[n][e]);

    // the output rows, straight from the accumulators
    const bool vec2 = a.dh % 2 == 0 && (reinterpret_cast<uintptr_t>(a.out) & 7) == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i >= a.Lq) continue;
      float* orow = a.out + ((size_t)b * a.Lq + i) * d + (size_t)h * a.dh;
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        const int e = 8 * n + 2 * t;
        if (vec2 && e + 1 < a.dh) {
          *reinterpret_cast<float2*>(orow + e) =
              make_float2(o[n][2 * r] * o_scale[r], o[n][2 * r + 1] * o_scale[r]);
        } else {
          if (e < a.dh) orow[e] = o[n][2 * r] * o_scale[r];
          if (e + 1 < a.dh) orow[e + 1] = o[n][2 * r + 1] * o_scale[r];
        }
      }
    }
  }
}

template <int kDh, bool kBf16>
cudaError_t launch_whole_row(const Args& a, cudaStream_t stream) {
  const int chunks = (a.Lk + kRowKeys - 1) / kRowKeys;
  const size_t smem = row_smem_bytes<kDh, kBf16>(chunks);
  cudaError_t err = cudaFuncSetAttribute(whole_row_kernel<kDh, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(whole_row_kernel<kDh, kBf16>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  whole_row_kernel<kDh, kBf16><<<dim3(a.H, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace carca

namespace {

using carca::attn::Args;

struct Forward {
  const Args& a;
  cudaStream_t stream;
  template <int kDh, bool kBf16>
  cudaError_t operator()() const {
    const cudaError_t err = carca::attn::launch_keep_bits(a, stream);
    if (err != cudaSuccess) return err;
    if constexpr (kDh <= 64) {
      if (carca::attn::takes_whole_row(a.Lk, a.dh))
        return carca::attn::launch_whole_row<kDh, kBf16>(a, stream);
    }
    return carca::attn::launch_rows<kDh, kBf16>(a, stream);
  }
};

}  // namespace

extern "C" {

const char* carca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dropout = 0: seed, seed_ptr, threshold, keep and bits are ignored; bits
// is scratch of ceil(B * H * Lq * Lk / 32) + 2 words; a non-null seed_ptr
// (one uint64 in device memory) overrides seed. Any head width: heads
// wider than 128 dims run in 128-column chunks.
int carca_attention_fwd(const void* q, const void* k, const void* v, const void* qm,
                        const void* km, void* out, void* bits, int B, int H, int Lq, int Lk,
                        int dh, int has_causal, int causal, float scale, int bf16,
                        int dropout, uint64_t seed, const void* seed_ptr, uint32_t threshold,
                        float keep, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(qm),
               static_cast<const float*>(km), nullptr, static_cast<float*>(out),
               static_cast<uint32_t*>(bits), B, H, Lq, Lk, dh, has_causal, causal, 1.f / scale, dropout, seed,
               static_cast<const uint64_t*>(seed_ptr), threshold, 1.f / keep};
  return (int)carca::attn::dispatch(dh, bf16, Forward{a, static_cast<cudaStream_t>(stream)});
}

// Which of K1's kernels runs at key length Lk and head width dh: 1 the
// whole-row kernel, 0 rows_kernel (flash_attention.py::fwd_branch).
int carca_attention_fwd_branch(int Lk, int dh) {
  return carca::attn::takes_whole_row(Lk, dh) ? 1 : 0;
}

// The packed keep bits K1 and K2 run on, for n = B * H * Lq * Lk weights:
// bits holds ceil(n / 32) words; seed_ptr as carca_attention_fwd's.
int carca_attention_keep_bits(void* bits, uint64_t n, uint64_t seed, const void* seed_ptr,
                              uint32_t threshold, void* stream) {
  return (int)carca::attn::launch_keep_bits(static_cast<uint32_t*>(bits), n, seed,
                                            static_cast<const uint64_t*>(seed_ptr), threshold,
                                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
