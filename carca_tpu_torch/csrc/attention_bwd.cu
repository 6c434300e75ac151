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
// The design this replaces ran a dQ pass that also wrote the row statistics
// to a [3, B H Lq] scratch, then a dK/dV pass per 64 keys that recomputed S
// and dW: three launches, seven products per tile pair (nine past 64 keys).
// Neither bound set its time. At 64-dim heads both passes took 198-255
// registers (2 blocks per SM) and staged tiles by a load-then-store loop
// whose latency every barrier exposed (55 and 62 us at the games encoder).
//
// Design: the TPU kernel's structure, one block per (b, h) that holds the
// head's keys in turn and walks its query tiles (64 rows, a warp per 16):
// - per key tile, dW = dO V^T, then S = Q K^T, into registers; the row max,
//   sum and D = sum_j dW_j w_j (past 64 keys online, in a first walk over the
//   key tiles); dS and w_d in registers; dQ (+)= dS K from registers;
// - w_d^T, then dS^T, through shared memory; each warp takes 16 keys for
//   dV (+)= w_d^T dO and dK (+)= dS^T Q. The block owns its (b, h)'s rows of
//   dq, dk and dv, so it adds a later tile's share to them itself: no
//   atomics, no scratch. Key tiles past a causal query tile's diagonal are
//   skipped.
// Five products per tile pair at L <= 64, seven past it; one launch after
// the keep bits. Shared memory is three slots: dO, Q, and one that holds in
// turn V (dW), K (S, dQ), w_d^T and dS^T, since V dies first. At 64-dim
// heads that is 52.7 KB: four blocks per SM, so the games encoder's 512
// (b, h) run in one wave (128 registers). cp.async stages every tile.
// Float32 products split their operands by split_fast (mma.cuh): sm_90
// lowers cvt.rna.tf32 with range checks, five instructions a conversion,
// which cost a quarter of the kernel. At L <= 56 (every train shape but
// men's, L = 50) a 56-row instantiation spends no product on the padding of
// a 64-row tile.
// What bounds it now: the latency of its mma.sync chains and tile stages at
// 16 warps per SM (PERF.md has the measurements).

#include "attention_tile.cuh"

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
        mma_rows_bt<kDh, kBf16, kN, true>(dw, dos + r0 * LD, dos + (r0 + 8) * LD, s1, g, t);
        __syncthreads();  // V is consumed
        if (nch > 1) load_tile_async<kDh>(qs, a.q + qoff + c * kDh, rows, d, w, vec_q);
        load_tile_async<kDh>(s1, a.k + koff + c * kDh, keys, d, w, vec_k);
        wait_copies();
        mma_rows_bt<kDh, kBf16, kN, true>(s, qs + r0 * LD, qs + (r0 + 8) * LD, s1, g, t);
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
          mma_regs_b<kDh, kBf16, kN, kCols, true>(acc, dw, s1 + 8 * kCols * win, g, t);
          store_acc<kCols>(a.out + qoff + (size_t)(16 * warp) * d + ch * kDh + 8 * kCols * win,
                           acc, g, t, rows - 16 * warp, d, w - 8 * kCols * win, kt > 0, vec2);
        }
      }

      // dV (+)= w_d^T dO, then dK (+)= dS^T Q, for the warp's 16 keys, per
      // column chunk and window; a key tile an earlier query tile reached
      // holds a partial sum
      const bool add = kt < visited;
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
              mma_regs_b<kDh, kBf16, kN, kCols, true>(acc, p, rows_src + 8 * kCols * win, g, t);
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

struct Backward {
  const Args& a;
  float* dk;
  float* dv;
  cudaStream_t stream;
  template <int kDh, bool kBf16>
  cudaError_t operator()() const {
    cudaError_t err = carca::attn::launch_keep_bits(a, stream);
    if (err != cudaSuccess) return err;
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

}  // extern "C"
