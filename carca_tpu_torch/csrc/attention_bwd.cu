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
// What bounds it on the H100: five [Lq, Lk, dh] products per (b, h) against
// 7 [L, dh] float32 tensors of traffic (~9 multiply-adds per byte at
// L = 50): device memory, 23 MB at the encoder shape (~7 us), is the floor.
// A first design (one block per (b, h), one warp per query row) ran at 7 %
// of it: serial dh- and Lk-long FMA chains, four block barriers per 32-row
// tile, one Philox call per weight, and shared memory that grew with Lk
// (170.6 KB at Lk = 200: one block per SM, and no room past Lk ~160 at
// dh = 64).
//
// Design: FlashAttention-2's backward, in launches without atomics.
// 0. The keep bits of the call's weights, packed (attention_tile.cuh::
//    keep_bits_kernel: one Philox call per four weights), with dropout on.
// 1. dQ pass (attention_tile.cuh::rows_kernel<.., true>), one block per
//    (64 query rows, h, b): the row statistics (max, sum, D) over the key
//    tiles, then dQ = dS K over them again, in registers (one walk with one
//    key tile); the statistics go to a [3, B H Lq] scratch.
// 2. dK/dV pass (dkv_kernel below), one block per (64 keys, h, b): each
//    warp owns 16 keys, loops over the query tiles in steps of 32 queries,
//    recomputes S^T = K Q^T and dW^T = V dO^T by mma.sync, turns them into
//    w_d^T and dS^T in registers with the stored statistics, and accumulates
//    dV += w_d^T dO and dK += dS^T Q in registers; each block writes its
//    keys' rows once.
// Every sum runs in one fixed order, so two runs are bit-equal. Shared
// memory is four [64, dh + 4] tiles whatever Lq and Lk (37 KB at dh = 32,
// 70 KB at dh = 64; a head wider than 128 dims runs in 128-column chunks,
// each chunk of dQ, dK and dV with its own walk that sums the scores over
// every chunk); both passes fit in 128 registers at dh <= 32, so four
// blocks share an SM and the flagship's 512 (b, h) blocks run in one wave.
// Now each pass is bound by the latency of its mma.sync chains and barriers
// at 16 warps per SM, not by bytes. The warp's fragment rows g and g + 8 are
// keys 2g and 2g + 1, so a lane's two keys are adjacent in the packed keep
// bits and one word serves both.

#include "attention_tile.cuh"

namespace {

using carca::attn::Args;
using carca::attn::kThreads;
using carca::attn::kTile;

constexpr int kNH = 4;  // n8 blocks of a 32-query half tile

template <int kDh>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kTile * (kDh + 4) + 5 * kTile);
}

// Block (key tile, h, b) -> dk, dv rows of its keys; reads the dQ pass's
// statistics from a.stats.
template <int kDh, bool kBf16>
__global__ void __launch_bounds__(kThreads, carca::attn::min_blocks<kDh>())
dkv_kernel(const Args a, float* __restrict__ dk, float* __restrict__ dv) {
  using namespace carca::attn;
  constexpr int LD = kDh + 4;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kTile][LD] keys, then dk
  float* vs = ks + kTile * LD;                   // [kTile][LD] values, then dv
  float* qs = vs + kTile * LD;                   // [kTile][LD] query tile
  float* dos = qs + kTile * LD;                  // [kTile][LD] dO tile
  float* kms = dos + kTile * LD;                 // [kTile]
  float* qms = kms + kTile;                      // [kTile]
  float* mst = qms + kTile;                      // [kTile] row max
  float* lst = mst + kTile;                      // [kTile] 1 / row sum
  float* dst = lst + kTile;                      // [kTile] D

  const int key0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int d = a.H * a.dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int keys = min(kTile, a.Lk - key0);
  const bool vec_dims = a.dh % 4 == 0 && d % 4 == 0;
  const size_t koff = ((size_t)b * a.Lk + key0) * d + (size_t)h * a.dh;
  const int nch = n_chunks<kDh>(a.dh);
  const bool vec_k = vec_dims && aligned16(a.k), vec_v = vec_dims && aligned16(a.v);
  const bool vec_q = vec_dims && aligned16(a.q), vec_do = vec_dims && aligned16(a.dout);
  // the K and V columns of chunk c
  auto stage_keys = [&](int c) {
    const int w = chunk_width<kDh>(a.dh, c);
    load_tile<kDh>(ks, a.k + koff + c * kDh, keys, d, w, vec_k);
    load_tile<kDh>(vs, a.v + koff + c * kDh, keys, d, w, vec_v);
  };
  // the Q and dO columns of chunk c for the query tile at qoff
  auto stage_rows = [&](int c, size_t qoff, int rows) {
    const int w = chunk_width<kDh>(a.dh, c);
    load_tile<kDh>(qs, a.q + qoff + c * kDh, rows, d, w, vec_q);
    load_tile<kDh>(dos, a.dout + qoff + c * kDh, rows, d, w, vec_do);
  };
  if (nch == 1) stage_keys(0);
  load_mask(kms, a.km + (size_t)b * a.Lk + key0, keys);

  const int r0 = 16 * warp + 2 * g;  // this lane's keys: tile rows r0 and r0 + 1
  const int j0 = key0 + r0;
  const uint64_t bh = (uint64_t)b * a.H + h;
  const size_t n_stats = (size_t)a.B * a.H * a.Lq;

  // once per column chunk of dK and dV (one but for heads wider than 128)
  for (int ch = 0; ch < nch; ++ch) {
    float dka[kDh / 8][4], dva[kDh / 8][4];
    zero(dka);
    zero(dva);
    for (int row0 = 0; row0 < a.Lq; row0 += kTile) {
      const int rows = min(kTile, a.Lq - row0);
      const size_t qoff = ((size_t)b * a.Lq + row0) * d + (size_t)h * a.dh;
      __syncthreads();  // the previous query tile is consumed
      if (nch == 1) stage_rows(0, qoff, rows);
      load_mask(qms, a.qm + (size_t)b * a.Lq + row0, rows);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const size_t at = bh * a.Lq + row0 + i;
        const bool in = i < rows;  // padded rows: w = 0 below
        mst[i] = in ? a.stats[at] : 0.f;
        lst[i] = in ? 1.f / a.stats[n_stats + at] : 1.f;
        dst[i] = in ? a.stats[2 * n_stats + at] : 0.f;
      }
      __syncthreads();

      // the tile's queries in steps of 32: [16 keys, 32 queries] score tiles
      // keep the lane within 128 registers
#pragma unroll 1
      for (int q0 = 0; q0 < rows; q0 += 32) {
        const float* qh = qs + q0 * LD;
        const float* doh = dos + q0 * LD;
        // keep bits of keys j0, j0 + 1 for each query column (padded rows and
        // keys weigh nothing), loaded ahead of the products
        uint32_t kb[kNH][2];
#pragma unroll
        for (int n = 0; n < kNH; ++n)
#pragma unroll
          for (int cq = 0; cq < 2; ++cq) {
            const int i = row0 + q0 + 8 * n + 2 * t + cq;
            kb[n][cq] = a.dropout && i < a.Lq && j0 < a.Lk
                            ? keep_window(a.bits, (bh * a.Lq + i) * a.Lk + j0).x
                            : 0u;
          }
        float st[kNH][4], dw[kNH][4];  // S^T then w_d^T; dW^T then dS^T (keys x queries)
        zero(st);
        zero(dw);
        for (int c = 0; c < nch; ++c) {  // S^T and dW^T sum over the column chunks
          if (nch > 1) {
            __syncthreads();
            stage_keys(c);
            stage_rows(c, qoff, rows);
            __syncthreads();
          }
          mma_rows_bt<kDh, kBf16, kNH>(st, ks + r0 * LD, ks + (r0 + 1) * LD, qh, g, t);
          mma_rows_bt<kDh, kBf16, kNH>(dw, vs + r0 * LD, vs + (r0 + 1) * LD, doh, g, t);
        }
#pragma unroll
        for (int n = 0; n < kNH; ++n) {
#pragma unroll
          for (int cq = 0; cq < 2; ++cq) {  // query column q0 + 8n + 2t + cq
            const int il = q0 + 8 * n + 2 * t + cq, i = row0 + il;
            const float qmi = qms[il], mi = mst[il], li = lst[il], di = dst[il];
            const bool kept[2] = {(kb[n][cq] & 1u) != 0, (kb[n][cq] & 2u) != 0};
#pragma unroll
            for (int rk = 0; rk < 2; ++rk) {  // key j0 + rk: fragment element cq + 2 rk
              const int c = cq + 2 * rk, j = j0 + rk;
              const float m = pair_mask(a, qmi, kms[r0 + rk], i, j);
              const float w = i < a.Lq ? exp_shifted(logit(a, st[n][c], m, j) - mi) * li : 0.f;
              float wd = w * m, dwm = dw[n][c];
              if (a.dropout) {
                wd = kept[rk] ? wd * a.inv_keep : 0.f;
                dwm = kept[rk] ? dwm * a.inv_keep : 0.f;
              }
              st[n][c] = wd;
              dw[n][c] = w * (dwm * m - di) * a.inv_scale;
            }
          }
        }
        if (nch > 1) {  // chunk ch's columns of Q and dO
          __syncthreads();
          stage_rows(ch, qoff, rows);
          __syncthreads();
        }
        mma_regs_b<kDh, kBf16, kNH>(dva, st, doh, g, t);
        mma_regs_b<kDh, kBf16, kNH>(dka, dw, qh, g, t);
      }
    }

    // a warp reads and writes only its own rows of ks and vs
    put_rows<kDh>(ks, dka, r0, r0 + 1, t);
    put_rows<kDh>(vs, dva, r0, r0 + 1, t);
    __syncthreads();
    const int w = chunk_width<kDh>(a.dh, ch);
    store_tile<kDh>(dk + koff + ch * kDh, ks, keys, d, w, vec_dims && aligned16(dk));
    store_tile<kDh>(dv + koff + ch * kDh, vs, keys, d, w, vec_dims && aligned16(dv));
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
    if (a.Lq > 0) {  // dq and the row statistics
      err = carca::attn::launch_rows<kDh, kBf16, true>(a, stream);
      if (err != cudaSuccess) return err;
    }
    constexpr size_t smem = dkv_smem_bytes<kDh>();
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          dkv_kernel<kDh, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    const dim3 grid((a.Lk + kTile - 1) / kTile, a.H, a.B);
    dkv_kernel<kDh, kBf16><<<grid, kThreads, smem, stream>>>(a, dk, dv);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// dropout = 0: seed, threshold, keep and bits are ignored. dq/dk/dv are
// written whole (every row, every head), so they need no zeroing; stats is
// scratch of 3 * B * H * Lq floats, bits of ceil(B * H * Lq * Lk / 32) + 2
// words. Any head width: heads wider than 128 dims run in 128-column chunks.
int carca_attention_bwd(const void* q, const void* k, const void* v, const void* qm,
                        const void* km, const void* dout, void* dq, void* dk, void* dv,
                        void* stats, void* bits, int B, int H, int Lq, int Lk, int dh,
                        int has_causal,
                        int causal, float scale, int bf16, int dropout, uint64_t seed,
                        uint32_t threshold, float keep, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(qm),
               static_cast<const float*>(km), static_cast<const float*>(dout),
               static_cast<float*>(dq), static_cast<float*>(stats),
               static_cast<uint32_t*>(bits), B, H, Lq, Lk, dh, has_causal, causal, 1.f / scale, dropout, seed, threshold,
               1.f / keep};
  return (int)carca::attn::dispatch(
      dh, bf16, Backward{a, static_cast<float*>(dk), static_cast<float*>(dv),
                         static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
