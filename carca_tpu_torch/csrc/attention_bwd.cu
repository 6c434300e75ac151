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
//   dZ    = w_raw * (dW - sum_j dW_j w_raw_j),  dS = dZ / scale;
//   dQ_i  = dS K,   dK += dS^T q_i,   dV += w_d^T dO_i.
// No gradient flows to the masks. A fully masked row has m = 0 everywhere,
// so dW = 0, dS = 0 and w_d = 0: its dQ row and its share of dK/dV are
// exactly zero. With bf16 compute the product inputs (q, k, v, dO, dS,
// w_d) are rounded to bf16, as _bwd_kernel's .astype(cd) do; every sum
// stays fp32.
//
// Design. The TPU kernel accumulates dK/dV across the sequential q-block
// grid axis. Hopper's blocks run in no order, so nothing is carried between
// blocks: one block owns one (b, h) and loops over q-tiles of kTileQ rows
// inside. K, V and the dK/dV accumulators stay in shared memory for the
// whole loop. For each tile, one warp per query row recomputes w_raw,
// regenerates the dropout bits and forms dS and w_d into shared [tile, Lk]
// buffers (lanes over keys, warp shuffles for the row max, sum and dot), and
// writes its dQ row (lanes over dh); then the block adds dS^T Q and
// w_d^T dO into the accumulators, each thread owning fixed (j, e) entries.
// So there are no atomics anywhere: the sums run in one fixed order and two
// runs give bit-equal gradients. Shared memory: 4 * (2 Lk (dh+1) + 2 Lk dh
// + Lk + 2 kTileQ dh + 2 kTileQ Lk + kWarps Lk) bytes, 48.8 KB at Lk = 50,
// dh = 32 and 170.6 KB at Lk = 200 (the men shape); grid B * H blocks (512
// for the flagship encoder, 1,024 for its decoder).
//
// What bounds it on the H100: five products of Lq Lk dh FMAs per (b, h)
// (the scores' recompute, dO V^T, dS K, dS^T Q, w_d^T dO) against
// (3 Lq + 4 Lk) dh * 4 bytes of traffic: ~9 FMAs per byte at L = 50, so
// the kernel is bound by latency and the serial per-lane FMA chains, not by
// device memory. No tensor cores yet: parity first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTileQ = 32;  // query rows per tile; warp w owns rows w, w + 8, ...
constexpr float kNegMask = -4294967295.0f;  // -(2^32 - 1), src/carca.py:251

__device__ __forceinline__ float round_cd(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int lk, int dh) {
  return sizeof(float) * ((size_t)2 * lk * (dh + 1) + (size_t)2 * lk * dh + lk +
                          (size_t)2 * kTileQ * dh + (size_t)2 * kTileQ * lk +
                          (size_t)kWarps * lk);
}

// q/dout/dq [B, Lq, H*dh], k/v/dk/dv [B, Lk, H*dh], qm [B, Lq], km [B, Lk];
// block (b * H + h)
template <bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ qm,
                     const float* __restrict__ km, const float* __restrict__ dout,
                     float* __restrict__ dq, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Lq, int Lk, int dh,
                     int has_causal, int causal, float scale, int bf16, uint64_t seed,
                     uint32_t threshold, float keep) {
  extern __shared__ float smem[];
  const int ldk = dh + 1;
  float* ks = smem;                  // [Lk][dh + 1]
  float* vs = ks + Lk * ldk;         // [Lk][dh + 1]
  float* dks = vs + Lk * ldk;        // [Lk][dh] accumulator
  float* dvs = dks + Lk * dh;        // [Lk][dh] accumulator
  float* kms = dvs + Lk * dh;        // [Lk]
  float* qs = kms + Lk;              // [kTileQ][dh]
  float* dos = qs + kTileQ * dh;     // [kTileQ][dh]
  float* dss = dos + kTileQ * dh;    // [kTileQ][Lk]: dW, then dS
  float* wds = dss + kTileQ * Lk;    // [kTileQ][Lk]: w_d
  float* ps = wds + kTileQ * Lk;     // [kWarps][Lk]: exp, then w_raw

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int d = H * dh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < Lk * dh; idx += blockDim.x) {
    const int j = idx / dh, e = idx % dh;
    const size_t g = ((size_t)b * Lk + j) * d + (size_t)h * dh + e;
    ks[j * ldk + e] = round_cd(k[g], bf16);
    vs[j * ldk + e] = round_cd(v[g], bf16);
    dks[idx] = 0.f;
    dvs[idx] = 0.f;
  }
  for (int j = threadIdx.x; j < Lk; j += blockDim.x) kms[j] = km[(size_t)b * Lk + j];

  float* prow = ps + warp * Lk;
  for (int row0 = 0; row0 < Lq; row0 += kTileQ) {
    const int rows = min(kTileQ, Lq - row0);
    __syncthreads();  // K/V staged; the previous tile's buffers are consumed
    for (int idx = threadIdx.x; idx < rows * dh; idx += blockDim.x) {
      const int t = idx / dh, e = idx % dh;
      const size_t g = ((size_t)b * Lq + row0 + t) * d + (size_t)h * dh + e;
      qs[idx] = round_cd(q[g], bf16);
      dos[idx] = round_cd(dout[g], bf16);
    }
    __syncthreads();

    for (int t = warp; t < rows; t += kWarps) {
      const int i = row0 + t;  // absolute query row
      const float qmi = qm[(size_t)b * Lq + i];
      const float* qrow = qs + t * dh;
      const float* dorow = dos + t * dh;
      float* dsrow = dss + t * Lk;
      float* wdrow = wds + t * Lk;

      // the forward's softmax, in K1's order of operations
      float mx = -INFINITY;
      for (int j = lane; j < Lk; j += 32) {
        float s = 0.f;
        for (int e = 0; e < dh; ++e) s = fmaf(qrow[e], ks[j * ldk + e], s);
        const bool live = qmi * kms[j] > 0.f && !(has_causal && j > i + causal);
        const float z = (s + (live ? 0.f : kNegMask)) / scale;
        prow[j] = z;
        mx = fmaxf(mx, z);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < Lk; j += 32) {
        const float p = expf(prow[j] - mx);
        prow[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);

      const uint64_t row_idx = ((uint64_t)(b * H + h) * Lq + i) * Lk;
      float dot = 0.f;
      for (int j = lane; j < Lk; j += 32) {
        float m = qmi * kms[j];
        if (has_causal && j > i + causal) m = 0.f;
        const float w_raw = prow[j] / sum;
        float dw = 0.f;
        for (int e = 0; e < dh; ++e) dw = fmaf(dorow[e], vs[j * ldk + e], dw);
        float wd = w_raw * m;
        if (kDropout) {
          const bool kept = carca::philox_keep(seed, row_idx + j, threshold);
          wd = kept ? wd / keep : 0.f;
          dw = kept ? dw / keep : 0.f;
        }
        dw *= m;  // through the re-mask
        prow[j] = w_raw;
        dsrow[j] = dw;
        wdrow[j] = round_cd(wd, bf16);
        dot = fmaf(dw, w_raw, dot);
      }
      dot = warp_sum(dot);
      for (int j = lane; j < Lk; j += 32)
        dsrow[j] = round_cd(prow[j] * (dsrow[j] - dot) / scale, bf16);
      __syncwarp();

      const size_t qoff = ((size_t)b * Lq + i) * d + (size_t)h * dh;
      for (int e = lane; e < dh; e += 32) {
        float acc = 0.f;
        for (int j = 0; j < Lk; ++j) acc = fmaf(dsrow[j], ks[j * ldk + e], acc);
        dq[qoff + e] = acc;
      }
      __syncwarp();  // prow is rewritten by the warp's next row
    }
    __syncthreads();

    // dK += dS^T Q, dV += w_d^T dO over the tile's rows, in row order
    for (int idx = threadIdx.x; idx < Lk * dh; idx += blockDim.x) {
      const int j = idx / dh, e = idx % dh;
      float a = dks[idx], c = dvs[idx];
      for (int t = 0; t < rows; ++t) {
        a = fmaf(dss[t * Lk + j], qs[t * dh + e], a);
        c = fmaf(wds[t * Lk + j], dos[t * dh + e], c);
      }
      dks[idx] = a;
      dvs[idx] = c;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < Lk * dh; idx += blockDim.x) {
    const int j = idx / dh, e = idx % dh;
    const size_t g = ((size_t)b * Lk + j) * d + (size_t)h * dh + e;
    dk[g] = dks[idx];
    dv[g] = dvs[idx];
  }
}

template <bool kDropout>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* qm,
                       const float* km, const float* dout, float* dq, float* dk,
                       float* dv, int B, int H, int Lq, int Lk, int dh, int has_causal,
                       int causal, float scale, int bf16, uint64_t seed,
                       uint32_t threshold, float keep, cudaStream_t stream) {
  const size_t smem = smem_bytes(Lk, dh);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<kDropout>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_bwd_kernel<kDropout><<<B * H, kWarps * 32, smem, stream>>>(
      q, k, v, qm, km, dout, dq, dk, dv, H, Lq, Lk, dh, has_causal, causal, scale, bf16,
      seed, threshold, keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

size_t carca_attention_bwd_smem_bytes(int lk, int dh) { return smem_bytes(lk, dh); }

// dropout = 0: seed, threshold and keep are ignored. dq/dk/dv are written
// whole (every row, every head), so they need no zeroing.
int carca_attention_bwd(const void* q, const void* k, const void* v, const void* qm,
                        const void* km, const void* dout, void* dq, void* dk, void* dv,
                        int B, int H, int Lq, int Lk, int dh, int has_causal, int causal,
                        float scale, int bf16, int dropout, uint64_t seed,
                        uint32_t threshold, float keep, void* stream) {
  auto launch = dropout ? launch_bwd<true> : launch_bwd<false>;
  return (int)launch(static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const float*>(qm),
                     static_cast<const float*>(km), static_cast<const float*>(dout),
                     static_cast<float*>(dq), static_cast<float*>(dk),
                     static_cast<float*>(dv), B, H, Lq, Lk, dh, has_causal, causal, scale,
                     bf16, seed, threshold, keep, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
