// K1: masked multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel carca_tpu/ops/flash_attention.py::_fwd_kernel
// (math in _weights_block and the post-softmax re-mask), reached from
// fused_attention through the _attention custom VJP. Plain version:
// carca_tpu_torch/models/attention.py::masked_attention.
//
// Semantics (src/carca.py:238-259): S = Q K^T with fp32 sums; pair mask
// m = q_mask[i] * k_mask[j], zeroed where j > i + causal when causal is on
// (i is the ABSOLUTE query row, so the offset survives q-tiling);
// z = (S + (m > 0 ? 0 : -(2^32 - 1))) / sqrt(d/H) in fp32 -- the additive
// constant is finite, so a fully masked row softmaxes to a uniform row
// that the re-mask w = softmax(z) * m turns into exact zeros (-inf would
// give NaN there); O = w V. With bf16 compute only the product inputs
// (q, k, w, v) are rounded to bf16; every sum stays fp32.
//
// What bounds it on the H100: at the serving shapes (Lk = 50, dh = 32) the
// work per (b, h) is ~2 * Lq * Lk * dh FMAs against Lq * dh * 8 bytes of
// q/out traffic -- about 12 FMAs per byte, so the kernel is bound by
// device-memory traffic and launch/latency, not by math. The design keeps
// every intermediate on chip: one block per (q-tile of 32 rows, head,
// batch row) stages that (b, h)'s K and V once in shared memory (12.8 KB
// at Lk=50, dh=32; K rows padded to dh+1 floats so lanes that read
// different keys hit different banks); one warp owns a query row --
// lanes over keys for the scores, warp shuffles for max and sum, lanes
// over dh for w V -- so the [Lq, Lk] score tile never reaches device
// memory, and q/k/v/out are read and written exactly once per block.
// Heads are addressed in place inside [B, L, d] (offset h * dh), so the
// wrapper needs no head split or merge copies. No tensor cores yet: the
// products are tiny (dh = 32) and fp32-exact parity with the plain
// version comes first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileQ = kWarps * kRowsPerWarp;
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
  return sizeof(float) * ((size_t)lk * (dh + 1) + (size_t)lk * dh + lk +
                          (size_t)kWarps * dh + (size_t)kWarps * lk);
}

// q [B, Lq, H*dh], k/v [B, Lk, H*dh], qm [B, Lq], km [B, Lk] -> out [B, Lq, H*dh]
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ qm,
                     const float* __restrict__ km, float* __restrict__ out,
                     int H, int Lq, int Lk, int dh, int has_causal, int causal,
                     float scale, int bf16) {
  extern __shared__ float smem[];
  const int ldk = dh + 1;
  float* ks = smem;                 // [Lk][dh + 1]
  float* vs = ks + Lk * ldk;        // [Lk][dh]
  float* kms = vs + Lk * dh;        // [Lk]
  float* qs = kms + Lk;             // [kWarps][dh]
  float* ws = qs + kWarps * dh;     // [kWarps][Lk]

  const int row0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d = H * dh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < Lk * dh; idx += blockDim.x) {
    const int j = idx / dh, e = idx % dh;
    const size_t g = ((size_t)b * Lk + j) * d + (size_t)h * dh + e;
    ks[j * ldk + e] = round_cd(k[g], bf16);
    vs[j * dh + e] = round_cd(v[g], bf16);
  }
  for (int j = threadIdx.x; j < Lk; j += blockDim.x) kms[j] = km[(size_t)b * Lk + j];
  __syncthreads();

  float* qrow = qs + warp * dh;
  float* wrow = ws + warp * Lk;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r * kWarps + warp;  // absolute query row
    if (i >= Lq) break;                      // warp-uniform
    const float qmi = qm[(size_t)b * Lq + i];
    const size_t qoff = ((size_t)b * Lq + i) * d + (size_t)h * dh;
    for (int e = lane; e < dh; e += 32) qrow[e] = round_cd(q[qoff + e], bf16);
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      float s = 0.f;
      for (int e = 0; e < dh; ++e) s = fmaf(qrow[e], ks[j * ldk + e], s);
      const bool keep = qmi * kms[j] > 0.f && !(has_causal && j > i + causal);
      const float z = (s + (keep ? 0.f : kNegMask)) / scale;
      wrow[j] = z;
      mx = fmaxf(mx, z);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float p = expf(wrow[j] - mx);
      wrow[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Lk; j += 32) {
      float m = qmi * kms[j];
      if (has_causal && j > i + causal) m = 0.f;
      wrow[j] = round_cd(wrow[j] / sum * m, bf16);  // post-softmax re-mask
    }
    __syncwarp();

    for (int e = lane; e < dh; e += 32) {
      float o = 0.f;
      for (int j = 0; j < Lk; ++j) o = fmaf(wrow[j], vs[j * dh + e], o);
      out[qoff + e] = o;
    }
    __syncwarp();  // qrow / wrow are rewritten by the next row
  }
}

}  // namespace

extern "C" {

const char* carca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

size_t carca_attention_fwd_smem_bytes(int lk, int dh) { return smem_bytes(lk, dh); }

int carca_attention_fwd(const void* q, const void* k, const void* v, const void* qm,
                        const void* km, void* out, int B, int H, int Lq, int Lk,
                        int dh, int has_causal, int causal, float scale, int bf16,
                        void* stream) {
  const size_t smem = smem_bytes(Lk, dh);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + kTileQ - 1) / kTileQ, H, B);
  attention_fwd_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(qm),
      static_cast<const float*>(km), static_cast<float*>(out), H, Lq, Lk, dh,
      has_causal, causal, scale, bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
