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
// What bounds it on the H100: at the serving and training shapes (Lk = 50,
// dh = 32) a (b, h) does 2 Lq Lk dh multiply-adds against (2 Lq + 2 Lk) dh
// * 4 bytes of q/out/k/v traffic, ~12 per byte: far below the tensor
// cores' ridge, so the floor is device-memory traffic (13 MB read and
// written at the encoder shape, ~4 us) plus one wave of blocks' latency.
// A first design missed it by 12x: one warp per query row, serial dh-long
// FMA chains for each score and an Lk-long chain for w V, K/V staged again
// by every 32-row q-tile, and one full Philox call per weight.
//
// Design (attention_tile.cuh::rows_kernel): one block per (64 query rows,
// head, batch row), so K and V reach shared memory once per block (one
// block per (b, h) at Lq = 50; eight at the rerank shape Lq = 512). Each
// warp owns 16 query rows; S = Q K^T goes into registers by mma.sync
// (3xTF32 for float32 compute, bf16 operands for bfloat16); mask, scale,
// row max, exp, sum, re-mask and dropout run in the accumulator layout with
// quad shuffles; P V takes P straight from registers; the output tile is
// written once, with 16-byte stores where aligned. Lk beyond 64 keys walks
// key tiles twice (row statistics, then weights), so shared memory does not
// grow with Lk. With dropout a pre-pass packs the call's keep bits (one
// Philox call per four weights) and the kernel reads three words per row
// and key tile. Heads are addressed in place inside [B, L, d] (offset
// h * dh), so the wrapper needs no head split or merge copies. A head wider
// than 128 dims sums S over 128-column chunks and walks the key tiles once
// more per chunk of the output (rare: every configuration has dh = 32). Four blocks
// share an SM at dh <= 32 (128 registers); the kernel is bound by the
// latency of its mma.sync chains, exp and barriers, not by bytes.
// carca_attention_keep_bits runs the pre-pass alone, for the checks that
// feed the bits to the plain version.

#include "attention_tile.cuh"

namespace {

using carca::attn::Args;

struct Forward {
  const Args& a;
  cudaStream_t stream;
  template <int kDh, bool kBf16>
  cudaError_t operator()() const {
    const cudaError_t err = carca::attn::launch_keep_bits(a, stream);
    if (err != cudaSuccess) return err;
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

// The packed keep bits K1 and K2 run on, for n = B * H * Lq * Lk weights:
// bits holds ceil(n / 32) words; seed_ptr as carca_attention_fwd's.
int carca_attention_keep_bits(void* bits, uint64_t n, uint64_t seed, const void* seed_ptr,
                              uint32_t threshold, void* stream) {
  return (int)carca::attn::launch_keep_bits(static_cast<uint32_t*>(bits), n, seed,
                                            static_cast<const uint64_t*>(seed_ptr), threshold,
                                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
