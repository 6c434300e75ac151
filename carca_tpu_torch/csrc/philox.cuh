// Stateless Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy
// as 1, 2, 3", SC'11) for the attention kernels' weight dropout.
//
// Stands in for the TPU's on-core generator of
// carca_tpu/ops/flash_attention.py::_dropout_bits. The bits cannot equal
// the TPU's; what matters is that K1 (forward) and K2 (backward) draw the
// SAME bit for the same attention weight, with no state between launches.
// So the generator is a pure function of (seed, element): the key is the
// 64-bit seed the wrapper draws per call; the element's identity is its
// linear index idx = ((b * H + h) * Lq + i) * Lk + j, and its 32 random bits
// are word idx % 4 of the block whose counter is idx / 4. One call of the
// 10 rounds thus serves four consecutive weights: the attention kernels'
// pre-pass (attention_tile.cuh::keep_bits_kernel) packs the keep bits of a
// call into a bitmask that way, and the kernels read it. No curand state per
// thread: initialising one costs far more than the 10 rounds.
//
// carca_tpu_torch/ops/flash_attention.py::philox_bits is the same function
// in numpy (checked against the Random123 known-answer vectors and against
// this header compiled for the host on the CPU, and against the kernels'
// bits on the card).

#pragma once

#include <stdint.h>

namespace carca {

__host__ __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint64_t p0 = (uint64_t)0xD2511F53u * c.x;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c.z;
    c = make_uint4((uint32_t)(p1 >> 32) ^ c.y ^ k.x, (uint32_t)p1,
                   (uint32_t)(p0 >> 32) ^ c.w ^ k.y, (uint32_t)p0);
  }
  return c;
}

// The four words of block `counter` under `seed`.
__host__ __device__ __forceinline__ uint4 philox_block(uint64_t seed, uint64_t counter) {
  return philox4x32_10(make_uint4((uint32_t)counter, (uint32_t)(counter >> 32), 0u, 0u),
                       make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
}

__host__ __device__ __forceinline__ uint32_t philox_word(uint4 r, uint32_t w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// 32 random bits of element `idx` under `seed`. A weight is kept iff its
// bits < floor((1 - p) * 2^32) (clamped to 2^32 - 1), as _dropout_bits
// does; the wrapper computes that threshold once.
__host__ __device__ __forceinline__ uint32_t philox_bits(uint64_t seed, uint64_t idx) {
  return philox_word(philox_block(seed, idx >> 2), (uint32_t)(idx & 3));
}

}  // namespace carca
