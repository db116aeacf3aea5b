// Philox4x32-10 (Salmon et al., SC'11) with the canonical constants.
//
// Bit-identical to repro_torch/core/philox.py: counter (x0, x1, x2, x3),
// key (k0, k1), ten rounds, key bumped by (0x9E3779B9, 0xBB67AE85)
// after each round.  The 32x32 -> 64 products use the native
// multiply-low and __umulhi.
#pragma once

#include <cstdint>

namespace repro {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// Mask or coefficient words of stream `hi` for the four elements of
// counter block `block`.  The "flat" layout of the party-batch kernels
// puts hi in the third counter word, (block, 0, hi, 0); the "tiled"
// layout of the reference's single-party kernels (philox.tiled_words)
// puts it in the second, (block, hi, 0, 0).
template <bool kTiled>
__device__ __forceinline__ void philox_words_at(uint32_t block, uint32_t hi,
                                                uint32_t k0, uint32_t k1,
                                                uint32_t w[4]) {
  const uint4 c = kTiled ? make_uint4(block, hi, 0u, 0u)
                         : make_uint4(block, 0u, hi, 0u);
  const uint4 y = philox4x32_10(c, k0, k1);
  w[0] = y.x;
  w[1] = y.y;
  w[2] = y.z;
  w[3] = y.w;
}

// The "flat" layout: counter (block, 0, j, 0) for share index j.
__device__ __forceinline__ void philox_words(uint32_t block, uint32_t j,
                                             uint32_t k0, uint32_t k1,
                                             uint32_t w[4]) {
  philox_words_at<false>(block, j, k0, k1, w);
}

}  // namespace repro
