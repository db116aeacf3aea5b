// Arithmetic in the Mersenne field F_p, p = 2^31 - 1, on uint32 words.
//
// Same canonical residues in [0, p) as repro_torch/core/field.py:
// fmul folds the 64-bit product with 2^32 = 2 (mod p) and 2^31 = 1
// (mod p), as core/field.py:126-136 of the reference does, but takes
// the product from the native multiply-low and __umulhi instead of
// 16-bit limbs.
//
// Integer operations per call, as chip_smoke.py counts them for the
// kernels' bounds: mersenne_reduce 5 (and, shift, add, subtract,
// select), fadd 6, fmul 12 (multiply-low, __umulhi, and, shift, three
// adds, a reduce), to_field 3.
#pragma once

#include <cstdint>

namespace repro {

constexpr uint32_t kP = 0x7FFFFFFFu;

// x in [0, 2^32) -> x mod p.
__device__ __forceinline__ uint32_t mersenne_reduce(uint32_t x) {
  const uint32_t t = (x & kP) + (x >> 31);
  return t >= kP ? t - kP : t;
}

// a, b in [0, p): a + b < 2^32, so the sum cannot wrap.
__device__ __forceinline__ uint32_t fadd(uint32_t a, uint32_t b) {
  return mersenne_reduce(a + b);
}

// a, b in [0, p): hi < 2^30 and the folded lo <= p + 1, so the total
// stays below 2^32.
__device__ __forceinline__ uint32_t fmul(uint32_t a, uint32_t b) {
  const uint32_t lo = a * b;
  const uint32_t hi = __umulhi(a, b);
  const uint32_t lo_folded = (lo & kP) + (lo >> 31);
  return mersenne_reduce(hi + hi + lo_folded);
}

// Any word -> [0, p): mask to 31 bits, map p itself to 0.
__device__ __forceinline__ uint32_t to_field(uint32_t x) {
  const uint32_t r = x & kP;
  return r == kP ? 0u : r;
}

}  // namespace repro
