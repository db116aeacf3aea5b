// Arithmetic in F_q, q = 2^59 - 2^28 + 1, the field of the Feldman
// commitment group (repro_torch/core/vss.py).
//
// Elements are uint64 values, canonical in [0, q): both sides of the
// Feldman comparison must be canonical, or an honest element would read
// as tampered.  The reference (src/repro/core/vss.py:108-165) builds the
// 118-bit product from 16-bit limbs, a TPU artifact; here it comes from
// the native 64-bit multiply and __umul64hi, and is reduced with the same
// Crandall fold, 2^59 = 2^28 - 1 (mod q), plus one conditional subtract.
//
// Integer operations per call, as chip_smoke.py counts them for the
// verify_shares bound: one per 64-bit source operation, counted in the
// brackets of qmul's body -- qmul 20.  The card splits a 64-bit multiply
// into several 32-bit ones, so a bound from these counts is a floor.
#pragma once

#include <cstdint>

namespace repro {

constexpr uint64_t kQ = (1ull << 59) - (1ull << 28) + 1;
// 2^59 = kT (mod q)
constexpr uint64_t kT = (1ull << 28) - 1;
constexpr uint64_t kLow59 = (1ull << 59) - 1;

// a, b in [0, q) -> a * b mod q, in [0, q).
__device__ __forceinline__ uint64_t qmul(uint64_t a, uint64_t b) {
  // V = a*b = hi*2^64 + lo < 2^118                          [2 ops]
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  // V = top*2^59 + low, top < 2^59; V = top*kT + low        [4 ops]
  const uint64_t top = (hi << 5) | (lo >> 59);
  const uint64_t low = lo & kLow59;
  // X = top*kT + low = hi2*2^64 + s < 2^88                  [5 ops]
  const uint64_t lo2 = top * kT;
  uint64_t hi2 = __umul64hi(top, kT);
  const uint64_t s = lo2 + low;
  hi2 += s < lo2 ? 1u : 0u;
  // X = top2*2^59 + (s mod 2^59), top2 < 2^29, so
  // r = top2*kT + (s mod 2^59) < 2^57 + 2^59 < 2q           [6 ops]
  const uint64_t top2 = (hi2 << 5) | (s >> 59);
  const uint64_t r = top2 * kT + (s & kLow59);
  // one conditional subtract                                [3 ops]
  return r >= kQ ? r - kQ : r;
}

// a^e mod q for a runtime exponent, left to right: bitlen(e) - 1
// squarings and popcount(e) - 1 multiplies.  e is the same in every
// thread of a block, so the loop does not diverge.
__device__ __forceinline__ uint64_t qpow(uint64_t a, uint32_t e) {
  if (e == 0) return 1;
  uint64_t r = a;
  for (int b = 30 - __clz(e); b >= 0; --b) {
    r = qmul(r, r);
    if ((e >> b) & 1u) r = qmul(r, a);
  }
  return r;
}

}  // namespace repro
