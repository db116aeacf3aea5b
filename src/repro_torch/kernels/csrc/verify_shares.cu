// Batched Feldman verification: flag each element of k rows where
//   h^{row_i[e]} == prod_j C_j[e]^{x_i^j}   (mod q, q = 2^59 - 2^28 + 1).
//
// Replaces: src/repro/kernels/verify_shares/kernel.py:43
//   verify_shares_pallas (called from fl/transport.py:715 on member sums
//   and :786 on every dealer's rows in the norm audit).
//
// What bounds it on the H100: integer operations.  Per (row, element)
// it reads 4 bytes of row and 8*c bytes of commitments and writes 4
// bytes, against a 30-step fixed-base ladder (30 qmul) and a Horner in
// the exponent of (c-1) qpow + qmul -- ~700 64-bit operations at c = 2,
// x <= 3 (fq.cuh counts them).  The design keeps every intermediate in
// registers and reads each commitment limb pair as it is needed: no
// array is indexed by the runtime degree, so nothing goes to local
// memory.
//
// Design: the port's flat layout, not the TPU's plane-major tiles.
// Rows are int32 bit patterns [k, D]; commitments are int32 limbs
// [D, c, 2] (hi, lo), element-major, the wire layout of core/vss.py;
// points are k small ints on the card.  Grid (ceil(D / 128), k): one
// thread per (row, element), so the member-row shape (k = 3,
// D = 10,000) still fills 237 blocks.  A bounds check on the flat index
// replaces the reference's identity padding, so a ragged D needs no pad.
// The fixed-base table h^(2^i) sits in __constant__ memory: every lane
// reads the same i in the same step, so the read is a broadcast, and
// the per-bit choice is a select, not a branch.
#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"

namespace {

// h^(2^i) mod q for i = 0..30, h = 3^(2^28) mod q: the values of
// repro_torch/core/vss.py::_GEN_POW (a CPU test holds them equal).
__constant__ uint64_t kGenPow[31] = {
    0x78bb9517880afc8ull, 0x79a65dfeb9f048aull,
    0x6dac8de4678c30dull, 0x590bef621d5f7e8ull,
    0x29fd0bd5b0cc66dull, 0x00477c2055a68deull,
    0x5be380280494059ull, 0x20a86b14b639076ull,
    0x5ab30fb930d5c2aull, 0x63b9f911ae0a3a3ull,
    0x0a7727434d30728ull, 0x039c8a4b2f3f0b8ull,
    0x4e58627fc77faffull, 0x55b26c339c069efull,
    0x43890a93bc6507bull, 0x381216260374d1cull,
    0x4c375d0ee171b85ull, 0x02e1210ccac91acull,
    0x620d1a5e804bc16ull, 0x4f8811b802b8418ull,
    0x5129a53f13e1f56ull, 0x12038a70ea0a134ull,
    0x2a063fb38e3b80dull, 0x2f619440ac92b86ull,
    0x5428c5ba7d99be4ull, 0x55801f20fdd9abfull,
    0x774e89bc481985dull, 0x6a8a5e64a06338eull,
    0x6fffec86a70861bull, 0x245c5b5632bf8d6ull,
    0x6674b27dbdeb453ull,
};

// h^s over the low 31 bits of s (exponents are field elements), as the
// reference's ladder: step i multiplies by h^(2^i) where bit i is set.
// Per step: qmul, a shift, an and and a select.
__device__ __forceinline__ uint64_t gpow(uint32_t s) {
  uint64_t acc = (s & 1u) ? kGenPow[0] : 1ull;
#pragma unroll
  for (int i = 1; i < 31; ++i) {
    const uint64_t m = repro::qmul(acc, kGenPow[i]);
    acc = ((s >> i) & 1u) ? m : acc;
  }
  return acc;
}

__device__ __forceinline__ uint64_t load_commit(
    const uint32_t* __restrict__ commits, long long word) {
  return ((uint64_t)commits[word] << 32) | commits[word + 1];
}

__global__ void verify_shares_kernel(const uint32_t* __restrict__ rows,
                                     const uint32_t* __restrict__ commits,
                                     const uint32_t* __restrict__ points,
                                     uint32_t* __restrict__ out, long long d,
                                     int c) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= d) return;
  const int i = blockIdx.y;
  const uint32_t x = points[i];
  const long long base = e * c * 2;
  // Horner in the exponent: C_0 * (C_1 * (...)^x)^x
  uint64_t rhs = load_commit(commits, base + 2ll * (c - 1));
  for (int j = c - 2; j >= 0; --j)
    rhs = repro::qmul(repro::qpow(rhs, x), load_commit(commits, base + 2ll * j));
  const long long at = (long long)i * d + e;
  out[at] = gpow(rows[at]) == rhs ? 1u : 0u;
}

}  // namespace

extern "C" int repro_verify_shares(const void* rows, const void* commits,
                                   const void* points, void* out, int k,
                                   long long d, int c, void* stream) {
  if (k < 1 || c < 1 || d < 0) return (int)cudaErrorInvalidValue;
  if (d == 0) return 0;
  const int threads = 128;
  const dim3 grid((unsigned)((d + threads - 1) / threads), (unsigned)k);
  verify_shares_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(rows),
      static_cast<const uint32_t*>(commits),
      static_cast<const uint32_t*>(points), static_cast<uint32_t*>(out), d,
      c);
  return (int)cudaGetLastError();
}
