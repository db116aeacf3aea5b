// Shamir share generation (Horner over F_p) and Lagrange reconstruction
// with decode, for the Mersenne field p = 2^31 - 1.
//
// Replaces:
//   src/repro/kernels/shamir/kernel.py:111 shamir_share_batch_pallas
//     (called from core/aggregation.py:201; "flat" counter layout);
//   src/repro/kernels/shamir/kernel.py:68 shamir_share_pallas
//     (called from fl/spmd.py:156-159; "tiled" layout);
//   src/repro/kernels/shamir/kernel.py:158 shamir_reconstruct_pallas
//     (called from core/aggregation.py:416 with n = 1, and from
//     fl/spmd.py with the party count folded into inv_scale).
//
// What bounds them on the H100:
//   * share generation is bound by integer operations: per element,
//     d quarters of a Philox call (25 operations each), d to_field (3
//     each) and m*d Horner multiply-adds of 18 operations each (fmul 12,
//     fadd 6, as mersenne.cuh spells them out) -- 164 operations for 16
//     bytes moved at m = 3, d = 2, above the card's integer-to-bandwidth
//     ratio.  chip_smoke.py counts the bound the same way.  The design
//     keeps the d coefficient words in registers (never in device
//     memory) and runs all m Horner chains from them, so each
//     coefficient is drawn once.
//   * reconstruction reads k rows and writes one float row with k
//     multiply-adds per element: bound by device memory.
//
// Design: as share_gen.cu -- flat [D] rows, one thread per four
// consecutive elements, Philox block counter_base + i/4 with counter
// (block, 0, hi_base + j, 0) ("flat") or (block, hi_base + j, 0, 0)
// ("tiled") for coefficient j = 1..d; grid (element quads, parties) for
// the batch, (element quads) for one party.  The degree is a runtime
// argument up to kMaxDegree so the coefficient array stays in
// registers; the wrapper rejects larger degrees.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_point.cuh"
#include "mersenne.cuh"
#include "philox.cuh"
#include "quad_io.cuh"

namespace {

constexpr int kMaxDegree = 16;

// The m shares of the four elements of quad `quad` of one party's row.
template <bool kTiled>
__device__ __forceinline__ void shamir_quad(
    const float* __restrict__ x_row, uint32_t* __restrict__ party_out,
    long long d, long long quad, int m, int degree, uint32_t counter_base,
    uint32_t hi_base, uint32_t k0, uint32_t k1, float scale, float clip) {
  const long long i0 = quad * 4;
  const int cnt = d - i0 < 4 ? (int)(d - i0) : 4;
  const bool vec = (d & 3) == 0;

  float xv[4];
  repro::load4(x_row, i0, cnt, vec, xv);
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = repro::encode_field(xv[k], scale, clip);

  const uint32_t block = counter_base + (uint32_t)quad;
  // The leading coefficient a_d is drawn on its own into lead[] (v at
  // degree 0) and a_1 .. a_{d-1} into a[]: no index of a[] depends on
  // the degree, so the array stays in registers.
  uint32_t lead[4] = {v[0], v[1], v[2], v[3]};
  if (degree > 0) {
    uint32_t w[4];
    repro::philox_words_at<kTiled>(block, hi_base + (uint32_t)degree, k0,
                                   k1, w);
#pragma unroll
    for (int k = 0; k < 4; ++k) lead[k] = repro::to_field(w[k]);
  }
  uint32_t a[kMaxDegree - 1][4];
#pragma unroll
  for (int j = 0; j < kMaxDegree - 1; ++j) {
    if (j < degree - 1) {
      uint32_t w[4];
      repro::philox_words_at<kTiled>(block, hi_base + (uint32_t)(j + 1), k0,
                                     k1, w);
#pragma unroll
      for (int k = 0; k < 4; ++k) a[j][k] = repro::to_field(w[k]);
    }
  }
  for (int s = 0; s < m; ++s) {
    const uint32_t xp = (uint32_t)(s + 1);
    // Horner from the leading coefficient, d multiply-adds:
    // q(x) = ((a_d x + a_{d-1}) x + ...) x + v
    uint32_t acc[4] = {lead[0], lead[1], lead[2], lead[3]};
#pragma unroll
    for (int j = kMaxDegree - 2; j >= 0; --j) {
      if (j < degree - 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[k] = repro::fadd(repro::fmul(acc[k], xp), a[j][k]);
      }
    }
    if (degree > 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] = repro::fadd(repro::fmul(acc[k], xp), v[k]);
    }
    repro::store4(party_out + (long long)s * d, i0, cnt, vec, acc);
  }
}

__global__ void shamir_share_batch_kernel(const float* __restrict__ x,
                                          const uint32_t* __restrict__ keys,
                                          uint32_t* __restrict__ out,
                                          long long d, int m, int degree,
                                          uint32_t counter_base, float scale,
                                          float clip) {
  const long long quad = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (quad * 4 >= d) return;
  const int p = blockIdx.y;
  shamir_quad<false>(x + (long long)p * d, out + (long long)p * m * d, d,
                     quad, m, degree, counter_base, 0u, keys[2 * p],
                     keys[2 * p + 1], scale, clip);
}

__global__ void shamir_share_kernel(const float* __restrict__ x,
                                    uint32_t* __restrict__ out, long long d,
                                    int m, int degree, uint32_t k0,
                                    uint32_t k1, uint32_t hi_base,
                                    float scale, float clip) {
  const long long quad = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (quad * 4 >= d) return;
  shamir_quad<true>(x, out, d, quad, m, degree, 0u, hi_base, k0, k1, scale,
                    clip);
}

__global__ void shamir_reconstruct_kernel(const uint32_t* __restrict__ sums,
                                          const uint32_t* __restrict__ weights,
                                          float* __restrict__ out, int k,
                                          long long d, float inv_scale,
                                          float n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d) return;
  uint32_t acc = repro::fmul(sums[i], weights[0]);
  for (int r = 1; r < k; ++r)
    acc = repro::fadd(acc, repro::fmul(sums[(long long)r * d + i],
                                       weights[r]));
  // symmetric decode: above (p-1)/2 is negative
  const bool neg = acc > (repro::kP >> 1);
  const float mag = __uint2float_rn(neg ? repro::kP - acc : acc);
  out[i] = repro::unscale_div(neg ? -mag : mag, inv_scale, n);
}

}  // namespace

extern "C" int repro_shamir_share_batch(const void* x, const void* keys,
                                        void* out, int l, long long d, int m,
                                        int degree, unsigned counter_base,
                                        float scale, float clip,
                                        void* stream) {
  if (degree < 0 || degree > kMaxDegree) return (int)cudaErrorInvalidValue;
  const long long quads = (d + 3) / 4;
  const int threads = 256;
  const dim3 grid((unsigned)((quads + threads - 1) / threads), (unsigned)l);
  shamir_share_batch_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(keys),
      static_cast<uint32_t*>(out), d, m, degree, counter_base, scale, clip);
  return (int)cudaGetLastError();
}

extern "C" int repro_shamir_share(const void* x, void* out, long long d,
                                  int m, int degree, unsigned k0,
                                  unsigned k1, unsigned hi_base, float scale,
                                  float clip, void* stream) {
  if (degree < 0 || degree > kMaxDegree) return (int)cudaErrorInvalidValue;
  const long long quads = (d + 3) / 4;
  const int threads = 256;
  const unsigned blocks = (unsigned)((quads + threads - 1) / threads);
  shamir_share_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(out), d, m,
      degree, k0, k1, hi_base, scale, clip);
  return (int)cudaGetLastError();
}

extern "C" int repro_shamir_reconstruct(const void* sums, const void* weights,
                                        void* out, int k, long long d,
                                        float inv_scale, float n,
                                        void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((d + threads - 1) / threads);
  shamir_reconstruct_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(sums),
      static_cast<const uint32_t*>(weights), static_cast<float*>(out), k, d,
      inv_scale, n);
  return (int)cudaGetLastError();
}
