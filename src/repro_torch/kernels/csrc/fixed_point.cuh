// Fixed-point codec shared by the share and reconstruct kernels.
//
// Bit-identical to repro_torch/core/fixed_point.py and to the reference's
// XLA sequence:
//   * NaN encodes to 0 (XLA's float -> int32 conversion of NaN gives 0;
//     fmaxf(NaN, -clip) would give -clip, so NaN is tested first);
//   * the clip is min(max(x, -clip), clip), so +-inf encode to +-clip;
//   * the product with the power-of-two scale is rounded half to even
//     (__float2int_rn, never roundf);
//   * decode is an exact power-of-two unscale followed by one IEEE
//     division by n (__fdiv_rn, not a multiply by 1/n).
// The sources are built without fast math for the same reason.
#pragma once

#include <cstdint>

#include "mersenne.cuh"

namespace repro {

__device__ __forceinline__ int32_t encode_q(float x, float scale,
                                            float clip) {
  if (isnan(x)) return 0;
  x = fminf(fmaxf(x, -clip), clip);
  return __float2int_rn(__fmul_rn(x, scale));
}

// Ring Z_2^32 codeword: two's complement of q.
__device__ __forceinline__ uint32_t encode_ring(float x, float scale,
                                                float clip) {
  return static_cast<uint32_t>(encode_q(x, scale, clip));
}

// Field F_p codeword: q >= 0 as is, q < 0 as p - |q|.
__device__ __forceinline__ uint32_t encode_field(float x, float scale,
                                                 float clip) {
  const int32_t q = encode_q(x, scale, clip);
  return q < 0 ? kP - static_cast<uint32_t>(-q) : static_cast<uint32_t>(q);
}

__device__ __forceinline__ float unscale_div(float v, float inv_scale,
                                             float n) {
  return __fdiv_rn(__fmul_rn(v, inv_scale), n);
}

}  // namespace repro
