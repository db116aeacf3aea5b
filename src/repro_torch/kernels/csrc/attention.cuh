// Shared pieces of the attention kernels: element types and the
// masking constant.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// the reference kernels' finite mask value: exp(NEG_INF - m) is exactly
// 0 for any finite running max m, and NEG_INF - NEG_INF is 0, not NaN
constexpr float kNegInf = -1e30f;

// dtype codes of the C interface (kernels/dispatch.py::DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the max and the sum over the 2^k lanes of a group of neighbouring lanes
template <int LANES>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int LANES>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace repro
