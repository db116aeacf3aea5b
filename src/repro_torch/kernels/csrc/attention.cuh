// Shared pieces of the attention kernels: element types, the masking
// constant, lane reductions and asynchronous copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// 16-byte asynchronous copy from device to shared memory (cp.async, in
// flight until a wait on its commit group); src_bytes 0 fills the 16
// bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
