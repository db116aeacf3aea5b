// Fused wrap-around share sum + ring decode + 1/n.
//
// Replaces: src/repro/kernels/reconstruct/kernel.py:33 reconstruct_pallas
//   (called from core/aggregation.py:412, with n = 1).
//
// What bounds it on the H100: device memory -- 4*m bytes read and 4
// bytes written per element against m-1 adds and one conversion.
//
// Design: one thread per element of the flat [D] row; the m member
// sums are added in uint32 (wrap-around), reinterpreted as int32,
// converted with __int2float_rn, multiplied by the exact power-of-two
// 1/scale and divided by n with an IEEE division -- the reference's
// decode sequence, so the result is bit-identical.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_point.cuh"

namespace {

__global__ void reconstruct_kernel(const uint32_t* __restrict__ shares,
                                   float* __restrict__ out, int m,
                                   long long d, float inv_scale, float n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d) return;
  uint32_t acc = shares[i];
  for (int j = 1; j < m; ++j) acc += shares[(long long)j * d + i];
  const float v = __int2float_rn(static_cast<int32_t>(acc));
  out[i] = repro::unscale_div(v, inv_scale, n);
}

}  // namespace

extern "C" int repro_reconstruct(const void* shares, void* out, int m,
                                 long long d, float inv_scale, float n,
                                 void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((d + threads - 1) / threads);
  reconstruct_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(shares), static_cast<float*>(out), m, d,
      inv_scale, n);
  return (int)cudaGetLastError();
}
