// Fused fixed-point encode + Philox masks + additive share split for a
// batch of parties.
//
// Replaces: src/repro/kernels/share_gen/kernel.py:140
//   share_gen_batch_pallas (called from core/aggregation.py:197).
//
// What bounds it on the H100: device memory.  Per element it reads 4
// bytes of x and writes 4*m bytes of shares, and does (m-1) quarters of
// a Philox call (100 integer operations per call of four words) plus a
// subtract per mask: at m = 3 that is about 52 integer operations for
// 16 bytes, below the card's integer-to-bandwidth ratio.
//
// Design: the reference's [R, 128] lane tiling is a TPU artifact and is
// dropped.  One thread owns four consecutive elements of one party's
// flat [D] row: element i of a chunk that starts at counter block
// counter_base uses Philox block counter_base + i/4, word i%4, with
// counter (block, 0, j, 0) for mask j = 1..m-1 -- exactly
// core/philox.random_bits(counter_base=elem_base//4), so elements past
// D (the ragged tail) shift no counter.  x is read once, the masks
// live in registers, each mask is stored once, then code - sum(masks).
// The grid is (element quads, parties).  Rows whose length is a
// multiple of four move 16 bytes per thread per load and store.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_point.cuh"
#include "philox.cuh"
#include "quad_io.cuh"

namespace {

using repro::load4;
using repro::store4;

__global__ void share_gen_batch_kernel(const float* __restrict__ x,
                                       const uint32_t* __restrict__ keys,
                                       uint32_t* __restrict__ out,
                                       long long d, int m,
                                       uint32_t counter_base, float scale,
                                       float clip) {
  const long long quad = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i0 = quad * 4;
  if (i0 >= d) return;
  const int p = blockIdx.y;
  const uint32_t k0 = keys[2 * p];
  const uint32_t k1 = keys[2 * p + 1];
  const int cnt = d - i0 < 4 ? (int)(d - i0) : 4;
  const bool vec = (d & 3) == 0;
  uint32_t* party_out = out + (long long)p * m * d;

  float v[4];
  load4(x + (long long)p * d, i0, cnt, vec, v);
  uint32_t last[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) last[k] = repro::encode_ring(v[k], scale, clip);

  // x0 stays in uint32 arithmetic: it wraps exactly as the reference's
  // uint32 counter does
  const uint32_t block = counter_base + (uint32_t)quad;
  for (int j = 0; j < m - 1; ++j) {
    uint32_t w[4];
    repro::philox_words(block, (uint32_t)(j + 1), k0, k1, w);
    store4(party_out + (long long)j * d, i0, cnt, vec, w);
#pragma unroll
    for (int k = 0; k < 4; ++k) last[k] -= w[k];
  }
  store4(party_out + (long long)(m - 1) * d, i0, cnt, vec, last);
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int repro_share_gen_batch(const void* x, const void* keys,
                                     void* out, int l, long long d, int m,
                                     unsigned counter_base, float scale,
                                     float clip, void* stream) {
  const long long quads = (d + 3) / 4;
  const int threads = 256;
  const dim3 grid((unsigned)((quads + threads - 1) / threads), (unsigned)l);
  share_gen_batch_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(keys),
      static_cast<uint32_t*>(out), d, m, counter_base, scale, clip);
  return (int)cudaGetLastError();
}
