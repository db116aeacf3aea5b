// Fused fixed-point encode + Philox masks + additive share split: for a
// batch of parties, and for one party.
//
// Replaces:
//   src/repro/kernels/share_gen/kernel.py:140 share_gen_batch_pallas
//     (called from core/aggregation.py:197; "flat" counter layout);
//   src/repro/kernels/share_gen/kernel.py:89 share_gen_pallas
//     (called from fl/spmd.py:166 _share_dynamic; "tiled" layout).
//
// What bounds them on the H100: device memory.  Per element they read 4
// bytes of x and write 4*m bytes of shares, and do (m-1) quarters of a
// Philox call (100 integer operations per call of four words) plus a
// subtract per mask: at m = 3 that is about 52 integer operations for
// 16 bytes, below the card's integer-to-bandwidth ratio.  The single-party
// form at the train path's largest leaf (D = 155,582,464, m = 3) moves
// 16*D bytes: 0.743 ms at 3.35 TB/s.
//
// Design: the reference's [R, 128] lane tiling is a TPU artifact and is
// dropped.  One thread owns four consecutive elements of one party's
// flat [D] row: element i of a row whose first counter block is
// counter_base uses Philox block counter_base + i/4, word i%4, with
// counter (block, 0, j, 0) ("flat") or (block, j, 0, 0) ("tiled") for
// mask j = hi_base+1 .. hi_base+m-1 -- exactly core/philox.random_bits,
// so elements past D (the ragged tail) shift no counter and a padded
// tail is never needed.  x is read once, the masks live in registers,
// each mask is stored once, then code - sum(masks).  The batch grid is
// (element quads, parties), the single-party grid (element quads).  Rows
// whose length is a multiple of four move 16 bytes per thread per load
// and store.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_point.cuh"
#include "philox.cuh"
#include "quad_io.cuh"

namespace {

using repro::load4;
using repro::store4;

// The m shares of the four elements of quad `quad` of one party's row.
template <bool kTiled>
__device__ __forceinline__ void share_split_quad(
    const float* __restrict__ x_row, uint32_t* __restrict__ party_out,
    long long d, long long quad, int m, uint32_t counter_base,
    uint32_t hi_base, uint32_t k0, uint32_t k1, float scale, float clip) {
  const long long i0 = quad * 4;
  const int cnt = d - i0 < 4 ? (int)(d - i0) : 4;
  const bool vec = (d & 3) == 0;

  float v[4];
  load4(x_row, i0, cnt, vec, v);
  uint32_t last[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) last[k] = repro::encode_ring(v[k], scale, clip);

  // x0 and hi stay in uint32 arithmetic: they wrap exactly as the
  // reference's uint32 counter words do
  const uint32_t block = counter_base + (uint32_t)quad;
  for (int j = 0; j < m - 1; ++j) {
    uint32_t w[4];
    repro::philox_words_at<kTiled>(block, hi_base + (uint32_t)(j + 1), k0,
                                   k1, w);
    store4(party_out + (long long)j * d, i0, cnt, vec, w);
#pragma unroll
    for (int k = 0; k < 4; ++k) last[k] -= w[k];
  }
  store4(party_out + (long long)(m - 1) * d, i0, cnt, vec, last);
}

__global__ void share_gen_batch_kernel(const float* __restrict__ x,
                                       const uint32_t* __restrict__ keys,
                                       uint32_t* __restrict__ out,
                                       long long d, int m,
                                       uint32_t counter_base, float scale,
                                       float clip) {
  const long long quad = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (quad * 4 >= d) return;
  const int p = blockIdx.y;
  share_split_quad<false>(x + (long long)p * d, out + (long long)p * m * d,
                          d, quad, m, counter_base, 0u, keys[2 * p],
                          keys[2 * p + 1], scale, clip);
}

__global__ void share_gen_kernel(const float* __restrict__ x,
                                 uint32_t* __restrict__ out, long long d,
                                 int m, uint32_t k0, uint32_t k1,
                                 uint32_t hi_base, float scale, float clip) {
  const long long quad = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (quad * 4 >= d) return;
  share_split_quad<true>(x, out, d, quad, m, 0u, hi_base, k0, k1, scale,
                         clip);
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

extern "C" int repro_share_gen(const void* x, void* out, long long d, int m,
                               unsigned k0, unsigned k1, unsigned hi_base,
                               float scale, float clip, void* stream) {
  const long long quads = (d + 3) / 4;
  const int threads = 256;
  const unsigned blocks = (unsigned)((quads + threads - 1) / threads);
  share_gen_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(out), d, m, k0,
      k1, hi_base, scale, clip);
  return (int)cudaGetLastError();
}
