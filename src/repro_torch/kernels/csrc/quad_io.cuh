// Loads and stores of the four consecutive elements a thread owns.
//
// `vec` is true when every row length is a multiple of four, so that
// row + i0 is 16-byte aligned as long as the tensor itself is: outputs
// come from torch.empty, and the wrapper (share_gen/ops.py,
// check_batch_inputs) rejects an input view that is not.  The ragged
// tail of other rows is masked element by element.
#pragma once

#include <cstdint>

namespace repro {

__device__ __forceinline__ void load4(const float* __restrict__ row,
                                      long long i0, int cnt, bool vec,
                                      float v[4]) {
  if (vec) {
    const float4 t = *reinterpret_cast<const float4*>(row + i0);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < cnt ? row[i0 + k] : 0.0f;
}

__device__ __forceinline__ void store4(uint32_t* __restrict__ row,
                                       long long i0, int cnt, bool vec,
                                       const uint32_t w[4]) {
  if (vec) {
    *reinterpret_cast<uint4*>(row + i0) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < cnt) row[i0 + k] = w[k];
}

}  // namespace repro
