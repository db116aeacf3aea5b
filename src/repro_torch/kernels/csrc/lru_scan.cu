// RG-LRU linear recurrence (Griffin / RecurrentGemma): every state of
//
//   h_t = a_t ⊙ h_{t-1} + b_t,   h_{-1} = 0,
//
// a, b [B, S, W] (float32 or bfloat16) -> h [B, S, W] of a's type, the
// carry in float32.
//
// Replaces: src/repro/kernels/lru_scan/kernel.py:42 lru_scan_pallas
//   (pallas_call at :52), which the reference's recurrent block runs once
//   per rec layer of every prefill on a TPU (models/hybrid.py:60-68); the
//   port's runs it through kernels/lru_scan/ops.py::lru_scan
//   (models/hybrid.py::rglru_apply).
//
// What bounds it on the H100: device memory.  Each (row, step, channel)
// reads a and b and writes h once and does two float32 operations: at
// recurrentgemma-9b's prefill shape [8, 2048, 4096] in float32 that is
// 805 MB, 0.240 ms at 3.35 TB/s, against 0.13 G operations.  But the
// recurrence is sequential in time, so only B·W = 32,768 threads exist
// there, far too few to fill 132 SMs with independent loads one step at
// a time: a thread that loaded a_t, b_t only when h_{t-1} was ready would
// wait a full memory latency every step.
//
// Design: one thread per (batch row, channel), 128 channels a block,
// grid (ceil(W / 128), B); neighbouring threads take neighbouring
// channels, so every load and store of a warp is one coalesced row
// segment, and the channel tail past W is masked.  None of the loads
// depends on h, so time runs in register tiles of kT steps, double
// buffered: the tile after the current one is loaded before the current
// one's dependent chain runs, which keeps 2·kT loads of each thread in
// flight.  The carry stays in a float32 register over the whole
// sequence.  Each step rounds the product before the sum
// (__fadd_rn(__fmul_rn(a, h), b)): the build allows FMA contraction, and
// a fused a·h + b would part from the plain version, which rounds the
// product, by up to an ulp a step, adding up over a nearly undamped
// carry.  So the kernel and the plain version do the same float
// operations and agree bit for bit.  A chunked two-pass scan over time
// (per-chunk products and local states, then a carry pass) would fill
// the card; that is a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kT = 16;

template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ p,
                                          long long w, int steps,
                                          float (&out)[kT]) {
#pragma unroll
  for (int u = 0; u < kT; ++u)
    out[u] = u < steps ? repro::to_float(p[u * w]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ h, int s, int w) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= w) return;
  const long long row = (long long)blockIdx.y * s * w + c;
  const long long ws = w;
  const T* ap = a + row;
  const T* bp = b + row;
  T* hp = h + row;

  float a_cur[kT], b_cur[kT], a_nxt[kT], b_nxt[kT];
  load_tile(ap, ws, min(kT, s), a_cur);
  load_tile(bp, ws, min(kT, s), b_cur);
  float carry = 0.f;
  for (int t0 = 0; t0 < s; t0 += kT) {
    const int t1 = t0 + kT;
    const int next = t1 < s ? min(kT, s - t1) : 0;
    load_tile(ap + t1 * ws, ws, next, a_nxt);
    load_tile(bp + t1 * ws, ws, next, b_nxt);
    const int steps = min(kT, s - t0);
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      if (u < steps) {
        carry = __fadd_rn(__fmul_rn(a_cur[u], carry), b_cur[u]);
        hp[(t0 + u) * ws] = repro::from_float<T>(carry);
      }
    }
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      a_cur[u] = a_nxt[u];
      b_cur[u] = b_nxt[u];
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int bsz, int s, int w,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((w + kThreads - 1) / kThreads), (unsigned)bsz);
  lru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      s, w);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b and h contiguous [B, S, W] of one type: dtype code 0 float32,
// 1 bfloat16.  B <= 65535.
extern "C" int repro_lru_scan(const void* a, const void* b, void* h, int bsz,
                              int s, int w, int dtype, void* stream) {
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch<float>(a, b, h, bsz, s, w, str);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(a, b, h, bsz, s, w, str);
  return (int)cudaErrorInvalidValue;
}
