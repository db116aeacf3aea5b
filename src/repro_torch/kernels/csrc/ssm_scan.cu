// Mamba-1 selective scan: the state carried over the whole sequence.
//
//   h_t = exp(dt_t ⊗ A) ⊙ h_{t-1} + (dt_t ⊙ x_t) ⊗ B_t
//   y_t = Σ_n h_t[·, n] · C_t[n]
//
// x [B, S, di] (float32 or bfloat16), dt [B, S, di] float32, B and C
// [B, S, st] of x's type, A [di, st] float32 -> y [B, S, di] of x's type.
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py:55 ssm_scan_pallas
//   (pallas_call at :67), which the reference's SSM block runs once per
//   layer of every prefill on a TPU (models/ssm.py:77); the port's runs
//   it through kernels/ssm_scan/ops.py::ssm_scan (models/ssm.py).
//
// What bounds it on the H100: the exponentials.  Every (row, step,
// channel, state) takes one expf, 2.15 G of them at the prefill shape
// [8, 2048, 8192] with st 16, against 1.07 GB of operands in bf16: at 16
// special-function results per clock per SM the expf alone take ~0.5 ms,
// the bytes 0.32 ms.  The [B, S, di, st] state tensor never reaches
// device memory: h lives in registers for the whole sequence.
//
// Design: one thread per (batch row, channel), 128 channels a block,
// grid (ceil(di / 128), B); the channel tail past di is masked.  The st
// states and A[d, :] sit in register arrays, so the kernel is templated
// on st (1..16): an array indexed by a runtime st would live on the
// stack.  Time runs in tiles of kT steps: each thread copies its own
// channel's x and dt for the tile into shared memory (coalesced along
// the channel), the block copies the tile's B and C rows once (every
// channel reads them), then each thread steps through the tile.  The
// state update rounds each product (no FMA), as the plain version does,
// so the carried h follows the plain version's float operations; y is
// summed over n in order.  B and C are read through their strides (in
// the model they are slices of x_proj's output).  expf, not __expf: the
// build has no fast math.  A chunked parallel scan over time is a later
// step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kT = 32;
constexpr int kMaxState = 16;

template <typename T, int ST>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ bc, const T* __restrict__ cc,
    const float* __restrict__ a, T* __restrict__ y, int s, int di,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss) {
  __shared__ float s_x[kT * kThreads];
  __shared__ float s_dt[kT * kThreads];
  __shared__ float s_b[kT * ST];
  __shared__ float s_c[kT * ST];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const int b = blockIdx.y;
  const bool live = d < di;

  float h[ST], av[ST];
#pragma unroll
  for (int n = 0; n < ST; ++n) {
    h[n] = 0.f;
    av[n] = live ? a[(long long)d * ST + n] : 0.f;
  }
  const long long row = (long long)b * s * di + d;
  const T* bp = bc + b * b_sb;
  const T* cp = cc + b * c_sb;

  for (int t0 = 0; t0 < s; t0 += kT) {
    const int nt = min(kT, s - t0);
    if (live) {
#pragma unroll 8
      for (int i = 0; i < nt; ++i) {
        const long long off = row + (long long)(t0 + i) * di;
        s_x[i * kThreads + tid] = repro::to_float(x[off]);
        s_dt[i * kThreads + tid] = dt[off];
      }
    }
    for (int i = tid; i < nt * ST; i += kThreads) {
      const long long t = t0 + i / ST;
      const int n = i % ST;
      s_b[i] = repro::to_float(bp[t * b_ss + n]);
      s_c[i] = repro::to_float(cp[t * c_ss + n]);
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < nt; ++i) {
        const float dtv = s_dt[i * kThreads + tid];
        const float dbx = dtv * s_x[i * kThreads + tid];
        const float* bt = s_b + i * ST;
        const float* ct = s_c + i * ST;
        float yv = 0.f;
#pragma unroll
        for (int n = 0; n < ST; ++n) {
          // each product rounded, as the plain version rounds it: an FMA
          // here would part from it by up to an ulp of h a step, and
          // with |A|·dt near 0 those add up over the whole sequence
          h[n] = __fadd_rn(__fmul_rn(expf(dtv * av[n]), h[n]),
                           __fmul_rn(dbx, bt[n]));
          yv = fmaf(h[n], ct[n], yv);
        }
        y[row + (long long)(t0 + i) * di] = repro::from_float<T>(yv);
      }
    }
    __syncthreads();
  }
}

template <typename T, int ST>
int launch_st(const void* x, const void* dt, const void* bc, const void* cc,
              const void* a, void* y, int b, int s, int di, long long b_sb,
              long long b_ss, long long c_sb, long long c_ss,
              cudaStream_t stream) {
  const dim3 grid((unsigned)((di + kThreads - 1) / kThreads), (unsigned)b);
  ssm_scan_kernel<T, ST><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(bc), static_cast<const T*>(cc),
      static_cast<const float*>(a), static_cast<T*>(y), s, di, b_sb, b_ss,
      c_sb, c_ss);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_type(int st, const void* x, const void* dt, const void* bc,
                const void* cc, const void* a, void* y, int b, int s, int di,
                long long b_sb, long long b_ss, long long c_sb,
                long long c_ss, cudaStream_t stream) {
  switch (st) {
#define REPRO_SSM_CASE(ST)                                                   \
  case ST:                                                                   \
    return launch_st<T, ST>(x, dt, bc, cc, a, y, b, s, di, b_sb, b_ss, c_sb, \
                            c_ss, stream);
    REPRO_SSM_CASE(1) REPRO_SSM_CASE(2) REPRO_SSM_CASE(3) REPRO_SSM_CASE(4)
    REPRO_SSM_CASE(5) REPRO_SSM_CASE(6) REPRO_SSM_CASE(7) REPRO_SSM_CASE(8)
    REPRO_SSM_CASE(9) REPRO_SSM_CASE(10) REPRO_SSM_CASE(11)
    REPRO_SSM_CASE(12) REPRO_SSM_CASE(13) REPRO_SSM_CASE(14)
    REPRO_SSM_CASE(15) REPRO_SSM_CASE(16)
#undef REPRO_SSM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y [B, S, di] and dt [B, S, di] contiguous; B and C [B, S, st] with
// strides (sb, ss, 1); A [di, st] contiguous.  1 <= st <= 16.  dtype code
// (0 float32, 1 bfloat16) of x, B, C and y; dt and A are float32.
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* bc,
                              const void* cc, const void* a, void* y, int b,
                              int s, int di, int st, long long b_sb,
                              long long b_ss, long long c_sb, long long c_ss,
                              int dtype, void* stream) {
  if (st < 1 || st > kMaxState) return (int)cudaErrorInvalidValue;
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_type<float>(st, x, dt, bc, cc, a, y, b, s, di, b_sb, b_ss,
                              c_sb, c_ss, str);
  if (dtype == repro::kBFloat16)
    return launch_type<__nv_bfloat16>(st, x, dt, bc, cc, a, y, b, s, di,
                                      b_sb, b_ss, c_sb, c_ss, str);
  return (int)cudaErrorInvalidValue;
}
