// Blockwise (flash) attention forward: causal or sliding-window masking,
// grouped KV heads, float32 or bfloat16 in, q's type out.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:104
//   flash_attention_pallas (pallas_call at :123), called from
//   models/attention.py:99 for prefill.
//
// What bounds it on the H100: operations.  Causal attention at the
// prefill shape [8, 16, 2048, 64] does 4·D multiply-adds per visible
// (query, key) pair, 68.7 GFLOP, against 134 MB of q, k, v and output
// in bf16: 0.069 ms at the 989 TFLOP/s bf16 tensor-core peak, 0.040 ms
// at 3.35 TB/s.  recurrentgemma-9b's prefill, q [8, 16, 2048, 256] against
// one KV head (MQA) in window 2,048, does 275 GFLOP: 0.278 ms at the
// same peak.  This kernel is the simple one: its products are float32
// FMAs on the CUDA cores (67 TFLOP/s peak), so it sits well above that
// bound; tensor cores (mma/wgmma) are the next step.
//
// Design: one block per (q-tile of 64 rows, query head, batch row), of
// 128 threads for D <= 128 and 256 threads for D = 256.  The q-tile is
// staged once in shared memory as float32; the block loops over 64-key
// tiles of its KV head (h / group), each staged as float32 (k with one
// float of padding per row, so the score reads hit distinct banks).
// Thread t owns R rows R·(t/8) .. +R-1 and keys (t%8) + 8j of the score
// tile, and columns (t%8) + 8c of the output rows: the eight threads of
// a row are neighbouring lanes, whose shuffles give the row's max and
// sum.  R is 4 up to D = 128 and 2 at D = 256, where a thread's R × D/8
// accumulators would otherwise take 128 registers and spill (213,760 B
// of shared memory at D = 256).  The running max m, the
// denominator l and the accumulator stay in registers in float32
// (the online-softmax recurrence of the reference kernel's :84-95).
// A k-tile that no row of the q-tile can see (above the causal
// diagonal, or below the window) is not visited, as the reference's
// pl.when does (:51-60).  Masked scores take the finite -1e30 and
// contribute p = 0 explicitly, so a row with no visible key so far keeps
// l = 0 and acc = 0 (and outputs 0 if it never sees one); any shape is
// taken, the ragged q and k tails masked, with no padding of the inputs.
#include <cuda_runtime.h>

#include <cstdint>

#include "attention.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;

// rows of the q-tile a thread owns, and the block's threads (eight a row
// group), for head dims up to DB
template <int DB>
struct Tile {
  static constexpr int kRows = DB > 128 ? 2 : 4;
  static constexpr int kThreads = 8 * kBQ / kRows;
};

using repro::kNegInf;

struct View {
  long long b, h, s;  // element strides; the last dim is contiguous
};

template <int DB>
constexpr int smem_floats() {
  return kBQ * (DB + 1) + kBK * (DB + 1) + kBK * DB + kBQ * (kBK + 1);
}

template <typename T, int DB>
__global__ void __launch_bounds__(Tile<DB>::kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int hq, int group, int sq, int skv, int d,
                           View qs, View ks, View vs, float scale,
                           int causal, int window) {
  extern __shared__ float smem[];
  float* s_q = smem;                    // [kBQ][DB + 1]
  float* s_k = s_q + kBQ * (DB + 1);    // [kBK][DB + 1]
  float* s_v = s_k + kBK * (DB + 1);    // [kBK][DB]
  float* s_p = s_v + kBK * DB;          // [kBQ][kBK + 1]
  constexpr int kCols = DB / 8;
  constexpr int kRows = Tile<DB>::kRows;
  constexpr int kThreads = Tile<DB>::kThreads;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows kRows·rg .. kRows·rg + kRows - 1
  const int cg = tid & 7;   // keys cg + 8j, output columns cg + 8c
  const int offs = causal ? skv - sq : 0;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + (h / group) * ks.h;
  const T* vp = v + b * vs.b + (h / group) * vs.h;

  for (int i = tid; i < kBQ * DB; i += kThreads) {
    const int r = i / DB, c = i % DB;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = repro::to_float(qp[(q0 + r) * qs.s + c]);
    s_q[r * (DB + 1) + c] = x;
  }

  // the k-tiles some row of this q-tile can see; rows at absolute
  // positions [q_lo, q_hi]
  const int q_lo = q0 + offs;
  const int q_hi = min(q0 + kBQ, sq) - 1 + offs;
  int kb_begin = 0;
  int kb_end = (skv + kBK - 1) / kBK;
  if (causal) kb_end = q_hi < 0 ? 0 : min(kb_end, q_hi / kBK + 1);
  if (window > 0 && q_lo - window + 1 > 0)
    kb_begin = (q_lo - window + 1) / kBK;

  float m_i[kRows], l_i[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's reads of s_k, s_v, s_p
    for (int i = tid; i < kBK * DB; i += kThreads) {
      const int r = i / DB, c = i % DB;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < skv && c < d) {
        kx = repro::to_float(kp[(k0 + r) * ks.s + c]);
        vx = repro::to_float(vp[(k0 + r) * vs.s + c]);
      }
      s_k[r * (DB + 1) + c] = kx;
      s_v[r * DB + c] = vx;
    }
    __syncthreads();

    float s[kRows][8];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int c = 0; c < DB; ++c) {
      float qv[kRows], kv[8];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = s_q[(kRows * rg + i) * (DB + 1) + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = s_k[(cg + 8 * j) * (DB + 1) + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qa = q0 + kRows * rg + i + offs;
      unsigned visible = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ka = k0 + cg + 8 * j;
        bool vis = ka < skv;
        if (causal) vis = vis && ka <= qa;
        if (window > 0) vis = vis && ka > qa - window;
        s[i][j] = vis ? s[i][j] * scale : kNegInf;
        visible |= (unsigned)vis << j;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = repro::group_max<8>(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (visible >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        s_p[(kRows * rg + i) * (kBK + 1) + cg + 8 * j] = p;
      }
      rs = repro::group_sum<8>(rs);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = s_p[(kRows * rg + i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = s_v[j * DB + cg + 8 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + kRows * rg + i;
    if (row >= sq) continue;
    // a row that saw no key has l = 0 and acc = 0: it outputs 0
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];
    T* o = out + (((long long)b * hq + h) * sq + row) * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = cg + 8 * c;
      if (col < d) o[col] = repro::from_float<T>(acc[i][c] / l);
    }
  }
}

template <typename T, int DB>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, int d, View qs, View ks,
           View vs, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<DB>() * 4;
  auto kernel = flash_attention_kernel<T, DB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)hq,
                  (unsigned)b);
  kernel<<<grid, Tile<DB>::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hq / hkv, sq, skv,
      d, qs, ks, vs, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             int hq, int hkv, int sq, int skv, int d, View qs, View ks,
             View vs, float scale, int causal, int window,
             cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, out, b, hq, hkv, sq, skv, d, qs, ks, vs,
                         scale, causal, window, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, b, hq, hkv, sq, skv, d, qs, ks, vs,
                         scale, causal, window, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, out, b, hq, hkv, sq, skv, d, qs, ks, vs,
                          scale, causal, window, stream);
  if (d <= 256)
    return launch<T, 256>(q, k, v, out, b, hq, hkv, sq, skv, d, qs, ks, vs,
                          scale, causal, window, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D] with the given element
// strides of their first three dims (the last is contiguous); out
// contiguous [B, Hq, Sq, D] of q's type.  dtype: 0 float32, 1 bfloat16.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int b, int hq,
    int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int window, int dtype, void* stream) {
  const View qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_d<float>(q, k, v, out, b, hq, hkv, sq, skv, d, qs, ks, vs,
                           scale, causal, window, st);
  if (dtype == repro::kBFloat16)
    return launch_d<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, skv, d, qs,
                                   ks, vs, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
