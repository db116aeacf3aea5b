// Decode attention: one query token per head against a KV cache, with a
// runtime valid length; returns the unnormalized partials.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:72
//   decode_attention_pallas (pallas_call at :91).  The reference's
//   docstring (models/attention.py:13-15) routes decode through it; the
//   port's decode step (models/transformer.py::_decode_attn_block) does.
//
// What bounds it on the H100: device memory.  A step reads the cache's
// first kv_len keys and values once (2·kv_len·D elements per KV head)
// for 4·group·D flops per key: at most a few flops per byte.  At the
// serve shape (batch 8, 16 KV heads, D 64, bf16) and kv_len 640 that is
// 21 MB of a layer's cache: 0.0063 ms at 3.35 TB/s, below the ~5 µs of a
// launch, so a decode step is launch-bound.
//
// Design: one block of 128 threads per (KV head, batch row); the group's
// query rows (Hq / Hkv, any count, qwen's 1 included) are the M
// dimension.  The block loops over key tiles of 128 keys (64 where 128
// would not fit the card's shared memory: recurrentgemma-9b's group 16 ×
// D 256 takes 168,384 B at 64 and would take 303,808 B at 128; the
// wrapper picks, kernels/decode_attention/kernel.py::block_keys) of the
// cache up to kv_len only: tiles past it are skipped, not masked, and the last
// tile's keys past kv_len take no part (the reference masks them to
// -1e30, whose exp against the running max is exactly 0).  A tile's keys
// and values are staged once in shared memory as float32 (keys padded by
// one float a row, for conflict-free score reads); each thread computes
// scores of (query row, key) pairs, one warp per query row takes the
// tile's max and sum with shuffles and updates m and l, and each thread
// updates accumulator elements (query row, column).  m, l and acc stay
// in float32 in shared memory and are written unnormalized, as the
// reference's kernel does: combine_partials divides outside.
#include <cuda_runtime.h>

#include <cstdint>

#include "attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

using repro::kNegInf;

template <typename TQ, typename TKV, int kBK>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int hq, int group,
    int d, int kv_len, long long q_sb, long long q_sh, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, float scale) {
  extern __shared__ float smem[];
  float* s_q = smem;                     // [group][d]
  float* s_acc = s_q + group * d;        // [group][d]
  float* s_k = s_acc + group * d;        // [kBK][d + 1]
  float* s_v = s_k + kBK * (d + 1);      // [kBK][d]
  float* s_s = s_v + kBK * d;            // [group][kBK]
  float* s_m = s_s + group * kBK;        // [group]
  float* s_l = s_m + group;              // [group]
  float* s_alpha = s_l + group;          // [group]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = kvh * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const TKV* kp = k + b * k_sb + kvh * k_sh;
  const TKV* vp = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < group * d; i += kThreads) {
    const int g = i / d, c = i % d;
    s_q[i] = repro::to_float(q[b * q_sb + (h0 + g) * q_sh + c]);
    s_acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    s_m[g] = kNegInf;
    s_l[g] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += kBK) {
    const int nk = min(kBK, kv_len - k0);
    __syncthreads();  // the previous tile's reads; the first tile's s_q
    for (int i = tid; i < nk * d; i += kThreads) {
      const int r = i / d, c = i % d;
      s_k[r * (d + 1) + c] = repro::to_float(kp[(k0 + r) * k_ss + c]);
      s_v[r * d + c] = repro::to_float(vp[(k0 + r) * v_ss + c]);
    }
    __syncthreads();
    for (int i = tid; i < group * nk; i += kThreads) {
      const int g = i / nk, j = i % nk;
      const float* qr = s_q + g * d;
      const float* kr = s_k + j * (d + 1);
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr[c], s);
      s_s[g * kBK + j] = s * scale;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kWarps) {
      float* row = s_s + g * kBK;
      float mx = kNegInf;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
      mx = repro::group_max<32>(mx);
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, mx);
      float rs = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        rs += p;
      }
      rs = repro::group_sum<32>(rs);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + rs;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < group * d; i += kThreads) {
      const int g = i / d, c = i % d;
      const float* p = s_s + g * kBK;
      float a = s_acc[i] * s_alpha[g];
      for (int j = 0; j < nk; ++j) a = fmaf(p[j], s_v[j * d + c], a);
      s_acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < group * d; i += kThreads)
    acc_out[((long long)b * hq + h0) * d + i] = s_acc[i];
  for (int g = tid; g < group; g += kThreads) {
    m_out[(long long)b * hq + h0 + g] = s_m[g];
    l_out[(long long)b * hq + h0 + g] = s_l[g];
  }
}

template <int kBK>
int launch_bk(const void* q, const void* k, const void* v, void* acc,
              void* m, void* l, int b, int hq, int hkv, int d, int kv_len,
              long long q_sb, long long q_sh, long long k_sb, long long k_sh,
              long long k_ss, long long v_sb, long long v_sh, long long v_ss,
              float scale, int q_dtype, int kv_dtype, cudaStream_t st) {
  const int group = hq / hkv;
  // kernels/decode_attention/kernel.py::smem_bytes
  const int bytes =
      4 * (2 * group * d + kBK * (d + 1) + kBK * d + group * kBK + 3 * group);
  const dim3 grid((unsigned)hkv, (unsigned)b);
#define REPRO_DECODE_LAUNCH(TQ, TKV)                                         \
  do {                                                                       \
    auto kernel = decode_attention_kernel<TQ, TKV, kBK>;                     \
    cudaError_t err = cudaFuncSetAttribute(                                  \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);         \
    if (err != cudaSuccess) return (int)err;                                 \
    kernel<<<grid, kThreads, bytes, st>>>(                                   \
        static_cast<const TQ*>(q), static_cast<const TKV*>(k),               \
        static_cast<const TKV*>(v), static_cast<float*>(acc),                \
        static_cast<float*>(m), static_cast<float*>(l), hq, group, d,        \
        kv_len, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale);      \
    return (int)cudaGetLastError();                                          \
  } while (0)
  if (q_dtype == repro::kFloat32 && kv_dtype == repro::kFloat32)
    REPRO_DECODE_LAUNCH(float, float);
  if (q_dtype == repro::kFloat32 && kv_dtype == repro::kBFloat16)
    REPRO_DECODE_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == repro::kBFloat16 && kv_dtype == repro::kFloat32)
    REPRO_DECODE_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == repro::kBFloat16 && kv_dtype == repro::kBFloat16)
    REPRO_DECODE_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, D] with strides (q_sb, q_sh, 1); k and v [B, Hkv, S, D] with
// strides (sb, sh, ss, 1); outputs float32 contiguous acc [B, Hq, D],
// m and l [B, Hq].  1 <= kv_len <= S.  block_k (keys a staged tile) 64 or
// 128.  dtype codes: 0 float32, 1 bfloat16, for q and for the cache
// separately.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* acc, void* m,
    void* l, int b, int hq, int hkv, int d, int kv_len, int block_k,
    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, int q_dtype, int kv_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_k == 128)
    return launch_bk<128>(q, k, v, acc, m, l, b, hq, hkv, d, kv_len, q_sb,
                          q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,
                          q_dtype, kv_dtype, st);
  if (block_k == 64)
    return launch_bk<64>(q, k, v, acc, m, l, b, hq, hkv, d, kv_len, q_sb,
                         q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,
                         q_dtype, kv_dtype, st);
  return (int)cudaErrorInvalidValue;
}
