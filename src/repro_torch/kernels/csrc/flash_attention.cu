// Blockwise (flash) attention forward: causal or sliding-window masking,
// grouped KV heads, float32 or bfloat16 in, q's type out.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:104
//   flash_attention_pallas (pallas_call at :123), called from
//   models/attention.py:99 for prefill.
//
// What bounds it on the H100: operations.  Causal attention at qwen1.5-
// 0.5b's prefill shape [8, 16, 2048, 64] does 4·D flops per visible
// (query, key) pair, 68.7 GFLOP, against 134 MB of q, k, v and output in
// bf16: 0.069 ms at the 989 TFLOP/s bf16 tensor-core peak, 0.040 ms at
// 3.35 TB/s.  recurrentgemma-9b's prefill, q [8, 16, 2048, 256] against
// one KV head (MQA) in window 2,048, does 275 GFLOP: 0.278 ms at the same
// peak.  Only the tensor cores come near that: the CUDA cores' float32
// peak is 67 TFLOP/s, 4.1 ms for the 275 GFLOP.
//
// bfloat16 (flash_attention_mma_kernel): both products on the tensor
// cores, mma.sync.m16n8k16 with float32 accumulators in registers (the
// FlashAttention-2 layout; wgmma, the only way to the full rate, is the
// next step).  One block of 4 warps per (query head, batch row, q-tile
// of 64 rows), 16 rows a warp; at D = 256 two blocks share an SM (96 KB
// of shared memory, 255 registers a thread).  The q-tile is copied once
// into shared memory in bf16 (its MMA fragments then held in registers
// up to D = 128, read again each tile at D = 256, where registers are
// full); K and V tiles of 64 keys (32 at D = 256) stream through a
// two-stage ring in bf16 with cp.async in 16-byte pieces, the next tile
// in flight while the block computes on this one, one barrier a tile.
// Every tile row is 16-byte chunks XORed with the row (chunk c of row r
// at c ^ (r & 7), or ^ ((r >> 1) & 3) for 4-chunk rows), so the ldmatrix
// reads of eight rows hit eight distinct bank groups.  D is padded to
// the bucket (32, 64, 128, 256) with zeros in shared memory, never in
// the caller's tensors; shapes whose rows are not 16-byte aligned (D %
// 8, strides, pointers) are staged element by element into the same
// layout.  S = QKᵀ comes out in the accumulator layout: each thread
// holds two rows' values, so the online softmax takes row max and row
// sum over the four lanes of a quad with two shuffles, in the base-2
// domain (p = 2^(s·scale·log2 e − m), one FMA and one ex2.approx), and
// only tiles on the causal diagonal, past Skv or on the window's lower
// edge apply the elementwise mask; interior tiles skip it, tiles no row
// of the block can see are not visited (the reference's pl.when,
// :51-60), and once a warp's row maxima settle (every rescale factor 1)
// the rescale of the accumulators is skipped.  Masked scores take the
// finite -1e30 and p = 0 explicitly, so a row that sees no key keeps l =
// 0 and acc = 0 and outputs 0.  P is fed to the PV product as two bf16
// halves, P_hi = bf16(P) and P_lo = bf16(P - P_hi), both into the same
// float32 accumulator: one rounding of P to bf16 (2^-9 of each weight)
// would part from the plain version's float32 P by more than the bf16
// output tolerance where the weighted sum cancels near 0; the two halves
// leave ~2^-17.  That is 1.5 times the function's tensor-core work; the
// bound above counts the function's.  Blocks run the heaviest causal
// q-tiles first (gridDim.z reversed), so the short ones fill the tail.
//
// float32 (flash_attention_kernel) stays on the CUDA cores: TF32 keeps 10
// bits of mantissa and would break the float32 limit (2e-5 + 1e-4
// relative), and no timed path runs attention in float32 (it serves the
// float32 checks of prefill, serving and the ring).  One block per
// (q-tile of 64 rows, query head, batch row), of 128 threads for
// D <= 128 and 256 threads for D = 256.  The q-tile is staged once in
// shared memory as float32; the block loops over 64-key tiles of its KV
// head (h / group), each staged as float32 (k with one float of padding
// per row, so the score reads hit distinct banks).  Thread t owns R rows
// R·(t/8) .. +R-1 and keys (t%8) + 8j of the score tile, and columns
// (t%8) + 8c of the output rows: the eight threads of a row are
// neighbouring lanes, whose shuffles give the row's max and sum.  R is 4
// up to D = 128 and 2 at D = 256, where a thread's R × D/8 accumulators
// would otherwise take 128 registers and spill (213,760 B of shared
// memory at D = 256).  The running max m, the denominator l and the
// accumulator stay in registers in float32 (the online-softmax
// recurrence of the reference kernel's :84-95), with the same tile
// skipping and -1e30 rule as above; any shape is taken, the ragged q and
// k tails masked, with no padding of the inputs.
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

// ---- bfloat16: tensor cores (mma.sync) and a cp.async ring ----

using bf16 = __nv_bfloat16;

// warps (16 query rows each), keys a K/V tile, and whether the q-tile's
// MMA fragments stay in registers, for head dims up to DB
template <int DB>
struct Mma {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kBK = DB > 128 ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr bool kQRegs = DB <= 128;
  static constexpr int kQBytes = kBQ * DB * 2;
  static constexpr int kTileBytes = kBK * DB * 2;  // one K or V tile
  // the q-tile, then the ring's stages of (K tile, V tile)
  static constexpr int kSmem = kQBytes + kStages * 2 * kTileBytes;
};

// byte offset of 16-byte chunk c of row r in a [rows][DB] bf16 tile
template <int DB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kChunks = DB / 8;
  const int x = kChunks >= 8 ? (r & 7) : ((r >> 1) & 3);
  return (uint32_t)(r * (DB * 2) + ((c ^ x) << 4));
}

// rows [row0, row0 + ROWS) of a [nrows, d] bf16 matrix with row stride
// `stride` into a swizzled tile, zero past nrows and d: cp.async 16-byte
// pieces when every row is 16-byte aligned, else element by element
template <int DB, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const bf16* __restrict__ src,
                                          long long stride, int row0,
                                          int nrows, int d, bool vec,
                                          int tid) {
  constexpr int kChunks = DB / 8;
  if (vec) {
    const uint32_t base = repro::smem_addr(tile);
    for (int i = tid; i < ROWS * kChunks; i += THREADS) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = row0 + r < nrows && c * 8 < d;
      const bf16* g = ok ? src + (row0 + r) * stride + c * 8 : src;
      repro::cp_async16(base + swz<DB>(r, c), g, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DB; i += THREADS) {
      const int r = i / DB, col = i % DB;
      bf16 x = __float2bfloat16_rn(0.f);
      if (row0 + r < nrows && col < d) x = src[(row0 + r) * stride + col];
      *reinterpret_cast<bf16*>(tile + swz<DB>(r, col / 8) + (col % 8) * 2) =
          x;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a·b: a 16×16 (row), b 16×8 (col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU.EX2 (relative error ~2^-22; results below 2^-126 flush
// to 0, weights far below what a float32 sum of ones can see)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as bf16 pairs hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

template <int DB>
__global__ void __launch_bounds__(Mma<DB>::kThreads)
    flash_attention_mma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ out, int hq, int group,
                               int sq, int skv, int d, View qs, View ks,
                               View vs, float scale_log2, int causal,
                               int window, int vec) {
  using C = Mma<DB>;
  constexpr int kBK = C::kBK;
  constexpr int kNT = kBK / 8;  // score n-tiles of 8 keys
  constexpr int kDT = DB / 8;   // output n-tiles of 8 columns
  // (its own name: the float32 kernel's extern array is float)
  extern __shared__ __align__(128) unsigned char smem_bf16[];
  unsigned char* s_q = smem_bf16;
  unsigned char* s_kv = smem_bf16 + C::kQBytes;  // stage s: K, then V

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::kBQ;  // heaviest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int offs = causal ? skv - sq : 0;
  const bf16* qp = q + b * qs.b + h * qs.h;
  const bf16* kp = k + b * ks.b + (h / group) * ks.h;
  const bf16* vp = v + b * vs.b + (h / group) * vs.h;

  // the k-tiles some row of this q-tile can see; rows at absolute
  // positions [q_lo, q_hi]
  const int q_lo = q0 + offs;
  const int q_hi = min(q0 + C::kBQ, sq) - 1 + offs;
  int kb_begin = 0;
  int kb_end = (skv + kBK - 1) / kBK;
  if (causal) kb_end = q_hi < 0 ? 0 : min(kb_end, q_hi / kBK + 1);
  if (window > 0 && q_lo - window + 1 > 0)
    kb_begin = (q_lo - window + 1) / kBK;
  const int n_kb = max(0, kb_end - kb_begin);
  // this warp's rows, for the choice of tiles that need the mask
  const int w_row = q0 + 16 * warp;
  const int w_lo = w_row + offs;
  const int w_hi = min(w_row + 15, sq - 1) + offs;

  // K and V tile `it` of this block into its stage of the ring
  const auto load_kv = [&](int it) {
    unsigned char* st = s_kv + (it % C::kStages) * 2 * C::kTileBytes;
    const int k0 = (kb_begin + it) * kBK;
    load_tile<DB, kBK, C::kThreads>(st, kp, ks.s, k0, skv, d, vec, tid);
    load_tile<DB, kBK, C::kThreads>(st + C::kTileBytes, vp, vs.s, k0, skv, d,
                                    vec, tid);
  };
  load_tile<DB, C::kBQ, C::kThreads>(s_q, qp, qs.s, q0, sq, d, vec, tid);
  repro::cp_async_commit();
  // one commit group a tile, the first kStages - 1 tiles ahead
#pragma unroll
  for (int it = 0; it < C::kStages - 1; ++it) {
    if (it < n_kb) load_kv(it);
    repro::cp_async_commit();
  }

  // lane's ldmatrix row within an 8x8 matrix, and which of the four
  const int lr = lane & 7, lm = lane >> 3;
  const uint32_t q_base = repro::smem_addr(s_q);
  uint32_t qf[C::kQRegs ? DB / 16 : 1][4];
  repro::cp_async_wait<C::kStages - 1>();  // the q-tile
  __syncthreads();
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < DB / 16; ++kk)
      ldmatrix_x4(qf[kk], q_base + swz<DB>(16 * warp + lr + (lm & 1) * 8,
                                           2 * kk + (lm >> 1)));
  }

  float o[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};
  // absolute positions of the thread's two rows
  const int qa0 = w_row + (lane >> 2) + offs;

  for (int it = 0; it < n_kb; ++it) {
    const int k0 = (kb_begin + it) * kBK;
    repro::cp_async_wait<C::kStages - 2>();  // this tile
    // one barrier a tile: this tile is in every thread's view, and every
    // warp is done with tile it - 1, whose stage the next load fills
    __syncthreads();
    if (it + C::kStages - 1 < n_kb) load_kv(it + C::kStages - 1);
    repro::cp_async_commit();
    const uint32_t k_base = repro::smem_addr(
        s_kv + (it % C::kStages) * 2 * C::kTileBytes);
    const uint32_t v_base = k_base + C::kTileBytes;

    // S = Q Kᵀ: kNT n-tiles of 16 rows × 8 keys
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DB / 16; ++kk) {
      uint32_t a[4];
      if constexpr (C::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, q_base + swz<DB>(16 * warp + lr + (lm & 1) * 8,
                                        2 * kk + (lm >> 1)));
      }
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_base + swz<DB>(16 * n2 + lr + (lm >> 1) * 8,
                                         2 * kk + (lm & 1)));
        mma_bf16(s[2 * n2], a, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }

    // mask only where some pair of this warp's rows and the tile's keys
    // is invisible: past Skv, on the causal diagonal, on the window edge
    // (a masked score is exactly -1e30 and takes p = 0 below)
    bool need = k0 + kBK > skv;
    if (causal) need = need || k0 + kBK - 1 > w_lo;
    if (window > 0) need = need || k0 <= w_hi - window;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if (need) {
          const int ka = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
          const int qa = qa0 + (e >> 1) * 8;
          bool ok = ka < skv;
          if (causal) ok = ok && ka <= qa;
          if (window > 0) ok = ok && ka > qa - window;
          if (!ok) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // the running max m_i is kept in the base-2 domain (raw max times
    // scale·log2 e, the scale positive), -1e30 while a row has seen no
    // key; p = 2^(s·scale·log2 e − m) in one FMA and one ex2
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = repro::group_max<4>(mx[i]);
      const float m_new =
          fmaxf(m_i[i], mx[i] == kNegInf ? kNegInf : mx[i] * scale_log2);
      alpha[i] = ex2(m_i[i] - m_new);
      m_i[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            need && s[n][e] == kNegInf
                ? 0.f
                : ex2(fmaf(s[n][e], scale_log2, -m_i[e >> 1]));
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    // l stays a per-lane share of the row's sum; the quad adds it up at
    // the end
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + rs[i];
    // once the rows' maxima settle, alpha is 1 and the rescale (exact
    // then) is skipped for the warp
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // O += P V, P as bf16 P_hi + P_lo: the score accumulators of n-tiles
    // 2j and 2j+1 are the A fragment of keys 16j .. 16j + 15
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n2 = 0; n2 < kDT / 2; ++n2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_base + swz<DB>(16 * j + lr + (lm & 1) * 8,
                                               2 * n2 + (lm >> 1)));
        mma_bf16(o[2 * n2], ph, bv[0], bv[1]);
        mma_bf16(o[2 * n2], pl, bv[0], bv[1]);
        mma_bf16(o[2 * n2 + 1], ph, bv[2], bv[3]);
        mma_bf16(o[2 * n2 + 1], pl, bv[2], bv[3]);
      }
    }
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_row = repro::group_sum<4>(l_i[i]);
    const int row = w_row + (lane >> 2) + 8 * i;
    if (row >= sq) continue;
    // a row that saw no key has l = 0 and acc = 0: it outputs 0
    const float l = l_row == 0.f ? 1.f : l_row;
    bf16* orow = out + (((long long)b * hq + h) * sq + row) * d;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int col = 8 * n + 2 * (lane & 3);
      const float x0 = o[n][2 * i] / l, x1 = o[n][2 * i + 1] / l;
      if (vec) {
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// true when every row of q, k, v starts on 16 bytes: cp.async can copy
// them in 16-byte pieces
inline bool rows_aligned(const void* q, const void* k, const void* v, int d,
                         View qs, View ks, View vs) {
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const auto st = [](View s) {
    return s.b % 8 == 0 && s.h % 8 == 0 && s.s % 8 == 0;
  };
  return d % 8 == 0 && al(q) && al(k) && al(v) && st(qs) && st(ks) &&
         st(vs);
}

template <int DB>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int b, int hq, int hkv, int sq, int skv, int d, View qs,
               View ks, View vs, float scale, int causal, int window,
               cudaStream_t stream) {
  using C = Mma<DB>;
  auto kernel = flash_attention_mma_kernel<DB>;
  static bool smem_set = false;  // once an instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int q_tiles = (sq + C::kBQ - 1) / C::kBQ;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)hq, (unsigned)b, (unsigned)q_tiles);
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), hq, hq / hkv, sq,
      skv, d, qs, ks, vs, scale * log2e, causal, window,
      (int)rows_aligned(q, k, v, d, qs, ks, vs));
  return (int)cudaGetLastError();
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

// float32 on the CUDA cores, bfloat16 on the tensor cores
template <int DB>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* out, int b, int hq, int hkv, int sq, int skv, int d,
                 View qs, View ks, View vs, float scale, int causal,
                 int window, cudaStream_t stream) {
  if (dtype == repro::kFloat32)
    return launch<float, DB>(q, k, v, out, b, hq, hkv, sq, skv, d, qs, ks,
                             vs, scale, causal, window, stream);
  if (dtype == repro::kBFloat16)
    return launch_mma<DB>(q, k, v, out, b, hq, hkv, sq, skv, d, qs, ks, vs,
                          scale, causal, window, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D] with the given element
// strides of their first three dims (the last is contiguous); out
// contiguous [B, Hq, Sq, D] of q's type.  dtype: 0 float32, 1 bfloat16.
// D runs in the bucket of 32, 64, 128 or 256 that holds it.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int b, int hq,
    int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int window, int dtype, void* stream) {
  const View qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_dtype<32>(dtype, q, k, v, out, b, hq, hkv, sq, skv, d, qs,
                            ks, vs, scale, causal, window, st);
  if (d <= 64)
    return launch_dtype<64>(dtype, q, k, v, out, b, hq, hkv, sq, skv, d, qs,
                            ks, vs, scale, causal, window, st);
  if (d <= 128)
    return launch_dtype<128>(dtype, q, k, v, out, b, hq, hkv, sq, skv, d, qs,
                             ks, vs, scale, causal, window, st);
  if (d <= 256)
    return launch_dtype<256>(dtype, q, k, v, out, b, hq, hkv, sq, skv, d, qs,
                             ks, vs, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
