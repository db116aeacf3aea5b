// Decode attention: one query token per head against a KV cache, with a
// runtime valid length; returns the unnormalized partials (acc, m, l), or
// acc / l in q's type.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:72
//   decode_attention_pallas (pallas_call at :91).  The reference's
//   docstring (models/attention.py:13-15) routes decode through it; the
//   port's decode step (models/transformer.py::_decode_attn_block) does.
//
// What bounds it on the H100: device memory, with the CUDA cores close
// behind where a group is large.  A step reads the cache's first kv_len
// keys and values once (2·kv_len·D elements per KV head) for 4·group·D
// flops per key.  qwen1.5-0.5b (batch 8, 16 KV heads, group 1, D 64,
// bf16) at kv_len 640 reads 21 MB: 0.0063 ms at 3.35 TB/s.
// recurrentgemma-9b (batch 8, one KV head, group 16, D 256) at kv_len
// 2,048 reads 16.8 MB, 0.0050 ms, for 268 MFLOP, 0.0040 ms at the 67
// TFLOP/s float32 peak.  The work is too small for the tensor cores to
// matter, and they would round P; scores, max, exp and the accumulator
// stay in float32 on the CUDA cores.
//
// Design (flash-decoding): the keys below kv_len are cut into splits of
// `chunk` keys, one block per (split, KV head, batch row), each taking one
// contiguous range and writing float32 partials (acc, m, l) of it; then
// decode_attention_fold_kernel folds the splits in split order (M = max
// m_i, acc = Σ acc_i·e^{m_i−M}, l = Σ l_i·e^{m_i−M}; no atomics), one
// block a (row, head), on the same stream.  One split writes the result
// directly (acc / l in q's type, or the partials) and launches no fold.
// kernels/decode_attention/kernel.py::split_plan picks the count: about
// two waves of 132 SMs where a group of query rows shares each key (the
// arithmetic wants the warps: recurrentgemma-9b's 8 (KV head, row) pairs
// become 256 blocks of 64 keys at kv_len 2,048), one wave where each KV
// head has one row (bytes-bound: qwen1.5-0.5b's 128 pairs already fill
// the card, and a fold would only add a launch and its round trip).
//
// Inside a block the threads form teams of D/8 lanes (D padded to the
// bucket 32, 64, 128 or 256), lane c owning columns 8c .. 8c+7: a team
// holds KG query rows in float32 registers with their accumulators, and
// takes batches of D/(8·KG) keys: each lane forms the partial dot
// products of its KG rows with its 8 columns of each key, and one
// transposing butterfly over the team (D/8 − 1 shuffles for D/8 sums)
// leaves each lane one whole score.  The online softmax updates m and l
// per batch; p and the rescale factor reach the team through shared
// memory, and each lane adds p·v for its columns.  Teams of the same rows
// take alternate batches, each with its own (m, l, acc), folded in
// shared memory at the end of the block in team order.  Masked keys get
// -1e30 and p = 0 explicitly, as in the reference.  Two ways in:
// * one query row a KV head (KG = 1, bf16 up to D = 64, float32 up to
//   32): no key is shared between teams, so 12 warps load each batch's
//   keys and values straight into registers with 16-byte loads, the next
//   round's in flight while this one computes (qwen1.5-0.5b: 48 teams of
//   8 lanes on 640 keys);
// * a group (KG = 4): every team needs every key, so K and V tiles of
//   8 KB stream through a four-stage cp.async ring in the cache's own
//   type, three in flight while 4 warps compute on one, one barrier a
//   tile (recurrentgemma-9b: 4 teams of 32 lanes, 4 of the 16 rows each).
// Rows past the range are zero-filled, and caches whose rows are not
// 16-byte aligned are read element by element into the same layout.
#include <cuda_runtime.h>

#include <cstdint>

#include "attention.cuh"

namespace {

using repro::kNegInf;

// splits the fold takes (kernels/decode_attention/kernel.py::split_plan
// gives at most 2 · 132)
constexpr int kMaxSplits = 1024;
using bf16 = __nv_bfloat16;

// stages of the K/V ring, and the keys of a staged K or V tile: 8 KB of
// the cache's type, at most 64; four stages keep three tiles (48 KB) of
// each block in flight while it computes on one
constexpr int kStages = 4;
template <typename TKV, int DB>
constexpr int tile_keys() {
  constexpr int t = 8192 / (DB * (int)sizeof(TKV));
  return t > 64 ? 64 : t;
}

template <typename TKV, int DB, int KG>
struct Plan {
  // KG = 1: one query row, no key shared between teams: keys and values
  // go straight to registers, 12 warps; KG = 4: four rows a team, K and
  // V tiles through the shared ring, 4 warps
  static constexpr bool kDirect = KG == 1;
  static constexpr int kThreads = kDirect ? 384 : 128;
  static constexpr int kLanes = DB / 8;  // a team: one 8-column piece each
  static constexpr int kTeams = kThreads / kLanes;
  static constexpr int kKB = kLanes / KG;  // keys a team scores a batch
  // levels of the butterfly over the team: log2(kLanes)
  static constexpr int kLevels = kLanes == 32   ? 5
                                 : kLanes == 16 ? 4
                                 : kLanes == 8  ? 3
                                                : 2;
  static constexpr int kT = tile_keys<TKV, DB>();
  static constexpr int kTileBytes = kT * DB * (int)sizeof(TKV);
  static constexpr int kRing = kDirect ? 0 : kStages * 2 * kTileBytes;
  // end of block: m, l, the fold's weight and acc of every team's rows,
  // and each row's max and sum
  static constexpr int kFold = 4 * kTeams * KG * (DB + 5);
  static constexpr int kMain = kRing > kFold ? kRing : kFold;
  // p of each team's batch, and its rows' rescale factors
  static constexpr int kSmem = kMain + 4 * kTeams * (kLanes + KG);
};

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 8 columns c0 .. c0+7 of one cache row, as loaded into registers (zero
// past d, or where the row is not taken)
template <typename TKV>
struct Piece;

template <>
struct Piece<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* row, int c0, int d,
                                       bool in, bool vec) {
    if (vec) {
      u = in && c0 < d ? __ldg(reinterpret_cast<const uint4*>(row + c0))
                       : make_uint4(0u, 0u, 0u, 0u);
      return;
    }
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + 2 * i;
      const uint32_t lo = in && c < d ? __bfloat16_as_ushort(row[c]) : 0u;
      const uint32_t hi =
          in && c + 1 < d ? __bfloat16_as_ushort(row[c + 1]) : 0u;
      w[i] = lo | hi << 16;
    }
    u = make_uint4(w[0], w[1], w[2], w[3]);
  }
  // a bf16 is the top half of its float32
  __device__ __forceinline__ void get(float (&x)[8]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Piece<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* row, int c0, int d,
                                       bool in, bool vec) {
    if (vec) {
      const bool ok = in && c0 < d;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      a = ok ? __ldg(reinterpret_cast<const float4*>(row + c0)) : z;
      b = ok ? __ldg(reinterpret_cast<const float4*>(row + c0 + 4)) : z;
      return;
    }
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = in && c0 + e < d ? row[c0 + e] : 0.f;
    a = make_float4(x[0], x[1], x[2], x[3]);
    b = make_float4(x[4], x[5], x[6], x[7]);
  }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  }
};

// keys [k0, k0 + kT) of one KV head's cache rows (stride ss), those at or
// past k_end zero, into a [kT][DB] tile of the cache's type
template <typename TKV, int DB, int kT, int kThreads>
__device__ __forceinline__ void load_tile(TKV* tile,
                                          const TKV* __restrict__ src,
                                          long long ss, int k0, int k_end,
                                          int d, bool vec, int tid) {
  constexpr int kPer = 16 / (int)sizeof(TKV);  // elements a 16-byte piece
  constexpr int kPieces = DB / kPer;
  if (vec) {
    const uint32_t base = repro::smem_addr(tile);
    for (int i = tid; i < kT * kPieces; i += kThreads) {
      const int r = i / kPieces, c = i % kPieces;
      const bool ok = k0 + r < k_end && c * kPer < d;
      const TKV* g = ok ? src + (k0 + r) * ss + c * kPer : src;
      repro::cp_async16(base + 16 * i, g, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kT * DB; i += kThreads) {
      const int r = i / DB, c = i % DB;
      tile[i] = k0 + r < k_end && c < d ? src[(k0 + r) * ss + c]
                                        : repro::from_float<TKV>(0.f);
    }
  }
}

template <typename TKV, int DB, int KG>
__global__ void __launch_bounds__(Plan<TKV, DB, KG>::kThreads, 1)
    decode_attention_kernel(
    const void* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    void* __restrict__ out, int q_dtype, int hq, int group, int d,
    int kv_len, int chunk, long long q_sb, long long q_sh, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, float scale, int vec) {
  using P = Plan<TKV, DB, KG>;
  constexpr int kLanes = P::kLanes, kKB = P::kKB, kT = P::kT;
  constexpr int kThreads = P::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_p = reinterpret_cast<float*>(smem + P::kMain);  // [team][lane]
  float* s_a = s_p + P::kTeams * kLanes;                    // [team][KG]

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int k_begin = split * chunk;
  const int k_end = min(kv_len, k_begin + chunk);
  const int tid = threadIdx.x;
  const int team = tid / kLanes, lane = tid % kLanes;
  // teams share out the group's rows KG at a time; teams of the same rows
  // take alternate batches of keys
  const int n_sets = (group + KG - 1) / KG;
  const int n_slices = P::kTeams / n_sets;
  const int set = team % n_sets, slice = team / n_sets;
  const bool active = slice < n_slices;
  const int h0 = kvh * group;

  // q rows set·KG .. +KG-1, columns 8·lane .. +7, in float32
  float qr[KG][8];
#pragma unroll
  for (int gi = 0; gi < KG; ++gi) {
    const int g = set * KG + gi;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = 8 * lane + e;
      float x = 0.f;
      if (g < group && c < d) {
        const long long at = b * q_sb + (h0 + g) * q_sh + c;
        x = q_dtype == repro::kFloat32
                ? static_cast<const float*>(q)[at]
                : __bfloat162float(static_cast<const bf16*>(q)[at]);
      }
      qr[gi][e] = x;
    }
  }

  float acc[KG][8];
#pragma unroll
  for (int gi = 0; gi < KG; ++gi)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[gi][e] = 0.f;
  // m and this lane's share of l, of the row whose score the lane holds
  // after a batch's butterfly (row lane / kKB)
  float m_r = kNegInf, l_r = 0.f;

  const TKV* kp = k + b * k_sb + kvh * k_sh;
  const TKV* vp = v + b * v_sb + kvh * v_sh;

  // one batch of the team: kKB keys, the first n_valid of them real; kfn
  // and vfn give the lane's 8 columns of key or value kk in float32
  const auto batch = [&](auto&& kfn, auto&& vfn, int n_valid) {
    // partial dot products of the team's KG rows with kKB keys
    float part[kLanes];
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk) {
      float kx[8];
      kfn(kk, kx);
#pragma unroll
      for (int gi = 0; gi < KG; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qr[gi][e], kx[e], s);
        part[gi * kKB + kk] = s;
      }
    }
    // transposing butterfly: after it, lane i holds the whole sum of
    // value i, row i / kKB with key i % kKB
#pragma unroll
    for (int lv = 0; lv < P::kLevels; ++lv) {
      const int o = kLanes >> (lv + 1);
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < kLanes / 2; ++i) {
        if (i < o) {
          const float send = up ? part[i] : part[i + o];
          const float keep = up ? part[i + o] : part[i];
          part[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
    }
    const int kk = lane % kKB;
    const bool ok = kk < n_valid;
    const float s = ok ? part[0] * scale : kNegInf;
    const float m_new = fmaxf(m_r, repro::group_max<kKB>(s));
    const float alpha = expf(m_r - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    l_r = l_r * alpha + p;
    m_r = m_new;
    s_p[team * kLanes + lane] = p;
    if (kk == 0) s_a[team * KG + lane / kKB] = alpha;
    __syncwarp();
    // acc of each row: rescale, then add p·v over the batch's keys
#pragma unroll
    for (int gi = 0; gi < KG; ++gi) {
      const float a = s_a[team * KG + gi];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[gi][e] *= a;
    }
    float pr[KG][kKB];
#pragma unroll
    for (int gi = 0; gi < KG; ++gi)
#pragma unroll
      for (int kk2 = 0; kk2 < kKB; ++kk2)
        pr[gi][kk2] = s_p[team * kLanes + gi * kKB + kk2];
#pragma unroll
    for (int kk2 = 0; kk2 < kKB; ++kk2) {
      float vx[8];
      vfn(kk2, vx);
#pragma unroll
      for (int gi = 0; gi < KG; ++gi)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[gi][e] = fmaf(pr[gi][kk2], vx[e], acc[gi][e]);
    }
    __syncwarp();
  };

  if constexpr (P::kDirect) {
    // one row: no key is shared between teams, so each team loads its
    // batches' keys and values straight into registers (16-byte loads,
    // the values' in flight while the scores are formed)
    const int n_keys = k_end - k_begin;
    const int rounds =
        ((n_keys + kKB - 1) / kKB + n_slices - 1) / n_slices;
    const auto n_valid = [&](int r) {
      return active ? max(0, min(kKB, n_keys - (slice + r * n_slices) * kKB))
                    : 0;
    };
    const auto fetch = [&](int r, Piece<TKV>(&kr)[kKB],
                           Piece<TKV>(&vr)[kKB]) {
      const int j0 = k_begin + (slice + r * n_slices) * kKB;
      const int n = n_valid(r);
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk) {
        kr[kk].load(kp + (long long)(j0 + kk) * k_ss, 8 * lane, d, kk < n,
                    vec);
        vr[kk].load(vp + (long long)(j0 + kk) * v_ss, 8 * lane, d, kk < n,
                    vec);
      }
    };
    const auto run = [&](int r, const Piece<TKV>(&kr)[kKB],
                         const Piece<TKV>(&vr)[kKB]) {
      batch([&](int kk, float(&x)[8]) { kr[kk].get(x); },
            [&](int kk, float(&x)[8]) { vr[kk].get(x); }, n_valid(r));
    };
    // two register sets in turn: round r + 1's loads are in flight while
    // round r computes
    Piece<TKV> ka[kKB], va[kKB], kb[kKB], vb[kKB];
    if (rounds > 0) fetch(0, ka, va);
    for (int r = 0; r < rounds; r += 2) {
      if (r + 1 < rounds) fetch(r + 1, kb, vb);
      run(r, ka, va);
      if (r + 1 < rounds) {
        if (r + 2 < rounds) fetch(r + 2, ka, va);
        run(r + 1, kb, vb);
      }
    }
  } else {
    // teams of several row sets share each key: K and V tiles go through
    // a ring in shared memory
    TKV* ring = reinterpret_cast<TKV*>(smem);
    constexpr int kTileElts = kT * DB;
    const int n_tiles = (k_end - k_begin + kT - 1) / kT;
    // K and V tile t of the range into its stage; one commit group a tile
    const auto load_kv = [&](int t) {
      TKV* st = ring + (t % kStages) * 2 * kTileElts;
      const int k0 = k_begin + t * kT;
      load_tile<TKV, DB, kT, kThreads>(st, kp, k_ss, k0, k_end, d, vec, tid);
      load_tile<TKV, DB, kT, kThreads>(st + kTileElts, vp, v_ss, k0, k_end,
                                       d, vec, tid);
    };
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) load_kv(t);
      repro::cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = k_begin + t * kT;
      repro::cp_async_wait<kStages - 2>();  // this tile
      // one barrier a tile: this tile is in every thread's view, and
      // every team is done with tile t - 1, whose stage the next load
      // fills
      __syncthreads();
      if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
      repro::cp_async_commit();
      const TKV* sk = ring + (t % kStages) * 2 * kTileElts;
      const TKV* sv = sk + kTileElts;
      const int n = min(kT, k_end - k0);
      const int rounds = ((n + kKB - 1) / kKB + n_slices - 1) / n_slices;
      for (int r = 0; r < rounds; ++r) {
        const int j0 = (slice + r * n_slices) * kKB;
        const int n_valid = active ? max(0, min(kKB, n - j0)) : 0;
        batch(
            [&](int kk, float(&x)[8]) {
              load8(sk + min(j0 + kk, kT - 1) * DB + 8 * lane, x);
            },
            [&](int kk, float(&x)[8]) {
              load8(sv + min(j0 + kk, kT - 1) * DB + 8 * lane, x);
            },
            n_valid);
      }
    }
    repro::cp_async_wait<0>();
  }
  __syncthreads();  // the ring's last reads, before the fold reuses it

  // fold the teams of each row in team order, in shared memory
  l_r = repro::group_sum<kKB>(l_r);
  float* f_m = reinterpret_cast<float*>(smem);  // [team][KG]
  float* f_l = f_m + P::kTeams * KG;
  float* f_w = f_l + P::kTeams * KG;
  float* f_rm = f_w + P::kTeams * KG;  // [row]
  float* f_rl = f_rm + P::kTeams * KG;
  float* f_acc = f_rl + P::kTeams * KG;  // [team][KG][DB]
  if (lane % kKB == 0) {
    f_m[team * KG + lane / kKB] = m_r;
    f_l[team * KG + lane / kKB] = l_r;
  }
#pragma unroll
  for (int gi = 0; gi < KG; ++gi)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f_acc[(team * KG + gi) * DB + 8 * lane + e] = acc[gi][e];
  __syncthreads();
  // each row's max over its teams, then each team's weight, in parallel
  for (int g = tid; g < group; g += kThreads) {
    const int gs = g / KG, gi = g % KG;
    float mx = kNegInf;
    for (int sl = 0; sl < n_slices; ++sl)
      mx = fmaxf(mx, f_m[(sl * n_sets + gs) * KG + gi]);
    f_rm[g] = mx;
  }
  __syncthreads();
  for (int i = tid; i < n_slices * group; i += kThreads) {
    const int sl = i / group, g = i % group;
    const int at = (sl * n_sets + g / KG) * KG + g % KG;
    f_w[at] = expf(f_m[at] - f_rm[g]);
  }
  __syncthreads();
  // each row's sum, in team order
  for (int g = tid; g < group; g += kThreads) {
    const int gs = g / KG, gi = g % KG;
    float l = 0.f;
    for (int sl = 0; sl < n_slices; ++sl) {
      const int at = (sl * n_sets + gs) * KG + gi;
      l = fmaf(f_w[at], f_l[at], l);
    }
    f_rl[g] = l;
  }
  __syncthreads();
  const int rows = gridDim.z * hq;  // partial rows a split
  for (int i = tid; i < group * d; i += kThreads) {
    const int g = i / d, c = i % d;
    const int gs = g / KG, gi = g % KG;
    float a = 0.f;
    for (int sl = 0; sl < n_slices; ++sl) {
      const int at = (sl * n_sets + gs) * KG + gi;
      a = fmaf(f_w[at], f_acc[at * DB + c], a);
    }
    const long long row = (long long)b * hq + h0 + g;
    if (out != nullptr) {  // one split: the normalized result
      const long long at = row * d + c;
      if (q_dtype == repro::kFloat32)
        static_cast<float*>(out)[at] = a / f_rl[g];
      else
        static_cast<bf16*>(out)[at] = __float2bfloat16_rn(a / f_rl[g]);
    } else {
      const long long prow = (long long)split * rows + row;
      acc_out[prow * d + c] = a;
      if (c == 0) {
        m_out[prow] = f_rm[g];
        l_out[prow] = f_rl[g];
      }
    }
  }
}

// the splits' partials [nsplit][rows][d] folded in split order, one block
// a row: into (acc, m, l), or acc / l in out's type where out is given
__global__ void __launch_bounds__(256) decode_attention_fold_kernel(
    const float* __restrict__ acc_p, const float* __restrict__ m_p,
    const float* __restrict__ l_p, int nsplit, int rows, int d,
    float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, void* __restrict__ out, int out_dtype) {
  __shared__ float s_w[kMaxSplits];
  __shared__ float s_max;
  const int row = blockIdx.x, tid = threadIdx.x;
  // the first warp: M = max m_i, then each split's weight e^{m_i - M}
  if (tid < 32) {
    float mx = kNegInf;
    for (int s = tid; s < nsplit; s += 32)
      mx = fmaxf(mx, m_p[(long long)s * rows + row]);
    mx = repro::group_max<32>(mx);
    for (int s = tid; s < nsplit; s += 32)
      s_w[s] = expf(m_p[(long long)s * rows + row] - mx);
    if (tid == 0) s_max = mx;
  }
  __syncthreads();
  for (int c = tid; c < d; c += blockDim.x) {
    float a = 0.f, l = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) {
      const long long at = (long long)s * rows + row;
      a = fmaf(s_w[s], acc_p[at * d + c], a);
      l = fmaf(s_w[s], l_p[at], l);
    }
    const long long at = (long long)row * d + c;
    if (out != nullptr) {
      if (out_dtype == repro::kFloat32)
        static_cast<float*>(out)[at] = a / l;
      else
        static_cast<bf16*>(out)[at] = __float2bfloat16_rn(a / l);
    } else {
      acc_out[at] = a;
      if (c == 0) {
        m_out[row] = s_max;
        l_out[row] = l;
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  float *acc, *m, *l;
  void* out;
  float *part_acc, *part_m, *part_l;
  int b, hq, hkv, d, kv_len, nsplit, chunk;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale;
  int q_dtype;
};

template <typename TKV, int DB, int KG>
int launch(const Args& a, cudaStream_t st) {
  using P = Plan<TKV, DB, KG>;
  auto kernel = decode_attention_kernel<TKV, DB, KG>;
  static bool smem_set = false;  // once an instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  constexpr int kPer = 16 / (int)sizeof(TKV);
  const bool vec = a.d % 8 == 0 && al(a.k) && al(a.v) && a.k_sb % kPer == 0 &&
                   a.k_sh % kPer == 0 && a.k_ss % kPer == 0 &&
                   a.v_sb % kPer == 0 && a.v_sh % kPer == 0 &&
                   a.v_ss % kPer == 0;
  const bool fold = a.nsplit > 1;
  const dim3 grid((unsigned)a.nsplit, (unsigned)a.hkv, (unsigned)a.b);
  kernel<<<grid, P::kThreads, P::kSmem, st>>>(
      a.q, static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      fold ? a.part_acc : a.acc, fold ? a.part_m : a.m,
      fold ? a.part_l : a.l, fold ? nullptr : a.out, a.q_dtype, a.hq,
      a.hq / a.hkv, a.d, a.kv_len, a.chunk, a.q_sb, a.q_sh, a.k_sb, a.k_sh,
      a.k_ss, a.v_sb, a.v_sh, a.v_ss, a.scale, (int)vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !fold) return (int)err;
  decode_attention_fold_kernel<<<(unsigned)(a.b * a.hq), 256, 0, st>>>(
      a.part_acc, a.part_m, a.part_l, a.nsplit, a.b * a.hq, a.d, a.acc, a.m,
      a.l, a.out, a.q_dtype);
  return (int)cudaGetLastError();
}

// rows a team holds: 1 for one query row where a batch of keys and values
// fits a lane's registers (8 pieces of 16 bytes each: bf16 up to D = 64,
// float32 up to 32), else 4 where the block's 128 threads hold the group
// (group · D ≤ 4,096; kernels/decode_attention/kernel.py::MAX_GROUP_DIM)
template <typename TKV, int DB>
int launch_kg(const Args& a, cudaStream_t st) {
  const int group = a.hq / a.hkv;
  if constexpr (DB / 8 * (int)sizeof(TKV) / 2 <= 8) {
    if (group == 1) return launch<TKV, DB, 1>(a, st);
  }
  if (group * (DB / 8) <= 512) return launch<TKV, DB, 4>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <typename TKV>
int launch_db(const Args& a, cudaStream_t st) {
  if (a.d <= 32) return launch_kg<TKV, 32>(a, st);
  if (a.d <= 64) return launch_kg<TKV, 64>(a, st);
  if (a.d <= 128) return launch_kg<TKV, 128>(a, st);
  if (a.d <= 256) return launch_kg<TKV, 256>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, D] with strides (q_sb, q_sh, 1); k and v [B, Hkv, S, D] with
// strides (sb, sh, ss, 1); 1 <= kv_len <= S.  Splits of `chunk` keys,
// nsplit = ceil(kv_len / chunk).  With out null: float32 contiguous acc
// [B, Hq, D], m and l [B, Hq]; with out given: acc / l into out [B, Hq, D]
// of q's type.  With nsplit > 1 the splits' partials go to part_acc
// [nsplit, B, Hq, D], part_m and part_l [nsplit, B, Hq] (float32), and
// the fold writes the result.  dtype codes: 0 float32, 1 bfloat16, for q
// and for the cache separately.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* acc, void* m,
    void* l, void* out, void* part_acc, void* part_m, void* part_l, int b,
    int hq, int hkv, int d, int kv_len, int nsplit, int chunk, long long q_sb,
    long long q_sh, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  const Args a{q, k, v,
               static_cast<float*>(acc), static_cast<float*>(m),
               static_cast<float*>(l), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_m),
               static_cast<float*>(part_l), b, hq, hkv, d, kv_len, nsplit,
               chunk, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,
               q_dtype};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > kMaxSplits ||
      (long long)(nsplit - 1) * chunk >= kv_len ||
      (long long)nsplit * chunk < kv_len ||
      (q_dtype != repro::kFloat32 && q_dtype != repro::kBFloat16))
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == repro::kFloat32) return launch_db<float>(a, st);
  if (kv_dtype == repro::kBFloat16) return launch_db<bf16>(a, st);
  return (int)cudaErrorInvalidValue;
}
