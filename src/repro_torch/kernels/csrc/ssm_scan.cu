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
// channel, state) takes one, 2.15 G of them at falcon-mamba-7b's prefill
// shape [8, 2048, 8192] with st 16: at 16 special-function results per
// clock per SM that is 0.51 ms at 1,980 MHz.  The bytes come close
// behind: x and y in bf16, dt in float32 and the strided B and C rows are
// 1.07 GB, 0.32 ms at 3.35 TB/s.  And the issue port is next: each
// (step, state) also needs five float32 instructions (dt·A2, the two
// rounded products, their sum, the y FMA), so a warp issues six
// instructions in the eight cycles its exponential holds the SM
// sub-partition's special-function unit.  The [B, S, di, st] state
// tensor never reaches device memory: h lives in registers for the whole
// sequence.
//
// Design:
// - A channel's states are split in two halves, each held by a thread of
//   a different warp with its P = ceil(st / 2) states and A entries in
//   registers: the block's first 128 threads hold the first half of its
//   128 channels, the next 128 the second.  The kernel is templated on
//   P, so no array is indexed at run time and no stack frame appears; a
//   padded state has A = B = C = 0 and stays 0.  At the prefill shape
//   that is 4,096 warps, not 2,048, and a warp's B and C reads are one
//   broadcast float4 address.
// - One MUFU.EX2 a (step, state): A2 = A·log2(e) is formed once, and the
//   exponential is ex2.approx.ftz(dt·A2); a result below 2^-126 flushes
//   to 0.  The plain version's torch.exp (expf) reduces its argument to
//   [0, 1) before the same instruction, so for factors near 1 the two
//   differ in their last bits: within the float32 limit of the plain
//   version except over a long, nearly undamped carry, where
//   chip_smoke.py holds the kernel to a float64 scan instead (no farther
//   from it than the plain version).
// - The update rounds each product and the sum as the plain version does
//   (__fadd_rn(__fmul_rn(dA, h), __fmul_rn(dt·x, B))).
// - y: each half sums its states in order by FMA from 0, into float32
//   partial sums in shared memory; the store of a tile adds the two
//   halves, first plus second.
// - Time runs in tiles of kT = 8 steps through a ring of three stages in
//   shared memory.  x and dt arrive by 16-byte cp.async copies (zero past
//   the sequence and the channel tail); B and C, read through their
//   strides (in the model they are slices of x_proj's output), go through
//   registers and are stored as float32, so a thread reads its P states
//   as float4 (or float2) vectors.  Two tiles' copies are in flight while
//   one is stepped, with one barrier a tile.
// - y is stored a tile at a time as 16-byte vectors along the channels.
// - One resident wave: every block runs the whole sequence, so the grid
//   of ceil(di / 128) × B blocks is sized to be resident at once: 512
//   blocks at [8, 2048, 8192], 4 an SM (__launch_bounds__ caps the
//   registers at 64; 37 KB of shared memory a block in bf16).
//   repro_ssm_scan_plan reports the blocks, registers and blocks an SM
//   holds.
// Rows whose x, dt or y do not start on 16 bytes take element-wise copies
// and stores.
//
// Measured (H100 80GB HBM3, 700 W; PERF.md §6; chip_smoke.py): 0.867–0.871
// ms at the prefill shape in bf16 by CUDA-graph replay, 0.59 of the
// bound, from 1.417 ms for the earlier design, one thread a channel with
// expf.  Two or four stages, tiles of 4 or 16 steps, the halves on
// neighbouring lanes folded by a shuffle, quarters on four lanes and two
// channels a thread were slower on the card.  A chunked scan over time
// (a second pass of exponentials), part of the exponentials as a
// polynomial on the FMA pipes, and fusing softplus, x·D or the gate are
// later steps (ROADMAP item 13).
// softplus, x·D or the gate are later steps (ROADMAP item 13).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention.cuh"

namespace {

constexpr int kMaxState = 16;
// warps a channel's states are split over: the block's first 128
// threads take the first half of every channel's states, the next 128 the
// second, so each warp reads one B and C row as a broadcast
constexpr int kG = 2;
// channels a block, steps a tile, tiles in the ring
constexpr int kChannels = 128;
constexpr int kT = 8;
constexpr int kStages = 3;
constexpr int kThreads = kChannels * kG;
// blocks an SM must hold for the prefill grid to be one wave
constexpr int kMinBlocks = 4;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int P>
struct Plan {
  static constexpr int kSP = kG * P;  // the states, padded
  static constexpr int kXBytes = kT * kChannels * (int)sizeof(T);
  static constexpr int kDtBytes = kT * kChannels * 4;
  static constexpr int kBcFloats = kT * kSP;  // one of B or C a stage
  static constexpr int kStageBytes = kXBytes + kDtBytes + 2 * kBcFloats * 4;
  // the kG partial sums of y, float32, two tiles
  static constexpr int kPartFloats = kG * kT * kChannels;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kPartFloats * 4;
  // B and C elements each thread carries through registers a tile
  static constexpr int kBcPer = (2 * kBcFloats + kThreads - 1) / kThreads;
  static_assert(kXBytes % 16 == 0 && kBcFloats % 4 == 0, "16-byte rows");
};

// f(q) for each q < N this thread takes, kThreads apart: a trip count
// known at compile time
template <int N, typename F>
__device__ __forceinline__ void each(int tid, F f) {
#pragma unroll
  for (int i = 0; i < (N + kThreads - 1) / kThreads; ++i) {
    const int q = tid + i * kThreads;
    if (N % kThreads == 0 || q < N) f(q);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// a thread's P states of one B or C row, as the widest vectors they allow
template <int P>
__device__ __forceinline__ void load_states(const float* p, float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int j = 0; j < P; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  } else if constexpr (P % 2 == 0) {
#pragma unroll
    for (int j = 0; j < P; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x, v[j + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = p[j];
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks) ssm_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ bc, const T* __restrict__ cc,
    const float* __restrict__ a, T* __restrict__ y, int s, int di, int st,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    int vec) {
  using Pl = Plan<T, P>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_part = reinterpret_cast<float*>(smem + kStages * Pl::kStageBytes);

  const int tid = threadIdx.x;
  const int g = tid / kChannels;  // the warp's half of the states
  const int c = tid % kChannels;  // the channel within the block
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const int b = blockIdx.y;
  const long long row0 = (long long)b * s * di;
  const int tiles = (s + kT - 1) / kT;

  float h[P], a2[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int n = g * P + j;
    h[j] = 0.f;
    a2[j] = d < di && n < st ? a[(long long)d * st + n] * kLog2e : 0.f;
  }

  const T* bp = bc + b * b_sb;
  const T* cp = cc + b * c_sb;
  // x and dt of tile k into a stage: cp.async, zero past s and di
  auto copy_xdt = [&](int k, int stage) {
    const int t0 = k * kT;
    unsigned char* sx = smem + stage * Pl::kStageBytes;
    float* sdt = reinterpret_cast<float*>(sx + Pl::kXBytes);
    if (vec) {
      constexpr int kXc = kChannels * (int)sizeof(T) / 16;  // a row
      constexpr int kXe = 16 / (int)sizeof(T);
      each<kT * kXc>(tid, [&](int q) {
        const int r = q / kXc, ch = q % kXc * kXe;
        const bool ok = t0 + r < s && d0 + ch < di;
        repro::cp_async16(repro::smem_addr(sx + (r * kChannels + ch) *
                                                    (int)sizeof(T)),
                          ok ? x + row0 + (long long)(t0 + r) * di + d0 + ch
                             : x,
                          ok ? 16 : 0);
      });
      each<kT * kChannels / 4>(tid, [&](int q) {
        const int r = q / (kChannels / 4), ch = q % (kChannels / 4) * 4;
        const bool ok = t0 + r < s && d0 + ch < di;
        repro::cp_async16(
            repro::smem_addr(sdt + r * kChannels + ch),
            ok ? dt + row0 + (long long)(t0 + r) * di + d0 + ch : dt,
            ok ? 16 : 0);
      });
    } else {
      T* sxt = reinterpret_cast<T*>(sx);
      each<kT * kChannels>(tid, [&](int e) {
        const int r = e / kChannels, ch = e % kChannels;
        const bool ok = t0 + r < s && d0 + ch < di;
        const long long off = row0 + (long long)(t0 + r) * di + d0 + ch;
        sxt[e] = ok ? x[off] : repro::from_float<T>(0.f);
        sdt[e] = ok ? dt[off] : 0.f;
      });
    }
  };

  // B and C of tile k: device memory -> registers -> a stage, as float32
  float bcv[Pl::kBcPer];
  auto load_bc = [&](int k) {
    const int t0 = k * kT;
#pragma unroll
    for (int i = 0; i < Pl::kBcPer; ++i) {
      const int e = tid + i * kThreads;
      const bool is_c = e >= Pl::kBcFloats;
      const int e2 = is_c ? e - Pl::kBcFloats : e;
      const int t = t0 + e2 / Pl::kSP, n = e2 % Pl::kSP;
      const bool ok = e < 2 * Pl::kBcFloats && t < s && n < st;
      bcv[i] = ok ? repro::to_float(is_c ? cp[t * c_ss + n] : bp[t * b_ss + n])
                  : 0.f;
    }
  };
  auto store_bc = [&](int stage) {
    float* sbc = reinterpret_cast<float*>(smem + stage * Pl::kStageBytes +
                                          Pl::kXBytes + Pl::kDtBytes);
#pragma unroll
    for (int i = 0; i < Pl::kBcPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < 2 * Pl::kBcFloats) sbc[e] = bcv[i];
    }
  };

  auto store_y = [&](int k) {
    const int t0 = k * kT;
    const float* part = s_part + (k & 1) * Pl::kPartFloats;
    const auto fold = [&](int e) {
      float v = part[e];
#pragma unroll
      for (int h2 = 1; h2 < kG; ++h2) v += part[h2 * kT * kChannels + e];
      return v;
    };
    if (vec) {
      constexpr int kYe = 16 / (int)sizeof(T);
      constexpr int kYc = kChannels / kYe;  // 16-byte pieces a row
      each<kT * kYc>(tid, [&](int q) {
        const int r = q / kYc, ch = q % kYc * kYe;
        if (t0 + r < s && d0 + ch < di) {
          __align__(16) T out[kYe];
#pragma unroll
          for (int i = 0; i < kYe; ++i)
            out[i] = repro::from_float<T>(fold(r * kChannels + ch + i));
          *reinterpret_cast<uint4*>(y + row0 + (long long)(t0 + r) * di +
                                    d0 + ch) =
              *reinterpret_cast<const uint4*>(out);
        }
      });
    } else {
      each<kT * kChannels>(tid, [&](int e) {
        const int r = e / kChannels, ch = e % kChannels;
        if (t0 + r < s && d0 + ch < di)
          y[row0 + (long long)(t0 + r) * di + d0 + ch] =
              repro::from_float<T>(fold(e));
      });
    }
  };

  // the first kStages - 1 tiles in flight, one commit group each
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles) {
      copy_xdt(k, k);
      load_bc(k);
      store_bc(k);
    }
    repro::cp_async_commit();
  }
  repro::cp_async_wait<kStages - 2>();
  __syncthreads();

  for (int k = 0; k < tiles; ++k) {
    const int stage = k % kStages;
    if (k > 0) store_y(k - 1);
    const int kn = k + kStages - 1;
    if (kn < tiles) {
      copy_xdt(kn, kn % kStages);
      load_bc(kn);
    }
    repro::cp_async_commit();

    const unsigned char* base = smem + stage * Pl::kStageBytes;
    const T* sx = reinterpret_cast<const T*>(base) + c;
    const float* sdt =
        reinterpret_cast<const float*>(base + Pl::kXBytes) + c;
    const float* sb = reinterpret_cast<const float*>(
                          base + Pl::kXBytes + Pl::kDtBytes) +
                      g * P;
    const float* sc = sb + Pl::kBcFloats;
    float* sp = s_part + (k & 1) * Pl::kPartFloats + g * kT * kChannels + c;
#pragma unroll
    for (int o = 0; o < kT; ++o) {
      const float dtv = sdt[o * kChannels];
      const float dbx = dtv * repro::to_float(sx[o * kChannels]);
      float bv[P], cv[P];
      load_states<P>(sb + o * Pl::kSP, bv);
      load_states<P>(sc + o * Pl::kSP, cv);
      float yv = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        // each product rounded, as the plain version rounds it: an FMA
        // here would part from it by up to an ulp of h a step, and with
        // |A|·dt near 0 those add up over the whole sequence
        h[j] = __fadd_rn(__fmul_rn(ex2(dtv * a2[j]), h[j]),
                         __fmul_rn(dbx, bv[j]));
        yv = fmaf(h[j], cv[j], yv);
      }
      sp[o * kChannels] = yv;
    }

    if (kn < tiles) store_bc(kn % kStages);
    repro::cp_async_wait<kStages - 2>();
    __syncthreads();
  }
  if (tiles > 0) store_y(tiles - 1);
}

template <typename T, int P>
cudaError_t prepare() {
  static bool done = false;  // once an instantiation
  if (done) return cudaSuccess;
  auto kernel = ssm_scan_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<T, P>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

struct Args {
  const void *x, *dt, *bc, *cc, *a;
  void* y;
  int b, s, di, st;
  long long b_sb, b_ss, c_sb, c_ss;
};

template <typename T, int P>
int launch_p(const Args& g, cudaStream_t stream) {
  cudaError_t err = prepare<T, P>();
  if (err != cudaSuccess) return (int)err;
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = al(g.x) && al(g.dt) && al(g.y) &&
                   g.di % (16 / (int)sizeof(T)) == 0;
  const dim3 grid((unsigned)((g.di + kChannels - 1) / kChannels),
                  (unsigned)g.b);
  ssm_scan_kernel<T, P><<<grid, kThreads, Plan<T, P>::kSmem, stream>>>(
      static_cast<const T*>(g.x), static_cast<const float*>(g.dt),
      static_cast<const T*>(g.bc), static_cast<const T*>(g.cc),
      static_cast<const float*>(g.a), static_cast<T*>(g.y), g.s, g.di, g.st,
      g.b_sb, g.b_ss, g.c_sb, g.c_ss, (int)vec);
  return (int)cudaGetLastError();
}

// out: kG, P, threads, blocks, blocks an SM holds, SMs, registers,
// shared bytes a block, kT, kStages
template <typename T, int P>
int plan_p(int b, int di, int* out) {
  cudaError_t err = prepare<T, P>();
  if (err != cudaSuccess) return (int)err;
  auto kernel = ssm_scan_kernel<T, P>;
  int per_sm = 0, dev = 0, sms = 0;
  cudaFuncAttributes attr{};
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, Plan<T, P>::kSmem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess)
    return (int)err;
  const int vals[] = {kG, P, kThreads, (di + kChannels - 1) / kChannels * b,
                      per_sm, sms, attr.numRegs, Plan<T, P>::kSmem, kT,
                      kStages};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

// P = ceil(st / kG) states a thread: 1..8
#define REPRO_SSM_SWITCH(CALL)                                              \
  switch ((st + kG - 1) / kG) {                                            \
    case 1: return CALL(1);                                                \
    case 2: return CALL(2);                                                \
    case 3: return CALL(3);                                                \
    case 4: return CALL(4);                                                \
    case 5: return CALL(5);                                                \
    case 6: return CALL(6);                                                \
    case 7: return CALL(7);                                                \
    case 8: return CALL(8);                                                \
    default: return (int)cudaErrorInvalidValue;                            \
  }
static_assert((kMaxState + kG - 1) / kG <= 8, "one case a P");

template <typename T>
int launch_type(const Args& g, cudaStream_t stream) {
  const int st = g.st;
#define REPRO_SSM_LAUNCH(P) launch_p<T, P>(g, stream)
  REPRO_SSM_SWITCH(REPRO_SSM_LAUNCH)
#undef REPRO_SSM_LAUNCH
}

template <typename T>
int plan_type(int b, int di, int st, int* out) {
#define REPRO_SSM_PLAN(P) plan_p<T, P>(b, di, out)
  REPRO_SSM_SWITCH(REPRO_SSM_PLAN)
#undef REPRO_SSM_PLAN
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
  const Args g{x, dt, bc, cc, a, y, b, s, di, st, b_sb, b_ss, c_sb, c_ss};
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return launch_type<float>(g, str);
  if (dtype == repro::kBFloat16) return launch_type<__nv_bfloat16>(g, str);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of repro_ssm_scan for [b, ·, di] with st states: out[10]
// gets the halves a channel, the states a thread, threads a block, blocks,
// blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), SMs,
// registers a thread, shared bytes a block, steps a tile and stages.
extern "C" int repro_ssm_scan_plan(int b, int di, int st, int dtype,
                                   int* out) {
  if (st < 1 || st > kMaxState) return (int)cudaErrorInvalidValue;
  if (dtype == repro::kFloat32) return plan_type<float>(b, di, st, out);
  if (dtype == repro::kBFloat16)
    return plan_type<__nv_bfloat16>(b, di, st, out);
  return (int)cudaErrorInvalidValue;
}
