// AUGRU (attention-gated GRU) scan on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/augru/kernel.py (augru_pallas;
// body _augru_kernel).  For every batch row it runs the serial recurrence
//
//   hU = h @ U                       (U: (H, 3H), gate layout r | z | n)
//   r  = sigmoid(x_r + hU_r)      z = sigmoid(x_z + hU_z)
//   n  = tanh(x_n + r * hU_n)     zg = att * z
//   h  = (1 - zg) * h + zg * n
//
// over t = 0 .. T-1 and writes every step's h to out[:, t].  DIEN runs it
// twice per forward: the GRU stage with att == 1 and the interest
// evolution with the target attention.  Any B, T, H >= 1 runs: no padding
// of H to 128 lanes and no batch blocks of 8 are forced on the caller, as
// the TPU kernel did.
//
// Bound: 2*B*T*H*3H float32 operations for the products against reading
// x_gates once and writing the states once.  At DIEN's H = 108 the
// operations bound it (3.58 GFLOP at (512, 100, 108): 53.5 us at 67
// TFLOP/s; 6.85 ms at 65,536 rows, where the 11.3 GB of gates and states
// take 3.4 ms at 3.35 TB/s).  Each step needs the last one's h, so a step
// is a (rows, H) x (H, 3H) product, then a gate chain (two expf, a tanhf,
// two divisions, all full float32: ~75 instructions per (row, unit)
// against 324 FMAs), then a barrier.  At a small batch the latency of that
// chain sets the time; at a large one the FMA issue rate and the gate
// chain's share of it do.
//
// The launch plan (route, rows or row groups, blocks, threads) is chosen
// by shape before the launch, in kernel.py::plan.  The entry points below
// derive the shared memory and scratch it needs and refuse a plan that the
// kernel cannot run or that does not fit the card.
//
// Route "small" (H <= 108, below 56 rows per SM): reg::augru_kernel<R>.
// U stays in registers for the whole scan: thread (unit j, slice s)
// holds U[k][j], U[k][H+j], U[k][2H+j] for the 108 / S k of slice s (zero
// beyond H), so the products read only h from shared memory, R rows per
// word as one broadcast.  The S slices of a unit are neighbouring lanes;
// their partial sums are reduced by xor shuffles in a fixed order (each
// lane keeps its share of the rows: no shared-memory round trip), then
// the lane that owns a row applies the gates.  h is double-buffered in
// shared memory ([k][row]; one barrier a step).  Each lane loads its
// rows' gates for step t+1 while step t ends, and asks L2 for those of
// t+1+kPrefetch.  R is the least of 1, 2, 4 that gives each SM at most one
// tile, so a block computes only rows that exist (at B = 1 one row, not
// four); beyond 4 rows per SM, R = 4 blocks walk over several tiles.  The
// register file bounds S, the k slices a unit, which follows from R: at
// S = 4 (R = 4) a block has 14 warps, 4 of which share a sub-partition's
// 16K registers, so 128 a thread hold 81 words of U and 12 accumulators
// (R = 8 spilled); at S = 2 (R = 1, 2), 7 warps of up to 255 registers
// hold 162 words, and a step has half the shuffles.
//
// Route "large" (H <= 108, from 56 rows per SM): tile::augru_kernel.  One
// persistent block per SM keeps U in shared memory (140 KB, read from
// device memory once per SM) and walks over tiles of 8 * RG rows.  Thread
// (row group, unit group) computes an 8-row x 4-unit x 3-gate outer
// product over all k, 96 FMAs per 5 float4 loads from shared memory, and
// applies the gates to its own 32 (row, unit) pairs: nothing to reduce.
// All of a step's gate inputs are loaded before its products (x_r and x_z
// as the r and z sums' first terms), so their latency is paid once a step,
// not once a row; that needs 8 warps of up to 255 registers.  The gate
// chain and the barrier still keep the FMA pipes below half the peak.
//
// Route "general" (H > 108, whose U does not fit in registers): the
// previous design, previous::augru_kernel, kept as the kernel of record
// there and, through augru_previous_launch, to time it beside the new
// routes.  One persistent block per group of kRows * groups batch rows; U
// sits in dynamic shared memory when it fits (196 KB at H = 128), else the
// same code reads it from global memory, where it stays L2-resident; h is
// double-buffered in shared memory (in a global scratch slice of the block
// when even that does not fit, H in the thousands).  Each step has two
// phases, one __syncthreads after each: (1) thread (group g, slice s, unit
// j) forms the partial products of hU[:, j], hU[:, H+j], hU[:, 2H+j] for
// the kRows rows of g over the s-th of `splits` slices of k, by a
// fixed-order fmaf loop into shared memory; (2) the same thread sums the
// slices in order for its rows and applies the gates.  It reads U from
// shared memory for every product and pays two barriers a step.
//
// Every route sums in a fixed order without atomics (two launches on the
// same inputs give bit-equal states); products are float32 fmaf on the
// CUDA cores, never TF32 or the tensor cores; the build's -fmad=false
// keeps every other multiply and add unfused.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launch plan kernel.py::plan computes (mirrored by kernel.CPlan).
struct AugruPlan {
  int route;            // kSmall, kLarge or kGeneral
  int rows;             // small: R, the rows of a tile
  int groups;           // large: 8-row groups a tile; general: 4-row groups
  int splits;           // general: k slices a unit
  int u_shared, state_shared;   // general: U and the state in shared memory
  int threads;
  int64_t blocks;
  int64_t scratch_floats;       // general: floats of the scratch passed
};

namespace {

using Plan = AugruPlan;

constexpr int kSmall = 0, kLarge = 1, kGeneral = 2;
constexpr int kInvalid = (int)cudaErrorInvalidValue;
constexpr int64_t kMaxBlocks = 0x7fffffff;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

int max_smem_optin(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// ---------------------------------------------------------------------------
// The small route: U in registers
// ---------------------------------------------------------------------------

namespace reg {

constexpr int kMaxH = 108;      // units a block holds (DIEN)
constexpr int kPrefetch = 4;    // steps ahead that the gates go into L2

// k slices a unit at R rows a tile: what the registers hold (see the top)
__host__ __device__ constexpr int splits(int R) { return R == 4 ? 4 : 2; }

// threads of a block: S slices of every unit, in whole warps
__host__ __device__ constexpr int max_threads(int R) {
  return 32 * ((splits(R) * kMaxH + 31) / 32);
}

// the h buffers: two of (kMaxH, R) float32
__host__ __device__ constexpr int64_t smem_bytes(int R) {
  return (int64_t)sizeof(float) * 2 * kMaxH * R;
}

// The R rows of h at one k: [k][row] in shared memory, R floats in a row.
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float* v) {
  if constexpr (R == 1) {
    v[0] = p[0];
  } else if constexpr (R == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
}

// Sums partial products v[L] over the lanes of a group of slices, xor
// masks M, M/2, .. 1, in a fixed order: while a lane holds more than one
// row it keeps half (the upper half where its bit M is set) and adds the
// partner's half; with one row left the rest is a butterfly.  Lane s ends
// with rows s*G .. s*G+G-1 in v[0..G) (R >= S), or the row s / (S / R).
template <int L, int M>
__device__ __forceinline__ void reduce_group(float* v, int s) {
  if constexpr (M > 0) {
    constexpr unsigned kAll = 0xffffffffu;
    if constexpr (L > 1) {
      const bool hi = s & M;
#pragma unroll
      for (int i = 0; i < L / 2; ++i) {
        const float send = hi ? v[i] : v[i + L / 2];
        const float keep = hi ? v[i + L / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(kAll, send, M);
      }
      reduce_group<L / 2, M / 2>(v, s);
    } else {
      v[0] += __shfl_xor_sync(kAll, v[0], M);
      reduce_group<1, M / 2>(v, s);
    }
  }
}

// R rows a block, S = splits(R) k slices a unit.  Thread (unit j, slice
// s) holds U's 3 x kMaxH / S words for its slice in registers for the
// whole scan.
template <int R>
__global__ void __launch_bounds__(max_threads(R), 1) augru_kernel(
    const float* __restrict__ xg, const float* __restrict__ u,
    const float* __restrict__ att, const float* __restrict__ h0,
    float* __restrict__ out, int B, int T, int H) {
  static_assert(R == 1 || R == 2 || R == 4, "rows per block");
  constexpr int S = splits(R);
  constexpr int KS = kMaxH / S;              // k per slice
  constexpr int G = R >= S ? R / S : 1;      // rows a lane owns
  constexpr int D = R >= S ? 1 : S / R;      // lanes that share a row
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);   // [2][kMaxH][R]
  const int s = threadIdx.x % S;
  const int j = threadIdx.x / S;
  const bool unit = j < H;
  const int row = R >= S ? s * G : s / D;    // the first row it owns
  const int64_t H3 = 3 * (int64_t)H;

  float w[3][KS];                            // U's slice, zero beyond H
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int k = s * KS + kk;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      w[c][kk] = unit && k < H ? u[k * H3 + c * H + j] : 0.0f;
  }

  const int64_t tiles = ceil_div(B, R);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int64_t bt[G];                           // b * T of each row, or -1
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int64_t b = tile * R + row + g;
      bt[g] = s % D == 0 && unit && b < B ? b * T : -1;
    }
    float xr[G] = {}, xz[G] = {}, xn[G] = {}, a[G] = {};
    auto load = [&](int t) {         // this lane's rows' gates at step t
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (bt[g] >= 0 && t < T) {
          const float* x = xg + (bt[g] + t) * H3 + j;
          xr[g] = x[0];
          xz[g] = x[H];
          xn[g] = x[2 * H];
          a[g] = att[bt[g] + t];
        }
      }
    };
    auto prefetch = [&](int t) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (bt[g] >= 0 && t < T) {
          const float* x = xg + (bt[g] + t) * H3 + j;
          prefetch_l2(x);
          prefetch_l2(x + H);
          prefetch_l2(x + 2 * H);
          prefetch_l2(att + bt[g] + t);
        }
      }
    };
#pragma unroll 1
    for (int d = 1; d <= kPrefetch; ++d) prefetch(d);
    load(0);

    // (the last tile's final barrier has passed: nothing reads hbuf now)
    for (int i = threadIdx.x; i < 2 * kMaxH * R; i += blockDim.x) {
      const int k = (i / R) % kMaxH;
      const int64_t b = tile * R + i % R;
      hbuf[i] = i < kMaxH * R && k < H && b < B ? h0[b * H + k] : 0.0f;
    }
    __syncthreads();

    float* hcur = hbuf;
    float* hnext = hbuf + kMaxH * R;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      float acc[3][R];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[c][r] = 0.0f;
      const float* hk = hcur + s * KS * R;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float hv[R];
        load_rows<R>(hk + kk * R, hv);
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[c][r] = fmaf(hv[r], w[c][kk], acc[c][r]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) reduce_group<R, S / 2>(acc[c], s);

#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (bt[g] < 0) continue;
        const float r = sigmoid_f(xr[g] + acc[0][g]);
        const float z = sigmoid_f(xz[g] + acc[1][g]);
        const float n = tanhf(xn[g] + r * acc[2][g]);
        const float zg = a[g] * z;
        const int hi = j * R + row + g;
        const float h = (1.0f - zg) * hcur[hi] + zg * n;
        hnext[hi] = h;
        __stcs(out + (bt[g] + t) * H + j, h);
      }
      load(t + 1);
      prefetch(t + 1 + kPrefetch);
      __syncthreads();
      float* tmp = hcur;
      hcur = hnext;
      hnext = tmp;
    }
  }
}

// Refuses a plan the kernel cannot run: U's slice fits in registers only
// up to H = 108 and for the compiled R (the register limit); whole warps
// (the shuffles) that cover every (unit, slice) within the compiled block;
// the h buffers within the opt-in shared memory.
int check(const Plan& p, int H, int cap) {
  const bool rows_ok = p.rows == 1 || p.rows == 2 || p.rows == 4;
  if (p.route != kSmall || H > kMaxH || !rows_ok || p.threads % 32 != 0
      || p.threads < splits(p.rows) * H || p.threads > max_threads(p.rows)
      || smem_bytes(p.rows) > cap || p.blocks < 1 || p.blocks > kMaxBlocks)
    return kInvalid;
  return 0;
}

template <int R>
int launch(const Plan& p, const float* xg, const float* u, const float* att,
           const float* h0, float* out, int B, int T, int H,
           cudaStream_t stream) {
  augru_kernel<R><<<(unsigned int)p.blocks, p.threads,
                    (size_t)smem_bytes(R), stream>>>(xg, u, att, h0, out,
                                                     B, T, H);
  return (int)cudaGetLastError();
}

}  // namespace reg

// ---------------------------------------------------------------------------
// The large route: register-tiled outer products, U and h in shared memory
// ---------------------------------------------------------------------------

namespace tile {

constexpr int kTR = 8;            // rows a thread computes
constexpr int kTU = 4;            // units a thread computes (x 3 gates)
constexpr int kMaxThreads = 256;  // 8 warps: 255 registers a thread

__host__ __device__ __forceinline__ int unit_groups(int H) {
  return (H + kTU - 1) / kTU;
}

// floats of shared memory: U as [H][unit group][r0..3 z0..3 n0..3], h
// twice as [H][rows + 4] (the pad spreads a unit's rows over the banks)
__host__ __device__ __forceinline__ int64_t smem_floats(int H, int rows) {
  return (int64_t)H * unit_groups(H) * 3 * kTU + 2 * (int64_t)H * (rows + 4);
}

__host__ __forceinline__ int64_t smem_bytes(const Plan& p, int H) {
  return (int64_t)sizeof(float) * smem_floats(H, kTR * p.groups);
}

// One persistent block per SM walks over tiles of rows = 8 * RG batch
// rows; thread (row group rg, unit group ug) computes hU for its 8 rows
// and 4 units (96 accumulators) over all H k, each k one float4 pair of h
// (its rows, broadcast to the warp) and three float4 of U from shared
// memory: 96 FMAs per 5 loads.  Then it applies the gates to the same 32
// (row, unit) pairs with nothing to reduce.  All of a step's gate inputs
// are loaded before its products, so their latency is paid once a step
// and not once a row: x_r and x_z start the r and z sums, x_n and att wait
// in registers (255 a thread at 8 warps); L2 has them since the last step.
// kVec: H % 4 == 0 and 16-byte aligned operands, so the gates and the
// states of 4 units move as float4.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1) augru_kernel(
    const float* __restrict__ xg, const float* __restrict__ u,
    const float* __restrict__ att, const float* __restrict__ h0,
    float* __restrict__ out, int B, int T, int H, int RG) {
  extern __shared__ float4 smem4[];
  const int UG = unit_groups(H);
  const int rows = kTR * RG;
  const int hstride = rows + 4;
  float* us = reinterpret_cast<float*>(smem4);
  float* hs = us + (int64_t)H * UG * 3 * kTU;
  const int tid = threadIdx.x;
  const int ug = tid % UG;
  const int rg = tid / UG;
  const int64_t H3 = 3 * (int64_t)H;

  for (int64_t i = tid; i < (int64_t)H * UG * 3 * kTU; i += blockDim.x) {
    const int k = (int)(i / (UG * 3 * kTU));
    const int rem = (int)(i % (UG * 3 * kTU));
    const int c = (rem % (3 * kTU)) / kTU;
    const int j = kTU * (rem / (3 * kTU)) + rem % kTU;
    us[i] = j < H ? u[k * H3 + c * H + j] : 0.0f;
  }

  const int64_t tiles = ceil_div(B, rows);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * rows + kTR * rg;    // this thread's rows
    // a thread whose rows all lie beyond B skips the step: the warps of a
    // partly filled last tile leave their issue slots to the others
    const bool active = tid < UG * RG && row0 < B;
    auto prefetch = [&](int t) {
      if (!active || t >= T) return;
#pragma unroll
      for (int q = 0; q < kTR; ++q) {
        const int64_t b = row0 + q;
        if (b >= B) break;
        const float* x = xg + (b * T + t) * H3 + kTU * ug;
        prefetch_l2(x);
        prefetch_l2(x + H);
        prefetch_l2(x + 2 * H);
        prefetch_l2(att + b * T + t);
      }
    };
    prefetch(0);
    // (the last tile's final barrier has passed: nothing reads hs now)
    for (int i = tid; i < H * rows; i += blockDim.x) {
      const int k = i / rows, r = i % rows;
      const int64_t b = tile * rows + r;
      hs[k * hstride + r] = b < B ? h0[b * H + k] : 0.0f;
    }
    __syncthreads();

    int cur = 0;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      const float* hc = hs + cur * H * hstride;
      float* hn = hs + (cur ^ 1) * H * hstride;
      if (active) {
        float acc[3][kTU][kTR], xn[kTU][kTR], a[kTR];
#pragma unroll
        for (int q = 0; q < kTR; ++q) {
          const int64_t b = row0 + q;
          float v[3][kTU] = {};
          a[q] = 0.0f;
          if (b < B) {
            const float* x = xg + (b * T + t) * H3 + kTU * ug;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              if (kVec) {
                const float4 x4 = *reinterpret_cast<const float4*>(x + c * H);
                v[c][0] = x4.x;
                v[c][1] = x4.y;
                v[c][2] = x4.z;
                v[c][3] = x4.w;
              } else {
#pragma unroll
                for (int i = 0; i < kTU; ++i)
                  if (kTU * ug + i < H) v[c][i] = x[c * H + i];
              }
            }
            a[q] = att[b * T + t];
          }
#pragma unroll
          for (int i = 0; i < kTU; ++i) {
            acc[0][i][q] = v[0][i];
            acc[1][i][q] = v[1][i];
            acc[2][i][q] = 0.0f;
            xn[i][q] = v[2][i];
          }
        }
        const float* hp = hc + kTR * rg;
        const float* up = us + ug * 3 * kTU;
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          const float4 ha = *reinterpret_cast<const float4*>(hp);
          const float4 hb = *reinterpret_cast<const float4*>(hp + 4);
          const float hv[kTR] = {ha.x, ha.y, ha.z, ha.w,
                                 hb.x, hb.y, hb.z, hb.w};
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float4 w4 = *reinterpret_cast<const float4*>(up + c * kTU);
            const float wv[kTU] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int i = 0; i < kTU; ++i)
#pragma unroll
              for (int q = 0; q < kTR; ++q)
                acc[c][i][q] = fmaf(hv[q], wv[i], acc[c][i][q]);
          }
          hp += hstride;
          up += UG * 3 * kTU;
        }
        prefetch(t + 1);

#pragma unroll
        for (int q = 0; q < kTR; ++q) {
          const int64_t b = row0 + q;
          float hv[kTU];
#pragma unroll
          for (int i = 0; i < kTU; ++i) {
            const int j = kTU * ug + i;
            const float r = sigmoid_f(acc[0][i][q]);
            const float z = sigmoid_f(acc[1][i][q]);
            const float n = tanhf(xn[i][q] + r * acc[2][i][q]);
            const float zg = a[q] * z;
            const int hi = (j < H ? j : 0) * hstride + kTR * rg + q;
            hv[i] = (1.0f - zg) * hc[hi] + zg * n;
            if (j < H) hn[hi] = hv[i];
          }
          if (b < B) {
            float* o = out + (b * T + t) * H + kTU * ug;
            if (kVec) {
              __stcs(reinterpret_cast<float4*>(o),
                     make_float4(hv[0], hv[1], hv[2], hv[3]));
            } else {
#pragma unroll
              for (int i = 0; i < kTU; ++i)
                if (kTU * ug + i < H) __stcs(o + i, hv[i]);
            }
          }
        }
      }
      __syncthreads();
      cur ^= 1;
    }
  }
}

// Refuses a plan the kernel cannot run: H within what the register
// routes cover, a thread for each (row group, unit group) and at most
// kMaxThreads (the register limit: a thread holds 96 accumulators and 40
// gate inputs across the products, which fit only in the 255 registers of
// 8 warps), and U and h within the opt-in shared memory.
int check(const Plan& p, int H, int cap) {
  if (p.route != kLarge || H > reg::kMaxH || p.groups < 1
      || p.threads < (int64_t)unit_groups(H) * p.groups
      || p.threads > kMaxThreads || smem_bytes(p, H) > cap || p.blocks < 1
      || p.blocks > kMaxBlocks)
    return kInvalid;
  return 0;
}

template <bool kVec>
int launch(const Plan& p, const float* xg, const float* u, const float* att,
           const float* h0, float* out, int B, int T, int H,
           cudaStream_t stream) {
  const int64_t smem = smem_bytes(p, H);
  cudaError_t err = cudaFuncSetAttribute(
      augru_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  augru_kernel<kVec><<<(unsigned int)p.blocks, p.threads, (size_t)smem,
                       stream>>>(xg, u, att, h0, out, B, T, H, p.groups);
  return (int)cudaGetLastError();
}

}  // namespace tile

// ---------------------------------------------------------------------------
// The general route: the previous design (the first port's kernel)
// ---------------------------------------------------------------------------

namespace previous {

constexpr int kRows = 4;        // batch rows a thread's products serve
constexpr int kMaxThreads = 512;

__host__ __device__ __forceinline__ int64_t round4(int64_t n) {
  return (n + 3) & ~int64_t(3);
}

// floats of one block's state: h twice (rows of round4(H)) and the
// partial products (group, slice, row, gate, H)
__host__ __device__ __forceinline__ int64_t state_floats(int H, int groups,
                                                         int splits) {
  return 2 * (int64_t)groups * kRows * round4(H)
         + (int64_t)groups * splits * kRows * 3 * H;
}

// the state where the plan puts it in shared memory, then U
__host__ __forceinline__ int64_t smem_bytes(const Plan& p, int H) {
  return (int64_t)sizeof(float)
         * ((p.state_shared ? state_floats(H, p.groups, p.splits) : 0)
            + (p.u_shared ? round4(3 * (int64_t)H * H) : 0));
}

template <bool kUShared, bool kStateShared>
__global__ void __launch_bounds__(kMaxThreads) augru_kernel(
    const float* __restrict__ xg, const float* __restrict__ u,
    const float* __restrict__ att, const float* __restrict__ h0,
    float* __restrict__ out, float* __restrict__ scratch, int B, int T,
    int H, int groups, int splits) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rows = groups * kRows;
  const int Hs = (int)round4(H);              // h row stride (16-byte rows)
  const int64_t H3 = 3 * (int64_t)H;
  float* su = smem;
  float* hbuf = kStateShared
      ? smem + (kUShared ? round4(H3 * H) : 0)
      : scratch + blockIdx.x * state_floats(H, groups, splits);
  float* part = hbuf + 2 * rows * Hs;
  const int64_t row0 = (int64_t)blockIdx.x * rows;

  if (kUShared) {
    for (int64_t i = threadIdx.x; i < H3 * H; i += blockDim.x) su[i] = u[i];
  }
  const float* U = kUShared ? su : u;
  for (int i = threadIdx.x; i < 2 * rows * Hs; i += blockDim.x) {
    const int r = i / Hs, j = i - r * Hs;
    const int64_t b = row0 + r;
    hbuf[i] = (r < rows && b < B && j < H) ? h0[b * H + j] : 0.0f;
  }
  __syncthreads();

  float* hcur = hbuf;
  float* hnext = hbuf + rows * Hs;
  const int items = groups * splits * H;      // (group, slice, j)
  const int chunks = Hs / 4;

  // x_r, x_z, x_n and att of item `it`'s rows at step t
  auto load = [&](int it, int t, float* xr, float* xz, float* xn,
                  float* a) {
    const int g = it / (splits * H);
    const int rem = it - g * splits * H;
    const int s = rem / H;
    const int j = rem - s * H;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q = s + i * splits;
      const int64_t b = row0 + g * kRows + q;
      if (q < kRows && b < B && t < T) {
        const int64_t bt = b * T + t;
        const float* x = xg + bt * H3;
        xr[i] = x[j];
        xz[i] = x[H + j];
        xn[i] = x[2 * H + j];
        a[i] = att[bt];
      }
    }
  };
  float pr[kRows], pz[kRows], pn[kRows], pa[kRows];  // a step ahead
  if (threadIdx.x < items) load(threadIdx.x, 0, pr, pz, pn, pa);

  for (int t = 0; t < T; ++t) {
    float cr[kRows], cz[kRows], cn[kRows], ca[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      cr[i] = pr[i];
      cz[i] = pz[i];
      cn[i] = pn[i];
      ca[i] = pa[i];
    }
    if (threadIdx.x < items) load(threadIdx.x, t + 1, pr, pz, pn, pa);

    // phase 1: slice s of k (whole float4 chunks), the kRows rows of g
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int g = it / (splits * H);
      const int rem = it - g * splits * H;
      const int s = rem / H;
      const int j = rem - s * H;
      const int kb = 4 * ((s * chunks) / splits);
      const int ke = min(H, 4 * (((s + 1) * chunks) / splits));
      const float* hg = hcur + g * kRows * Hs;
      float ar[kRows], az[kRows], an[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) ar[q] = az[q] = an[q] = 0.0f;
      int k = kb;
      for (; k + 4 <= ke; k += 4) {
        float4 h4[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          h4[q] = *reinterpret_cast<const float4*>(hg + q * Hs + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* uk = U + (k + kk) * H3;
          const float ur = uk[j], uz = uk[H + j], un = uk[2 * H + j];
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const float hk = kk == 0 ? h4[q].x : kk == 1 ? h4[q].y
                           : kk == 2 ? h4[q].z : h4[q].w;
            ar[q] = fmaf(hk, ur, ar[q]);
            az[q] = fmaf(hk, uz, az[q]);
            an[q] = fmaf(hk, un, an[q]);
          }
        }
      }
      for (; k < ke; ++k) {                   // the last, partial chunk
        const float* uk = U + k * H3;
        const float ur = uk[j], uz = uk[H + j], un = uk[2 * H + j];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float hk = hg[q * Hs + k];
          ar[q] = fmaf(hk, ur, ar[q]);
          az[q] = fmaf(hk, uz, az[q]);
          an[q] = fmaf(hk, un, an[q]);
        }
      }
      float* p = part + ((int64_t)(g * splits + s) * kRows) * 3 * H + j;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        p[(q * 3 + 0) * H] = ar[q];
        p[(q * 3 + 1) * H] = az[q];
        p[(q * 3 + 2) * H] = an[q];
      }
    }
    __syncthreads();

    // phase 2: rows s, s + splits, ... of g; the slices summed in order
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int g = it / (splits * H);
      const int rem = it - g * splits * H;
      const int s = rem / H;
      const int j = rem - s * H;
      float xr[kRows], xz[kRows], xn[kRows], a[kRows];
      if (it == threadIdx.x) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          xr[i] = cr[i];
          xz[i] = cz[i];
          xn[i] = cn[i];
          a[i] = ca[i];
        }
      } else {
        load(it, t, xr, xz, xn, a);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q = s + i * splits;
        const int64_t b = row0 + g * kRows + q;
        if (q >= kRows || b >= B) break;
        float hu[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float acc = 0.0f;
          for (int s2 = 0; s2 < splits; ++s2)
            acc += part[((int64_t)((g * splits + s2) * kRows + q) * 3 + c)
                        * H + j];
          hu[c] = acc;
        }
        const float r = sigmoid_f(xr[i] + hu[0]);
        const float z = sigmoid_f(xz[i] + hu[1]);
        const float n = tanhf(xn[i] + r * hu[2]);
        const float zg = a[i] * z;
        const int hi = (g * kRows + q) * Hs + j;
        const float h = (1.0f - zg) * hcur[hi] + zg * n;
        hnext[hi] = h;
        out[(b * T + t) * H + j] = h;
      }
    }
    __syncthreads();
    float* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }
}

// Refuses a plan the kernel cannot run: groups * splits must be 4 (or 1
// and 1), U in shared memory only beside the state, that within the
// device's opt-in limit, a block for each kRows * groups rows, and
// otherwise a scratch slice of the state for every block.
int check(const Plan& p, int B, int H, int cap, const void* scratch) {
  const bool split_ok = (p.groups == 1 && p.splits == 1)
                        || ((p.groups == 1 || p.groups == 2 || p.groups == 4)
                            && p.groups * p.splits == 4);
  if (p.route != kGeneral || !split_ok || (p.u_shared && !p.state_shared)
      || smem_bytes(p, H) > cap || p.threads < 1 || p.threads > kMaxThreads
      || p.blocks < ceil_div(B, kRows * p.groups) || p.blocks > kMaxBlocks)
    return kInvalid;
  if (!p.state_shared
      && (scratch == nullptr
          || p.scratch_floats < p.blocks * state_floats(H, p.groups,
                                                        p.splits)))
    return kInvalid;
  return 0;
}

template <bool kU, bool kS>
int launch(const Plan& p, const float* xg, const float* u, const float* att,
           const float* h0, float* out, float* scratch, int B, int T, int H,
           cudaStream_t stream) {
  const int64_t smem = smem_bytes(p, H);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        augru_kernel<kU, kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  augru_kernel<kU, kS><<<(unsigned int)p.blocks, p.threads, (size_t)smem,
                         stream>>>(xg, u, att, h0, out, scratch, B, T, H,
                                   p.groups, p.splits);
  return (int)cudaGetLastError();
}

}  // namespace previous

}  // namespace

// The device's SM count and opt-in shared memory per block, the inputs of
// kernel.py::plan; returns a CUDA error code (0 on success).
extern "C" int augru_device_limits(int* sms, int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return max_smem_optin(max_smem);
}

// Launches the small or the large route on `stream` and returns a CUDA
// error code (0 on success; cudaErrorInvalidValue for a plan that does not
// fit).  All operands are contiguous float32: xg (B, T, 3H), u (H, 3H),
// att (B, T), h0 (B, H), out (B, T, H).
extern "C" int augru_launch(const void* xg, const void* u, const void* att,
                            const void* h0, void* out, int B, int T, int H,
                            const AugruPlan* plan, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  const Plan& p = *plan;
  int cap = 0;
  int err = max_smem_optin(&cap);
  if (err) return err;
  err = p.route == kLarge ? tile::check(p, H, cap) : reg::check(p, H, cap);
  if (err) return err;
  auto* s = (cudaStream_t)stream;
  const auto* x = (const float*)xg;
  const auto* w = (const float*)u;
  const auto* a = (const float*)att;
  const auto* h = (const float*)h0;
  auto* o = (float*)out;
  const bool vec = H % 4 == 0 && ((uintptr_t)xg | (uintptr_t)out) % 16 == 0;
  if (p.route == kLarge)
    return vec ? tile::launch<true>(p, x, w, a, h, o, B, T, H, s)
               : tile::launch<false>(p, x, w, a, h, o, B, T, H, s);
  switch (p.rows) {
    case 1:
      return reg::launch<1>(p, x, w, a, h, o, B, T, H, s);
    case 2:
      return reg::launch<2>(p, x, w, a, h, o, B, T, H, s);
    default:
      return reg::launch<4>(p, x, w, a, h, o, B, T, H, s);
  }
}

// Launches the previous design (the general route) with the same operands;
// scratch holds plan->scratch_floats floats when the state does not fit in
// shared memory (may be null otherwise).
extern "C" int augru_previous_launch(const void* xg, const void* u,
                                     const void* att, const void* h0,
                                     void* out, void* scratch, int B, int T,
                                     int H, const AugruPlan* plan,
                                     void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  const Plan& p = *plan;
  int cap = 0;
  int err = max_smem_optin(&cap);
  if (err) return err;
  err = previous::check(p, B, H, cap, scratch);
  if (err) return err;
  auto* s = (cudaStream_t)stream;
  const auto* x = (const float*)xg;
  const auto* w = (const float*)u;
  const auto* a = (const float*)att;
  const auto* h = (const float*)h0;
  auto* o = (float*)out;
  auto* sc = (float*)scratch;
  if (p.u_shared)
    return previous::launch<true, true>(p, x, w, a, h, o, sc, B, T, H, s);
  if (p.state_shared)
    return previous::launch<false, true>(p, x, w, a, h, o, sc, B, T, H, s);
  return previous::launch<false, false>(p, x, w, a, h, o, sc, B, T, H, s);
}
