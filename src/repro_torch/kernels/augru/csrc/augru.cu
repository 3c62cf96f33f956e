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
// Design: one persistent block per group of kRows * groups batch rows runs
// all T steps.  U sits in dynamic shared memory for the whole scan when it
// fits (140 KB at H = 108, 196 KB at H = 128; opted in with
// cudaFuncSetAttribute), else the same code reads it from global memory,
// where it stays L2-resident.  h is double-buffered in shared memory (in a
// global scratch slice of the block when even that does not fit).  Each
// step has two phases, one __syncthreads after each:
//
//   1. thread (group g, slice s, unit j) forms the partial products of
//      hU[:, j], hU[:, H+j], hU[:, 2H+j] for the kRows rows of g over the
//      s-th of `splits` slices of k, by a fixed-order fmaf loop (each U word
//      it loads serves kRows rows; h is read as float4), into shared memory;
//   2. the same thread sums the slices in order for its rows (s, s +
//      splits, ...) and applies the gates, expf/tanhf in full float32.
//
// Splitting k puts 4H threads on the kRows rows of a small batch (one
// block per SM at B <= 4 * SMs), so more warps hide the latency of each
// step's dependent chain; a large batch takes 4 groups of rows and one
// slice.  Each thread's gate inputs for step t+1 are loaded during step t.
//
// Bound: 2*B*T*H*3H float32 operations for the products (3.58 GFLOP at
// (512, 100, 108), 53.5 us at 67 TFLOP/s) against reading x_gates once
// and writing the states once (89 MB, 26.6 us at 3.35 TB/s): the
// operations bound it.  This first version feeds the FMA units from shared
// memory (3 words of U per 3 * kRows FMAs) and pays two barriers and a
// serial gate chain per step, so latency, not the float32 peak, sets its
// time; mma/wgmma on 16-row tiles and TMA are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;        // batch rows a thread's products serve
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

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

struct Plan {
  int groups, splits, u_shared, state_shared;
  int64_t blocks;
  size_t smem;
};

// Rows per block and k slices for B rows on this device: at most one
// 4-row block per SM gets 4 slices; larger batches take 2 or 4 row groups
// (splits * groups == 4, so a block has 4H items).  U and the state go to
// shared memory as far as they fit.
int make_plan(int B, int H, Plan* p) {
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t per_wave = (int64_t)kRows * sms;
  p->groups = B <= per_wave ? 1 : B <= 2 * per_wave ? 2 : 4;
  p->splits = 4 / p->groups;
  const size_t cap = (size_t)max_smem;
  const size_t u_bytes = sizeof(float) * round4(3 * (int64_t)H * H);
  auto state_bytes = [&]() {
    return sizeof(float) * state_floats(H, p->groups, p->splits);
  };
  if (state_bytes() > cap) p->groups = p->splits = 1;
  p->state_shared = state_bytes() <= cap;
  p->u_shared = p->state_shared && u_bytes + state_bytes() <= cap;
  p->smem = (p->state_shared ? state_bytes() : 0)
            + (p->u_shared ? u_bytes : 0);
  const int rows = p->groups * kRows;
  p->blocks = ((int64_t)B + rows - 1) / rows;
  return 0;
}

template <bool kU, bool kS>
int launch(const Plan& p, const float* xg, const float* u, const float* att,
           const float* h0, float* out, float* scratch, int B, int T, int H,
           cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        augru_kernel<kU, kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = ((p.groups * p.splits * H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  augru_kernel<kU, kS><<<(unsigned int)p.blocks, threads, p.smem, stream>>>(
      xg, u, att, h0, out, scratch, B, T, H, p.groups, p.splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of global scratch the launch below needs for (B, H) on the
// current device (0 when the state fits in shared memory), or -1 with the
// CUDA error code in *err.
extern "C" int64_t augru_scratch_floats(int B, int H, int* err) {
  Plan p;
  *err = B > 0 && H > 0 ? make_plan(B, H, &p) : 0;
  if (*err) return -1;
  if (B <= 0 || H <= 0 || p.state_shared) return 0;
  return p.blocks * state_floats(H, p.groups, p.splits);
}

// Launches on `stream` and returns a CUDA error code (0 on success).  All
// operands are contiguous float32: xg (B, T, 3H), u (H, 3H), att (B, T),
// h0 (B, H), out (B, T, H); scratch holds augru_scratch_floats(B, H)
// floats (may be null when that is 0).
extern "C" int augru_launch(const void* xg, const void* u, const void* att,
                            const void* h0, void* out, void* scratch, int B,
                            int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  Plan p;
  const int err = make_plan(B, H, &p);
  if (err) return err;
  if (!p.state_shared && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  auto* s = (cudaStream_t)stream;
  const auto* x = (const float*)xg;
  const auto* w = (const float*)u;
  const auto* a = (const float*)att;
  const auto* h = (const float*)h0;
  auto* o = (float*)out;
  auto* sc = (float*)scratch;
  if (p.u_shared) return launch<true, true>(p, x, w, a, h, o, sc, B, T, H, s);
  if (p.state_shared)
    return launch<false, true>(p, x, w, a, h, o, sc, B, T, H, s);
  return launch<false, false>(p, x, w, a, h, o, sc, B, T, H, s);
}
