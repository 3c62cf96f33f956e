// Backward of the AUGRU scan on Hopper (sm_90a): the gradients of
// augru.cu's recurrence with respect to its gates, attention and initial
// state.
//
// The reference's Pallas kernel (src/repro/kernels/augru/kernel.py,
// augru_pallas) has no backward: off the TPU its op runs the plain
// augru_ref, and jax.grad differentiates that lax.scan.  On the card the
// port's forward is the hand-written kernel, so its gradient is a kernel
// too.  With the forward's step (U: (H, 3H), gates r | z | n)
//
//   hU = h_{t-1} U,  r = sigmoid(x_r + hU_r),  z = sigmoid(x_z + hU_z),
//   n = tanh(x_n + r hU_n),  zg = a_t z,  h_t = (1 - zg) h_{t-1} + zg n,
//
// and dh the gradient reaching h_t (its output's gradient plus what step
// t + 1 sends back), one reverse step forms
//
//   dn = dh zg,  dzg = dh (n - h_{t-1}),  datt_t = sum_H dzg z,  dz = dzg a
//   dx_n = dn (1 - n^2),  dx_z = dz z (1 - z),  dx_r = dx_n hU_n r (1 - r)
//   dhU = [dx_r, dx_z, dx_n r]
//   dh_{t-1} = dh (1 - zg) + dhU U^T
//
// and writes dx_gates[:, t] = [dx_r, dx_z, dx_n], dhU's n section (dx_n r)
// and datt[:, t]; after t = 0 it writes dh0.  The wrapper forms
// du = sum_t h_{t-1}^T dhU as one matrix product over (B T, H)^T x
// (B T, 3H) afterwards, as the reference leaves that product to XLA.
//
// It recomputes hU, r, z and n from the saved states (out[:, t - 1], or h0
// at t = 0) instead of keeping them from the forward.
//
// Layout (the general route's structure: U in shared memory): a block
// serves R batch rows at once, TP threads a row (a multiple of 32, so a
// row's threads start on a warp), and walks over groups of R rows.  U sits
// in dynamic shared memory with an odd row stride (3H | 1) when it fits
// (H up to 136; 140 KB at DIEN's H = 108): the forward product reads
// U[k][j] across j and the transposed product U[k][j] across k, and an odd
// stride keeps both free of bank conflicts; otherwise the same code reads
// U from global memory (L2).  A row's h_{t-1}, dh, zg, the datt terms and
// dhU (7H floats) sit in shared memory.  Each step has two phases, one
// barrier after each: (1) thread (row, unit j) forms hU[:, j] by a
// fixed-order fmaf loop over k, the gates and the gradients above; (2)
// thread (row, unit k) forms dh_{t-1}[k] = dh (1 - zg) + sum_j dhU[j]
// U[k][j] in a fixed order, loads h_{t-2}[k] for the next step, and the
// row's first warp sums the datt terms by a fixed shuffle tree.  No
// atomics: two launches on the same inputs give the same bits.
//
// Bound: 4 B T H 3H float32 operations (two (rows, H) x (H, 3H) products a
// step) against reading the gates, states and output gradients once and
// writing dx_gates, dhU_n, datt and dh0 once.  At DIEN's (512, 100, 108)
// 7.2e9 operations (0.11 ms at 67 TFLOP/s) against 0.13 GB (0.04 ms at
// 3.35 TB/s): operations bound it; as in the forward, a step's chain of
// dependent products, gates and barriers keeps it far from that bound.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kInvalid = (int)cudaErrorInvalidValue;
constexpr int kMaxThreads = 512;   // 80 registers a thread at most

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kUShared>
__global__ void __launch_bounds__(kMaxThreads) augru_backward_kernel(
    const float* __restrict__ x_gates, const float* __restrict__ u,
    const float* __restrict__ att, const float* __restrict__ h0,
    const float* __restrict__ out, const float* __restrict__ dout,
    float* __restrict__ dx_gates, float* __restrict__ dhu_n,
    float* __restrict__ datt, float* __restrict__ dh0, int B, int T, int H,
    int R, int TP, int ustride) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  float* U_sh = smem;
  float* st = smem + (kUShared ? (size_t)H * ustride : 0);
  const int r = threadIdx.x / TP, lane = threadIdx.x - r * TP;
  float* hprev = st + (size_t)r * 7 * H;
  float* dh = hprev + H;
  float* zg = dh + H;
  float* red = zg + H;
  float* dhu = red + H;
  if (kUShared) {
    for (int64_t idx = threadIdx.x; idx < (int64_t)H * H3; idx += blockDim.x) {
      const int64_t kk = idx / H3, j = idx - kk * H3;
      U_sh[kk * ustride + j] = u[idx];
    }
  }
  const float* U = kUShared ? U_sh : u;
  const int us = kUShared ? ustride : H3;
  const int64_t n_groups = ((int64_t)B + R - 1) / R;

  for (int64_t grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int64_t b = grp * R + r;
    const bool valid = r < R && b < B;
    for (int j = lane; j < H; j += TP) {
      dh[j] = 0.0f;
      hprev[j] = !valid ? 0.0f
                 : T >= 2 ? out[(b * T + T - 2) * H + j] : h0[b * H + j];
    }
    __syncthreads();
    for (int t = T - 1; t >= 0; --t) {
      const int64_t bt = b * T + t;
      const float a = valid ? att[bt] : 0.0f;
      // phase 1: hU, the gates and their gradients for unit j
      for (int j = lane; j < H; j += TP) {
        float hr = 0.0f, hz = 0.0f, hn = 0.0f;
        for (int kk = 0; kk < H; ++kk) {
          const float hk = hprev[kk];
          const float* urow = U + (int64_t)kk * us;
          hr = fmaf(hk, urow[j], hr);
          hz = fmaf(hk, urow[H + j], hz);
          hn = fmaf(hk, urow[2 * H + j], hn);
        }
        if (valid) {
          const float* xg = x_gates + bt * H3;
          const float rr = sigmoid_f(xg[j] + hr);
          const float zz = sigmoid_f(xg[H + j] + hz);
          const float nn = tanhf(xg[2 * H + j] + rr * hn);
          const float zgj = a * zz;
          const float d = dh[j] + dout[bt * H + j];
          const float dzg = d * (nn - hprev[j]);
          const float dxn = d * zgj * (1.0f - nn * nn);
          const float dxz = dzg * a * zz * (1.0f - zz);
          const float dxr = dxn * hn * rr * (1.0f - rr);
          float* dxg = dx_gates + bt * H3;
          dxg[j] = dxr;
          dxg[H + j] = dxz;
          dxg[2 * H + j] = dxn;
          dhu_n[bt * H + j] = dxn * rr;
          dhu[j] = dxr;
          dhu[H + j] = dxz;
          dhu[2 * H + j] = dxn * rr;
          red[j] = dzg * zz;
          dh[j] = d;
          zg[j] = zgj;
        } else {
          dhu[j] = dhu[H + j] = dhu[2 * H + j] = 0.0f;
          red[j] = dh[j] = zg[j] = 0.0f;
        }
      }
      __syncthreads();
      // phase 2: dh_{t-1}[k], the next step's h_{t-2}, datt
      for (int kk = lane; kk < H; kk += TP) {
        const float* urow = U + (int64_t)kk * us;
        float s = 0.0f;
        for (int j = 0; j < H3; ++j) s = fmaf(dhu[j], urow[j], s);
        dh[kk] = dh[kk] * (1.0f - zg[kk]) + s;
        if (t >= 1)
          hprev[kk] = !valid ? 0.0f
                      : t >= 2 ? out[(b * T + t - 2) * H + kk]
                               : h0[b * H + kk];
      }
      if (lane < 32) {
        float part = 0.0f;
        for (int j = lane; j < H; j += 32) part += red[j];
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, w);
        if (lane == 0 && valid) datt[bt] = part;
      }
      __syncthreads();
    }
    if (valid)
      for (int kk = lane; kk < H; kk += TP) dh0[b * H + kk] = dh[kk];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// All float32, contiguous: x_gates (B, T, 3H), u (H, 3H), att (B, T), h0
// (B, H), out (B, T, H) the forward's states, dout (B, T, H) their
// gradient; writes dx_gates (B, T, 3H), dhu_n (B, T, H), datt (B, T) and
// dh0 (B, H).  rows: R batch rows a block; threads_per_row: TP, a multiple
// of 32; blocks: the grid (a block walks over groups of R rows);
// u_shared: U in shared memory; at most 512 threads a block.  Returns the CUDA error of the launch (0
// on success); a plan the kernel cannot run returns cudaErrorInvalidValue
// without launching.
int augru_backward_launch(const float* x_gates, const float* u,
                          const float* att, const float* h0,
                          const float* out, const float* dout,
                          float* dx_gates, float* dhu_n, float* datt,
                          float* dh0, int B, int T, int H, int rows,
                          int threads_per_row, int blocks, int u_shared,
                          void* stream) {
  if (B < 1 || T < 1 || H < 1 || rows < 1 || blocks < 1
      || threads_per_row < 32 || threads_per_row % 32
      || (int64_t)rows * threads_per_row > kMaxThreads)
    return kInvalid;
  const int ustride = (3 * H) | 1;
  const size_t state = sizeof(float) * (size_t)rows * 7 * H;
  const size_t smem = state + (u_shared ? sizeof(float) * (size_t)H * ustride
                                        : 0);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = rows * threads_per_row;
  if (u_shared) {
    err = cudaFuncSetAttribute(augru_backward_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    augru_backward_kernel<true><<<blocks, threads, smem, s>>>(
        x_gates, u, att, h0, out, dout, dx_gates, dhu_n, datt, dh0, B, T, H,
        rows, threads_per_row, ustride);
  } else {
    err = cudaFuncSetAttribute(augru_backward_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    augru_backward_kernel<false><<<blocks, threads, smem, s>>>(
        x_gates, u, att, h0, out, dout, dx_gates, dhu_n, datt, dh0, B, T, H,
        rows, threads_per_row, ustride);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
