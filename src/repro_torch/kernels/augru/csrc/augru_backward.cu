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
// It recomputes hU, r, z and n from the saved states (out[:, t - 1], or h0
// at t = 0) instead of keeping them from the forward.
//
// Bound: a step's two products, hU = h_{t-1} U and dhU U^T, are 12 B T H^2
// float32 operations in this kernel; du's product after it adds 6 B T H^2.
// The bytes are 4 B T (9 H + 2): the gates, states, attention and output
// gradients read once, dx_gates, dhU_n and datt written once.  At DIEN's
// (65,536, 100, 108): 13.69 ms of operations at 67 TFLOP/s in the kernel
// and 6.85 ms in du's product, against 7.6 ms of bytes at 3.35 TB/s:
// operations bound it.  At (512, 100, 108) the same split gives 0.107 +
// 0.054 ms, and a step's chain of products, gates and barriers sets the
// time instead.
//
// Routes, chosen by shape before the launch in kernel.py::backward_plan;
// the entry points derive the shared memory and refuse a plan that does
// not fit.
//
// Route "tile" (large batches, from kernel.BACKWARD_TILE_ROWS_PER_SM rows
// per SM; H up to 128 on the H100, where U, one 8-row group and its staged
// inputs still fit in shared memory): tile::backward_kernel.  One
// persistent block per SM keeps U in shared memory and walks over tiles
// of 8 * RG batch rows (RG = 4 at DIEN's H = 108: 108 threads, one warp on
// each of the SM's 4 schedulers).  Thread (row group rg, unit group ug)
// owns 8 rows and the 4 indices 4 ug .. 4 ug + 3.  Phase 1 forms hU for
// its 8 rows x 4 units x 3 gates over all k (96 FMAs per 5 float4 loads
// from shared memory: h's rows broadcast, U's three words of each unit),
// recomputes the gates and forms the gradients of its 32 (row, unit)
// pairs with nothing to reduce but datt.  Phase 2 forms dh_{t-1} for the
// same 8 rows and the same 4 indices, now as k, over all 3H columns: an
// 8-row x 4-k outer product, 384 FMAs per 36 float4 loads (dhU broadcast,
// U by the thread's 4 k rows).  Phase 2's k are phase 1's units, so dh
// and dh (1 - zg) never leave the thread (through phase 1's products they
// wait in its own dhU slots, which no one reads before phase 2, so the
// thread holds 96 accumulators and little else there); only h_{t-1} and
// dhU pass between threads.  The previous design did 3 FMAs per 4 shared
// loads in phase 1 and 1 per 2 in phase 2: shared memory's 32 words a
// clock against 128 FP32 lanes capped it near an eighth of the FP32
// peak.  A row stride that is a multiple of 4 words keeps rows 4 apart on
// the same 16 banks, so each group of 4 k rows (U, h) and each 8-row
// group (dhU) is padded by 4 words instead: the float4 accesses of 8
// neighbouring unit groups fall on 8 different bank quads.  The next
// step's inputs and state are asked of L2 a step ahead; x_n, dout and att
// are staged into shared memory by cp.async during phase 2, h_{t-2} is
// loaded into the single h buffer during phase 2 (which does not read h),
// and x_r and x_z start the r and z sums at phase 1.  datt's row sums run
// in a fixed order: the per-thread partials go through shared memory,
// then one thread a row sums them by unit group.  kVec (H % 4 == 0 and
// 16-byte aligned operands): gates, states and gradients move as float4;
// otherwise element by element, with U and h zero beyond H so that no
// product needs a guard.
//
// Route "rows" (small batches, and H above the tile route's): the
// previous design, rowwise::backward_kernel, kept as the kernel of record
// there and to time it beside the tile route.  A block serves R batch
// rows at once, TP threads a row, and walks over groups of R rows; U sits
// in dynamic shared memory at an odd row stride (3H | 1) when it fits (H
// up to 136), else the same code reads it from global memory (L2).  A
// row's h_{t-1}, dh, zg, the datt terms and dhU (7H floats) sit in shared
// memory; thread (row, unit j) forms hU[:, j] and the gradients, then
// thread (row, k) forms dh_{t-1}[k], one barrier after each phase.
//
// Both routes sum in a fixed order without atomics (two launches on the
// same inputs give the same bits); products are float32 fmaf on the CUDA
// cores, never TF32 or the tensor cores; the build's -fmad=false keeps
// every other multiply and add unfused.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kInvalid = (int)cudaErrorInvalidValue;

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

// Asynchronous copies from device to shared memory (sm_80 and later):
// `bytes` (4 or 16) from src, or zeros where `valid` is false (src is then
// not read); complete after cp_async_wait_all in the issuing thread.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---------------------------------------------------------------------------
// The tile route: register-tiled outer products, U resident
// ---------------------------------------------------------------------------

namespace tile {

constexpr int kTR = 8;            // rows a thread computes
constexpr int kTU = 4;            // units (phase 1) and k (phase 2) a thread
constexpr int kMaxThreads = 256;  // 8 warps: 255 registers a thread

__host__ __device__ __forceinline__ int unit_groups(int H) {
  return (H + kTU - 1) / kTU;
}

// The block's shared memory, in floats, for UG unit groups and `rows` rows
// a tile: U as 4-k-row groups of [k][unit group][r0..3 z0..3 n0..3] (k and
// units zero beyond H) and h_{t-1} as 4-k-row groups of [k][row], each
// group padded by 4 words; dhU as [row][unit group][r0..3 z0..3 n0..3],
// each 8-row group padded by 4 words; the step's x_n and dout as
// [row][x_n | dout][unit], staged a phase ahead; datt's partials as
// [row][unit group] at an odd stride; the step's att as [row].
struct Layout {
  int ug, rows;
  __host__ __device__ Layout(int H, int rows_)
      : ug(unit_groups(H)), rows(rows_) {}
  __host__ __device__ int u_row() const { return 3 * kTU * ug; }
  __host__ __device__ int u_group() const { return 4 * u_row() + 4; }
  __host__ __device__ int h_group() const { return 4 * rows + 4; }
  __host__ __device__ int d_group() const { return kTR * u_row() + 4; }
  __host__ __device__ int p_stride() const { return ug | 1; }
  __host__ __device__ int64_t h_offset() const {
    return (int64_t)ug * u_group();
  }
  __host__ __device__ int64_t d_offset() const {
    return h_offset() + (int64_t)ug * h_group();
  }
  __host__ __device__ int s_row() const { return 2 * kTU * ug; }
  __host__ __device__ int64_t s_offset() const {
    return d_offset() + (int64_t)(rows / kTR) * d_group();
  }
  __host__ __device__ int64_t p_offset() const {
    return s_offset() + (int64_t)rows * s_row();
  }
  __host__ __device__ int64_t a_offset() const {
    return p_offset() + (int64_t)rows * p_stride();
  }
  __host__ __device__ int64_t floats() const { return a_offset() + rows; }
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// One persistent block per SM walks over tiles of 8 * RG rows, each from
// t = T - 1 down to 0 (see the top of the file).  A thread carries dh for
// its 32 (row, k) pairs from step to step; through phase 1's products it
// parks them in its own dhU slots.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1) backward_kernel(
    const float* __restrict__ xg, const float* __restrict__ u,
    const float* __restrict__ att, const float* __restrict__ h0,
    const float* __restrict__ out, const float* __restrict__ dout,
    float* __restrict__ dxg, float* __restrict__ dhu_n,
    float* __restrict__ datt, float* __restrict__ dh0, int B, int T, int H,
    int RG) {
  extern __shared__ float4 smem4[];
  const Layout L(H, kTR * RG);
  const int UG = L.ug, rows = L.rows;
  const int UR = L.u_row(), UGS = L.u_group();
  const int HGS = L.h_group(), PS = L.p_stride();
  float* us = reinterpret_cast<float*>(smem4);
  float* hs = us + L.h_offset();
  float* ps = us + L.p_offset();
  float* as = us + L.a_offset();
  const int SR = L.s_row();
  const int tid = threadIdx.x;
  const int ug = tid % UG;
  const int rg = tid / UG;
  const int64_t H3 = 3 * (int64_t)H;
  const int j0 = kTU * ug;          // this thread's first unit (and k)

  for (int64_t i = tid; i < (int64_t)4 * UG * UR; i += blockDim.x) {
    const int k = (int)(i / UR), rem = (int)(i % UR);
    const int g = (rem % (3 * kTU)) / kTU;
    const int j = kTU * (rem / (3 * kTU)) + rem % kTU;
    us[(k >> 2) * UGS + (k & 3) * UR + rem] =
        k < H && j < H ? u[k * H3 + g * H + j] : 0.0f;
  }
  // this thread's h_{t-1} (k = j0 .. j0 + 3, its rows), its row group's
  // dhU rows and its own dhU slots (its rows, units j0 .. j0 + 3)
  float* hmine = hs + ug * HGS + kTR * rg;
  const float* drows = us + L.d_offset() + (int64_t)rg * L.d_group();
  float* dmine = us + L.d_offset() + (int64_t)rg * L.d_group() + 3 * kTU * ug;
  // this thread's staged x_n (dout at + kTU * UG) for its first row
  float* smine = us + L.s_offset() + (int64_t)kTR * rg * SR + kTU * ug;

  const int64_t tiles = ceil_div(B, rows);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * rows + kTR * rg;    // this thread's rows
    // a thread whose rows all lie beyond B computes nothing; its row
    // group's buffers are read by no one
    const bool active = tid < UG * RG && row0 < B;

    // 4 floats from p (units j0 .. j0 + 3, zero beyond H)
    auto load4 = [&](const float* p, float (&v)[kTU]) {
      if (kVec) {
        const float4 w = *reinterpret_cast<const float4*>(p);
        v[0] = w.x;
        v[1] = w.y;
        v[2] = w.z;
        v[3] = w.w;
      } else {
#pragma unroll
        for (int i = 0; i < kTU; ++i) v[i] = j0 + i < H ? p[i] : 0.0f;
      }
    };
    auto prefetch = [&](int t) {
#pragma unroll
      for (int q = 0; q < kTR; ++q) {
        const int64_t b = row0 + q;
        if (b >= B) break;
        const float* x = xg + (b * T + t) * H3 + j0;
        prefetch_l2(x);
        prefetch_l2(x + H);
        prefetch_l2(x + 2 * H);
        prefetch_l2(dout + (b * T + t) * H + j0);
        prefetch_l2(att + b * T + t);
        if (t >= 1) prefetch_l2(out + (b * T + t - 1) * H + j0);
      }
    };
    // step t's x_n, dout and att into shared memory, asynchronously: each
    // thread its rows' x_n and dout, att by the first threads of a row group
    auto stage = [&](int t) {
#pragma unroll
      for (int q = 0; q < kTR; ++q) {
        const int64_t b = row0 + q;
        const float* x = xg + (b * T + t) * H3 + 2 * H + j0;
        const float* o = dout + (b * T + t) * H + j0;
        float* sx = smine + q * SR;
        if (kVec) {
          cp_async<16>(sx, b < B ? x : xg, b < B);
          cp_async<16>(sx + kTU * UG, b < B ? o : dout, b < B);
        } else {
#pragma unroll
          for (int i = 0; i < kTU; ++i) {
            const bool v = b < B && j0 + i < H;
            cp_async<4>(sx + i, v ? x + i : xg, v);
            cp_async<4>(sx + kTU * UG + i, v ? o + i : dout, v);
          }
        }
      }
      for (int q = ug; q < kTR; q += UG) {
        const int64_t b = row0 + q;
        cp_async<4>(as + kTR * rg + q, b < B ? att + b * T + t : att, b < B);
      }
    };
    // h_{t-1} of this thread's 8 rows and 4 k into registers (step t - 1's
    // output, h0 at t = 0), then into shared memory
    float hv[kTU][kTR];
    auto load_state = [&](int t) {
#pragma unroll
      for (int q = 0; q < kTR; ++q) {
        const int64_t b = row0 + q;
        float v[kTU] = {};
        if (b < B)
          load4(t >= 1 ? out + (b * T + t - 1) * H + j0 : h0 + b * H + j0, v);
#pragma unroll
        for (int i = 0; i < kTU; ++i) hv[i][q] = v[i];
      }
    };
    auto store_state = [&]() {
#pragma unroll
      for (int i = 0; i < kTU; ++i) {
        sts4(hmine + i * rows, hv[i][0], hv[i][1], hv[i][2], hv[i][3]);
        sts4(hmine + i * rows + 4, hv[i][4], hv[i][5], hv[i][6], hv[i][7]);
      }
    };

    float dh[kTU][kTR];
#pragma unroll
    for (int i = 0; i < kTU; ++i)
#pragma unroll
      for (int q = 0; q < kTR; ++q) dh[i][q] = 0.0f;
    if (active) {
      stage(T - 1);
      load_state(T - 1);
      store_state();
      cp_async_wait_all();
    }
    // (the last tile's final barrier has passed: nothing reads hs now)
    __syncthreads();

#pragma unroll 1
    for (int t = T - 1; t >= 0; --t) {
      // phase 1: hU, the gates and their gradients for units j0 .. j0 + 3
      if (active) {
        // x_r and x_z start the r and z sums, as in the forward; dh waits
        // in this thread's dhU slots (no one reads them before phase 2)
        // through the products
        float acc[3][kTU][kTR];
#pragma unroll
        for (int q = 0; q < kTR; ++q) {
          const int64_t b = row0 + q;
          float v[2][kTU] = {};
          if (b < B) {
            const float* x = xg + (b * T + t) * H3 + j0;
            load4(x, v[0]);
            load4(x + H, v[1]);
          }
#pragma unroll
          for (int i = 0; i < kTU; ++i) {
            acc[0][i][q] = v[0][i];
            acc[1][i][q] = v[1][i];
            acc[2][i][q] = 0.0f;
          }
        }
        if (t >= 1) prefetch(t - 1);
#pragma unroll
        for (int q = 0; q < kTR; ++q)
          sts4(dmine + q * UR, dh[0][q], dh[1][q], dh[2][q], dh[3][q]);
        const float* hp = hs + kTR * rg;
        const float* up = us + kTU * 3 * ug;
#pragma unroll 1
        for (int k4 = 0; k4 < UG; ++k4) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 ha = lds4(hp + kk * rows);
            const float4 hb = lds4(hp + kk * rows + 4);
            const float h8[kTR] = {ha.x, ha.y, ha.z, ha.w,
                                   hb.x, hb.y, hb.z, hb.w};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float4 w4 = lds4(up + kk * UR + c * kTU);
              const float w[kTU] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
              for (int i = 0; i < kTU; ++i)
#pragma unroll
                for (int q = 0; q < kTR; ++q)
                  acc[c][i][q] = fmaf(h8[q], w[i], acc[c][i][q]);
            }
          }
          hp += HGS;
          up += UGS;
        }

        // the gates and their gradients, row by row: each row's dhU goes
        // to this thread's slots, its outputs to device memory, and dh
        // becomes dh (1 - zg), phase 2's starting sum
#pragma unroll
        for (int q = 0; q < kTR; ++q) {
          const int64_t b = row0 + q;
          const float4 x4 = lds4(smine + q * SR);
          const float4 o4 = lds4(smine + q * SR + kTU * UG);
          const float xn[kTU] = {x4.x, x4.y, x4.z, x4.w};
          const float go[kTU] = {o4.x, o4.y, o4.z, o4.w};
          const float a = as[kTR * rg + q];
          const float4 parked = lds4(dmine + q * UR);
          const float dq[kTU] = {parked.x, parked.y, parked.z, parked.w};
          float dr[kTU], dz[kTU], dn[kTU], dnr[kTU], part = 0.0f;
#pragma unroll
          for (int i = 0; i < kTU; ++i) {
            const float rr = sigmoid_f(acc[0][i][q]);
            const float zz = sigmoid_f(acc[1][i][q]);
            const float hn = acc[2][i][q];
            const float nn = tanhf(xn[i] + rr * hn);
            const float zgj = a * zz;
            const float d = dq[i] + go[i];   // the gradient reaching h_t
            const float dzg = d * (nn - hmine[i * rows + q]);
            const float dxn = d * zgj * (1.0f - nn * nn);
            const float dxz = dzg * a * zz * (1.0f - zz);
            dr[i] = dxn * hn * rr * (1.0f - rr);
            dz[i] = dxz;
            dn[i] = dxn;
            dnr[i] = dxn * rr;
            part += dzg * zz;
            dh[i][q] = d * (1.0f - zgj);
          }
          float* slot = dmine + q * UR;
          sts4(slot, dr[0], dr[1], dr[2], dr[3]);
          sts4(slot + kTU, dz[0], dz[1], dz[2], dz[3]);
          sts4(slot + 2 * kTU, dnr[0], dnr[1], dnr[2], dnr[3]);
          ps[(kTR * rg + q) * PS + ug] = part;
          if (b >= B) continue;
          float* x = dxg + (b * T + t) * H3 + j0;
          float* n = dhu_n + (b * T + t) * H + j0;
          if (kVec) {
            __stcs(reinterpret_cast<float4*>(x),
                   make_float4(dr[0], dr[1], dr[2], dr[3]));
            __stcs(reinterpret_cast<float4*>(x + H),
                   make_float4(dz[0], dz[1], dz[2], dz[3]));
            __stcs(reinterpret_cast<float4*>(x + 2 * H),
                   make_float4(dn[0], dn[1], dn[2], dn[3]));
            __stcs(reinterpret_cast<float4*>(n),
                   make_float4(dnr[0], dnr[1], dnr[2], dnr[3]));
          } else {
#pragma unroll
            for (int i = 0; i < kTU; ++i)
              if (j0 + i < H) {
                __stcs(x + i, dr[i]);
                __stcs(x + H + i, dz[i]);
                __stcs(x + 2 * H + i, dn[i]);
                __stcs(n + i, dnr[i]);
              }
          }
        }
      }
      __syncthreads();

      // phase 2: datt, dh_{t-1} = dh (1 - zg) + dhU U^T for k = j0 .. j0 +
      // 3, h_{t-2} into the h buffer and the next step's inputs
      for (int r = tid; r < rows; r += blockDim.x) {
        const int64_t b = tile * rows + r;
        if (b >= B) break;
        float s = 0.0f;
#pragma unroll 9
        for (int g = 0; g < UG; ++g) s += ps[r * PS + g];
        datt[b * T + t] = s;
      }
      if (active) {
        if (t >= 1) {
          stage(t - 1);
          load_state(t - 1);
        }
        const float* dp = drows;
        const float* up = us + ug * UGS;
#pragma unroll 2
        for (int g2 = 0; g2 < UG; ++g2) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float w[4][kTU];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 w4 = lds4(up + kk * UR + c * kTU);
              w[kk][0] = w4.x;
              w[kk][1] = w4.y;
              w[kk][2] = w4.z;
              w[kk][3] = w4.w;
            }
#pragma unroll
            for (int q = 0; q < kTR; ++q) {
              const float4 d4 = lds4(dp + q * UR + c * kTU);
              const float dv[kTU] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
              for (int i = 0; i < kTU; ++i)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                  dh[kk][q] = fmaf(dv[i], w[kk][i], dh[kk][q]);
            }
          }
          dp += 3 * kTU;
          up += 3 * kTU;
        }
        if (t >= 1) {
          store_state();
          cp_async_wait_all();
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < kTR; ++q) {
        const int64_t b = row0 + q;
        if (b >= B) break;
        float* p = dh0 + b * H + j0;
        if (kVec) {
          *reinterpret_cast<float4*>(p) =
              make_float4(dh[0][q], dh[1][q], dh[2][q], dh[3][q]);
        } else {
#pragma unroll
          for (int i = 0; i < kTU; ++i)
            if (j0 + i < H) p[i] = dh[i][q];
        }
      }
    }
  }
}

// Refuses a plan the kernel cannot run: a thread for each (row group,
// unit group), whole warps, at most kMaxThreads (the register limit: a
// thread's 96 accumulators and the software pipeline of its shared loads
// fit only in the 255 registers of 8 warps), and U, h, dhU and datt's
// partials within the opt-in shared memory.
int check(int H, int groups, int threads, int64_t blocks, int cap) {
  if (groups < 1 || threads < (int64_t)unit_groups(H) * groups
      || threads % 32 || threads > kMaxThreads || blocks < 1
      || blocks > 0x7fffffff
      || (int64_t)sizeof(float) * Layout(H, kTR * groups).floats() > cap)
    return kInvalid;
  return 0;
}

template <bool kVec>
int launch(const float* xg, const float* u, const float* att,
           const float* h0, const float* out, const float* dout, float* dxg,
           float* dhu_n, float* datt, float* dh0, int B, int T, int H,
           int groups, int threads, int64_t blocks, cudaStream_t stream) {
  const int64_t smem =
      (int64_t)sizeof(float) * Layout(H, kTR * groups).floats();
  cudaError_t err = cudaFuncSetAttribute(
      backward_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  backward_kernel<kVec><<<(unsigned int)blocks, threads, (size_t)smem,
                          stream>>>(xg, u, att, h0, out, dout, dxg, dhu_n,
                                    datt, dh0, B, T, H, groups);
  return (int)cudaGetLastError();
}

}  // namespace tile

// ---------------------------------------------------------------------------
// The rows route: the previous design (the first backward)
// ---------------------------------------------------------------------------

namespace rowwise {

constexpr int kMaxThreads = 512;   // 80 registers a thread at most

template <bool kUShared>
__global__ void __launch_bounds__(kMaxThreads) backward_kernel(
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

}  // namespace rowwise

}  // namespace

extern "C" {

// Operands of both entries, all float32 and contiguous: x_gates (B, T, 3H),
// u (H, 3H), att (B, T), h0 (B, H), out (B, T, H) the forward's states,
// dout (B, T, H) their gradient; they write dx_gates (B, T, 3H), dhu_n
// (B, T, H), datt (B, T) and dh0 (B, H).  Each returns the CUDA error of
// the launch (0 on success); a plan the kernel cannot run returns
// cudaErrorInvalidValue without launching.

// The tile route: `groups` 8-row groups a tile, `threads` a block (whole
// warps, at least one per (row group, unit group), at most 256), `blocks`
// persistent blocks (one per SM).
int augru_backward_tile_launch(const float* x_gates, const float* u,
                               const float* att, const float* h0,
                               const float* out, const float* dout,
                               float* dx_gates, float* dhu_n, float* datt,
                               float* dh0, int B, int T, int H, int groups,
                               int threads, int blocks, void* stream) {
  if (B < 1 || T < 1 || H < 1) return kInvalid;
  int cap = 0;
  int err = max_smem_optin(&cap);
  if (err) return err;
  err = tile::check(H, groups, threads, blocks, cap);
  if (err) return err;
  const bool vec =
      H % 4 == 0
      && ((uintptr_t)x_gates | (uintptr_t)h0 | (uintptr_t)out
          | (uintptr_t)dout | (uintptr_t)dx_gates | (uintptr_t)dhu_n
          | (uintptr_t)dh0) % 16 == 0;
  auto* s = static_cast<cudaStream_t>(stream);
  return vec ? tile::launch<true>(x_gates, u, att, h0, out, dout, dx_gates,
                                  dhu_n, datt, dh0, B, T, H, groups, threads,
                                  blocks, s)
             : tile::launch<false>(x_gates, u, att, h0, out, dout, dx_gates,
                                   dhu_n, datt, dh0, B, T, H, groups,
                                   threads, blocks, s);
}

// The rows route: rows: R batch rows a block; threads_per_row: TP, a
// multiple of 32; blocks: the grid (a block walks over groups of R rows);
// u_shared: U in shared memory; at most 512 threads a block.
int augru_backward_rows_launch(const float* x_gates, const float* u,
                               const float* att, const float* h0,
                               const float* out, const float* dout,
                               float* dx_gates, float* dhu_n, float* datt,
                               float* dh0, int B, int T, int H, int rows,
                               int threads_per_row, int blocks, int u_shared,
                               void* stream) {
  if (B < 1 || T < 1 || H < 1 || rows < 1 || blocks < 1
      || threads_per_row < 32 || threads_per_row % 32
      || (int64_t)rows * threads_per_row > rowwise::kMaxThreads)
    return kInvalid;
  const int ustride = (3 * H) | 1;
  const size_t state = sizeof(float) * (size_t)rows * 7 * H;
  const size_t smem = state + (u_shared ? sizeof(float) * (size_t)H * ustride
                                        : 0);
  int optin = 0;
  int err = max_smem_optin(&optin);
  if (err) return err;
  if (smem > (size_t)optin) return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = rows * threads_per_row;
  cudaError_t e;
  if (u_shared) {
    e = cudaFuncSetAttribute(rowwise::backward_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    rowwise::backward_kernel<true><<<blocks, threads, smem, s>>>(
        x_gates, u, att, h0, out, dout, dx_gates, dhu_n, datt, dh0, B, T, H,
        rows, threads_per_row, ustride);
  } else {
    e = cudaFuncSetAttribute(rowwise::backward_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    rowwise::backward_kernel<false><<<blocks, threads, smem, s>>>(
        x_gates, u, att, h0, out, dout, dx_gates, dhu_n, datt, dh0, B, T, H,
        rows, threads_per_row, ustride);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
