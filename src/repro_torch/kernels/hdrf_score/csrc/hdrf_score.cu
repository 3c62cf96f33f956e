// HDRF k-way scoring and first-index argmax on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hdrf_score/kernel.py
// (hdrf_pallas; bodies _hdrf_kernel and _hdrf_host_kernel).  For every edge
// it scores ALL k partitions as (g_u + g_v) + c_bal[p] (minus
// pen * (miss_u + miss_v) in the host variant) and writes the lowest index
// of the highest score (chosen) and that score (best).  With
// degree_weighted == 0 the replica term is 1 per endpoint (PowerGraph
// Greedy); the TPU kernel hard-coded the degree term, this one takes a flag.
//
// Design: one warp per edge, its 32 lanes striding over the partitions, so
// a row of the (E, k) flag matrices is read in 32-byte coalesced pieces.
// Each lane keeps its best (score, index) while its index rises, then a
// shuffle reduction keeps the higher score and, on a tie, the lower index
// (jnp.argmax's rule).  The balance term depends only on the sizes, so each
// block computes max/min of `sizes` once and c_bal for TILE partitions at a
// time into shared memory; k of any size runs in k / TILE tiles.
//
// Bound: per edge it reads two int32 degrees and 2k flag bytes (4k with the
// host flags) and writes an int32 and a float32: 80 B per edge at k = 32, so
// a 65,536-edge chunk is ~5.2 MB, about 1.6 us at 3.35 TB/s, while a few
// float operations per (edge, partition) are far below the card's float32
// rate.  At the HDRF
// micro-batch (64, 32) the launch itself sets the time.
//
// Arithmetic: exactly the plain version's (core/scoring.py::hdrf_score,
// which follows what the jitted reference computes): theta = d / max(float(
// du + dv), 1) from an int32 add, g = 2 - theta, c_bal = (lam * (max - s)) /
// ((1 + max) - min), score = (g_u + g_v) + c_bal, the penalty subtracted
// after its own rounding.  The __f*_rn intrinsics keep every operation
// correctly rounded and unfused (the build also passes -fmad=false).
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;          // partitions of c_bal per shared tile

__device__ __forceinline__ void better(float& best, int& arg, float s, int p) {
  if (s > best || (s == best && p < arg)) {
    best = s;
    arg = p;
  }
}

__global__ void hdrf_score_kernel(
    const int32_t* __restrict__ du, const int32_t* __restrict__ dv,
    const uint8_t* __restrict__ rep_u, const uint8_t* __restrict__ rep_v,
    const int32_t* __restrict__ sizes, const uint8_t* __restrict__ hrep_u,
    const uint8_t* __restrict__ hrep_v, float lam, float pen,
    int degree_weighted, int64_t n, int k, int32_t* __restrict__ chosen,
    float* __restrict__ best_out) {
  __shared__ float cbal[kTile];
  __shared__ int wmax[kWarps], wmin[kWarps];
  __shared__ float smax, smin;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // max / min of the sizes, once per block
  int mx = INT_MIN, mn = INT_MAX;
  for (int p = threadIdx.x; p < k; p += kThreads) {
    mx = max(mx, sizes[p]);
    mn = min(mn, sizes[p]);
  }
  mx = __reduce_max_sync(0xffffffffu, mx);
  mn = __reduce_min_sync(0xffffffffu, mn);
  if (lane == 0) {
    wmax[warp] = mx;
    wmin[warp] = mn;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      mx = max(mx, wmax[w]);
      mn = min(mn, wmin[w]);
    }
    smax = __int2float_rn(mx);
    smin = __int2float_rn(mn);
  }
  __syncthreads();
  const float maxf = smax;
  const float denom = __fsub_rn(__fadd_rn(1.0f, maxf), smin);

  const int64_t e = (int64_t)blockIdx.x * kWarps + warp;
  const bool live = e < n;
  float gu = 0.0f, gv = 0.0f;
  if (live) {
    if (degree_weighted) {
      const int a = du[e], b = dv[e];
      const float dsum = fmaxf(__int2float_rn(a + b), 1.0f);
      gu = __fsub_rn(2.0f, __fdiv_rn(__int2float_rn(a), dsum));
      gv = __fsub_rn(2.0f, __fdiv_rn(__int2float_rn(b), dsum));
    } else {
      gu = gv = 1.0f;
    }
  }
  const int64_t row = live ? e * k : 0;
  const uint8_t* ru = rep_u + row;
  const uint8_t* rv = rep_v + row;
  float best = -INFINITY;
  int arg = INT_MAX;
  for (int t0 = 0; t0 < k; t0 += kTile) {
    const int tn = min(kTile, k - t0);
    __syncthreads();                 // the previous tile is consumed
    for (int p = threadIdx.x; p < tn; p += kThreads)
      cbal[p] = __fdiv_rn(__fmul_rn(lam, __fsub_rn(maxf,
                              __int2float_rn(sizes[t0 + p]))), denom);
    __syncthreads();
    if (!live) continue;
    for (int j = lane; j < tn; j += 32) {
      const int p = t0 + j;
      float s = __fadd_rn(__fadd_rn(ru[p] ? gu : 0.0f, rv[p] ? gv : 0.0f),
                          cbal[j]);
      if (pen != 0.0f) {
        const float miss_u = hrep_u[row + p] ? 0.0f : 1.0f;
        const float miss_v = hrep_v[row + p] ? 0.0f : 1.0f;
        s = __fsub_rn(s, __fmul_rn(pen, __fadd_rn(miss_u, miss_v)));
      }
      if (s > best) {                // p rises: ties keep the lower index
        best = s;
        arg = p;
      }
    }
  }
  if (!live) return;
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oa = __shfl_down_sync(0xffffffffu, arg, off);
    better(best, arg, ob, oa);
  }
  if (lane == 0) {
    chosen[e] = arg;
    best_out[e] = best;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rep_u / rep_v (and hrep_u / hrep_v) are row-major (n, k) byte matrices;
// with pen == 0 the host pointers are never read and may be null.
extern "C" int hdrf_score_launch(
    const void* du, const void* dv, const void* rep_u, const void* rep_v,
    const void* sizes, const void* hrep_u, const void* hrep_v, float lam,
    float pen, int degree_weighted, int64_t n, int k, void* chosen,
    void* best, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  hdrf_score_kernel<<<(unsigned int)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)du, (const int32_t*)dv, (const uint8_t*)rep_u,
      (const uint8_t*)rep_v, (const int32_t*)sizes, (const uint8_t*)hrep_u,
      (const uint8_t*)hrep_v, lam, pen, degree_weighted, n, k,
      (int32_t*)chosen, (float*)best);
  return (int)cudaGetLastError();
}
