// 2PS-L Phase-2 Step-3 two-candidate scoring on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/edge_score/kernel.py
// (edge_score_pallas; bodies _edge_score_kernel and _edge_score_host_kernel).
// For every edge it scores the two candidate partitions pu and pv as
// g_u + g_v + sc_u + sc_v (minus dcn_penalty * (miss_u + miss_v) in the host
// variant) and writes chosen = (s2 > s1 ? pv : pu), best = max(s1, s2).
//
// Bound: the kernel reads four int32 operands, four 1-byte replica flags
// and two int32 candidates, and writes an int32 and a float32: 36 B per edge
// flat, 40 B with the four host flags.  A 65,536-edge chunk is ~2.4 MB, about
// 0.7 us at 3.35 TB/s, while ~30 float operations per edge are far below the
// card's float32 rate.  At chunk size the kernel is bound by launch latency,
// not by bytes: one thread per edge, no shared memory, no padding.  The
// later speed step is to fuse the gathers from bits / v2c / c2p / d / vol
// into this kernel, so the flag and operand arrays never reach device memory.
//
// Arithmetic: exactly the plain version's (core/scoring.py::twopsl_score,
// which follows what the jitted reference computes): g = 2 - d_self / dsum
// with dsum = max(float(du + dv), 1) from an int32 add, the four terms summed
// left to right, the penalty subtracted after its own rounding.  The
// __f*_rn intrinsics keep every operation correctly rounded and stop the
// compiler from contracting any pair into an FMA (the build also passes
// -fmad=false).  Ties go to pu.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float g_term(int d_self, float dsum, bool rep) {
  return rep ? __fsub_rn(2.0f, __fdiv_rn(__int2float_rn(d_self), dsum)) : 0.0f;
}

__device__ __forceinline__ float sc_term(int vol_self, float vsum, bool on_p) {
  return on_p ? __fdiv_rn(__int2float_rn(vol_self), vsum) : 0.0f;
}

__device__ __forceinline__ float penalty(float pen, uint8_t hu, uint8_t hv) {
  float miss_u = hu ? 0.0f : 1.0f;
  float miss_v = hv ? 0.0f : 1.0f;
  return __fmul_rn(pen, __fadd_rn(miss_u, miss_v));
}

__global__ void edge_score_kernel(
    const int32_t* __restrict__ du, const int32_t* __restrict__ dv,
    const int32_t* __restrict__ vol_u, const int32_t* __restrict__ vol_v,
    const uint8_t* __restrict__ rep_u1, const uint8_t* __restrict__ rep_v1,
    const uint8_t* __restrict__ rep_u2, const uint8_t* __restrict__ rep_v2,
    const int32_t* __restrict__ pu, const int32_t* __restrict__ pv,
    const uint8_t* __restrict__ hrep_u1, const uint8_t* __restrict__ hrep_v1,
    const uint8_t* __restrict__ hrep_u2, const uint8_t* __restrict__ hrep_v2,
    float pen, int64_t n, int32_t* __restrict__ chosen,
    float* __restrict__ best) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int a = du[i], b = dv[i];
  const int va = vol_u[i], vb = vol_v[i];
  const int p1 = pu[i], p2 = pv[i];
  const float dsum = fmaxf(__int2float_rn(a + b), 1.0f);
  const float vsum = fmaxf(__int2float_rn(va + vb), 1.0f);
  const bool same = p1 == p2;
  // candidate 1 = pu: u's cluster is on pu by construction
  float s1 = __fadd_rn(__fadd_rn(__fadd_rn(g_term(a, dsum, rep_u1[i] != 0),
                                           g_term(b, dsum, rep_v1[i] != 0)),
                                 sc_term(va, vsum, true)),
                       sc_term(vb, vsum, same));
  // candidate 2 = pv: v's cluster is on pv by construction
  float s2 = __fadd_rn(__fadd_rn(__fadd_rn(g_term(a, dsum, rep_u2[i] != 0),
                                           g_term(b, dsum, rep_v2[i] != 0)),
                                 sc_term(va, vsum, same)),
                       sc_term(vb, vsum, true));
  if (pen != 0.0f) {
    s1 = __fsub_rn(s1, penalty(pen, hrep_u1[i], hrep_v1[i]));
    s2 = __fsub_rn(s2, penalty(pen, hrep_u2[i], hrep_v2[i]));
  }
  chosen[i] = s2 > s1 ? p2 : p1;
  best[i] = fmaxf(s1, s2);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  With
// pen == 0 the four host-flag pointers are never read and may be null.
extern "C" int edge_score_launch(
    const void* du, const void* dv, const void* vol_u, const void* vol_v,
    const void* rep_u1, const void* rep_v1, const void* rep_u2,
    const void* rep_v2, const void* pu, const void* pv, const void* hrep_u1,
    const void* hrep_v1, const void* hrep_u2, const void* hrep_v2, float pen,
    int64_t n, void* chosen, void* best, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  edge_score_kernel<<<(unsigned int)blocks, threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)du, (const int32_t*)dv, (const int32_t*)vol_u,
      (const int32_t*)vol_v, (const uint8_t*)rep_u1, (const uint8_t*)rep_v1,
      (const uint8_t*)rep_u2, (const uint8_t*)rep_v2, (const int32_t*)pu,
      (const int32_t*)pv, (const uint8_t*)hrep_u1, (const uint8_t*)hrep_v1,
      (const uint8_t*)hrep_u2, (const uint8_t*)hrep_v2, pen, n,
      (int32_t*)chosen, (float*)best);
  return (int)cudaGetLastError();
}
