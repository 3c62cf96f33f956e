// Bag pooling with a fused gather on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (bag_pool_pallas; body _bag_kernel).  For every bag b and feature d
//
//   out[b, d] = sum_l w[b, l] * table[idx[b, l], d]          (mode sum)
//   out[b, d] = that / max(sum_l w[b, l], 1e-9)              (mode mean)
//
// in float32, with the output in the table's dtype.  idx follows JAX's
// gather rule: a negative index wraps once (+ V), then it is clamped to
// [0, V - 1].  Missing weights are ones.  sum_l w is taken in float32, as
// the Pallas kernel does (kernel.py:29-32); the reference's ref.py sums
// bf16 weights in bf16.  The division is IEEE-rounded (no fast math), and
// w * table is one rounded multiply before the add (-fmad=false).
//
// The TPU kernel pooled a (B, L, D) block that XLA had gathered into HBM
// beforehand, with B padded to 8 and D to 128 lanes.  Here the kernel reads
// the table rows itself, so the (B, L, D) tensor never reaches device
// memory, and takes any B, L and D unpadded.
//
// Design: one thread per (bag, feature), threads of a block over
// consecutive (b, d), so neighbouring threads read neighbouring features of
// one row (72 contiguous bytes at DIEN's D = 18); each thread walks l in
// ascending order, unrolled so that several rows' loads are in flight.
// Threads of one bag read the same index and weight (one load per warp
// from L1).  Packing a bag's rows into 16-byte loads per warp is later
// speed work.
//
// Bound: bytes.  At DIEN's bulk batch (65,536 bags of 100 over a 2,097,152
// x 18 float32 table) the indices and weights are 26.2 MB each and the
// output 4.7 MB; the rows touched are at most the 151 MB table, but 472 MB
// once per lookup: 62-158 us at 3.35 TB/s.  2 B L D operations (0.24
// GFLOP) are far below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const T* __restrict__ table, int64_t V, int64_t D,
    const void* __restrict__ indices, int idx64,
    const float* __restrict__ weights, int64_t B, int64_t L, int mean,
    T* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= B * D) return;
  const int64_t b = t / D, d = t - b * D;
  const int64_t base = b * L;
  const int* idx32 = static_cast<const int*>(indices);
  const long long* idx64p = static_cast<const long long*>(indices);
  float acc = 0.0f, wsum = 0.0f;
#pragma unroll 4
  for (int64_t l = 0; l < L; ++l) {
    int64_t i = idx64 ? (int64_t)__ldg(idx64p + base + l)
                      : (int64_t)__ldg(idx32 + base + l);
    if (i < 0) i += V;
    i = i < 0 ? 0 : (i >= V ? V - 1 : i);
    const float w = weights ? __ldg(weights + base + l) : 1.0f;
    acc = acc + w * to_f32(table[i * D + d]);
    wsum = wsum + w;
  }
  if (mean) acc = acc / fmaxf(wsum, 1e-9f);
  store(out + t, acc);
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
// table_bf16 selects a bf16 table (and output) over float32; idx64 int64
// indices over int32; `weights` (B, L) float32 may be null.
extern "C" int embedding_bag_launch(const void* table, int table_bf16,
                                    int64_t V, int64_t D,
                                    const void* indices, int idx64,
                                    const void* weights, int64_t B,
                                    int64_t L, int mean, void* out,
                                    void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (V <= 0 && L > 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (B * D + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* w = static_cast<const float*>(weights);
  if (table_bf16) {
    embedding_bag_kernel<__nv_bfloat16><<<(unsigned int)blocks, kThreads, 0,
                                          s>>>(
        static_cast<const __nv_bfloat16*>(table), V, D, indices, idx64, w, B,
        L, mean, static_cast<__nv_bfloat16*>(out));
  } else {
    embedding_bag_kernel<float><<<(unsigned int)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(table), V, D, indices, idx64, w, B, L,
        mean, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
