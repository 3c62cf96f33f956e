// Destination-sorted segment sum with a fused gather on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/spmm/kernel.py
// (segment_sum_pallas; body _segment_kernel).  For every node i it computes
//
//   Y[i, :] = sum_{p = row_ptr[i]}^{row_ptr[i+1]-1} w(p) * R[g(p), :]
//
// in float32 and writes Y in the output's dtype.  The edges are taken in
// the order of `perm`, the stable argsort of dst, so p runs over node i's
// in-edges in their original order:
//
//   segment_sum_tiles:  R = messages (E, D),  g(p) = perm[p],       w = 1
//   spmm:               R = x (V, D),         g(p) = src[perm[p]],  w(p) =
//                       weights[perm[p]] or 1
//
// src follows JAX's gather rule: a negative index wraps once (+ V), then
// it is clamped to [0, V - 1].  So spmm never materialises the (E, D)
// message tensor that the reference gathers before its kernel.  w * R is
// one rounded float32 multiply before the add, as the reference's
// `msg * weights[:, None]` (the build's -fmad=false keeps it unfused).
//
// The TPU kernel cut the sorted edges into 128-edge tiles, one output
// block of 128 rows per tile, and scattered each tile by a one-hot
// (128 x 128) matmul on the MXU, zeroing a block at its first visit.  None
// of that is carried over: here each output row has one owner, so there
// are no atomics on Y, the sum has one fixed order (the result is the same
// from run to run), and rows with no edges are written as zeros.
//
// Design: one warp per destination row, lanes over the features
// (K registers each, so 32 * K columns per pass; any D, in column passes
// above 256).  A warp loads 32 edges' (g, w) at once, one per lane, and
// broadcasts them by shuffles; four rows' loads are issued before their
// adds.  A power-law hub (tens of thousands of in-edges) would hold one
// warp for the whole kernel, so rows with more than `split` edges are cut
// into chunks of `split` edges, one warp each, placed first in the grid so
// they start first.  A chunk's warp writes its float32 partial to scratch;
// the last chunk of a hub to finish (an atomic count per hub) adds the
// partials in chunk order and writes the row, so the result stays
// deterministic.
//
// Types: float32 or bf16 rows, float32 weights (the wrapper widens bf16
// weights), float32 accumulation, float32 or bf16 output.  With bf16 rows
// this differs from the reference's Pallas kernel by more than one
// rounding: that kernel rounds its output block to the message dtype after
// every 128-edge tile (kernel.py:47-49), and its bf16 product w * x is
// rounded to bf16 before the sum; here both stay float32 until the end.
//
// Bound: the rows are read at random.  Each input read once (the x rows the
// edges touch, src, weights, perm, row_ptr) and Y written once is ~2.1 GB
// at ogb_products' scale with D = 64 (0.63 ms at 3.35 TB/s); one x row per
// edge is 16.5 GB (5.3 ms).  x (0.66 GB) does not fit in the 50 MB L2, so
// the time lies between the two.  2 E D float32 operations (8 GFLOP) are
// far below either, so bytes bound it.  src[perm[p]] and weights[perm[p]]
// are 4-byte gathers that each cost a 32-byte sector: the later speed work
// is a prep that stores them in sorted order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* rows;                       // R: (n_rows, D)
  int64_t n_rows, D;
  const void* perm;                       // (E,) int32 or int64
  int perm64;
  const void* src;                        // (E,) or null (g(p) = perm[p])
  int src64;
  const float* weights;                   // (E,) or null (w = 1)
  const int64_t* row_ptr;                 // (n_nodes + 1,)
  int64_t n_nodes;
  const int64_t* hub_rows;                // (n_hubs,)
  const int64_t* hub_chunk_ptr;           // (n_hubs + 1,)
  int64_t n_hubs, n_chunks, split;        // split 0: no row is cut
  float* partial;                         // (n_chunks, D)
  unsigned int* arrived;                  // (n_hubs,) zeroed by the caller
  void* out;                              // (n_nodes, D)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int64_t load_index(const void* p, int wide,
                                              int64_t i) {
  return wide ? (int64_t)__ldg(static_cast<const long long*>(p) + i)
              : (int64_t)__ldg(static_cast<const int*>(p) + i);
}

// acc[k] (column c0 + lane + 32k) += w(p) * R[g(p), column] for p in
// [lo, hi), in order of p
template <typename TIn, int K>
__device__ __forceinline__ void gather_sum(const Args& a, int64_t lo,
                                           int64_t hi, int64_t c0, int lane,
                                           float (&acc)[K]) {
  const TIn* __restrict__ rows = static_cast<const TIn*>(a.rows);
  const int64_t D = a.D;
  for (int64_t base = lo; base < hi; base += 32) {
    const int64_t p = base + lane;
    int64_t g = 0;
    float w = 1.0f;
    if (p < hi) {
      const int64_t e = load_index(a.perm, a.perm64, p);
      g = e;
      if (a.src) {
        g = load_index(a.src, a.src64, e);
        if (g < 0) g += a.n_rows;
        g = g < 0 ? 0 : (g >= a.n_rows ? a.n_rows - 1 : g);
      }
      if (a.weights) w = __ldg(a.weights + e);
    }
    const int n = (int)(hi - base < 32 ? hi - base : 32);
    const TIn* col = rows + c0 + lane;
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      const TIn* r0 = col + (int64_t)__shfl_sync(kFull, (long long)g, j) * D;
      const TIn* r1 =
          col + (int64_t)__shfl_sync(kFull, (long long)g, j + 1) * D;
      const TIn* r2 =
          col + (int64_t)__shfl_sync(kFull, (long long)g, j + 2) * D;
      const TIn* r3 =
          col + (int64_t)__shfl_sync(kFull, (long long)g, j + 3) * D;
      const float w0 = __shfl_sync(kFull, w, j);
      const float w1 = __shfl_sync(kFull, w, j + 1);
      const float w2 = __shfl_sync(kFull, w, j + 2);
      const float w3 = __shfl_sync(kFull, w, j + 3);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (c0 + lane + 32 * k < D) {
          const float v0 = to_f32(r0[32 * k]), v1 = to_f32(r1[32 * k]);
          const float v2 = to_f32(r2[32 * k]), v3 = to_f32(r3[32 * k]);
          acc[k] = acc[k] + w0 * v0;
          acc[k] = acc[k] + w1 * v1;
          acc[k] = acc[k] + w2 * v2;
          acc[k] = acc[k] + w3 * v3;
        }
      }
    }
    for (; j < n; ++j) {
      const TIn* r = col + (int64_t)__shfl_sync(kFull, (long long)g, j) * D;
      const float wj = __shfl_sync(kFull, w, j);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (c0 + lane + 32 * k < D) acc[k] = acc[k] + wj * to_f32(r[32 * k]);
      }
    }
  }
}

template <typename TIn, typename TOut, int K>
__global__ void __launch_bounds__(kWarps * 32) spmm_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t D = a.D;
  if (warp < a.n_chunks) {
    // one chunk of a hub: the hub h with hub_chunk_ptr[h] <= warp < [h+1]
    int64_t lo = 0, hi = a.n_hubs;
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) / 2;
      if (a.hub_chunk_ptr[mid] <= warp) lo = mid; else hi = mid;
    }
    const int64_t h = lo;
    const int64_t first = a.hub_chunk_ptr[h];
    const int64_t nc = a.hub_chunk_ptr[h + 1] - first;
    const int64_t row = a.hub_rows[h];
    const int64_t e_lo = a.row_ptr[row] + (warp - first) * a.split;
    const int64_t e_end = a.row_ptr[row + 1];
    const int64_t e_hi = e_lo + a.split < e_end ? e_lo + a.split : e_end;
    float* part = a.partial + warp * D;
    for (int64_t c0 = 0; c0 < D; c0 += 32 * K) {
      float acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.0f;
      gather_sum<TIn, K>(a, e_lo, e_hi, c0, lane, acc);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t c = c0 + lane + 32 * k;
        if (c < D) part[c] = acc[k];
      }
    }
    __threadfence();                      // partial visible before the count
    __syncwarp();
    unsigned int before = 0;
    if (lane == 0) before = atomicAdd(a.arrived + h, 1u);
    before = __shfl_sync(kFull, before, 0);
    if ((int64_t)before != nc - 1) return;
    __threadfence();                      // the last chunk sums them in order
    const float* parts = a.partial + first * D;
    TOut* y = static_cast<TOut*>(a.out) + row * D;
    for (int64_t c = lane; c < D; c += 32) {
      float s = 0.0f;
      for (int64_t q = 0; q < nc; ++q) s = s + __ldcg(parts + q * D + c);
      store(y + c, s);
    }
    return;
  }
  const int64_t row = warp - a.n_chunks;
  if (row >= a.n_nodes) return;
  const int64_t lo = a.row_ptr[row], hi = a.row_ptr[row + 1];
  if (a.split > 0 && hi - lo > a.split) return;   // its chunks write it
  TOut* y = static_cast<TOut*>(a.out) + row * D;
  for (int64_t c0 = 0; c0 < D; c0 += 32 * K) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
    gather_sum<TIn, K>(a, lo, hi, c0, lane, acc);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t c = c0 + lane + 32 * k;
      if (c < D) store(y + c, acc[k]);
    }
  }
}

template <typename TIn, typename TOut>
int launch(const Args& a, cudaStream_t stream) {
  const int64_t warps = a.n_chunks + a.n_nodes;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)blocks), block(kWarps * 32);
  if (a.D <= 32) {
    spmm_kernel<TIn, TOut, 1><<<grid, block, 0, stream>>>(a);
  } else if (a.D <= 64) {
    spmm_kernel<TIn, TOut, 2><<<grid, block, 0, stream>>>(a);
  } else if (a.D <= 96) {
    spmm_kernel<TIn, TOut, 3><<<grid, block, 0, stream>>>(a);
  } else if (a.D <= 128) {
    spmm_kernel<TIn, TOut, 4><<<grid, block, 0, stream>>>(a);
  } else {
    spmm_kernel<TIn, TOut, 8><<<grid, block, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
// Types: rows_bf16 / out_bf16 select bf16 over float32 (float32 rows give a
// float32 output); perm64 / src64 select int64 over int32 indices.  `src`
// and `weights` may be null; with n_hubs == 0 the hub arrays, `partial` and
// `arrived` are never read and may be null.
extern "C" int spmm_launch(
    const void* rows, int rows_bf16, int64_t n_rows, int64_t D,
    const void* perm, int perm64, const void* src, int src64,
    const void* weights, const void* row_ptr, int64_t n_nodes,
    const void* hub_rows, const void* hub_chunk_ptr, int64_t n_hubs,
    int64_t n_chunks, int64_t split, void* partial, void* arrived,
    void* out, int out_bf16, void* stream) {
  if (n_nodes <= 0 || D <= 0) return 0;
  if (n_hubs < 0 || n_chunks < n_hubs || split < 0 ||
      (n_chunks > 0 && (n_hubs == 0 || split == 0)))
    return (int)cudaErrorInvalidValue;
  Args a{rows, n_rows, D, perm, perm64, src, src64,
         static_cast<const float*>(weights),
         static_cast<const int64_t*>(row_ptr), n_nodes,
         static_cast<const int64_t*>(hub_rows),
         static_cast<const int64_t*>(hub_chunk_ptr), n_hubs, n_chunks,
         split, static_cast<float*>(partial),
         static_cast<unsigned int*>(arrived), out};
  cudaStream_t s = (cudaStream_t)stream;
  if (!rows_bf16) {
    if (out_bf16) return (int)cudaErrorInvalidValue;
    return launch<float, float>(a, s);
  }
  if (out_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return launch<__nv_bfloat16, float>(a, s);
}
