// Destination-sorted segment sum with a fused gather on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/spmm/kernel.py
// (segment_sum_pallas; body _segment_kernel).  For every node i it computes
//
//   Y[i, :] = sum_{p = row_ptr[i]}^{row_ptr[i+1]-1} w(p) * R[g(p), :]
//
// in float32 and writes Y in the output's dtype.  p runs over node i's
// in-edges in the destination order of `perm` (the stable argsort of dst,
// so in their original order).  w * R is one rounded float32 multiply
// before the add, as the reference's `msg * weights[:, None]` (the build's
// -fmad=false keeps it unfused).
//
// The TPU kernel cut the sorted edges into 128-edge tiles, one output
// block of 128 rows per tile, and scattered each tile by a one-hot
// (128 x 128) matmul on the MXU, zeroing a block at its first visit.  None
// of that is carried over: here each output row has one owner, so there
// are no atomics on Y, the sum has one fixed order (two launches give the
// same bits), and rows with no edges are written as zeros.
//
// Two routes, each a kernel (the wrapper picks one; neither falls back):
//
//   bound (spmm_bound_launch): g and w are stored in destination order,
//     bound once per graph by TilePrep.with_edges: g = src[perm] with
//     JAX's gather rule applied there (a negative index wraps once, + V,
//     then clamps to [0, V - 1]), w = weights[perm] or 1.  It reads
//     row_ptr, then g and w coalesced, then the R rows; perm is not read.
//     segment_sum_tiles can take it too, with g = perm and w = 1.
//   previous (spmm_launch, the previous kernel): g(p) = src[perm[p]] with
//     the rule applied in the kernel, w(p) = weights[perm[p]], or g(p) =
//     perm[p] for segment_sum_tiles: two 4-byte gathers at random per edge
//     besides the row, and one warp per row.  It stays the route for edges
//     that are not bound and for segment_sum_tiles.
//
// Bound: bytes.  One R row per edge is 16.5 GB at ogb_products' scale with
// D = 64 float32 (64.3M edges; 5.35 ms at 3.35 TB/s with src, weights,
// perm, row_ptr and Y); each touched row read once is 2.0 GB (0.60 ms).
// x (0.66 GB) does not fit in the 50 MB L2, so the time lies between the
// two (rows of high out-degree stay in L2).  2 E D float32 operations
// (8 GFLOP) are far below either.  The previous route adds src[perm[p]]
// and weights[perm[p]], each a 32-byte sector at random per edge, to the
// 256-byte row, and a warp per row runs the chain row_ptr -> perm -> src
// -> rows once per row (~25 edges): latency, not bytes, held it.
//
// Bound route design.  Rows are read as vectors of 16 bytes (float4, or 8
// bf16), else 8 bytes, else one element (whatever the row's width and the
// base pointer's alignment allow; the wrapper's pure-Python `kernel.plan`
// chooses, this entry refuses the rest).  `lanes` lanes (a power of two, at
// most 32) cover a row's vectors, K vectors each per column pass; a warp's
// S = 32 / lanes sub-groups take one edge each per step, so at D = 64
// float32 two half-warps read two rows at once.  A warp owns a block of
// consecutive rows (TilePrep.blocks: at most 31 rows, edges starting in one
// window of 256) and walks their edges as one stream of steps across row
// ends, so the loads of U = SPMM_STEPS / K steps are in flight whatever
// rows they belong to, and row_ptr is read once a block.  g and w sit in a
// window of 64 edges (two batches of 32, one per lane, the next loaded a
// batch ahead).  Few registers matter more than many loads a lane: 4
// warps a block, 8 blocks an SM (64 registers, 32 warps an SM), 4 steps
// in flight; `chip_smoke.py --spmm-tune` times the other shapes.
// Order of summation: for each row, sub-group s adds the row's edges s,
// s + S, s + 2S, ... in that order into its float32 partial; at the row's
// end the S partials are added by xor shuffles at distances lanes, 2 lanes,
// ..., 16 (a fixed tree).  Fixed for given D, dtype and alignment, so two
// launches are bit-equal; it differs from the plain version's order by
// float32 rounding only (within 1e-5 of the absolute sum).
//
// Hubs (both routes): a power-law hub (tens of thousands of in-edges)
// would hold one warp for the whole kernel, so rows with more than `split`
// edges are cut into chunks of `split` edges, one warp each, placed first
// in the grid so they start first (the bound route's blocks skip them).  A
// chunk's warp writes its float32 partial to scratch; the last chunk of a
// hub to finish (an atomic count per hub) adds the partials in chunk order
// and writes the row.  The scratch is ~4 MB a call at ogb_products' scale
// (16,328 chunks x 256 bytes), a fraction of a per cent of the bytes, so it
// stays in device memory.
//
// Types: float32 or bf16 rows, float32 weights (the wrapper widens bf16
// weights), float32 accumulation, float32 or bf16 output.  With bf16 rows
// this differs from the reference's Pallas kernel by more than one
// rounding: that kernel rounds its output block to the message dtype after
// every 128-edge tile (kernel.py:47-49), and its bf16 product w * x is
// rounded to bf16 before the sum; here both stay float32 until the end.
//
// Measured (chip_smoke.py `gnn_aggregate` and `--spmm-tune`, CUDA events,
// NVIDIA H100 80GB HBM3 at 700 W), D = 64 float32 on 64.3M edges: the
// bound route 4.125 ms a call against the previous route's 8.867 and
// cuSPARSE's SpMM 5.959 in the same run (7.775 without the hub split);
// below the 5.35 ms of one x row per edge from DRAM, as rows of high
// out-degree hit in L2.  Shapes: 4.09-4.11 ms as shipped (64 registers),
// 6.88 at 8 steps, 8 warps and no register cap (118 registers), 5.47 at 1
// step.  segment_sum_tiles at D = 70 on the bound route took 11.05 ms
// against the previous route's 10.18, so it stays there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr unsigned kFull = 0xffffffffu;

// the destination order and its hub chunks, common to both routes
struct Rows {
  const int64_t* row_ptr;                 // (n_nodes + 1,)
  int64_t n_nodes;
  const int64_t* hub_rows;                // (n_hubs,)
  const int64_t* hub_chunk_ptr;           // (n_hubs + 1,)
  int64_t n_hubs, n_chunks, split;        // split 0: no row is cut
  float* partial;                         // (n_chunks, D)
  unsigned int* arrived;                  // (n_hubs,) zeroed by the caller
  void* out;                              // (n_nodes, D)
  int64_t D;
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

__device__ __forceinline__ int64_t warp_id() {
  return (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
}

// The edges [lo, hi) that `warp` sums into output row `row`: for warp <
// n_chunks one chunk of `split` edges of hub `hub`, else row warp -
// n_chunks whole (hub = -1).  False when the warp has nothing to do (past
// the last row, or a hub row, which its chunks write).
__device__ __forceinline__ bool warp_edges(const Rows& a, int64_t warp,
                                           int64_t& row, int64_t& lo,
                                           int64_t& hi, int64_t& hub) {
  if (warp < a.n_chunks) {                // the hub h with ptr[h] <= warp
    int64_t l = 0, r = a.n_hubs;
    while (r - l > 1) {
      const int64_t mid = (l + r) / 2;
      if (a.hub_chunk_ptr[mid] <= warp) l = mid; else r = mid;
    }
    hub = l;
    row = a.hub_rows[hub];
    lo = a.row_ptr[row] + (warp - a.hub_chunk_ptr[hub]) * a.split;
    const int64_t end = a.row_ptr[row + 1];
    hi = lo + a.split < end ? lo + a.split : end;
    return true;
  }
  hub = -1;
  row = warp - a.n_chunks;
  if (row >= a.n_nodes) return false;
  lo = a.row_ptr[row];
  hi = a.row_ptr[row + 1];
  return !(a.split > 0 && hi - lo > a.split);
}

// After a chunk's warp has written its partial: the last chunk of `hub` to
// arrive adds the hub's partials in chunk order and writes the row.
template <typename TOut>
__device__ __forceinline__ void finish_hub(const Rows& a, int64_t hub,
                                           int64_t row, int lane) {
  const int64_t first = a.hub_chunk_ptr[hub];
  const int64_t nc = a.hub_chunk_ptr[hub + 1] - first;
  __threadfence();                        // partial visible before the count
  __syncwarp();
  unsigned int before = 0;
  if (lane == 0) before = atomicAdd(a.arrived + hub, 1u);
  before = __shfl_sync(kFull, before, 0);
  if ((int64_t)before != nc - 1) return;
  __threadfence();                        // the last chunk sums them in order
  const int64_t D = a.D;
  const float* parts = a.partial + first * D;
  TOut* y = static_cast<TOut*>(a.out) + row * D;
  for (int64_t c = lane; c < D; c += 32) {
    float s = 0.0f;
    for (int64_t q = 0; q < nc; ++q) s = s + __ldcg(parts + q * D + c);
    store(y + c, s);
  }
}

// the previous route's grid: one warp per hub chunk and per row
int grid_for(const Rows& a, dim3& grid) {
  const int64_t warps = a.n_chunks + a.n_nodes;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  grid = dim3((unsigned int)blocks);
  return 0;
}

// ---------------------------------------------------------------------------
// previous: the previous kernel (g and w gathered through perm in the kernel)
// ---------------------------------------------------------------------------
namespace previous {

struct Args {
  Rows r;
  const void* rows;                       // R: (n_rows, D)
  int64_t n_rows;
  const void* perm;                       // (E,) int32 or int64
  int perm64;
  const void* src;                        // (E,) or null (g(p) = perm[p])
  int src64;
  const float* weights;                   // (E,) or null (w = 1)
};

// acc[k] (column c0 + lane + 32k) += w(p) * R[g(p), column] for p in
// [lo, hi), in order of p
template <typename TIn, int K>
__device__ __forceinline__ void gather_sum(const Args& a, int64_t lo,
                                           int64_t hi, int64_t c0, int lane,
                                           float (&acc)[K]) {
  const TIn* __restrict__ rows = static_cast<const TIn*>(a.rows);
  const int64_t D = a.r.D;
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

// One warp per row (or hub chunk), lanes over the features: K registers
// each, so 32 K columns per pass; any D, in column passes above 256.  A
// warp loads 32 edges' (g, w) at once, one per lane, broadcasts them by
// shuffles and issues four rows' loads before their adds.
template <typename TIn, typename TOut, int K>
__global__ void __launch_bounds__(kWarps * 32) spmm_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = warp_id();
  int64_t row, lo, hi, hub;
  if (!warp_edges(a.r, warp, row, lo, hi, hub)) return;
  const int64_t D = a.r.D;
  float* part = a.r.partial + warp * D;
  TOut* y = static_cast<TOut*>(a.r.out) + row * D;
  for (int64_t c0 = 0; c0 < D; c0 += 32 * K) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
    gather_sum<TIn, K>(a, lo, hi, c0, lane, acc);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t c = c0 + lane + 32 * k;
      if (c >= D) continue;
      if (hub >= 0) part[c] = acc[k]; else store(y + c, acc[k]);
    }
  }
  if (hub >= 0) finish_hub<TOut>(a.r, hub, row, lane);
}

template <typename TIn, typename TOut>
int launch(const Args& a, cudaStream_t stream) {
  dim3 grid;
  if (int rc = grid_for(a.r, grid)) return rc;
  const dim3 block(kWarps * 32);
  if (a.r.D <= 32) {
    spmm_kernel<TIn, TOut, 1><<<grid, block, 0, stream>>>(a);
  } else if (a.r.D <= 64) {
    spmm_kernel<TIn, TOut, 2><<<grid, block, 0, stream>>>(a);
  } else if (a.r.D <= 96) {
    spmm_kernel<TIn, TOut, 3><<<grid, block, 0, stream>>>(a);
  } else if (a.r.D <= 128) {
    spmm_kernel<TIn, TOut, 4><<<grid, block, 0, stream>>>(a);
  } else {
    spmm_kernel<TIn, TOut, 8><<<grid, block, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace previous

// ---------------------------------------------------------------------------
// bound: g and w stored in destination order, rows read as vectors
// ---------------------------------------------------------------------------
namespace bound {

// The bound route's launch shape (`chip_smoke.py --spmm-tune` rebuilds
// with -D overrides of these and times each): steps whose row loads a lane
// has in flight (U = SPMM_STEPS / K), warps per block, and the blocks per
// SM the registers must allow (8 blocks of 4 warps: at most 64 registers a
// thread, 32 warps an SM).
#ifndef SPMM_STEPS
#define SPMM_STEPS 4
#endif
#ifndef SPMM_WARPS
#define SPMM_WARPS 4
#endif
#ifndef SPMM_MIN_BLOCKS
#define SPMM_MIN_BLOCKS 8
#endif
constexpr int kBoundWarps = SPMM_WARPS;

template <int K>
__host__ __device__ constexpr int steps_in_flight() {
  return SPMM_STEPS / K > 0 ? SPMM_STEPS / K : 1;
}

struct Args {
  Rows r;
  const void* rows;                       // R: (n_rows, D), vector-aligned
  const void* idx;                        // (E,) g in destination order
  int idx64;
  const float* weights;                   // (E,) w in destination order, or
                                          // null (w = 1)
  const int64_t* blocks;                  // (n_blocks + 1,) first rows of
  int64_t n_blocks;                       // the row blocks, at most 31 rows
  int lanes_log2;                         // lanes per edge = 1 << lanes_log2
};

// the load type of VB bytes of T: a row vector
template <typename T, int VB> struct Vec;
template <> struct Vec<float, 16> { using type = float4; };
template <> struct Vec<float, 8> { using type = float2; };
template <> struct Vec<float, 4> { using type = float; };
template <> struct Vec<__nv_bfloat16, 16> { using type = uint4; };
template <> struct Vec<__nv_bfloat16, 8> { using type = uint2; };
template <> struct Vec<__nv_bfloat16, 2> { using type = unsigned short; };

// bf16 halves of a 32-bit word (element 2i in the low half) as float32
__device__ __forceinline__ float lo_f32(unsigned int u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_f32(unsigned int u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ void unpack(float4 v, float (&f)[4]) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack(float2 v, float (&f)[2]) {
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void unpack(float v, float (&f)[1]) { f[0] = v; }
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  f[0] = lo_f32(v.x); f[1] = hi_f32(v.x); f[2] = lo_f32(v.y);
  f[3] = hi_f32(v.y); f[4] = lo_f32(v.z); f[5] = hi_f32(v.z);
  f[6] = lo_f32(v.w); f[7] = hi_f32(v.w);
}
__device__ __forceinline__ void unpack(uint2 v, float (&f)[4]) {
  f[0] = lo_f32(v.x); f[1] = hi_f32(v.x); f[2] = lo_f32(v.y);
  f[3] = hi_f32(v.y);
}
__device__ __forceinline__ void unpack(unsigned short v, float (&f)[1]) {
  f[0] = __uint_as_float((unsigned int)v << 16);
}

__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float2 load(const float2* p) { return __ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ uint4 load(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ uint2 load(const uint2* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short load(const unsigned short* p) {
  return __ldg(p);
}

__device__ __forceinline__ unsigned int bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// VEC values to p, aligned to min(VEC * sizeof(TOut), 16) bytes
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
        bf16_bits(v[2]) | bf16_bits(v[3]) << 16,
        bf16_bits(v[4]) | bf16_bits(v[5]) << 16,
        bf16_bits(v[6]) | bf16_bits(v[7]) << 16);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                   bf16_bits(v[2]) | bf16_bits(v[3]) << 16);
  } else {
    static_assert(VEC == 1, "bf16 vectors are 8, 4 or 1 values");
    *p = __float2bfloat16_rn(v[0]);
  }
}

// lane's (g, w) of edge base + lane, or (0, 1) past hi; streamed (read once)
template <typename TIdx>
__device__ __forceinline__ void load_edge(const Args& a, int64_t base,
                                          int64_t hi, int lane, TIdx& g,
                                          float& w) {
  const int64_t p = base + lane;
  g = 0;
  w = 1.0f;
  if (p < hi) {
    g = __ldcs(static_cast<const TIdx*>(a.idx) + p);
    if (a.weights) w = __ldcs(a.weights + p);
  }
}

// acc[k] (vector c0 + t + lanes k of the row) += w(p) R[g(p)] over this
// sub-group's edges p = lo + s, lo + s + S, ... < hi, in that order (one
// hub chunk; U steps of loads in flight)
template <typename TIn, typename TIdx, int VB, int K>
__device__ __forceinline__ void gather_sum(
    const Args& a, int64_t lo, int64_t hi, int64_t c0, int64_t C, int lane,
    int s, int t, float (&acc)[K][VB / sizeof(TIn)]) {
  using V = typename Vec<TIn, VB>::type;
  constexpr int VEC = VB / sizeof(TIn);
  constexpr int U = steps_in_flight<K>();
  const int lg = a.lanes_log2;
  const int L = 1 << lg, S = 32 >> lg;
  const V* __restrict__ rows = static_cast<const V*>(a.rows);
  TIdx g_next, g;
  float w_next, w;
  load_edge(a, lo, hi, lane, g_next, w_next);
  for (int64_t base = lo; base < hi; base += 32) {
    g = g_next;
    w = w_next;
    if (base + 32 < hi) load_edge(a, base + 32, hi, lane, g_next, w_next);
    const int n = (int)(hi - base < 32 ? hi - base : 32);
    const int steps = (n + S - 1) >> (5 - lg);
    for (int j0 = 0; j0 < steps; j0 += U) {
      V v[U][K];
      float wu[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = (j0 + u) * S + s;   // the sub-group's edge, in batch
        const TIdx gq = __shfl_sync(kFull, g, q & 31);
        wu[u] = __shfl_sync(kFull, w, q & 31);
        ok[u] = q < n;
        const V* r = rows + (int64_t)gq * C;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int64_t c = c0 + t + (int64_t)L * k;
          if (ok[u] && c < C) v[u][k] = load(r + c);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (c0 + t + (int64_t)L * k >= C) continue;
          float f[VEC];
          unpack(v[u][k], f);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[k][i] = acc[k][i] + wu[u] * f[i];
        }
      }
    }
  }
}

// the partials of the S sub-groups of a warp, added in a fixed tree (xor
// distances lanes, 2 lanes, ..., 16); every lane ends with the sum
template <int K, int VEC>
__device__ __forceinline__ void add_subgroups(float (&acc)[K][VEC], int L) {
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[k][i] = acc[k][i] + __shfl_xor_sync(kFull, acc[k][i], off);
  }
}

// Rows [r0, r1) (at most 31) of one warp: their edges in destination order
// as one stream of steps, a step being S consecutive edges of one row, one
// a sub-group.  A lane issues the row loads of U steps before their
// products, whatever rows they belong to; at the last step of a row the
// sub-groups' partials are added and the row written.  g and w are held in
// a window of 64 edges, two batches of 32 (one per lane), the second
// loaded a batch ahead.  Rows without edges are written as zeros; hub rows
// are skipped (their chunks write them).  Edge positions are int (the
// wrapper binds at most 2^31 - 1 edges).
template <typename TIn, typename TOut, typename TIdx, int VB, int K>
__device__ __forceinline__ void block_sum(const Args& a, int64_t r0,
                                          int64_t r1, int lane, int s, int t,
                                          int64_t C) {
  using V = typename Vec<TIn, VB>::type;
  constexpr int VEC = VB / sizeof(TIn);
  constexpr int U = steps_in_flight<K>();
  const int lg = a.lanes_log2;
  const int L = 1 << lg, S = 32 >> lg;
  const V* __restrict__ rows = static_cast<const V*>(a.rows);
  const int nr = (int)(r1 - r0);
  const int rp = lane <= nr ? (int)a.r.row_ptr[r0 + lane] : 0;
  const int bend = __shfl_sync(kFull, rp, nr);
  const int split = (int)a.r.split;
  // a row to sum: edges, and not a hub
  auto summed = [&](int row) {
    const int d =
        __shfl_sync(kFull, rp, row + 1) - __shfl_sync(kFull, rp, row);
    return d > 0 && !(split > 0 && d > split);
  };
  auto y_row = [&](int row) {
    return static_cast<TOut*>(a.r.out) + (r0 + row) * a.r.D;
  };
  for (int64_t c0 = 0; c0 < C; c0 += (int64_t)L * K) {
    // rows without edges first: zeros
    for (int row = 0; row < nr; ++row) {
      if (__shfl_sync(kFull, rp, row + 1) != __shfl_sync(kFull, rp, row) ||
          s != 0)
        continue;
      float zero[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) zero[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t c = c0 + t + (int64_t)L * k;
        if (c < C) store_vec<VEC>(y_row(row) + c * VEC, zero);
      }
    }
    int row = 0;                          // the row the issued steps are in
    while (row < nr && !summed(row)) ++row;
    int crow = row;                       // the row the products are in
    bool live = row < nr;
    int p = live ? __shfl_sync(kFull, rp, row) : 0;
    int end = live ? __shfl_sync(kFull, rp, row + 1) : 0;
    float acc[K][VEC];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0f;
    int b0 = p;
    TIdx g = 0, g2 = 0;
    float w = 1.0f, w2 = 1.0f;
    if (live) {
      load_edge(a, b0, bend, lane, g, w);
      load_edge(a, b0 + 32, bend, lane, g2, w2);
    }
    while (live) {
      if (p >= b0 + 32) {                 // move the window on
        if (p < b0 + 64) {
          g = g2;
          w = w2;
          b0 += 32;
        } else {                          // past a hub: a fresh window
          b0 = p;
          load_edge(a, b0, bend, lane, g, w);
        }
        load_edge(a, b0 + 32, bend, lane, g2, w2);
      }
      V v[U][K];
      float wu[U];
      unsigned ok = 0;                    // bit u: step u has an edge here
      unsigned last = 0;                  // bit u: step u ends its row
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int stop = p + S < end ? p + S : end;
        const bool step = live && stop <= b0 + 64;
        const int q = p + s;              // this sub-group's edge
        const int off = (q - b0) & 31;
        const TIdx ga = __shfl_sync(kFull, g, off);
        const TIdx gb = __shfl_sync(kFull, g2, off);
        const float wa = __shfl_sync(kFull, w, off);
        const float wb = __shfl_sync(kFull, w2, off);
        const bool first = q - b0 < 32;
        wu[u] = first ? wa : wb;
        const bool has = step && q < end;
        ok |= (unsigned)has << u;
        const V* r = rows + (int64_t)(first ? ga : gb) * C;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int64_t c = c0 + t + (int64_t)L * k;
          if (has && c < C) v[u][k] = load(r + c);
        }
        if (step) {
          p = stop;
          if (p == end) {                 // on to the next row to sum
            last |= 1u << u;
            do ++row; while (row < nr && !summed(row));
            live = row < nr;
            if (live) {
              p = __shfl_sync(kFull, rp, row);
              end = __shfl_sync(kFull, rp, row + 1);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok >> u & 1u) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (c0 + t + (int64_t)L * k >= C) continue;
            float f[VEC];
            unpack(v[u][k], f);
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              acc[k][i] = acc[k][i] + wu[u] * f[i];
          }
        }
        if (last >> u & 1u) {
          add_subgroups<K, VEC>(acc, L);
          TOut* y = y_row(crow);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int64_t c = c0 + t + (int64_t)L * k;
            if (s == 0 && c < C) store_vec<VEC>(y + c * VEC, acc[k]);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0f;
          }
          do ++crow; while (crow < nr && !summed(crow));
        }
      }
    }
  }
}

template <typename TIn, typename TOut, typename TIdx, int VB, int K>
__global__ void __launch_bounds__(kBoundWarps * 32, SPMM_MIN_BLOCKS)
    spmm_kernel(Args a) {
  constexpr int VEC = VB / sizeof(TIn);
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (int64_t)blockIdx.x * kBoundWarps + (threadIdx.x >> 5);
  const int lg = a.lanes_log2;
  const int L = 1 << lg;
  const int s = lane >> lg, t = lane & (L - 1);
  const int64_t D = a.r.D, C = D / VEC;   // vectors per row
  if (warp >= a.r.n_chunks) {
    const int64_t b = warp - a.r.n_chunks;
    if (b < a.n_blocks)
      block_sum<TIn, TOut, TIdx, VB, K>(a, a.blocks[b], a.blocks[b + 1],
                                        lane, s, t, C);
    return;
  }
  int64_t row, lo, hi, hub;               // one chunk of a hub
  warp_edges(a.r, warp, row, lo, hi, hub);
  float* part = a.r.partial + warp * D;
  for (int64_t c0 = 0; c0 < C; c0 += (int64_t)L * K) {
    float acc[K][VEC];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0f;
    gather_sum<TIn, TIdx, VB, K>(a, lo, hi, c0, C, lane, s, t, acc);
    add_subgroups<K, VEC>(acc, L);
    if (s != 0) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t c = c0 + t + (int64_t)L * k;
      if (c < C) store_vec<VEC>(part + c * VEC, acc[k]);
    }
  }
  finish_hub<TOut>(a.r, hub, row, lane);
}

template <typename TIn, typename TOut, typename TIdx, int VB>
int launch_vec(const Args& a, int chunks, cudaStream_t stream) {
  const int64_t warps = a.r.n_chunks + a.n_blocks;
  const int64_t blocks = (warps + kBoundWarps - 1) / kBoundWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)blocks), block(kBoundWarps * 32);
  switch (chunks) {
    case 1:
      spmm_kernel<TIn, TOut, TIdx, VB, 1><<<grid, block, 0, stream>>>(a);
      break;
    case 2:
      spmm_kernel<TIn, TOut, TIdx, VB, 2><<<grid, block, 0, stream>>>(a);
      break;
    case 4:
      spmm_kernel<TIn, TOut, TIdx, VB, 4><<<grid, block, 0, stream>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut, typename TIdx>
int launch_idx(const Args& a, int vec_bytes, int chunks,
               cudaStream_t stream) {
  if (vec_bytes == 16)
    return launch_vec<TIn, TOut, TIdx, 16>(a, chunks, stream);
  if (vec_bytes == 8)
    return launch_vec<TIn, TOut, TIdx, 8>(a, chunks, stream);
  return launch_vec<TIn, TOut, TIdx, (int)sizeof(TIn)>(a, chunks, stream);
}

template <typename TIn, typename TOut>
int launch(const Args& a, int vec_bytes, int chunks, cudaStream_t stream) {
  if (a.idx64)
    return launch_idx<TIn, TOut, long long>(a, vec_bytes, chunks, stream);
  return launch_idx<TIn, TOut, int>(a, vec_bytes, chunks, stream);
}

}  // namespace bound

int check_rows(const Rows& r) {
  if (r.n_hubs < 0 || r.n_chunks < r.n_hubs || r.split < 0 ||
      (r.n_chunks > 0 && (r.n_hubs == 0 || r.split == 0)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

Rows make_rows(int64_t D, const void* row_ptr, int64_t n_nodes,
               const void* hub_rows, const void* hub_chunk_ptr,
               int64_t n_hubs, int64_t n_chunks, int64_t split,
               void* partial, void* arrived, void* out) {
  return Rows{static_cast<const int64_t*>(row_ptr), n_nodes,
              static_cast<const int64_t*>(hub_rows),
              static_cast<const int64_t*>(hub_chunk_ptr), n_hubs, n_chunks,
              split, static_cast<float*>(partial),
              static_cast<unsigned int*>(arrived), out, D};
}

}  // namespace

// The previous route.  Launches on `stream` and returns a CUDA error code
// (0 on success).  Types: rows_bf16 / out_bf16 select bf16 over float32
// (float32 rows give a float32 output); perm64 / src64 select int64 over
// int32 indices.  `src` and `weights` may be null; with n_hubs == 0 the
// hub arrays, `partial` and `arrived` are never read and may be null.
extern "C" int spmm_launch(
    const void* rows, int rows_bf16, int64_t n_rows, int64_t D,
    const void* perm, int perm64, const void* src, int src64,
    const void* weights, const void* row_ptr, int64_t n_nodes,
    const void* hub_rows, const void* hub_chunk_ptr, int64_t n_hubs,
    int64_t n_chunks, int64_t split, void* partial, void* arrived,
    void* out, int out_bf16, void* stream) {
  if (n_nodes <= 0 || D <= 0) return 0;
  const Rows r = make_rows(D, row_ptr, n_nodes, hub_rows, hub_chunk_ptr,
                           n_hubs, n_chunks, split, partial, arrived, out);
  if (int rc = check_rows(r)) return rc;
  const previous::Args a{r, rows, n_rows, perm, perm64, src, src64,
                         static_cast<const float*>(weights)};
  cudaStream_t s = (cudaStream_t)stream;
  if (!rows_bf16) {
    if (out_bf16) return (int)cudaErrorInvalidValue;
    return previous::launch<float, float>(a, s);
  }
  if (out_bf16) return previous::launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return previous::launch<__nv_bfloat16, float>(a, s);
}

// The bound route: `idx` (E,) int32 / int64 (idx64) rows of R in
// destination order, each in [0, n_rows) (not checked here), `weights`
// (E,) float32 in the same order or null; `blocks` (n_blocks + 1,) int64
// the first row of each row block (0 first, n_nodes last, at most 31 rows
// a block), one warp each; n_edges = row_ptr[n_nodes], below 2^31.  The
// plan: rows are read as vectors of `vec_bytes` (16, 8 or one element),
// `lanes` lanes per edge (a power of two up to 32), `chunks` (1, 2 or 4)
// vectors a lane per column pass.
// Refused (cudaErrorInvalidValue): another plan, a row width or a `rows`
// pointer that is not a multiple of vec_bytes, `out` or `partial` not
// 16-byte aligned, a bf16 output from float32 rows, no blocks, 2^31 edges
// or more.
extern "C" int spmm_bound_launch(
    const void* rows, int rows_bf16, int64_t D, const void* idx, int idx64,
    const void* weights, int64_t n_edges, const void* row_ptr,
    int64_t n_nodes,
    const void* blocks, int64_t n_blocks, const void* hub_rows,
    const void* hub_chunk_ptr, int64_t n_hubs, int64_t n_chunks,
    int64_t split, void* partial, void* arrived, void* out, int out_bf16,
    int vec_bytes, int lanes, int chunks, void* stream) {
  if (n_nodes <= 0 || D <= 0) return 0;
  const Rows r = make_rows(D, row_ptr, n_nodes, hub_rows, hub_chunk_ptr,
                           n_hubs, n_chunks, split, partial, arrived, out);
  if (int rc = check_rows(r)) return rc;
  const int item = rows_bf16 ? 2 : 4;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes && lanes_log2 < 5) ++lanes_log2;
  if ((vec_bytes != 16 && vec_bytes != 8 && vec_bytes != item) ||
      (D * item) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(rows) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (n_hubs > 0 && reinterpret_cast<uintptr_t>(partial) % 16 != 0) ||
      (1 << lanes_log2) != lanes ||
      (chunks != 1 && chunks != 2 && chunks != 4) ||
      (!rows_bf16 && out_bf16) || n_blocks < 1 || !blocks ||
      n_edges < 0 || n_edges > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const bound::Args a{r, rows, idx, idx64, static_cast<const float*>(weights),
                      static_cast<const int64_t*>(blocks), n_blocks,
                      lanes_log2};
  cudaStream_t s = (cudaStream_t)stream;
  if (!rows_bf16) return bound::launch<float, float>(a, vec_bytes, chunks, s);
  if (out_bf16)
    return bound::launch<__nv_bfloat16, __nv_bfloat16>(a, vec_bytes, chunks,
                                                       s);
  return bound::launch<__nv_bfloat16, float>(a, vec_bytes, chunks, s);
}
