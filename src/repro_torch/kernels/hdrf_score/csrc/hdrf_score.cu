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
// Two entries share one kernel:
//   hdrf_bits_launch   reads the packed (V, ceil(k/32)) replica bit matrix,
//                      the degree table and the endpoints u = uv[e],
//                      v = uv[n + e] itself, and derives the host-group
//                      presence (host_any) from the same words, so no
//                      (2E, k) flag matrix, host matrix or gathered degree
//                      vector reaches device memory (the chunk functions'
//                      entry);
//   hdrf_flags_launch  takes the (E,) degrees and the (E, k) byte flags as
//                      the reference's hdrf_choose does, read 16, 8, 4, 2
//                      or 1 bytes at a time and kept as bit masks.
//
// Design: each block computes max/min of `sizes` and c_bal for all k
// partitions into shared memory once (k <= kSmemCbal; beyond, c_bal is
// recomputed from `sizes` per partition), then walks many edges, grid
// stride; the loads of a thread's first edge are issued before that
// prologue, so their latency overlaps it.  An edge belongs to a group of
// `lanes` = 1..32 lanes (a power of two, chosen by kernel.py::plan): lane
// j scores the `span` partitions from j * span in ascending order, keeping
// its best (score, index) with a strict `>`, so ties keep the lower index;
// the group's lanes then combine by xor shuffles that keep the higher
// score and, on a tie, the lower index (jnp.argmax's rule).  A lane reads
// a row's word (or flag vector) once and keeps it in a register while its
// partitions stay inside it: many edges give each lane a whole word (or
// vector), few edges one partition per lane (the shortest chain).
//
// Bound: bytes, and at the paths' sizes the latency of a few dependent
// loads.  The bits entry needs, per edge, two endpoint ids, two degrees and
// 2 ceil(k/32) words: 32 B at k = 32 with int64 ids, plus 8 B out, so a
// 65,536-edge chunk is ~2.6 MB, ~0.8 us at 3.35 TB/s (the four random
// 4-byte reads touch a 32-byte sector each: ~144 B per edge at sector
// granularity).  The flag entry reads 2 int32 degrees and 2k flag bytes
// (4k with the host flags): 80 B per edge at k = 32.  A few float
// operations per (edge, partition) are far below the float32 rate.  At the
// HDRF micro-batch (64 edges) the launch itself sets the time.
//
// Arithmetic: exactly the plain version's (core/scoring.py::hdrf_score,
// which follows what the jitted reference computes): theta = d / max(float(
// du + dv), 1) from an int32 add, g = 2 - theta, c_bal = (lam * (max - s)) /
// ((1 + max) - min), score = (g_u + g_v) + c_bal, the penalty subtracted
// after its own rounding.  The __f*_rn intrinsics keep every operation
// correctly rounded and unfused (the build also passes -fmad=false).
//
// hdrf_score_previous_launch keeps the previous design (one warp per edge,
// 8 edges per block, each block redoing the k-wide prologue) on the flag
// entry's arguments, to be timed beside the new one.
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void better(float& best, int& arg, float s, int p) {
  if (s > best || (s == best && p < arg)) {
    best = s;
    arg = p;
  }
}

// max / min of the k sizes over the block's threads (every thread calls it)
__device__ void size_range(const int32_t* __restrict__ sizes, int k,
                           int threads, float& maxf, float& minf) {
  __shared__ int wmax[32], wmin[32];
  __shared__ float smax, smin;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int mx = INT_MIN, mn = INT_MAX;
  for (int p = threadIdx.x; p < k; p += threads) {
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
    for (int w = 1; w < threads / 32; ++w) {
      mx = max(mx, wmax[w]);
      mn = min(mn, wmin[w]);
    }
    smax = __int2float_rn(mx);
    smin = __int2float_rn(mn);
  }
  __syncthreads();
  maxf = smax;
  minf = smin;
}

__device__ __forceinline__ float balance(float lam, float maxf, float denom,
                                         int32_t size) {
  return __fdiv_rn(__fmul_rn(lam, __fsub_rn(maxf, __int2float_rn(size))),
                   denom);
}

__device__ __forceinline__ void gains(int a, int b, int degree_weighted,
                                      float& gu, float& gv) {
  if (degree_weighted) {
    const float dsum = fmaxf(__int2float_rn(a + b), 1.0f);
    gu = __fsub_rn(2.0f, __fdiv_rn(__int2float_rn(a), dsum));
    gv = __fsub_rn(2.0f, __fdiv_rn(__int2float_rn(b), dsum));
  } else {
    gu = gv = 1.0f;
  }
}

// ---------------------------------------------------------------------------
// the previous design: one warp per edge, 8 edges per block
// ---------------------------------------------------------------------------

namespace previous {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;          // partitions of c_bal per shared tile

__global__ void hdrf_score_kernel(
    const int32_t* __restrict__ du, const int32_t* __restrict__ dv,
    const uint8_t* __restrict__ rep_u, const uint8_t* __restrict__ rep_v,
    const int32_t* __restrict__ sizes, const uint8_t* __restrict__ hrep_u,
    const uint8_t* __restrict__ hrep_v, float lam, float pen,
    int degree_weighted, int64_t n, int k, int32_t* __restrict__ chosen,
    float* __restrict__ best_out) {
  __shared__ float cbal[kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float maxf, minf;
  size_range(sizes, k, kThreads, maxf, minf);
  const float denom = __fsub_rn(__fadd_rn(1.0f, maxf), minf);

  const int64_t e = (int64_t)blockIdx.x * kWarps + warp;
  const bool live = e < n;
  float gu = 0.0f, gv = 0.0f;
  if (live) gains(du[e], dv[e], degree_weighted, gu, gv);
  const int64_t row = live ? e * k : 0;
  const uint8_t* ru = rep_u + row;
  const uint8_t* rv = rep_v + row;
  float best = -INFINITY;
  int arg = INT_MAX;
  for (int t0 = 0; t0 < k; t0 += kTile) {
    const int tn = min(kTile, k - t0);
    __syncthreads();                 // the previous tile is consumed
    for (int p = threadIdx.x; p < tn; p += kThreads)
      cbal[p] = balance(lam, maxf, denom, sizes[t0 + p]);
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

}  // namespace previous

// ---------------------------------------------------------------------------
// the block design: c_bal once per block, many edges per block
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
// c_bal in the 48 KB of shared memory a block takes without an opt-in,
// less 512 bytes for size_range's static arrays (264 bytes)
constexpr int kSmemCbal = (48 * 1024 - 512) / 4;

// bit i set iff byte i of x is nonzero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  const uint32_t m = __vcmpne4(x, 0u) & 0x01010101u;
  return (m | (m >> 7) | (m >> 14) | (m >> 21)) & 0xFu;
}

// 1 << lvec flag bytes at p as a bit mask (p aligned to the width)
__device__ __forceinline__ uint32_t flag_mask(const uint8_t* p, int lvec) {
  switch (lvec) {
    case 4: {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
      return nonzero_bytes(x.x) | nonzero_bytes(x.y) << 4 |
             nonzero_bytes(x.z) << 8 | nonzero_bytes(x.w) << 12;
    }
    case 3: {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      return nonzero_bytes(x.x) | nonzero_bytes(x.y) << 4;
    }
    case 2:
      return nonzero_bytes(__ldg(reinterpret_cast<const uint32_t*>(p)));
    case 1:
      return nonzero_bytes(
          __ldg(reinterpret_cast<const unsigned short*>(p)));
    default:
      return __ldg(p) != 0;
  }
}

__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// Flags [p0, p0 + n) of a byte row (n <= 32) as bits, read 1 << lvec
// bytes at a time; the last vector read stays cached.
struct FlagRow {
  const uint8_t* row;
  int lvec, chunk;
  uint32_t mask;
  __device__ FlagRow() : row(nullptr), lvec(0), chunk(-1), mask(0u) {}
  __device__ FlagRow(const uint8_t* r, int lv)
      : row(r), lvec(lv), chunk(-1), mask(0u) {}
  __device__ __forceinline__ uint32_t vector(int c) {
    if (c != chunk) {
      chunk = c;
      mask = flag_mask(row + ((int64_t)c << lvec), lvec);
    }
    return mask;
  }
  __device__ __forceinline__ void prime(int p) { vector(p >> lvec); }
  __device__ __forceinline__ uint32_t bits(int p0, int n) {
    const int first = p0 >> lvec, last = (p0 + n - 1) >> lvec;
    uint64_t acc = 0;
    for (int c = first; c <= last; ++c)
      acc |= (uint64_t)vector(c) << ((c - first) << lvec);
    return (uint32_t)(acc >> (p0 - (first << lvec)));
  }
};

// Bits [p0, p0 + n) of a packed row (n <= 32); the last word read stays
// cached.
struct BitRow {
  const uint32_t* row;
  int index;
  uint32_t word;
  __device__ BitRow() : row(nullptr), index(-1), word(0u) {}
  __device__ explicit BitRow(const uint32_t* r)
      : row(r), index(-1), word(0u) {}
  __device__ __forceinline__ uint32_t at(int i) {
    if (i != index) {
      index = i;
      word = __ldg(row + i);
    }
    return word;
  }
  __device__ __forceinline__ void prime(int p) { at(p >> 5); }
  __device__ __forceinline__ uint32_t bits(int p0, int n) {
    const int i = p0 >> 5, sh = p0 & 31;
    const uint32_t w0 = at(i);
    if (sh + n <= 32) return w0 >> sh;
    return __funnelshift_r(w0, at(i + 1), sh);
  }
};

// whether any of bits [lo, hi) of a packed row is set
__device__ bool any_bit(const uint32_t* row, int lo, int hi) {
  for (int w = lo >> 5; w <= (hi - 1) >> 5; ++w) {
    const int a = max(lo - (w << 5), 0), b = min(hi - (w << 5), 32);
    if (__ldg(row + w) & low_bits(b) & ~low_bits(a)) return true;
  }
  return false;
}

// host_any from a packed row for partitions [p0, p0 + n) (n <= 32) as
// bits: bit i says the row has a bit in the host group of p0 + i (`group`
// consecutive partitions, which may straddle words); the last group's
// answer stays cached.
struct GroupRow {
  const uint32_t* row;
  int group, lo;
  bool any;
  __device__ GroupRow() : row(nullptr), group(1), lo(-1), any(false) {}
  __device__ GroupRow(const uint32_t* r, int g)
      : row(r), group(g), lo(-1), any(false) {}
  __device__ __forceinline__ uint32_t bits(int p0, int n) {
    uint32_t out = 0;
    for (int g = p0 - p0 % group; g < p0 + n; g += group) {
      if (g != lo) {
        lo = g;
        any = any_bit(row, g, g + group);
      }
      if (any) {
        const int a = max(g - p0, 0), b = min(g + group - p0, n);
        out |= low_bits(b) & ~low_bits(a);
      }
    }
    return out;
  }
};

struct Balance {
  const float* cbal;                 // shared c_bal, or null beyond kSmemCbal
  const int32_t* sizes;
  float lam, maxf, denom;
  __device__ __forceinline__ float operator()(int p) const {
    return cbal ? cbal[p] : balance(lam, maxf, denom, sizes[p]);
  }
};

// One edge's operands as one lane holds them: the endpoints' degrees and
// their rows' readers (Row: replicas, Host: host-group presence).  `load`
// issues the loads a lane's first partition needs, so that they are in
// flight while the block computes the balance term; `score` scores the
// lane's partitions [lo, hi) in ascending order, keeping the first best.
template <class Row, class Host>
struct Edge {
  int a, b;
  Row ru, rv;
  Host hu, hv;
  template <bool kHost>
  __device__ __forceinline__ void score(int lo, int hi, int dw, float pen,
                                        const Balance& bal, float& best,
                                        int& arg) {
    float gu, gv;
    gains(a, b, dw, gu, gv);
    // (g_u + g_v) for each pair of replica flags, and the penalty for
    // each count of missing host groups, as the plain version rounds them
    const float g00 = __fadd_rn(0.0f, 0.0f), g01 = __fadd_rn(0.0f, gv);
    const float g10 = __fadd_rn(gu, 0.0f), g11 = __fadd_rn(gu, gv);
    const float pen0 = __fmul_rn(pen, __fadd_rn(0.0f, 0.0f));
    const float pen1 = __fmul_rn(pen, __fadd_rn(0.0f, 1.0f));
    const float pen2 = __fmul_rn(pen, __fadd_rn(1.0f, 1.0f));
    for (int p0 = lo; p0 < hi; p0 += 32) {
      const int n = min(32, hi - p0);
      const uint32_t mu = ru.bits(p0, n), mv = rv.bits(p0, n);
      uint32_t xu = 0, xv = 0;
      if constexpr (kHost) {
        xu = hu.bits(p0, n);
        xv = hv.bits(p0, n);
      }
      for (int i = 0; i < n; ++i) {
        const bool bu = (mu >> i) & 1u, bv = (mv >> i) & 1u;
        float s = __fadd_rn(bu ? (bv ? g11 : g10) : (bv ? g01 : g00),
                            bal(p0 + i));
        if constexpr (kHost) {
          const bool hu_i = (xu >> i) & 1u, hv_i = (xv >> i) & 1u;
          s = __fsub_rn(s, hu_i ? (hv_i ? pen0 : pen1)
                                : (hv_i ? pen1 : pen2));
        }
        if (s > best) {              // p rises: ties keep the lower index
          best = s;
          arg = p0 + i;
        }
      }
    }
  }
};

// the flag entry's operands
struct FlagEdges {
  using Op = Edge<FlagRow, FlagRow>;
  const int32_t* du;
  const int32_t* dv;
  const uint8_t* ru;
  const uint8_t* rv;
  const uint8_t* hu;
  const uint8_t* hv;
  int lvec;
  template <bool kHost>
  __device__ __forceinline__ void load(Op& op, int64_t e, int64_t n, int k,
                                       int lo) const {
    op.a = __ldg(du + e);
    op.b = __ldg(dv + e);
    const int64_t row = e * k;
    op.ru = FlagRow(ru + row, lvec);
    op.rv = FlagRow(rv + row, lvec);
    if constexpr (kHost) {
      op.hu = FlagRow(hu + row, lvec);
      op.hv = FlagRow(hv + row, lvec);
    }
    if (lo < k) {                    // the first vectors, in flight
      op.ru.prime(lo);
      op.rv.prime(lo);
      if constexpr (kHost) {
        op.hu.prime(lo);
        op.hv.prime(lo);
      }
    }
  }
};

// the bits entry's operands: endpoints, degree table, packed rows
struct BitEdges {
  using Op = Edge<BitRow, GroupRow>;
  const uint32_t* bits;
  const int32_t* d;
  const void* uv;
  int64_t V;
  int words, idx64, group;
  __device__ __forceinline__ int64_t vertex(int64_t i) const {
    int64_t x = idx64 ? __ldg(static_cast<const long long*>(uv) + i)
                      : (int64_t)__ldg(static_cast<const int*>(uv) + i);
    if (x < 0) x += V;               // JAX's gather rule: wrap once, clamp
    return x < 0 ? 0 : (x >= V ? V - 1 : x);
  }
  template <bool kHost>
  __device__ __forceinline__ void load(Op& op, int64_t e, int64_t n, int k,
                                       int lo) const {
    const int64_t u = vertex(e), v = vertex(n + e);
    op.a = __ldg(d + u);
    op.b = __ldg(d + v);
    const uint32_t* row_u = bits + u * words;
    const uint32_t* row_v = bits + v * words;
    op.ru = BitRow(row_u);
    op.rv = BitRow(row_v);
    if constexpr (kHost) {
      op.hu = GroupRow(row_u, group);
      op.hv = GroupRow(row_v, group);
    }
    if (lo < k) {                    // the first words, in flight
      op.ru.prime(lo);
      op.rv.prime(lo);
    }
  }
};

template <bool kHost, class Edges>
__global__ void __launch_bounds__(kThreads) hdrf_kernel(
    Edges edges, const int32_t* __restrict__ sizes, float lam, float pen,
    int degree_weighted, int64_t n, int k, int lanes_log2, int span,
    int32_t* __restrict__ chosen, float* __restrict__ best_out) {
  extern __shared__ float cbal[];
  const int lanes = 1 << lanes_log2;
  const int j = threadIdx.x & (lanes - 1);
  const int per_block = kThreads >> lanes_log2;
  const int lo = j * span, hi = min(k, lo + span);
  const int64_t stride = (int64_t)gridDim.x * per_block;
  int64_t base = (int64_t)blockIdx.x * per_block;
  int64_t e = base + (threadIdx.x >> lanes_log2);
  // the first edge's loads, in flight across the block's prologue
  typename Edges::Op op;
  if (e < n) edges.template load<kHost>(op, e, n, k, lo);

  float maxf, minf;
  size_range(sizes, k, kThreads, maxf, minf);
  const float denom = __fsub_rn(__fadd_rn(1.0f, maxf), minf);
  const bool in_smem = k <= kSmemCbal;
  if (in_smem)
    for (int p = threadIdx.x; p < k; p += kThreads)
      cbal[p] = balance(lam, maxf, denom, sizes[p]);
  __syncthreads();
  const Balance bal{in_smem ? cbal : nullptr, sizes, lam, maxf, denom};

  // lane j of an edge's `lanes` scores partitions [j * span, (j + 1) *
  // span); the trip count depends on the block alone, so every lane
  // reaches the shuffles of every step
  for (; base < n; base += stride) {
    e = base + (threadIdx.x >> lanes_log2);
    if (base != (int64_t)blockIdx.x * per_block && e < n)
      edges.template load<kHost>(op, e, n, k, lo);
    float best = -INFINITY;
    int arg = INT_MAX;
    if (e < n)
      op.template score<kHost>(lo, hi, degree_weighted, pen, bal, best,
                               arg);
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
      better(best, arg, ob, oa);
    }
    if (e < n && j == 0) {
      chosen[e] = arg;
      best_out[e] = best;
    }
  }
}

// refuses what the kernel cannot take; else launches and returns
// cudaGetLastError()
template <bool kHost, class Edges>
int launch_edges(const Edges& edges, const int32_t* sizes, float lam,
                 float pen, int degree_weighted, int64_t n, int k,
                 int lanes_log2, int span, int blocks, int32_t* chosen,
                 float* best, cudaStream_t stream) {
  if (lanes_log2 < 0 || lanes_log2 > 5 || blocks < 1 || span < 1 ||
      (int64_t)span << lanes_log2 < k)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k <= kSmemCbal ? (size_t)k * sizeof(float) : 0;
  hdrf_kernel<kHost, Edges><<<blocks, kThreads, smem, stream>>>(
      edges, sizes, lam, pen, degree_weighted, n, k, lanes_log2, span,
      chosen, best);
  return (int)cudaGetLastError();
}

}  // namespace

// The flag entry.  du / dv (n,) int32; rep_u / rep_v (and hrep_u / hrep_v
// when pen != 0, else never read and may be null) row-major (n, k) byte
// matrices, each base and k a multiple of 1 << vec_log2 bytes; sizes (k,)
// int32.  `blocks` blocks of 256 threads, 1 << lanes_log2 lanes per edge,
// each scoring `span` consecutive partitions (lanes * span >= k).
// Returns a CUDA error code (0 on success).
extern "C" int hdrf_flags_launch(
    const void* du, const void* dv, const void* rep_u, const void* rep_v,
    const void* sizes, const void* hrep_u, const void* hrep_v, float lam,
    float pen, int degree_weighted, int64_t n, int k, int lanes_log2,
    int span, int vec_log2, int blocks, void* chosen, void* best,
    void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (vec_log2 < 0 || vec_log2 > 4 || k % (1 << vec_log2)) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t align = (1u << vec_log2) - 1u;
  const bool host = pen != 0.0f;
  if (((uintptr_t)rep_u | (uintptr_t)rep_v) & align ||
      (host && ((uintptr_t)hrep_u | (uintptr_t)hrep_v) & align)) {
    return (int)cudaErrorMisalignedAddress;
  }
  const FlagEdges edges{(const int32_t*)du, (const int32_t*)dv,
                        (const uint8_t*)rep_u, (const uint8_t*)rep_v,
                        (const uint8_t*)hrep_u, (const uint8_t*)hrep_v,
                        vec_log2};
  auto f = host ? launch_edges<true, FlagEdges>
                : launch_edges<false, FlagEdges>;
  return f(edges, (const int32_t*)sizes, lam, pen, degree_weighted, n, k,
           lanes_log2, span, blocks, (int32_t*)chosen, (float*)best,
           (cudaStream_t)stream);
}

// The bits entry.  bits (V, words) int32, words = ceil(k / 32); d (V,)
// int32; uv (2n,) int32 or int64 (idx64), u's then v's, each wrapped once
// and clamped to [0, V); with pen != 0 the host groups are `group`
// consecutive partitions (k a multiple of group).  Returns a CUDA error
// code (0 on success).
extern "C" int hdrf_bits_launch(
    const void* bits, int64_t V, int words, const void* d, const void* uv,
    int idx64, const void* sizes, float lam, float pen, int group,
    int degree_weighted, int64_t n, int k, int lanes_log2, int span,
    int blocks, void* chosen, void* best, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const bool host = pen != 0.0f;
  if (V <= 0 || words != (k + 31) / 32 ||
      (host && (group <= 0 || k % group))) {
    return (int)cudaErrorInvalidValue;
  }
  const BitEdges edges{(const uint32_t*)bits, (const int32_t*)d, uv, V,
                       words, idx64, host ? group : k};
  auto f = host ? launch_edges<true, BitEdges>
                : launch_edges<false, BitEdges>;
  return f(edges, (const int32_t*)sizes, lam, pen, degree_weighted, n, k,
           lanes_log2, span, blocks, (int32_t*)chosen, (float*)best,
           (cudaStream_t)stream);
}

// The previous design on the flag entry's arguments (any alignment).
extern "C" int hdrf_score_previous_launch(
    const void* du, const void* dv, const void* rep_u, const void* rep_v,
    const void* sizes, const void* hrep_u, const void* hrep_v, float lam,
    float pen, int degree_weighted, int64_t n, int k, void* chosen,
    void* best, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const int64_t blocks = (n + previous::kWarps - 1) / previous::kWarps;
  previous::hdrf_score_kernel<<<(unsigned int)blocks, previous::kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const int32_t*)du, (const int32_t*)dv, (const uint8_t*)rep_u,
      (const uint8_t*)rep_v, (const int32_t*)sizes, (const uint8_t*)hrep_u,
      (const uint8_t*)hrep_v, lam, pen, degree_weighted, n, k,
      (int32_t*)chosen, (float*)best);
  return (int)cudaGetLastError();
}
