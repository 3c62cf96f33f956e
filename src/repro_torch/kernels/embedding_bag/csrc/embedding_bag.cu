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
// Design: a warp per bag.  A warp loads up to kTile of its indices and
// weights at once, coalesced, and stages their rows' byte offsets and the
// weights in shared memory.  Its lanes form R = 32 / G row slots of G
// lanes: each lane reads VEC bytes of a row (16, 8, 4 or 2, the widest
// aligned load kernel.py::plan allows), so a warp step reads R whole rows
// (D = 18 float32: 9 lanes x 8 bytes, 3 rows), and each lane keeps
// kLaneBytes of row loads in flight (a ring of steps in registers: each
// step's load is issued as the step that many before is added).  Rows
// wider than 32 vectors are walked in column passes.  Slot r sums rows r, r + R, ... of
// the bag in ascending order; the slots are then added in slot order by
// shuffles: a fixed order, so launches are bit-equal (not bit-equal to the
// previous design, which summed in l order).
//
// Bound: bytes.  At DIEN's bulk batch (65,536 bags of 100 over a 2,097,152
// x 18 float32 table) the indices and weights are 26.2 MB each and the
// output 4.7 MB; the rows touched are at most the 151 MB table, but 472 MB
// once per lookup, and 629 MB in the 32-byte sectors a 72-byte row spans
// (3): 62-205 us at 3.35 TB/s.  2 B L D operations (0.24 GFLOP) are far
// below.
//
// embedding_bag_previous_launch keeps the previous design (one thread per
// (bag, feature), l ascending), to be timed beside the new one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int64_t row_of(const void* indices, int idx64,
                                          int64_t at, int64_t V) {
  int64_t i = idx64 ? (int64_t)__ldg(static_cast<const long long*>(indices) +
                                     at)
                    : (int64_t)__ldg(static_cast<const int*>(indices) + at);
  if (i < 0) i += V;
  return i < 0 ? 0 : (i >= V ? V - 1 : i);
}

// ---------------------------------------------------------------------------
// the previous design: one thread per (bag, feature)
// ---------------------------------------------------------------------------

namespace previous {

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
  float acc = 0.0f, wsum = 0.0f;
#pragma unroll 4
  for (int64_t l = 0; l < L; ++l) {
    const int64_t i = row_of(indices, idx64, base + l, V);
    const float w = weights ? __ldg(weights + base + l) : 1.0f;
    acc = acc + w * to_f32(table[i * D + d]);
    wsum = wsum + w;
  }
  if (mean) acc = acc / fmaxf(wsum, 1e-9f);
  store(out + t, acc);
}

}  // namespace previous

// ---------------------------------------------------------------------------
// a warp per bag, rows in VEC-byte loads
// ---------------------------------------------------------------------------

// VEC bytes as 32-bit words (the low half of one word at VEC = 2)
template <int VEC>
struct Raw {
  static constexpr int kWords = VEC >= 4 ? VEC / 4 : 1;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const char* p) {
    if constexpr (VEC == 16) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else if constexpr (VEC == 8) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = x.x; w[1] = x.y;
    } else if constexpr (VEC == 4) {
      w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }
  __device__ __forceinline__ void store(char* p) const {
    if constexpr (VEC == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VEC == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)w[0];
    }
  }
};

// element e of a raw vector, and back
template <typename T, int VEC>
__device__ __forceinline__ float element(const Raw<VEC>& r, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.w[e]);
  } else {
    const uint32_t x = r.w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}
template <typename T, int VEC>
__device__ __forceinline__ void pack(Raw<VEC>& r, int e, float v) {
  if constexpr (sizeof(T) == 4) {
    r.w[e] = __float_as_uint(v);
  } else {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    r.w[e >> 1] = (e & 1) ? (r.w[e >> 1] | (h << 16)) : h;
  }
}

// lookups of a warp staged in shared memory at a time: their rows' byte
// offsets and weights
constexpr int kTile = 128;

// the row-load bytes a lane keeps in flight
constexpr int kLaneBytes = 64;

// steps of row loads a lane keeps in flight: kLaneBytes, 2 to 32 loads
template <int VEC>
struct Depth {
  static constexpr int n = kLaneBytes / VEC;
  static constexpr int value = n < 2 ? 2 : (n > 32 ? 32 : n);
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) bag_kernel(
    const T* __restrict__ table, int64_t V, int64_t D,
    const void* __restrict__ indices, int idx64,
    const float* __restrict__ weights, int64_t B, int64_t L, int mean,
    T* __restrict__ out, int G) {
  constexpr int EV = VEC / (int)sizeof(T);
  constexpr int P = Depth<VEC>::value;
  // [kWarps][kTile] row offsets, then [kWarps][kTile] weights
  extern __shared__ int64_t stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t* offs = stage + warp * kTile;
  float* wts = reinterpret_cast<float*>(stage + kWarps * kTile) +
               warp * kTile;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  if (b >= B) return;                // whole warps: the shuffles stay full
  const int64_t base = b * L;
  const int R = 32 / G;
  const int r = lane / G, c = lane - r * G;
  const int64_t nvec = D * (int64_t)sizeof(T) / VEC;
  const int64_t row_bytes = D * (int64_t)sizeof(T);

  float wsum = 0.0f;                  // the bag's weights, lane-strided
  for (int64_t q = 0; q < nvec; q += G) {        // column passes
    const int64_t col = q + c;
    const bool active = r < R && col < nvec;
    const char* src = reinterpret_cast<const char*>(table) + col * VEC;
    float acc[EV];
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[e] = 0.0f;
    for (int64_t t0 = 0; t0 < L; t0 += kTile) {
      const int n = (int)min((int64_t)kTile, L - t0);
      __syncwarp();                              // the last tile is read
      for (int i = lane; i < n; i += 32) {
        offs[i] = row_of(indices, idx64, base + t0 + i, V) * row_bytes;
        const float w = weights ? __ldg(weights + base + t0 + i) : 1.0f;
        wts[i] = w;
        if (q == 0) wsum = wsum + w;
      }
      __syncwarp();
      // step s reads row s * R + r of the tile; P steps stay in flight
      const int steps = (n + R - 1) / R;
      Raw<VEC> x[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int l = i * R + r;
        if (active && l < n) x[i].load(src + offs[l]);
      }
      for (int s0 = 0; s0 < steps; s0 += P) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int l = (s0 + i) * R + r;
          if (active && l < n) {
            const float w = wts[l];
#pragma unroll
            for (int e = 0; e < EV; ++e)
              acc[e] = acc[e] + w * element<T, VEC>(x[i], e);
          }
          const int l2 = l + P * R;
          if (active && l2 < n) x[i].load(src + offs[l2]);
        }
      }
    }
    if (q == 0) {                                // the bag's weight sum
      for (int off = 16; off > 0; off >>= 1)
        wsum = wsum + __shfl_xor_sync(0xffffffffu, wsum, off);
    }
    // the row slots' sums, added in slot order onto slot 0
    float sum[EV];
#pragma unroll
    for (int e = 0; e < EV; ++e) sum[e] = acc[e];
    for (int s = 1; s < R; ++s) {
#pragma unroll
      for (int e = 0; e < EV; ++e)
        sum[e] = sum[e] + __shfl_sync(0xffffffffu, acc[e], s * G + c);
    }
    if (r != 0 || col >= nvec) continue;
    Raw<VEC> y;
#pragma unroll
    for (int e = 0; e < EV; ++e)
      pack<T, VEC>(y, e, mean ? sum[e] / fmaxf(wsum, 1e-9f) : sum[e]);
    y.store(reinterpret_cast<char*>(out + b * D) + col * VEC);
  }
}

template <typename T, int VEC>
int launch_bags(const void* table, int64_t V, int64_t D,
                const void* indices, int idx64, const float* w, int64_t B,
                int64_t L, int mean, void* out, int G, cudaStream_t s) {
  const int64_t blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = kWarps * kTile * (sizeof(int64_t) + sizeof(float));
  bag_kernel<T, VEC><<<(unsigned int)blocks, kThreads, smem, s>>>(
      static_cast<const T*>(table), V, D, indices, idx64, w, B, L, mean,
      static_cast<T*>(out), G);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
// table_bf16 selects a bf16 table (and output) over float32; idx64 int64
// indices over int32; `weights` (B, L) float32 may be null.  `vec` bytes
// per row load (16, 8, 4, or 2 for bf16), which must divide the row's
// bytes and the table's address; G = min(32, vectors per row) lanes per row
// slot.  Refuses other values.
extern "C" int embedding_bag_launch(const void* table, int table_bf16,
                                    int64_t V, int64_t D,
                                    const void* indices, int idx64,
                                    const void* weights, int64_t B,
                                    int64_t L, int mean, void* out, int vec,
                                    int G, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (V <= 0 && L > 0) return (int)cudaErrorInvalidValue;
  const int64_t itemsize = table_bf16 ? 2 : 4;
  const int64_t nvec = vec > 0 ? D * itemsize / vec : 0;
  if (vec < itemsize || (D * itemsize) % vec || (uintptr_t)table % vec ||
      G != (nvec < 32 ? nvec : 32)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* w = static_cast<const float*>(weights);
  auto f = table_bf16 ? (vec == 16   ? launch_bags<__nv_bfloat16, 16>
                         : vec == 8 ? launch_bags<__nv_bfloat16, 8>
                         : vec == 4 ? launch_bags<__nv_bfloat16, 4>
                                    : launch_bags<__nv_bfloat16, 2>)
                      : (vec == 16   ? launch_bags<float, 16>
                         : vec == 8 ? launch_bags<float, 8>
                                    : launch_bags<float, 4>);
  return f(table, V, D, indices, idx64, w, B, L, mean, out, G, s);
}

// The previous design (one thread per (bag, feature)) on the same
// arguments, without a plan.
extern "C" int embedding_bag_previous_launch(const void* table,
                                             int table_bf16, int64_t V,
                                             int64_t D, const void* indices,
                                             int idx64, const void* weights,
                                             int64_t B, int64_t L, int mean,
                                             void* out, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (V <= 0 && L > 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (B * D + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* w = static_cast<const float*>(weights);
  if (table_bf16) {
    previous::embedding_bag_kernel<__nv_bfloat16>
        <<<(unsigned int)blocks, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(table), V, D, indices, idx64,
            w, B, L, mean, static_cast<__nv_bfloat16*>(out));
  } else {
    previous::embedding_bag_kernel<float>
        <<<(unsigned int)blocks, kThreads, 0, s>>>(
            static_cast<const float*>(table), V, D, indices, idx64, w, B, L,
            mean, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
