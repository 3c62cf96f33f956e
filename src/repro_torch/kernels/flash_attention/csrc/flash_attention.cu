// Causal / non-causal GQA attention with an online softmax on Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas; body _flash_kernel).  For q (B, Hq, Sq, D) and
// k, v (B, Hkv, Skv, D) it writes o (B, Hq, Sq, D), contiguous, in the
// operands' type:
//
//   o[b, h, i] = softmax_j(q[b, h, i] . k[b, h / (Hq / Hkv), j] * scale)
//                . v[b, h / (Hq / Hkv), :]
//
// with scale = 1 / sqrt(D) and, when causal, key j visible to query i iff
// j <= i + (Skv - Sq) (global coordinates: decode and chunked prefill read
// a longer cache than they have queries).  As the TPU kernel does, it
// keeps an fp32 running max m, denominator l and accumulator per query
// row, masks with -1e30, skips key tiles wholly above the diagonal and
// ends with acc / max(l, 1e-30).  Operands are float32 or bfloat16; every
// product and sum is float32 (bf16 operands are widened when staged, as
// the TPU kernel's astype(float32)).  Any D <= 256, Sq >= 1 and Skv >= 1:
// no padding of D to 128 lanes or of the sequences to 128-row blocks is
// asked of the caller.  q, k and v may be strided views (the unit stride
// must be D's), so the model's (B, S, H, D) projections are read in place.
//
// Design: one block of 256 threads per (64-query tile, query head,
// batch), heaviest causal tiles first.  q's tile sits transposed in
// shared memory for the whole block; each 64-key tile of k is staged
// transposed, scored, and then the same buffer takes the tile of v.
// Thread (ty, tx) of the 16 x 16 grid owns rows 4ty..4ty+3: it forms the
// 4 x 4 scores of columns 4tx..4tx+3 (two float4 loads per 16 fmaf), and
// the row's max and sum are reduced over the 16 threads of a half-warp by
// shuffles, so the softmax state m, l of a row lives in the registers of
// the threads that also hold the row's accumulator (columns 4tx + 64g +
// e, e < 4, g < G).  p goes through shared memory (transposed) to the
// P.V products.  Shared memory: (2 D + 64) * 68 floats, 87 KB at D = 128,
// so two blocks share an SM.
//
// Bound: 4 D operations per visible (query, key) pair and head, 6.6e12 for
// a causal (1, 24, 32768, 128) call, which is 6.7 ms at the bf16 tensor
// core peak (989 TFLOP/s) against 0.13 ms for its bytes: the operations
// bound it.  This first version runs them as float32 fmaf on the CUDA
// cores (67 TFLOP/s peak), so it cannot come within 15x of that bound;
// mma.sync / wgmma on bf16 tiles with TMA staging is the later speed work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // a 16 x 16 grid of (ty, tx)
constexpr int kStride = 68;      // row stride (floats) of the transposed
                                 // tiles: 16-byte rows, 4-way store conflicts
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ int kv_floats(int D, int G) {
  return D * kStride > kBK * 64 * G ? D * kStride : kBK * 64 * G;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int D, int G) {
  return sizeof(float) * ((size_t)D * kStride + kv_floats(D, G)
                          + (size_t)kBK * kStride);
}

// G: float4 column groups of 64 per thread row, D <= 64 G
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv, int Sq,
    int Skv, int D, int causal, float scale, int64_t qsb, int64_t qsh,
    int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
    int64_t vsh, int64_t vss) {
  constexpr int DP = 64 * G;               // row stride of the v tile
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [D][kStride]
  float* kv = qT + D * kStride;            // [D][kStride] k^T, [kBK][DP] v
  float* pT = kv + kv_floats(D, G);        // [kBK][kStride] p^T

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const int64_t offset = (int64_t)Skv - Sq;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int i = idx / D, d = idx - i * D;
    const int row = q0 + i;
    qT[d * kStride + i] = row < Sq ? to_float(qb[row * qss + d]) : 0.0f;
  }
  // causal: the last key the block's last row sees bounds the tiles
  int64_t kv_end = Skv;
  if (causal) {
    const int64_t last = (int64_t)q0 + kBQ - 1 + offset;
    kv_end = last + 1 < kv_end ? last + 1 : kv_end;
    if (kv_end < 0) kv_end = 0;
  }
  const int n_tiles = (int)((kv_end + kBK - 1) / kBK);

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[a][c] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBK;
    __syncthreads();             // the last tile's v and p are read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx - j * D;
      const int col = j0 + j;
      kv[d * kStride + j] = col < Skv ? to_float(kb[col * kss + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qT + d * kStride
                                                         + 4 * ty);
      const float4 kc = *reinterpret_cast<const float4*>(kv + d * kStride
                                                         + 4 * tx);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kr[4] = {kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qr[a], kr[c], s[a][c]);
    }

    // scale and mask, then the online softmax of each of the 4 rows; a
    // row's 64 columns lie in the 16 threads of one half-warp
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int64_t row = (int64_t)q0 + 4 * ty + a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t col = (int64_t)j0 + 4 * tx + c;
        const bool ok = col < Skv && (!causal || col <= row + offset);
        s[a][c] = ok ? s[a][c] * scale : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = expf(s[a][c] - m_new);
        sum += s[a][c];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[a] = alpha * l[a] + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[a][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pT + (4 * tx + c) * kStride + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();             // k^T is read and p^T written

    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int j = idx / DP, d = idx - j * DP;
      const int col = j0 + j;
      kv[idx] = (col < Skv && d < D) ? to_float(vb[col * vss + d]) : 0.0f;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(pT + j * kStride
                                                         + 4 * ty);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vc = *reinterpret_cast<const float4*>(
            kv + j * DP + 64 * g + 4 * tx);
        const float vr[4] = {vc.x, vc.y, vc.z, vc.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[a][4 * g + e] = fmaf(pr[a], vr[e], acc[a][4 * g + e]);
      }
    }
  }

  T* ob = o + ((int64_t)b * Hq + h) * Sq * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + 4 * ty + a;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * g + 4 * tx + e;
        if (d < D) store(ob + (int64_t)row * D + d, acc[a][4 * g + e] / denom);
      }
  }
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int causal, float scale,
           const int64_t* st, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, G);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D,
      causal, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, int causal,
             float scale, const int64_t* st, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 1>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale,
                        st, stream);
  if (D <= 128)
    return launch<T, 2>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale,
                        st, stream);
  return launch<T, 4>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, st,
                      stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  strides: q's, k's, v's (batch, head,
// position) strides in elements.  Returns the CUDA error of the launch
// (0 on success); shapes the kernel does not take return
// cudaErrorInvalidValue without launching.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int Hq, int Hkv,
                           int Sq, int Skv, int D, int causal, float scale,
                           const int64_t* strides, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 || D < 1
      || D > 256 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                           scale, strides, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                   causal, scale, strides, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
