// Backward of GQA attention on Hopper (sm_90a): dQ, dK and dV of
// flash_attention.cu's function.
//
// The reference's Pallas kernel (src/repro/kernels/flash_attention/
// kernel.py, flash_attention_pallas) has no backward: off the TPU its op
// runs the plain gqa_attention, and jax.grad differentiates that.  On the
// card the port's forward is the hand-written kernel, so its gradient is a
// kernel too, written from the gradient of the plain function:
//
//   s_ij  = scale * q_i . k_j   (masked: -1e30; causal in global
//                                coordinates, key j visible to query i iff
//                                j <= i + Skv - Sq)
//   p_ij  = exp(s_ij - lse_i),  lse_i = log sum_j exp(s_ij)
//   dv_j  = sum_i p_ij do_i                dp_ij = do_i . v_j
//   ds_ij = p_ij (dp_ij - delta_i),        delta_i = do_i . o_i
//   dq_i  = scale sum_j ds_ij k_j          dk_j  = scale sum_i ds_ij q_i
//
// summed over the query heads of a kv head (h / (Hq / Hkv)) for dk and dv.
// Three kernels, launched in order by flash_attention_backward_launch:
//
//   lse_delta_kernel  one block per (64-query tile, query head, batch):
//                     recomputes each row's log-sum-exp by the forward's
//                     online max and sum over the visible key tiles, and
//                     delta_i from the forward's output o;
//   dq_kernel         one block per (64-query tile, query head, batch):
//                     walks the visible key tiles, recomputes p and ds,
//                     and accumulates dq;
//   dkv_kernel        one block per (64-key tile, kv head, batch): walks
//                     the group's query heads and, per head, the query
//                     tiles that see the key tile, and accumulates dk and
//                     dv.
//
// Every output element has one owner, which sums in a fixed order: no
// atomics, so two launches on the same inputs give the same bits.  All
// arithmetic is float32 fmaf on the CUDA cores, the operands widened from
// their type (float32 or bf16) as they are staged; outputs are rounded to
// the operands' type once.  The build's -fmad=false keeps every other
// multiply and add unfused.
//
// Bound: 4 D operations per visible (query, key) pair and head for the
// three products of dq_kernel and dkv_kernel's four (S and dP are formed
// twice), plus lse_delta_kernel's 2 D: 18 D a pair in all; for
// starcoder2-3b's (1, 24/2, 4096, 128) causal layer 1.9e11 operations,
// 2.9 ms at the float32 rate (67 TFLOP/s), 0.19 ms at the bf16 tensor-core
// rate, against 0.13 GB of operands and gradients (0.04 ms at 3.35 TB/s):
// operations bound it.  This first design is the SIMT tiling of the
// forward's float32 kernel (4 x 4 register tiles per thread, tiles staged
// transposed in shared memory, 64-row tiles, 256 threads): simple and
// exact, not the tensor-core design a later PR would give it.  Shared
// memory holds, besides the block's own two tiles, one staging buffer that
// the key (or query) tile, the value (or output-gradient) tile and the
// row-major copy for the last product take in turn, and the 64 x 64
// probabilities: 119 KB at D = 128, 221 KB at D = 256 (one block per SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kT = 64;           // rows per tile (queries or keys)
constexpr int kThreads = 256;    // a 16 x 16 grid of (ty, tx)
constexpr int kStride = 68;      // row stride (floats) of a transposed tile
constexpr int kInvalid = (int)cudaErrorInvalidValue;

struct Geo {
  int B, Hq, Hkv, Sq, Skv, D, causal;
  float scale;
  int64_t qs[3], ks[3], vs[3];   // (batch, head, position) strides
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [r0, r0 + kT) of an (S, D) operand, position stride ss, into
// dst[d * kStride + i] (transposed); rows >= S are zeros
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, const T* src, int64_t r0,
                                        int64_t S, int D, int64_t ss,
                                        int tid) {
  for (int idx = tid; idx < kT * D; idx += kThreads) {
    const int i = idx / D, d = idx - i * D;
    const int64_t row = r0 + i;
    dst[d * kStride + i] = row < S ? to_float(src[row * ss + d]) : 0.0f;
  }
}

// the same rows into dst[i * DP + d] (row-major); columns >= D are zeros
template <typename T>
__device__ __forceinline__ void stage_r(float* dst, const T* src, int64_t r0,
                                        int64_t S, int D, int DP, int64_t ss,
                                        int tid) {
  for (int idx = tid; idx < kT * DP; idx += kThreads) {
    const int i = idx / DP, d = idx - i * DP;
    const int64_t row = r0 + i;
    dst[idx] = (row < S && d < D) ? to_float(src[row * ss + d]) : 0.0f;
  }
}

// s[a][c] = sum_d A[d][4 ty + a] * Bt[d][4 tx + c] over two transposed tiles
__device__ __forceinline__ void tile_product(const float* A, const float* Bt,
                                             int D, int ty, int tx,
                                             float (&s)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(A + d * kStride + 4 * ty);
    const float4 y = *reinterpret_cast<const float4*>(Bt + d * kStride + 4 * tx);
    const float xr[4] = {x.x, x.y, x.z, x.w};
    const float yr[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = fmaf(xr[a], yr[c], s[a][c]);
  }
}

// acc[a][4 g + e] += sum_j P[j][4 ty + a] * R[j][64 g + 4 tx + e]: P a
// (64, 64) tile stored [j][row] (stride kStride), R row-major (64, DP)
template <int G>
__device__ __forceinline__ void accumulate(const float* P, const float* R,
                                           int ty, int tx,
                                           float (&acc)[4][4 * G]) {
  constexpr int DP = 64 * G;
  for (int j = 0; j < kT; ++j) {
    const float4 pa = *reinterpret_cast<const float4*>(P + j * kStride + 4 * ty);
    const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 rc = *reinterpret_cast<const float4*>(R + j * DP + 64 * g
                                                         + 4 * tx);
      const float rr[4] = {rc.x, rc.y, rc.z, rc.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[a][4 * g + e] = fmaf(pr[a], rr[e], acc[a][4 * g + e]);
    }
  }
}

// the causal limit of a query tile: one past the last key its last row sees
__device__ __forceinline__ int64_t kv_end_of(const Geo& g, int64_t q0) {
  int64_t end = g.Skv;
  if (g.causal) {
    const int64_t last = q0 + kT - 1 + (int64_t)g.Skv - g.Sq;
    end = last + 1 < end ? last + 1 : end;
    if (end < 0) end = 0;
  }
  return end;
}

__device__ __forceinline__ bool visible(const Geo& g, int64_t row,
                                        int64_t col) {
  return row < g.Sq && col < g.Skv
         && (!g.causal || col <= row + (int64_t)g.Skv - g.Sq);
}

__host__ __device__ __forceinline__ size_t tile_floats(int D) {
  return (size_t)D * kStride;
}

__host__ __device__ __forceinline__ size_t buf_floats(int D, int G) {
  const size_t t = tile_floats(D), r = (size_t)kT * 64 * G;
  return t > r ? t : r;
}

// ---------------------------------------------------------------------------
// lse and delta per query row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) lse_delta_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ lse, float* __restrict__ delta, Geo g) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT_ = qT + tile_floats(g.D);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t q0 = (int64_t)blockIdx.x * kT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (g.Hq / g.Hkv);
  const T* qb = q + b * g.qs[0] + h * g.qs[1];
  const T* kb = k + b * g.ks[0] + hk * g.ks[1];
  const int64_t rows_off = ((int64_t)b * g.Hq + h) * g.Sq;

  stage_t(qT, qb, q0, g.Sq, g.D, g.qs[2], tid);
  const int n_tiles = (int)((kv_end_of(g, q0) + kT - 1) / kT);
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.0f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t j0 = (int64_t)t * kT;
    __syncthreads();
    stage_t(kT_, kb, j0, g.Skv, g.D, g.ks[2], tid);
    __syncthreads();
    float s[4][4];
    tile_product(qT, kT_, g.D, ty, tx, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int64_t row = q0 + 4 * ty + a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = visible(g, row, j0 + 4 * tx + c) ? s[a][c] * g.scale
                                                    : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += expf(s[a][c] - m_new);
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[a] = expf(m[a] - m_new) * l[a] + sum;
      m[a] = m_new;
    }
  }
  // delta: the 16 threads of a row's half-warp split D
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t row = q0 + 4 * ty + a;
    float part = 0.0f;
    if (row < g.Sq) {
      const T* orow = o + (rows_off + row) * g.D;
      const T* drow = dout + (rows_off + row) * g.D;
      for (int d = tx; d < g.D; d += 16)
        part = fmaf(to_float(drow[d]), to_float(orow[d]), part);
    }
#pragma unroll
    for (int w = 8; w > 0; w >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, w);
    if (tx == 0 && row < g.Sq) {
      lse[rows_off + row] = m[a] + logf(l[a]);
      delta[rows_off + row] = part;
    }
  }
}

// ---------------------------------------------------------------------------
// dq per query tile
// ---------------------------------------------------------------------------

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, Geo g) {
  constexpr int DP = 64 * G;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* doT = qT + tile_floats(g.D);
  float* buf = doT + tile_floats(g.D);
  float* dsT = buf + buf_floats(g.D, G);     // [key][query]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * kT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (g.Hq / g.Hkv);
  const T* qb = q + b * g.qs[0] + h * g.qs[1];
  const T* kb = k + b * g.ks[0] + hk * g.ks[1];
  const T* vb = v + b * g.vs[0] + hk * g.vs[1];
  const int64_t rows_off = ((int64_t)b * g.Hq + h) * g.Sq;
  const T* dob = dout + rows_off * g.D;

  stage_t(qT, qb, q0, g.Sq, g.D, g.qs[2], tid);
  stage_t(doT, dob, q0, g.Sq, g.D, (int64_t)g.D, tid);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t row = q0 + 4 * ty + a;
    lse_r[a] = row < g.Sq ? lse[rows_off + row] : 0.0f;
    delta_r[a] = row < g.Sq ? delta[rows_off + row] : 0.0f;
  }
  float acc[4][4 * G];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[a][c] = 0.0f;

  const int n_tiles = (int)((kv_end_of(g, q0) + kT - 1) / kT);
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t j0 = (int64_t)t * kT;
    __syncthreads();               // the last tile's buf and dsT are read
    stage_t(buf, kb, j0, g.Skv, g.D, g.ks[2], tid);
    __syncthreads();
    float p[4][4];
    tile_product(qT, buf, g.D, ty, tx, p);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[a][c] = visible(g, q0 + 4 * ty + a, j0 + 4 * tx + c)
                      ? expf(p[a][c] * g.scale - lse_r[a]) : 0.0f;
    __syncthreads();
    stage_t(buf, vb, j0, g.Skv, g.D, g.vs[2], tid);
    __syncthreads();
    float dp[4][4];
    tile_product(doT, buf, g.D, ty, tx, dp);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds[a] = p[a][c] * (dp[a][c] - delta_r[a]);
      *reinterpret_cast<float4*>(dsT + (4 * tx + c) * kStride + 4 * ty) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    stage_r(buf, kb, j0, g.Skv, g.D, DP, g.ks[2], tid);
    __syncthreads();
    accumulate<G>(dsT, buf, ty, tx, acc);
  }

  T* dqb = dq + rows_off * g.D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t row = q0 + 4 * ty + a;
    if (row >= g.Sq) continue;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * gg + 4 * tx + e;
        if (d < g.D) store(dqb + row * g.D + d, acc[a][4 * gg + e] * g.scale);
      }
  }
}

// ---------------------------------------------------------------------------
// dk and dv per key tile, summed over the group's query heads
// ---------------------------------------------------------------------------

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, Geo g) {
  constexpr int DP = 64 * G;
  extern __shared__ float4 smem4[];
  float* kT_ = reinterpret_cast<float*>(smem4);
  float* vT = kT_ + tile_floats(g.D);
  float* buf = vT + tile_floats(g.D);
  float* pT = buf + buf_floats(g.D, G);      // [query][key]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t j0 = (int64_t)blockIdx.x * kT;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = g.Hq / g.Hkv;
  const T* kb = k + b * g.ks[0] + hk * g.ks[1];
  const T* vb = v + b * g.vs[0] + hk * g.vs[1];
  const int64_t offset = (int64_t)g.Skv - g.Sq;

  stage_t(kT_, kb, j0, g.Skv, g.D, g.ks[2], tid);
  stage_t(vT, vb, j0, g.Skv, g.D, g.vs[2], tid);
  float dka[4][4 * G], dva[4][4 * G];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) dka[a][c] = dva[a][c] = 0.0f;

  // causal: the first query that sees key j0 is j0 - offset
  int64_t i_first = g.causal ? j0 - offset : 0;
  if (i_first < 0) i_first = 0;
  const int t_first = (int)(i_first / kT);
  const int n_tiles = (g.Sq + kT - 1) / kT;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const T* qb = q + b * g.qs[0] + h * g.qs[1];
    const int64_t rows_off = ((int64_t)b * g.Hq + h) * g.Sq;
    const T* dob = dout + rows_off * g.D;
    for (int t = t_first; t < n_tiles; ++t) {
      const int64_t i0 = (int64_t)t * kT;
      float lse_c[4], delta_c[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t row = i0 + 4 * tx + c;
        lse_c[c] = row < g.Sq ? lse[rows_off + row] : 0.0f;
        delta_c[c] = row < g.Sq ? delta[rows_off + row] : 0.0f;
      }
      __syncthreads();             // the last tile's buf and pT are read
      stage_t(buf, qb, i0, g.Sq, g.D, g.qs[2], tid);
      __syncthreads();
      float p[4][4];               // p[key a][query c]
      tile_product(kT_, buf, g.D, ty, tx, p);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          p[a][c] = visible(g, i0 + 4 * tx + c, j0 + 4 * ty + a)
                        ? expf(p[a][c] * g.scale - lse_c[c]) : 0.0f;
      __syncthreads();
      stage_t(buf, dob, i0, g.Sq, g.D, (int64_t)g.D, tid);
      __syncthreads();
      float ds[4][4];
      tile_product(vT, buf, g.D, ty, tx, ds);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          ds[a][c] = p[a][c] * (ds[a][c] - delta_c[c]);
        *reinterpret_cast<float4*>(pT + (4 * tx + c) * kStride + 4 * ty) =
            make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
      }
      __syncthreads();
      stage_r(buf, dob, i0, g.Sq, g.D, DP, (int64_t)g.D, tid);
      __syncthreads();
      accumulate<G>(pT, buf, ty, tx, dva);
      __syncthreads();             // pT and buf are read
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(pT + (4 * tx + c) * kStride + 4 * ty) =
            make_float4(ds[0][c], ds[1][c], ds[2][c], ds[3][c]);
      stage_r(buf, qb, i0, g.Sq, g.D, DP, g.qs[2], tid);
      __syncthreads();
      accumulate<G>(pT, buf, ty, tx, dka);
    }
  }

  const int64_t base = ((int64_t)b * g.Hkv + hk) * g.Skv;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t row = j0 + 4 * ty + a;
    if (row >= g.Skv) continue;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * gg + 4 * tx + e;
        if (d >= g.D) continue;
        store(dk + (base + row) * g.D + d, dka[a][4 * gg + e] * g.scale);
        store(dv + (base + row) * g.D + d, dva[a][4 * gg + e]);
      }
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, const Geo& g, cudaStream_t stream) {
  const size_t t = tile_floats(g.D) * sizeof(float);
  const size_t main_smem = 2 * t + buf_floats(g.D, G) * sizeof(float)
                           + (size_t)kT * kStride * sizeof(float);
  int err;
  if ((err = allow_smem(lse_delta_kernel<T>, 2 * t))) return err;
  if ((err = allow_smem(dq_kernel<T, G>, main_smem))) return err;
  if ((err = allow_smem(dkv_kernel<T, G>, main_smem))) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const dim3 qgrid((g.Sq + kT - 1) / kT, g.Hq, g.B);
  lse_delta_kernel<T><<<qgrid, kThreads, 2 * t, stream>>>(
      qp, kp, static_cast<const T*>(o), dop, lse, delta, g);
  if ((err = (int)cudaGetLastError())) return err;
  dq_kernel<T, G><<<qgrid, kThreads, main_smem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), g);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 kgrid((g.Skv + kT - 1) / kT, g.Hkv, g.B);
  dkv_kernel<T, G><<<kgrid, kThreads, main_smem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* delta, const Geo& g, cudaStream_t stream) {
  if (g.D <= 64)
    return launch<T, 1>(q, k, v, o, dout, dq, dk, dv, lse, delta, g, stream);
  if (g.D <= 128)
    return launch<T, 2>(q, k, v, o, dout, dq, dk, dv, lse, delta, g, stream);
  return launch<T, 4>(q, k, v, o, dout, dq, dk, dv, lse, delta, g, stream);
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) strided views (unit stride on
// D; strides: q's, k's, v's (batch, head, position) strides in elements);
// o and dout (B, Hq, Sq, D), dq (B, Hq, Sq, D), dk and dv (B, Hkv, Skv, D)
// contiguous; lse and delta (B, Hq, Sq) float32 scratch.  dtype: 0
// float32, 1 bfloat16.  Causal calls need Sq <= Skv (every query row sees
// a key).  Returns the CUDA error of the launches (0 on success); shapes
// the kernels do not take return cudaErrorInvalidValue without launching.
int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
    float scale, const int64_t* strides, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 || D < 1
      || D > 256 || Hq > 65535 || B > 65535 || (causal && Sq > Skv))
    return kInvalid;
  Geo g{B, Hq, Hkv, Sq, Skv, D, causal ? 1 : 0, scale, {}, {}, {}};
  for (int a = 0; a < 3; ++a) {
    g.qs[a] = strides[a];
    g.ks[a] = strides[3 + a];
    g.vs[a] = strides[6 + a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, g, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                   g, s);
  return kInvalid;
}

}  // extern "C"
