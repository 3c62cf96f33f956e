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
//
// Bound: 10 D operations per visible (query, key) pair and head (the five
// products S, dP, dV, dQ and dK, two multiply-adds of D each); for
// starcoder2-3b's (1, 24/2, 4096, 128) causal layer 2.58e11 operations,
// 0.2606 ms at the bf16 tensor-core rate (989 TFLOP/s), against 0.13 GB of
// operands and gradients (0.04 ms at 3.35 TB/s): operations bound it.
//
// Two designs, chosen by the caller (flash_attention_backward_launch's
// `design`; the wrapper picks it from dtype and D before the launch):
//
// design 1, bf16 at D <= 128 -> the tensor-core kernels of namespace tc,
// four launches in order (three when Hq == Hkv):
//
//   tc::lse_delta_kernel  one block of 4 warps per (64-query tile, query
//                         head, batch): S = Q K^T on the tensor cores over
//                         the visible key tiles with the forward's online
//                         max and sum (exp2 domain), so each row's lse in
//                         base 2; delta_i = do_i . o_i in float32;
//   tc::dq_kernel         one block per (64-query tile, query head, batch),
//                         heaviest causal tiles first: per key tile S = Q
//                         K^T and dP = dO V^T, P = 2^(S scale log2 e -
//                         lse) and dS = P (dP - delta) in float32
//                         registers, dQ += dS K; each dq row has one owner;
//   tc::dkv_kernel        one block per (64-key tile, query head, batch),
//                         heaviest causal tiles first (1,536 blocks at
//                         starcoder2-3b's shape, where one per kv head gave
//                         128): K and V stay resident, the block walks the
//                         visible query tiles with Q, dO, lse and delta in
//                         a 2-stage cp.async ring, forms S^T = K Q^T and
//                         dP^T = V dO^T (keys as rows, so P^T and dS^T come
//                         out of the accumulators in the A layout of the
//                         next products and never touch shared memory),
//                         and accumulates dV_h += P^T dO and dK_h += dS^T Q,
//                         dO and Q read by ldmatrix.trans; it writes its
//                         head's float32 partials to a (B, Hq, Skv, D)
//                         scratch pair (straight to dk and dv when Hq ==
//                         Hkv);
//   tc::dkv_reduce_kernel sums each kv head's G partials in head order,
//                         scales dK, and rounds once to bf16.
//
// Every product is mma.sync.m16n8k16 bf16 with fp32 accumulators, on the
// forward's building blocks (mma_bf16.cuh).  S and dP are single products:
// their operands are bf16 values, exact.  P and dS are float32; rounding
// them once to bf16 before the dV, dK and dQ products would move the
// gradients by up to 2^-9 of each term, which a CPU emulation puts at
// 5.9-13.9x ops.bf16_gradient_bound on its cases.  So each is fed as a
// split pair, hi = bf16(x) and lo = bf16(x - hi), in two products on the
// same B fragments: hi + lo carries x to 2^-17 of itself, and the
// gradients stay where exact float32 products put them
// (tests/test_torch_backward.py emulates both).
// Every output element is summed by one owner in a fixed order (the group
// sum in head order), with no atomics, so two launches give the same bits.
// D below 128 pads to 64 or 128 in shared memory; rows whose start is not
// on 16 bytes (D or a stride not a multiple of 8, or a base pointer off 16
// bytes) are staged by element loads (kAligned = false), as the forward
// does.  Shared memory at D = 128: 104 KB for tc::dq_kernel and 105 KB for
// tc::dkv_kernel, two blocks (8 warps) per SM.
//
// design 0 -> the SIMT kernels, the first design, in float32 fmaf on the
// CUDA cores for float32 operands (the float32 results keep full float32
// products) and for bf16 at D > 128, where tc::dkv_kernel's two 16 x D
// float32 accumulators per warp would not fit the registers; three
// launches:
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
// The operands are widened from their type as they are staged, outputs
// rounded to it once; the build's -fmad=false keeps every other multiply
// and add unfused.  The SIMT tiling is the forward's float32 kernel's (4 x
// 4 register tiles per thread, tiles staged transposed in shared memory,
// 64-row tiles, 256 threads).  Shared memory holds, besides the block's
// own two tiles, one staging buffer that the key (or query) tile, the
// value (or output-gradient) tile and the row-major copy for the last
// product take in turn, and the 64 x 64 probabilities: 119 KB at D = 128,
// 221 KB at D = 256 (one block per SM).  Its bf16 instantiation at any D
// is reachable through design 0, to time it beside the tensor-core design.
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

// ===========================================================================
// bf16 on the tensor cores (design 1)
// ===========================================================================

namespace tc {

#include "mma_bf16.cuh"

constexpr int kBM = 64;          // rows a block owns: queries or keys
constexpr int kBN = 64;          // rows of each tile it walks
constexpr int kNT = kBN / 8;     // n tiles of a warp's 16 x 64 scores
constexpr int kMaxD = 128;       // the largest D these kernels take
static_assert(kBM == kT && kBN == kT, "kv_end_of counts 64-row tiles");

template <int DP>
struct Cfg {
  static constexpr int RS = DP + 8;      // shared row stride: 16 bytes pad
  static constexpr int ND = DP / 8;      // n tiles of a 16 x DP output
  static constexpr uint32_t kTile = kBN * RS * sizeof(bf16);  // bytes
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), each a packed A register
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

// c[nt] += A B^T over DP: A the warp's 16 rows of a row-major tile at
// a_addr (this lane's ldmatrix address), B the 64 rows of a row-major tile
// at b_addr (the col operand, by ldmatrix without .trans)
template <int DP>
__device__ __forceinline__ void scores(float (&c)[kNT][4], uint32_t a_addr,
                                       uint32_t b_addr) {
  constexpr int RS = Cfg<DP>::RS;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_addr + kk * 32, a);
#pragma unroll
    for (int nt = 0; nt < kNT; nt += 2) {
      uint32_t bb[4];
      ldsm_x4(b_addr + (nt * 8 * RS + kk * 16) * 2, bb);
      mma_bf16(c[nt], a, bb[0], bb[1]);
      mma_bf16(c[nt + 1], a, bb[2], bb[3]);
    }
  }
}

// acc += X R: X the warp's 16 x 64 float32 tile in the accumulator layout
// (the A layout of this product), fed as the split pair (hi, lo); R the 64
// rows of a row-major [row][d] tile at b_addr, read by ldmatrix.trans
template <int DP>
__device__ __forceinline__ void accumulate_split(
    float (&acc)[Cfg<DP>::ND][4], const float (&x)[kNT][4],
    uint32_t b_addr) {
  constexpr int RS = Cfg<DP>::RS;
#pragma unroll
  for (int kp = 0; kp < kBN / 16; ++kp) {
    uint32_t hi[4], lo[4];
    split(x[2 * kp][0], x[2 * kp][1], hi[0], lo[0]);
    split(x[2 * kp][2], x[2 * kp][3], hi[1], lo[1]);
    split(x[2 * kp + 1][0], x[2 * kp + 1][1], hi[2], lo[2]);
    split(x[2 * kp + 1][2], x[2 * kp + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int nd = 0; nd < Cfg<DP>::ND; nd += 2) {
      uint32_t bb[4];
      ldsm_x4_trans(b_addr + (kp * 16 * RS + nd * 8) * 2, bb);
      mma_bf16(acc[nd], hi, bb[0], bb[1]);
      mma_bf16(acc[nd], lo, bb[0], bb[1]);
      mma_bf16(acc[nd + 1], hi, bb[2], bb[3]);
      mma_bf16(acc[nd + 1], lo, bb[2], bb[3]);
    }
  }
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void put2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// a warp's 16 x DP accumulator (rows row0 + lane / 4 and + 8), times mul,
// into the rows < S and columns < D of a row-major output of row stride D
template <int DP, typename T>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[Cfg<DP>::ND][4],
                                           int64_t row0, int64_t S, int D,
                                           float mul, int gq, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + gq + 8 * r;
    if (row >= S) continue;
    T* orow = out + row * D;
#pragma unroll
    for (int nd = 0; nd < Cfg<DP>::ND; ++nd) {
      const int d = nd * 8 + 2 * tig;
      if (d >= D) continue;
      const float x0 = acc[nd][2 * r] * mul, x1 = acc[nd][2 * r + 1] * mul;
      if ((D & 1) == 0) {
        put2(orow + d, x0, x1);
      } else {
        put(orow + d, x0);
        if (d + 1 < D) put(orow + d + 1, x1);
      }
    }
  }
}

// the columns c < lim_c of key tile j0 that query row `row` sees
__device__ __forceinline__ int row_limit(const Geo& g, int64_t row,
                                         int64_t j0) {
  int64_t lim = g.Skv - j0;
  const int64_t diag = row + (int64_t)g.Skv - g.Sq + 1 - j0;
  if (g.causal && diag < lim) lim = diag;
  return lim < 0 ? 0 : (lim > kBN ? kBN : (int)lim);
}

// ---------------------------------------------------------------------------
// lse (base 2) and delta per query row
// ---------------------------------------------------------------------------

// lse and delta: (B, Hq, n_qt * 64) float32; rows >= Sq get 0
template <int DP, bool kAligned>
__global__ void __launch_bounds__(kThreads) lse_delta_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    float* __restrict__ lse, float* __restrict__ delta, Geo g,
    float scale_log2, int n_qt) {
  constexpr int RS = Cfg<DP>::RS;
  extern __shared__ uint4 smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [64][RS]
  bf16* sK = sQ + kBM * RS;                       // [2][64][RS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x % g.Hq, b = blockIdx.y;
  const int64_t q0 = (int64_t)(n_qt - 1 - (int)(blockIdx.x / g.Hq)) * kBM;
  const int hk = h / (g.Hq / g.Hkv);
  const bf16* qb = q + b * g.qs[0] + h * g.qs[1];
  const bf16* kb = k + b * g.ks[0] + hk * g.ks[1];
  const int64_t offset = (int64_t)g.Skv - g.Sq;
  const int n_tiles = (int)((kv_end_of(g, q0) + kBN - 1) / kBN);

  stage<DP, kBM, kAligned>(sQ, qb, q0, g.Sq, g.D, g.qs[2], tid);
  if (n_tiles > 0)
    stage<DP, kBN, kAligned>(sK, kb, 0, g.Skv, g.D, g.ks[2], tid);
  cp_async_commit();
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 8;
  const uint32_t q_addr = smem_u32(sQ + (warp * 16 + a_row) * RS + a_col);
  const uint32_t k_addr = smem_u32(sK + k_row * RS + k_col);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      stage<DP, kBN, kAligned>(sK + (st ^ 1) * kBN * RS, kb,
                               (int64_t)(t + 1) * kBN, g.Skv, g.D, g.ks[2],
                               tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
    scores<DP>(s, q_addr, k_addr + st * Cfg<DP>::kTile);

    // scale into the exp2 domain, mask, online max and sum per row
    const int64_t j0 = (int64_t)t * kBN;
    const bool masked = j0 + kBN > g.Skv
                        || (g.causal && j0 + kBN - 1 > q0 + offset);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lim_c =
          masked ? row_limit(g, q0 + warp * 16 + gq + 8 * r, j0) : kBN;
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[nt][2 * r + e] * scale_log2;
          if (nt * 8 + 2 * tig + e >= lim_c) x = kNegInf;
          s[nt][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        sum += ex2(s[nt][2 * r] - m_new) + ex2(s[nt][2 * r + 1] - m_new);
      l[r] = l[r] * ex2(m[r] - m_new) + sum;
      m[r] = m_new;
    }
    __syncthreads();             // stage st is read before t + 1 refills it
  }
  if (n_tiles == 0) cp_async_wait<0>();

  const int64_t pad_off = ((int64_t)b * g.Hq + h) * n_qt * kBM;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int64_t row = q0 + warp * 16 + gq + 8 * r;
    if (tig == 0)
      lse[pad_off + row] = row < g.Sq ? m[r] + log2f(sum) : 0.0f;
  }
  // delta: each of the warp's 16 rows over its 32 lanes
  const int64_t rows_off = ((int64_t)b * g.Hq + h) * g.Sq;
  for (int r = 0; r < 16; ++r) {
    const int64_t row = q0 + warp * 16 + r;
    float part = 0.0f;
    if (row < g.Sq) {
      const bf16* orow = o + (rows_off + row) * g.D;
      const bf16* drow = dout + (rows_off + row) * g.D;
      for (int d = lane; d < g.D; d += 32)
        part += __bfloat162float(drow[d]) * __bfloat162float(orow[d]);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, w);
    if (lane == 0) delta[pad_off + row] = part;
  }
}

// ---------------------------------------------------------------------------
// dq per query tile
// ---------------------------------------------------------------------------

template <int DP, bool kAligned>
__global__ void __launch_bounds__(kThreads, 2) dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, Geo g, float scale_log2, int n_qt) {
  using C = Cfg<DP>;
  constexpr int RS = C::RS;
  extern __shared__ uint4 smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [64][RS]
  bf16* sdO = sQ + kBM * RS;                      // [64][RS]
  bf16* sK = sdO + kBM * RS;                      // [2][64][RS]
  bf16* sV = sK + 2 * kBN * RS;                   // [2][64][RS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x % g.Hq, b = blockIdx.y;
  const int64_t q0 = (int64_t)(n_qt - 1 - (int)(blockIdx.x / g.Hq)) * kBM;
  const int hk = h / (g.Hq / g.Hkv);
  const bf16* qb = q + b * g.qs[0] + h * g.qs[1];
  const bf16* kb = k + b * g.ks[0] + hk * g.ks[1];
  const bf16* vb = v + b * g.vs[0] + hk * g.vs[1];
  const int64_t rows_off = ((int64_t)b * g.Hq + h) * g.Sq;
  const bf16* dob = dout + rows_off * g.D;
  const int64_t offset = (int64_t)g.Skv - g.Sq;
  const int n_tiles = (int)((kv_end_of(g, q0) + kBN - 1) / kBN);

  stage<DP, kBM, kAligned>(sQ, qb, q0, g.Sq, g.D, g.qs[2], tid);
  stage<DP, kBM, kAligned>(sdO, dob, q0, g.Sq, g.D, (int64_t)g.D, tid);
  if (n_tiles > 0) {
    stage<DP, kBN, kAligned>(sK, kb, 0, g.Skv, g.D, g.ks[2], tid);
    stage<DP, kBN, kAligned>(sV, vb, 0, g.Skv, g.D, g.vs[2], tid);
  }
  cp_async_commit();

  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 8;
  const uint32_t q_addr = smem_u32(sQ + (warp * 16 + a_row) * RS + a_col);
  const uint32_t do_addr = smem_u32(sdO + (warp * 16 + a_row) * RS + a_col);
  const uint32_t k_addr = smem_u32(sK + k_row * RS + k_col);
  const uint32_t v_addr = smem_u32(sV + k_row * RS + k_col);
  const uint32_t kt_addr = smem_u32(sK + a_row * RS + a_col);   // .trans

  const int64_t pad_off = ((int64_t)b * g.Hq + h) * n_qt * kBM;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = q0 + warp * 16 + gq + 8 * r;
    lse_r[r] = lse[pad_off + row];
    delta_r[r] = delta[pad_off + row];
  }
  float acc[C::ND][4];
#pragma unroll
  for (int nd = 0; nd < C::ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      const int64_t j1 = (int64_t)(t + 1) * kBN;
      stage<DP, kBN, kAligned>(sK + (st ^ 1) * kBN * RS, kb, j1, g.Skv, g.D,
                               g.ks[2], tid);
      stage<DP, kBN, kAligned>(sV + (st ^ 1) * kBN * RS, vb, j1, g.Skv, g.D,
                               g.vs[2], tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
    scores<DP>(s, q_addr, k_addr + st * C::kTile);
    scores<DP>(dp, do_addr, v_addr + st * C::kTile);

    // P = 2^(S scale log2 e - lse), masked to 0; dS = P (dP - delta) in s
    const int64_t j0 = (int64_t)t * kBN;
    const bool masked = j0 + kBN > g.Skv
                        || (g.causal && j0 + kBN - 1 > q0 + offset);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lim_c =
          masked ? row_limit(g, q0 + warp * 16 + gq + 8 * r, j0) : kBN;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = ex2(s[nt][2 * r + e] * scale_log2 - lse_r[r]);
          if (nt * 8 + 2 * tig + e >= lim_c) p = 0.0f;
          s[nt][2 * r + e] = p * (dp[nt][2 * r + e] - delta_r[r]);
        }
    }
    accumulate_split<DP>(acc, s, kt_addr + st * C::kTile);
    __syncthreads();             // stage st is read before t + 1 refills it
  }
  if (n_tiles == 0) cp_async_wait<0>();

  store_rows<DP>(dq + rows_off * g.D, acc, q0 + warp * 16, g.Sq, g.D,
                 g.scale, gq, tig);
}

// ---------------------------------------------------------------------------
// dk and dv per (key tile, query head): the head's partials
// ---------------------------------------------------------------------------

// direct (Hq == Hkv): dk and dv written in bf16, dk scaled; else the
// head's unscaled float32 partials to pk and pv, (B, Hq, Skv, D)
template <int DP, bool kAligned>
__global__ void __launch_bounds__(kThreads, 2) dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ pk, float* __restrict__ pv, bf16* __restrict__ dk,
    bf16* __restrict__ dv, Geo g, float scale_log2, int n_qt, int direct) {
  using C = Cfg<DP>;
  constexpr int RS = C::RS;
  extern __shared__ uint4 smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [64][RS]
  bf16* sV = sK + kBM * RS;                       // [64][RS]
  bf16* sQ = sV + kBM * RS;                       // [2][64][RS]
  bf16* sdO = sQ + 2 * kBN * RS;                  // [2][64][RS]
  float* sL = reinterpret_cast<float*>(sdO + 2 * kBN * RS);   // [2][64]
  float* sDl = sL + 2 * kBN;                                  // [2][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x % g.Hq, b = blockIdx.y;
  const int64_t j0 = (int64_t)(blockIdx.x / g.Hq) * kBM;
  const int group = g.Hq / g.Hkv, hk = h / group;
  const bf16* qb = q + b * g.qs[0] + h * g.qs[1];
  const bf16* kb = k + b * g.ks[0] + hk * g.ks[1];
  const bf16* vb = v + b * g.vs[0] + hk * g.vs[1];
  const int64_t rows_off = ((int64_t)b * g.Hq + h) * g.Sq;
  const bf16* dob = dout + rows_off * g.D;
  const int64_t pad_off = ((int64_t)b * g.Hq + h) * n_qt * kBM;
  const int64_t offset = (int64_t)g.Skv - g.Sq;

  // causal: the first query that sees key j0 is j0 - offset
  int64_t i_first = g.causal ? j0 - offset : 0;
  if (i_first < 0) i_first = 0;
  const int t_first = (int)(i_first / kBN);

  // query tile t into ring stage st: Q, dO, and lse and delta (16-byte
  // chunks of the padded scratch rows)
  auto stage_q = [&](int t, int st) {
    const int64_t i0 = (int64_t)t * kBN;
    stage<DP, kBN, kAligned>(sQ + st * kBN * RS, qb, i0, g.Sq, g.D, g.qs[2],
                             tid);
    stage<DP, kBN, kAligned>(sdO + st * kBN * RS, dob, i0, g.Sq, g.D,
                             (int64_t)g.D, tid);
    if (tid < kBN / 2) {
      const int c = tid & (kBN / 4 - 1);
      const bool is_lse = tid < kBN / 4;
      cp_async16(smem_u32((is_lse ? sL : sDl) + st * kBN + 4 * c),
                 (is_lse ? lse : delta) + pad_off + i0 + 4 * c, 16);
    }
  };

  stage<DP, kBM, kAligned>(sK, kb, j0, g.Skv, g.D, g.ks[2], tid);
  stage<DP, kBM, kAligned>(sV, vb, j0, g.Skv, g.D, g.vs[2], tid);
  if (t_first < n_qt) stage_q(t_first, 0);
  cp_async_commit();

  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 8;
  const uint32_t k_addr = smem_u32(sK + (warp * 16 + a_row) * RS + a_col);
  const uint32_t v_addr = smem_u32(sV + (warp * 16 + a_row) * RS + a_col);
  const uint32_t q_addr = smem_u32(sQ + k_row * RS + k_col);
  const uint32_t do_addr = smem_u32(sdO + k_row * RS + k_col);
  const uint32_t qt_addr = smem_u32(sQ + a_row * RS + a_col);    // .trans
  const uint32_t dot_addr = smem_u32(sdO + a_row * RS + a_col);  // .trans

  float acc_k[C::ND][4], acc_v[C::ND][4];
#pragma unroll
  for (int nd = 0; nd < C::ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nd][e] = acc_v[nd][e] = 0.0f;

  for (int t = t_first; t < n_qt; ++t) {
    const int st = (t - t_first) & 1;
    if (t + 1 < n_qt) {
      stage_q(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: keys as rows, queries as columns
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
    scores<DP>(s, k_addr, q_addr + st * C::kTile);
    scores<DP>(dp, v_addr, do_addr + st * C::kTile);

    // P^T into s, dS^T into dp; pairs past Sq or Skv or above the diagonal
    // are 0
    const int64_t i0 = (int64_t)t * kBN;
    const bool masked = i0 + kBN > g.Sq || j0 + kBM > g.Skv
                        || (g.causal && j0 + kBM - 1 > i0 + offset);
    const float* lse_t = sL + st * kBN;
    const float* delta_t = sDl + st * kBN;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      const float2 ls = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 de = *reinterpret_cast<const float2*>(delta_t + c);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = ex2(s[nt][2 * r + e] * scale_log2 - (e ? ls.y : ls.x));
          if (masked) {
            const int64_t i = i0 + c + e;
            const int64_t j = j0 + warp * 16 + gq + 8 * r;
            if (i >= g.Sq || j >= g.Skv || (g.causal && j > i + offset))
              p = 0.0f;
          }
          s[nt][2 * r + e] = p;
          dp[nt][2 * r + e] = p * (dp[nt][2 * r + e] - (e ? de.y : de.x));
        }
    }
    accumulate_split<DP>(acc_v, s, dot_addr + st * C::kTile);
    accumulate_split<DP>(acc_k, dp, qt_addr + st * C::kTile);
    __syncthreads();             // stage st is read before t + 1 refills it
  }
  if (t_first >= n_qt) cp_async_wait<0>();

  const int64_t row0 = j0 + warp * 16;
  if (direct) {
    const int64_t base = ((int64_t)b * g.Hkv + hk) * g.Skv * g.D;
    store_rows<DP>(dk + base, acc_k, row0, g.Skv, g.D, g.scale, gq, tig);
    store_rows<DP>(dv + base, acc_v, row0, g.Skv, g.D, 1.0f, gq, tig);
  } else {
    const int64_t base = ((int64_t)b * g.Hq + h) * g.Skv * g.D;
    store_rows<DP>(pk + base, acc_k, row0, g.Skv, g.D, 1.0f, gq, tig);
    store_rows<DP>(pv + base, acc_v, row0, g.Skv, g.D, 1.0f, gq, tig);
  }
}

// dk = bf16(scale sum_h pk[h]), dv = bf16(sum_h pv[h]) over each kv head's
// group, h in order from its first: one thread per output element
__global__ void __launch_bounds__(256) dkv_reduce_kernel(
    const float* __restrict__ pk, const float* __restrict__ pv,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int64_t n_out,
    int64_t per_head, int group, float scale) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n_out;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t bh = e / per_head;             // b * Hkv + hk
    const int64_t src = bh * group * per_head + (e - bh * per_head);
    float sk = 0.0f, sv = 0.0f;
    for (int hh = 0; hh < group; ++hh) {
      sk += pk[src + hh * per_head];
      sv += pv[src + hh * per_head];
    }
    dk[e] = __float2bfloat16_rn(sk * scale);
    dv[e] = __float2bfloat16_rn(sv);
  }
}

template <int DP>
__host__ __device__ constexpr size_t smem_lse() {
  return sizeof(bf16) * Cfg<DP>::RS * (kBM + 2 * kBN);
}
template <int DP>
__host__ __device__ constexpr size_t smem_dq() {
  return sizeof(bf16) * Cfg<DP>::RS * (2 * kBM + 4 * kBN);
}
template <int DP>
__host__ __device__ constexpr size_t smem_dkv() {
  return smem_dq<DP>() + sizeof(float) * 4 * kBN;
}

template <int DP, bool kAligned>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, float* pk, float* pv, const Geo& g,
           cudaStream_t stream) {
  const int n_qt = (g.Sq + kBM - 1) / kBM, n_kt = (g.Skv + kBM - 1) / kBM;
  const int group = g.Hq / g.Hkv;
  if ((int64_t)n_qt * g.Hq > 0x7fffffff || (int64_t)n_kt * g.Hq > 0x7fffffff
      || (group > 1 && (pk == nullptr || pv == nullptr)))
    return kInvalid;
  int err;
  if ((err = allow_smem(lse_delta_kernel<DP, kAligned>, smem_lse<DP>())))
    return err;
  if ((err = allow_smem(dq_kernel<DP, kAligned>, smem_dq<DP>()))) return err;
  if ((err = allow_smem(dkv_kernel<DP, kAligned>, smem_dkv<DP>())))
    return err;
  const float scale_log2 = g.scale * kLog2e;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const dim3 qgrid((unsigned)(n_qt * g.Hq), (unsigned)g.B);
  lse_delta_kernel<DP, kAligned><<<qgrid, kThreads, smem_lse<DP>(),
                                   stream>>>(
      qp, kp, static_cast<const bf16*>(o), dop, lse, delta, g, scale_log2,
      n_qt);
  if ((err = (int)cudaGetLastError())) return err;
  dq_kernel<DP, kAligned><<<qgrid, kThreads, smem_dq<DP>(), stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dq), g, scale_log2,
      n_qt);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 kgrid((unsigned)(n_kt * g.Hq), (unsigned)g.B);
  dkv_kernel<DP, kAligned><<<kgrid, kThreads, smem_dkv<DP>(), stream>>>(
      qp, kp, vp, dop, lse, delta, pk, pv, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), g, scale_log2, n_qt, group == 1);
  if ((err = (int)cudaGetLastError())) return err;
  if (group == 1) return 0;
  const int64_t per_head = (int64_t)g.Skv * g.D;
  const int64_t n_out = (int64_t)g.B * g.Hkv * per_head;
  const int64_t want = (n_out + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  dkv_reduce_kernel<<<blocks, 256, 0, stream>>>(
      pk, pv, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_out,
      per_head, group, g.scale);
  return (int)cudaGetLastError();
}

template <bool kAligned>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* delta, float* pk, float* pv, const Geo& g,
             cudaStream_t stream) {
  if (g.D <= 64)
    return launch<64, kAligned>(q, k, v, o, dout, dq, dk, dv, lse, delta, pk,
                                pv, g, stream);
  return launch<128, kAligned>(q, k, v, o, dout, dq, dk, dv, lse, delta, pk,
                               pv, g, stream);
}

// what the wrapper's `aligned` claims: every row start of q, k, v, o and
// dout on 16 bytes (the pointers, D and the strides of q's, k's and v's
// axes longer than 1; o and dout are contiguous)
bool rows_aligned(const void* const (&ptrs)[5], const Geo& g) {
  const int64_t extent[3][3] = {{g.B, g.Hq, g.Sq}, {g.B, g.Hkv, g.Skv},
                                {g.B, g.Hkv, g.Skv}};
  const int64_t* st[3] = {g.qs, g.ks, g.vs};
  if (g.D % 8) return false;
  for (int t = 0; t < 5; ++t)
    if (reinterpret_cast<uintptr_t>(ptrs[t]) % 16) return false;
  for (int t = 0; t < 3; ++t)
    for (int a = 0; a < 3; ++a)
      if (extent[t][a] > 1 && st[t][a] % 8) return false;
  return true;
}

}  // namespace tc

}  // namespace

extern "C" {

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) strided views (unit stride on
// D; strides: q's, k's, v's (batch, head, position) strides in elements);
// o and dout (B, Hq, Sq, D), dq (B, Hq, Sq, D), dk and dv (B, Hkv, Skv, D)
// contiguous.  dtype: 0 float32, 1 bfloat16.  design: 0 the SIMT kernels
// (lse and delta (B, Hq, Sq) float32 scratch; pk and pv unused), 1 the
// tensor-core kernels (bfloat16, D <= 128; lse and delta (B, Hq, 64
// ceil(Sq / 64)) float32 scratch; pk and pv (B, Hq, Skv, D) float32
// scratch when Hq > Hkv, else unused).  aligned (design 1): 1 if every row
// start of q, k, v, o and dout is 16-byte aligned, so rows are staged by
// cp.async; a claim the pointers and strides do not bear out is refused.
// Causal calls need Sq <= Skv (every query row sees a key).  Returns the
// CUDA error of the launches (0 on success); calls the kernels do not take
// return cudaErrorInvalidValue without launching.
int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    float* pk, float* pv, int dtype, int design, int B, int Hq, int Hkv,
    int Sq, int Skv, int D, int causal, float scale, const int64_t* strides,
    int aligned, void* stream) {
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
  if (design == 1) {
    if (dtype != 1 || D > tc::kMaxD) return kInvalid;
    if (!aligned)
      return tc::launch_d<false>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                 pk, pv, g, s);
    const void* const ptrs[5] = {q, k, v, o, dout};
    if (!tc::rows_aligned(ptrs, g)) return kInvalid;
    return tc::launch_d<true>(q, k, v, o, dout, dq, dk, dv, lse, delta, pk,
                              pv, g, s);
  }
  if (design != 0) return kInvalid;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, g, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                   g, s);
  return kInvalid;
}

}  // extern "C"
