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
// ends with acc / max(l, 1e-30).  Any D <= 256, Sq >= 1 and Skv >= 1: no
// padding of D to 128 lanes or of the sequences to 128-row blocks is asked
// of the caller.  q, k and v may be strided views (the unit stride must be
// D's), so the model's (B, S, H, D) projections are read in place.
//
// Bound: 4 D operations per visible (query, key) pair and head, 6.6e12 for
// a causal (1, 24, 32768, 128) prefill layer, which is 6.67 ms at the bf16
// tensor-core peak (989 TFLOP/s) against 0.13 ms for its 0.44 GB of
// operands and output: the operations bound it, so the products have to
// run on the tensor cores.
//
// Two kernels, chosen by dtype (flash_attention_launch):
//
// bfloat16 -> flash_tc_kernel, a FlashAttention-2-style forward on the
// tensor cores.  One block of 4 warps per (query tile, query head, batch),
// heaviest causal tiles first; each warp owns 16 MT query rows (MT = 2 at
// D <= 128, 1 at 256: 128- or 64-row tiles), so a row's m, l and
// accumulator live in one warp's registers and the row max and sum are
// reduced over the 4 threads of a quad by shuffles (no shared memory and no
// barrier in the softmax).  S = Q K^T and O += P V are mma.sync.m16n8k16
// bf16 products with fp32 accumulators: Q's fragments come by ldmatrix
// (kept in registers at D <= 64, re-read from shared memory above, where
// the registers hold the 2 x 16 rows' accumulators instead: each K and V
// fragment then feeds two m tiles, which halves the ldmatrix traffic per
// product), K's by ldmatrix and V's by ldmatrix.trans.  The S accumulator,
// scaled into the exp2 domain (scale * log2 e folded in) and exponentiated
// by ex2.approx, is packed pairwise into the bf16 A fragments of P V (the
// m16n8 C layout is the A layout), so P never touches shared memory.  K and
// V tiles are staged by 16-byte cp.async copies into a 2-stage ring (tile
// t + 1 loads while tile t computes), rows padded by 16 bytes so
// ldmatrix's 8 rows fall in distinct banks.  Only tiles that cross the
// diagonal or the end of the keys are masked (a per-row column limit);
// tiles wholly above the diagonal are not visited.  D is templated at 64,
// 128 and 256 (BK = 64, 64, 32 keys per tile); any other D is zero-padded
// in shared memory to the next of those, and padded columns are not
// stored.  Rows whose start is not 16-byte aligned (D or a stride not a
// multiple of 8 elements, or a base pointer off 16 bytes) take the
// kAligned = false variant, which stages by element loads; the wrapper
// picks it from the pointers and strides before the launch.  Shared memory
// at D = 128: Q 34 KB and K, V in 2 stages 70 KB, two blocks (8 warps of
// 255 registers) per SM.  GQA: the 12 query heads of a kv head re-read its
// K and V; both kv heads of the prefill layer (16 MB each) stay in the
// 50 MB L2, so query heads are not packed into one block.  P is rounded to
// bf16 before P V, as on every tensor-core flash kernel, so each output
// differs from a float32 evaluation by up to 2^-8 sum_j p_j |v_j| / l
// besides its own rounding (ops.bf16_output_bound).  mma.sync, not wgmma +
// TMA, which is the later redesign that can match the card's peak.
//
// float32 -> simt::flash_attention_kernel, float32 fmaf on the CUDA cores
// (67 TFLOP/s peak), so the float32 results keep full float32 products (no
// TF32): one block of 256 threads per (64-query tile, head, batch); q's
// tile sits transposed in shared memory, each 64-key tile of k is staged
// transposed and scored in 4 x 4 register tiles per thread, p goes through
// shared memory to the P.V products.  Its bf16 instantiation, the design
// this file had before the tensor-core kernel, is reachable only through
// flash_attention_previous_launch, to time the two on one card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

namespace simt {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // a 16 x 16 grid of (ty, tx)
constexpr int kStride = 68;      // row stride (floats) of the transposed
                                 // tiles: 16-byte rows, 4-way store conflicts

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

}  // namespace simt

namespace tc {

#include "mma_bf16.cuh"

// DP: the head dim the tiles hold; MT: 16-row m tiles per warp
template <int DP, int MT>
struct Cfg {
  static constexpr int BQ = 16 * MT * kWarps;  // query rows per block
  static constexpr int BK = DP == 256 ? 32 : 64;  // keys per tile
  static constexpr int RS = DP + 8;   // shared row stride: 16 bytes of pad
  // Q's A fragments stay in registers for the whole block where they fit
  static constexpr bool kQRegs = DP * MT <= 128;
  static constexpr size_t kSmem = sizeof(bf16) * RS * (BQ + 4 * BK);
};

template <int DP, int MT, bool kAligned>
__global__ void __launch_bounds__(kThreads) flash_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int Hq, int Hkv,
    int Sq, int Skv, int D, int causal, float scale_log2, int64_t qsb,
    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss) {
  using C = Cfg<DP, MT>;
  constexpr int BQ = C::BQ, BK = C::BK, RS = C::RS;
  constexpr int NK = DP / 16;   // k steps of Q K^T over d
  constexpr int NT = BK / 8;    // n tiles of S over keys
  constexpr int NP = BK / 16;   // k steps of P V over keys
  constexpr int ND = DP / 8;    // n tiles of O over d
  extern __shared__ uint4 smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BQ][RS]
  bf16* sK = sQ + BQ * RS;                        // [2][BK][RS]
  bf16* sV = sK + 2 * BK * RS;                    // [2][BK][RS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;   // row in 8, column pair in 4
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;
  const int64_t offset = (int64_t)Skv - Sq;

  // causal: the last key the block's last row sees bounds the tiles
  int64_t kv_end = Skv;
  if (causal) {
    const int64_t last = (int64_t)q0 + BQ - 1 + offset;
    kv_end = last + 1 < kv_end ? last + 1 : kv_end;
    if (kv_end < 0) kv_end = 0;
  }
  const int n_tiles = (int)((kv_end + BK - 1) / BK);

  stage<DP, BQ, kAligned>(sQ, qb, q0, Sq, D, qss, tid);
  if (n_tiles > 0) {
    stage<DP, BK, kAligned>(sK, kb, 0, Skv, D, kss, tid);
    stage<DP, BK, kAligned>(sV, vb, 0, Skv, D, vss, tid);
  }
  cp_async_commit();

  // ldmatrix row addresses of this lane: the A operand (Q) and V^T take
  // rows lane % 16 at column 8 (lane / 16); K takes rows 8 (lane / 16) +
  // lane % 8 at column 8 ((lane / 8) % 2)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 8;
  const uint32_t q_addr =
      smem_u32(sQ + (warp * 16 * MT + a_row) * RS + a_col);
  const uint32_t k_addr = smem_u32(sK + k_row * RS + k_col);
  const uint32_t v_addr = smem_u32(sV + a_row * RS + a_col);
  constexpr uint32_t kStageBytes = BK * RS * sizeof(bf16);

  float acc[MT][ND][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nd][e] = 0.0f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.0f;   // this thread's share of the row sum
  }
  uint32_t qf[C::kQRegs ? MT : 1][C::kQRegs ? NK : 1][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {       // the ring's other stage, read at t - 1
      const int64_t j1 = (int64_t)(t + 1) * BK;
      stage<DP, BK, kAligned>(sK + (st ^ 1) * BK * RS, kb, j1, Skv, D, kss,
                              tid);
      stage<DP, BK, kAligned>(sV + (st ^ 1) * BK * RS, vb, j1, Skv, D, vss,
                              tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();             // tile t (and Q) landed for every warp

    if (C::kQRegs && t == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          ldsm_x4(q_addr + (mt * 16 * RS + kk * 16) * 2,
                  qf[C::kQRegs ? mt : 0][C::kQRegs ? kk : 0]);
    }

    // S = Q K^T
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.0f;
    const uint32_t kt_addr = k_addr + st * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (C::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[mt][e] = qf[C::kQRegs ? mt : 0][C::kQRegs ? kk : 0][e];
        } else {
          ldsm_x4(q_addr + (mt * 16 * RS + kk * 16) * 2, a[mt]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bk[4];
        ldsm_x4(kt_addr + (nt * 8 * RS + kk * 16) * 2, bk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][nt], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][nt + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // scale into the exp2 domain, mask the tiles that cross the diagonal
    // or the end of the keys, online softmax per row
    const int64_t j0 = (int64_t)t * BK;
    const bool masked = j0 + BK > Skv
                        || (causal && j0 + BK - 1 > (int64_t)q0 + offset);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] *= scale_log2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {        // rows g and g + 8
        if (masked) {   // the tile's columns c < lim are visible to the row
          const int64_t row =
              (int64_t)q0 + (warp * MT + mt) * 16 + g + 8 * r;
          int64_t lim = Skv - j0;
          if (causal && row + offset + 1 - j0 < lim)
            lim = row + offset + 1 - j0;
          const int lim_c = lim < 0 ? 0 : (lim > BK ? BK : (int)lim);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int c = nt * 8 + 2 * tig;
            if (c >= lim_c) s[mt][nt][2 * r] = kNegInf;
            if (c + 1 >= lim_c) s[mt][nt][2 * r + 1] = kNegInf;
          }
        }
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mx = fmaxf(mx, fmaxf(s[mt][nt][2 * r], s[mt][nt][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx);
        const float alpha = ex2(m[mt][r] - m_new);
        m[mt][r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          s[mt][nt][2 * r] = ex2(s[mt][nt][2 * r] - m_new);
          s[mt][nt][2 * r + 1] = ex2(s[mt][nt][2 * r + 1] - m_new);
          sum += s[mt][nt][2 * r] + s[mt][nt][2 * r + 1];
        }
        l[mt][r] = l[mt][r] * alpha + sum;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[mt][nd][2 * r] *= alpha;
          acc[mt][nd][2 * r + 1] *= alpha;
        }
      }
    }

    // O += P V, P's bf16 A fragments packed from the S accumulators
    const uint32_t vt_addr = v_addr + st * kStageBytes;
#pragma unroll
    for (int kp = 0; kp < NP; ++kp) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kp][0], s[mt][2 * kp][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kp][2], s[mt][2 * kp][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kp + 1][0], s[mt][2 * kp + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kp + 1][2], s[mt][2 * kp + 1][3]);
      }
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(vt_addr + (kp * 16 * RS + nd * 8) * 2, bv);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][nd], pa[mt], bv[0], bv[1]);
          mma_bf16(acc[mt][nd + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();             // stage st is read before t + 1 refills it
  }
  if (n_tiles == 0) cp_async_wait<0>();

  bf16* ob = o + ((int64_t)b * Hq + h) * Sq * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float denom = fmaxf(sum, 1e-30f);
      const int64_t row = (int64_t)q0 + (warp * MT + mt) * 16 + g + 8 * r;
      if (row >= Sq) continue;
      bf16* orow = ob + row * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int d = nd * 8 + 2 * tig;
        if (d >= D) continue;
        const float x0 = acc[mt][nd][2 * r] / denom;
        const float x1 = acc[mt][nd][2 * r + 1] / denom;
        if ((D & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          orow[d] = __float2bfloat16_rn(x0);
          if (d + 1 < D) orow[d + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
}

template <int DP, int MT, bool kAligned>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int causal, float scale,
           const int64_t* st, cudaStream_t stream) {
  using C = Cfg<DP, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DP, MT, kAligned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, Hq, B);
  flash_tc_kernel<DP, MT, kAligned><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hkv, Sq, Skv,
      D, causal, scale * kLog2e, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

template <bool kAligned>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, int causal,
             float scale, const int64_t* st, cudaStream_t stream) {
  if (D <= 64)
    return launch<64, 2, kAligned>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                   causal, scale, st, stream);
  if (D <= 128)
    return launch<128, 2, kAligned>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                    causal, scale, st, stream);
  return launch<256, 1, kAligned>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                  causal, scale, st, stream);
}

// what the wrapper's `aligned` claims: every row start of q, k and v on 16
// bytes (the pointers, D and the strides of every axis longer than 1)
bool rows_aligned(const void* q, const void* k, const void* v, int B,
                  int Hq, int Hkv, int Sq, int Skv, int D,
                  const int64_t* st) {
  const void* ptrs[3] = {q, k, v};
  const int64_t extent[3][3] = {{B, Hq, Sq}, {B, Hkv, Skv}, {B, Hkv, Skv}};
  if (D % 8) return false;
  for (int t = 0; t < 3; ++t) {
    if (reinterpret_cast<uintptr_t>(ptrs[t]) % 16) return false;
    for (int a = 0; a < 3; ++a)
      if (extent[t][a] > 1 && st[3 * t + a] % 8) return false;
  }
  return true;
}

}  // namespace tc

bool shape_ok(int B, int Hq, int Hkv, int Sq, int Skv, int D) {
  return !(B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1
           || D < 1 || D > 256 || Hq > 65535 || B > 65535);
}

}  // namespace

extern "C" {

// dtype: 0 float32 (the SIMT kernel), 1 bfloat16 (the tensor-core
// kernel).  strides: q's, k's, v's (batch, head, position) strides in
// elements.  aligned (bfloat16 only): 1 if every row start of q, k and v
// is 16-byte aligned, so rows are staged by cp.async; a claim the pointers
// and strides do not bear out is refused.  Returns the CUDA error of the
// launch (0 on success); shapes the kernels do not take return
// cudaErrorInvalidValue without launching.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int Hq, int Hkv,
                           int Sq, int Skv, int D, int causal, float scale,
                           const int64_t* strides, int aligned,
                           void* stream) {
  if (!shape_ok(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::launch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                                 scale, strides, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!aligned)
    return tc::launch_d<false>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                               scale, strides, s);
  if (!tc::rows_aligned(q, k, v, B, Hq, Hkv, Sq, Skv, D, strides))
    return (int)cudaErrorInvalidValue;
  return tc::launch_d<true>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                            scale, strides, s);
}

// The previous bfloat16 design (the SIMT kernel), kept to be timed beside
// the tensor-core kernel on the same card; the op never routes to it.
int flash_attention_previous_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int Sq, int Skv, int D,
                                    int causal, float scale,
                                    const int64_t* strides, void* stream) {
  if (!shape_ok(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  return simt::launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                       causal, scale, strides,
                                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
