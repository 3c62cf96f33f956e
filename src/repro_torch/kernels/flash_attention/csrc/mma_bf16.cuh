// Tensor-core building blocks of the bf16 flash kernels: the forward's
// flash_tc_kernel (flash_attention.cu) and the backward's tensor-core
// kernels (flash_attention_backward.cu).  mma.sync.m16n8k16 bf16 -> fp32,
// ldmatrix (plain and .trans), cp.async 16-byte copies into padded shared
// tiles, ex2.approx, and the staging of a row tile.  Each source includes
// this file inside its own namespace tc, after <cuda_bf16.h>,
// <cuda_runtime.h> and <stdint.h>; cuda_build hashes it with the source.

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x by the special-function unit (relative error ~2^-22, subnormal
// results flushed to 0: far below P's bf16 rounding)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values -> one register of bf16 A fragment, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [r0, r0 + ROWS) of a (S, D) operand with position stride ss into a
// [ROWS][DP + 8] shared tile, in 16-byte chunks; rows >= S and columns >=
// D are zeros.  kAligned: every row start is 16-byte aligned and D % 8 ==
// 0, so a chunk is one cp.async; otherwise element loads and a 16-byte
// shared store.
template <int DP, int ROWS, bool kAligned>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src,
                                      int64_t r0, int64_t S, int D,
                                      int64_t ss, int tid) {
  constexpr int kChunks = DP / 8;
  static_assert((ROWS * kChunks) % kThreads == 0, "uneven staging");
#pragma unroll
  for (int idx = tid; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks, d = (idx % kChunks) * 8;
    const int64_t row = r0 + r;
    bf16* dst = tile + r * (DP + 8) + d;
    if (kAligned) {
      const bool ok = row < S && d < D;
      cp_async16(smem_u32(dst), ok ? src + row * ss + d : src, ok ? 16 : 0);
    } else {
      const unsigned short* s16 =
          reinterpret_cast<const unsigned short*>(src) + row * ss;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = row < S && d + 2 * e < D ? s16[d + 2 * e] : 0u;
        const uint32_t hi =
            row < S && d + 2 * e + 1 < D ? s16[d + 2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}
