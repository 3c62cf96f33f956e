// 2PS-L Phase-2 Step-3 two-candidate scoring on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/edge_score/kernel.py
// (edge_score_pallas; bodies _edge_score_kernel and _edge_score_host_kernel).
// For every edge it scores the two candidate partitions pu and pv as
// g_u + g_v + sc_u + sc_v (minus dcn_penalty * (miss_u + miss_v) in the host
// variant) and writes chosen = (s2 > s1 ? pv : pu), best = max(s1, s2).
//
// Two entries share that arithmetic (`choose`):
//   edge_score_bits_launch  reads the endpoints, the packed (V, words)
//                           replica bit matrix, the degree table d, the
//                           cluster tables v2c / vol / c2p and, hosted,
//                           host_of and the per-host bit matrix itself, and
//                           writes chosen, best, todo = valid & !(cu == cv |
//                           pu == pv) and hi = (d[u] >= d[v] ? u : v): the
//                           whole choice of a 2PS-L scoring chunk in one
//                           launch, no per-edge operand in device memory
//                           (the chunk functions' entry);
//   edge_score_launch       takes the ten gathered (E,) operands and flags
//                           as the reference's edge_score_choose does (one
//                           thread per edge).
//
// Bound of the bits entry: not bytes.  Per edge it reads the endpoints (8
// or 16 B), valid, and a 4-byte entry of v2c, d and bits per endpoint and
// of c2p and vol per cluster, and writes 13 or 17 B: ~75 B, ~4.9 MB at
// 65,536 edges, ~1.5 us at 3.35 TB/s, and at RMAT-19 the tables (~10 MB)
// sit in the 50 MB L2.  But each of those ten random reads is a 32-byte
// sector, and the loads form a chain of dependent levels: edges -> v2c /
// d -> c2p / vol -> the rows' words (and, hosted, host_of -> the host
// rows' words).  One thread takes one edge, every load is __ldg.  On an
// H100 a 65,536-edge chunk takes about what its sectors take at the HBM
// rate: the sectors, not the chain, set its time.  Reading the words
// beside v2c and d at one word a row (a chain one level shorter), or 2-4
// edges a thread, measured level or slower at that size, so neither is
// kept.
// Endpoints follow JAX's gather rule in the reads (wrapped once, clamped to
// [0, V)); hi keeps the raw ids.  Cluster and partition ids come from the
// engine's own tables and are in range.
//
// Arithmetic: exactly the plain version's (core/scoring.py::twopsl_score,
// which follows what the jitted reference computes): g = 2 - d_self / dsum
// with dsum = max(float(du + dv), 1) from an int32 add, the four terms summed
// left to right, the penalty subtracted after its own rounding.  The
// __f*_rn intrinsics keep every operation correctly rounded and stop the
// compiler from contracting any pair into an FMA (the build also passes
// -fmad=false).  Ties go to pu.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // kernel.py THREADS

__device__ __forceinline__ float g_term(int d_self, float dsum, bool rep) {
  return rep ? __fsub_rn(2.0f, __fdiv_rn(__int2float_rn(d_self), dsum)) : 0.0f;
}

__device__ __forceinline__ float sc_term(int vol_self, float vsum, bool on_p) {
  return on_p ? __fdiv_rn(__int2float_rn(vol_self), vsum) : 0.0f;
}

__device__ __forceinline__ float penalty(float pen, bool hu, bool hv) {
  float miss_u = hu ? 0.0f : 1.0f;
  float miss_v = hv ? 0.0f : 1.0f;
  return __fmul_rn(pen, __fadd_rn(miss_u, miss_v));
}

// One edge's choice between its candidates p1 = pu and p2 = pv from the
// degrees a, b, the cluster volumes va, vb, the replica flags r (u on p1, v
// on p1, u on p2, v on p2) and, with pen != 0, the host flags h (same
// order).  Both entries score through this function.
__device__ __forceinline__ void choose(int a, int b, int va, int vb, int p1,
                                       int p2, const bool (&r)[4], float pen,
                                       const bool (&h)[4], int32_t& chosen,
                                       float& best) {
  const float dsum = fmaxf(__int2float_rn(a + b), 1.0f);
  const float vsum = fmaxf(__int2float_rn(va + vb), 1.0f);
  const bool same = p1 == p2;
  // candidate 1 = pu: u's cluster is on pu by construction
  float s1 = __fadd_rn(__fadd_rn(__fadd_rn(g_term(a, dsum, r[0]),
                                           g_term(b, dsum, r[1])),
                                 sc_term(va, vsum, true)),
                       sc_term(vb, vsum, same));
  // candidate 2 = pv: v's cluster is on pv by construction
  float s2 = __fadd_rn(__fadd_rn(__fadd_rn(g_term(a, dsum, r[2]),
                                           g_term(b, dsum, r[3])),
                                 sc_term(va, vsum, same)),
                       sc_term(vb, vsum, true));
  if (pen != 0.0f) {
    s1 = __fsub_rn(s1, penalty(pen, h[0], h[1]));
    s2 = __fsub_rn(s2, penalty(pen, h[2], h[3]));
  }
  chosen = s2 > s1 ? p2 : p1;
  best = fmaxf(s1, s2);
}

// ---------------------------------------------------------------------------
// the flag entry: one thread per edge on the gathered operands
// ---------------------------------------------------------------------------

__global__ void edge_score_kernel(
    const int32_t* __restrict__ du, const int32_t* __restrict__ dv,
    const int32_t* __restrict__ vol_u, const int32_t* __restrict__ vol_v,
    const uint8_t* __restrict__ rep_u1, const uint8_t* __restrict__ rep_v1,
    const uint8_t* __restrict__ rep_u2, const uint8_t* __restrict__ rep_v2,
    const int32_t* __restrict__ pu, const int32_t* __restrict__ pv,
    const uint8_t* __restrict__ hrep_u1, const uint8_t* __restrict__ hrep_v1,
    const uint8_t* __restrict__ hrep_u2, const uint8_t* __restrict__ hrep_v2,
    float pen, int64_t n, int32_t* __restrict__ chosen,
    float* __restrict__ best) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool r[4] = {rep_u1[i] != 0, rep_v1[i] != 0, rep_u2[i] != 0,
                     rep_v2[i] != 0};
  bool h[4] = {false, false, false, false};
  if (pen != 0.0f) {
    h[0] = hrep_u1[i] != 0;
    h[1] = hrep_v1[i] != 0;
    h[2] = hrep_u2[i] != 0;
    h[3] = hrep_v2[i] != 0;
  }
  int32_t c;
  float s;
  choose(du[i], dv[i], vol_u[i], vol_v[i], pu[i], pv[i], r, pen, h, c, s);
  chosen[i] = c;
  best[i] = s;
}

// ---------------------------------------------------------------------------
// the bits entry: the replication state and the cluster tables read here
// ---------------------------------------------------------------------------

struct Tables {
  const uint32_t* bits;     // (V, words) packed replicas
  const int32_t* d;         // (V,) degrees
  const int32_t* v2c;       // (V,) vertex -> cluster
  const int32_t* vol;       // (clusters,) cluster volumes
  const int32_t* c2p;       // (clusters,) cluster -> partition
  const uint32_t* hbits;    // (V, hwords) packed host replicas (hosted)
  const int32_t* host_of;   // (k,) partition -> host (hosted)
  int64_t V;
  int words, hwords;
};

// JAX's gather rule: a negative id wraps once, then clamps to [0, V)
__device__ __forceinline__ int64_t vertex(long long x, int64_t V) {
  if (x < 0) x += V;
  return x < 0 ? 0 : (x >= V ? V - 1 : x);
}

// an edge's endpoints: one 8- or 16-byte load where `vec`, else two
__device__ __forceinline__ void load_pair(const int* p, bool vec, int& u,
                                          int& v) {
  if (vec) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(p));
    u = x.x;
    v = x.y;
  } else {
    u = __ldg(p);
    v = __ldg(p + 1);
  }
}

__device__ __forceinline__ void load_pair(const long long* p, bool vec,
                                          long long& u, long long& v) {
  if (vec) {
    const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(p));
    u = x.x;
    v = x.y;
  } else {
    u = __ldg(p);
    v = __ldg(p + 1);
  }
}

__device__ __forceinline__ bool bit(uint32_t word, int p) {
  return (word >> (p & 31)) & 1u;
}

// One thread per edge.  The loads form a chain of dependent levels:
// the endpoints and valid -> v2c and d -> c2p and vol -> the words that
// hold the candidates' bits (and, hosted, host_of -> the host words).
template <typename Idx, bool kHost>
__global__ void __launch_bounds__(kThreads) edge_score_bits_kernel(
    Tables t, const Idx* __restrict__ edges, int vec,
    const uint8_t* __restrict__ valid, float pen, int64_t n,
    int32_t* __restrict__ chosen, float* __restrict__ best,
    uint8_t* __restrict__ todo, Idx* __restrict__ hi) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  Idx u, v;
  load_pair(edges + 2 * e, vec, u, v);
  const bool ok = __ldg(valid + e) != 0;
  const int64_t ui = vertex(u, t.V), vi = vertex(v, t.V);
  const int cu = __ldg(t.v2c + ui), cv = __ldg(t.v2c + vi);
  const int a = __ldg(t.d + ui), b = __ldg(t.d + vi);
  const int pu = __ldg(t.c2p + cu), pv = __ldg(t.c2p + cv);
  const int va = __ldg(t.vol + cu), vb = __ldg(t.vol + cv);
  const uint32_t* row_u = t.bits + ui * t.words;
  const uint32_t* row_v = t.bits + vi * t.words;
  const bool r[4] = {bit(__ldg(row_u + (pu >> 5)), pu),
                     bit(__ldg(row_v + (pu >> 5)), pu),
                     bit(__ldg(row_u + (pv >> 5)), pv),
                     bit(__ldg(row_v + (pv >> 5)), pv)};
  bool h[4] = {false, false, false, false};
  if constexpr (kHost) {
    const int hu = __ldg(t.host_of + pu), hv = __ldg(t.host_of + pv);
    const uint32_t* hrow_u = t.hbits + ui * t.hwords;
    const uint32_t* hrow_v = t.hbits + vi * t.hwords;
    h[0] = bit(__ldg(hrow_u + (hu >> 5)), hu);
    h[1] = bit(__ldg(hrow_v + (hu >> 5)), hu);
    h[2] = bit(__ldg(hrow_u + (hv >> 5)), hv);
    h[3] = bit(__ldg(hrow_v + (hv >> 5)), hv);
  }
  int32_t c;
  float s;
  choose(a, b, va, vb, pu, pv, r, kHost ? pen : 0.0f, h, c, s);
  chosen[e] = c;
  best[e] = s;
  todo[e] = ok && cu != cv && pu != pv;
  hi[e] = a >= b ? u : v;
}

template <typename Idx, bool kHost>
int launch_bits(const Tables& t, const void* edges, int vec,
                const void* valid, float pen, int64_t n, void* chosen,
                void* best, void* todo, void* hi, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  edge_score_bits_kernel<Idx, kHost>
      <<<(unsigned int)blocks, kThreads, 0, stream>>>(
          t, static_cast<const Idx*>(edges), vec,
          static_cast<const uint8_t*>(valid), pen, n,
          static_cast<int32_t*>(chosen), static_cast<float*>(best),
          static_cast<uint8_t*>(todo), static_cast<Idx*>(hi));
  return (int)cudaGetLastError();
}

}  // namespace

// The flag entry.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).  With pen == 0 the four host-flag pointers are never read and
// may be null.
extern "C" int edge_score_launch(
    const void* du, const void* dv, const void* vol_u, const void* vol_v,
    const void* rep_u1, const void* rep_v1, const void* rep_u2,
    const void* rep_v2, const void* pu, const void* pv, const void* hrep_u1,
    const void* hrep_v1, const void* hrep_u2, const void* hrep_v2, float pen,
    int64_t n, void* chosen, void* best, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  edge_score_kernel<<<(unsigned int)blocks, threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)du, (const int32_t*)dv, (const int32_t*)vol_u,
      (const int32_t*)vol_v, (const uint8_t*)rep_u1, (const uint8_t*)rep_v1,
      (const uint8_t*)rep_u2, (const uint8_t*)rep_v2, (const int32_t*)pu,
      (const int32_t*)pv, (const uint8_t*)hrep_u1, (const uint8_t*)hrep_v1,
      (const uint8_t*)hrep_u2, (const uint8_t*)hrep_v2, pen, n,
      (int32_t*)chosen, (float*)best);
  return (int)cudaGetLastError();
}

// The bits entry.  bits (V, words) and, with pen != 0, hbits (V, hwords)
// int32 row-major; d and v2c (V,) int32; vol and c2p (clusters,) int32;
// host_of (k,) int32 (read only with pen != 0; hbits and host_of may be
// null otherwise); edges (n, 2) int32 or int64 (idx64) row-major, read as
// one 8- or 16-byte load per edge where `vec`; valid (n,) bytes.  Writes
// chosen (n,) int32, best (n,) float32, todo (n,) bytes (0/1) and hi (n,)
// of the edges' type.  One thread per edge, blocks of 256.  Refuses
// (cudaErrorInvalidValue) V = 0 with n > 0 and a hosted call without its
// host tables, and (cudaErrorMisalignedAddress) edges not aligned to their
// load.  Returns a CUDA error code (0 on success).
extern "C" int edge_score_bits_launch(
    const void* bits, int64_t V, int words, const void* d, const void* v2c,
    const void* vol, const void* c2p, const void* edges, int idx64,
    const void* valid, const void* hbits, int hwords, const void* host_of,
    float pen, int64_t n, int vec, void* chosen, void* best, void* todo,
    void* hi, void* stream) {
  if (n <= 0) return 0;
  const bool host = pen != 0.0f;
  if (V <= 0 || words < 1 ||
      (host && (hwords < 1 || hbits == nullptr || host_of == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t item = idx64 ? 8 : 4;
  if ((uintptr_t)edges % (vec ? 2 * item : item)) {
    return (int)cudaErrorMisalignedAddress;
  }
  const Tables t{(const uint32_t*)bits, (const int32_t*)d,
                 (const int32_t*)v2c, (const int32_t*)vol,
                 (const int32_t*)c2p, (const uint32_t*)hbits,
                 (const int32_t*)host_of, V, words, hwords};
  auto f = idx64 ? (host ? launch_bits<long long, true>
                          : launch_bits<long long, false>)
                 : (host ? launch_bits<int, true> : launch_bits<int, false>);
  return f(t, edges, vec, valid, pen, n, chosen, best, todo, hi,
           (cudaStream_t)stream);
}
