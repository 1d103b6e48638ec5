// One gossip matching round over node-stacked statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix/gossip_mix.py,
// _mix_kernel (reached through mix_matching_pallas). Same function:
// S_out[i] = 0.5 * (S[i] + S[p[i]]) for an involution p over the n rows of
// S [n, K, V] float32, a self-partner copying its row through. Here it runs
// in place and over the matched pairs (i, p[i]), i != p[i], only: a
// self-partner's row is left as it is, which is the same bits
// (0.5f * (x + x) == x for every finite x), and a pair's average is
// computed once and stored to both rows (a + b == b + a in IEEE float).
//
// What bounds it on an H100. Bytes: each pair reads two rows and writes two
// rows of K*V floats, 16*K*V bytes per pair (25 pairs at K=100, V=50,000:
// 2 GB, 0.60 ms at 3.35 TB/s). One add and one multiply per element pair
// is nothing against that, so the kernel is a stream: the TPU kernel
// fetched the partner's tile through a scalar-prefetched index map and
// wrote one output tile per step (3 tiles moved per tile produced, and
// every self-partnered row copied); this one moves 2 tiles per tile
// produced and touches no unmatched row.
//
// Design. Grid (chunks of the row, pairs): block (c, q) owns chunk c of
// the two rows of pair q and each thread moves kVecPerThread 16-byte
// vectors of each row (float4 loads and stores, neighbouring threads on
// neighbouring addresses). A row whose length or base is not a multiple
// of 16 bytes takes the same kernel over single floats. The pair list is
// passed by value as a kernel parameter (at most kMaxPairs pairs, 3,840
// bytes), so a round needs no host-to-device copy and no device index
// array; the wrapper splits a longer list over several launches. The
// multiply is 0.5f * (a + b) with --fmad=false, the float operations of
// the plain torch version 0.5 * (S + S[p]).
//
// bfloat16 (parameter trees of the decentralized LM trainer; the Pallas
// body is generic over dtypes). Each thread loads 8 bf16 per 16-byte
// vector, adds each pair in float32, takes 0.5f * (a + b) and rounds to
// the nearest even bf16 once (__float2bfloat16_rn). For bf16 inputs that
// equals the bf16 sum halved, the reference's 0.5 * (a + b) in bf16:
// halving is exact, and the float32 sum of two bf16 values is exact
// unless their exponents differ by more than 16, when the smaller one is
// far below half a bf16 ulp of the larger and both roundings give the
// larger. A row whose length is not a multiple of 8 elements, or whose
// base is not 16-byte aligned, takes the kernel over single bf16 values.
// Bytes bound the same way: 8 bytes moved per element pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPairs = 480;
constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;

struct Pairs {
  int i[kMaxPairs];
  int j[kMaxPairs];
};

__device__ __forceinline__ float mix(float a, float b) {
  return 0.5f * (a + b);
}

__device__ __forceinline__ float4 mix(float4 a, float4 b) {
  return make_float4(mix(a.x, b.x), mix(a.y, b.y), mix(a.z, b.z),
                     mix(a.w, b.w));
}

__device__ __forceinline__ __nv_bfloat16 mix(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return __float2bfloat16_rn(mix(__bfloat162float(a), __bfloat162float(b)));
}

// 8 bf16 values in one 16-byte vector.
struct alignas(16) Bf16x8 {
  __nv_bfloat162 h[4];
};

__device__ __forceinline__ Bf16x8 mix(Bf16x8 a, Bf16x8 b) {
  Bf16x8 m;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 x = __bfloat1622float2(a.h[k]);
    const float2 y = __bfloat1622float2(b.h[k]);
    m.h[k] = __floats2bfloat162_rn(mix(x.x, y.x), mix(x.y, y.y));
  }
  return m;
}

template <typename T>
__global__ void mix_pairs_kernel(void* __restrict__ stats,
                                 long long row_vecs, const Pairs pairs) {
  const int q = blockIdx.y;
  T* a = reinterpret_cast<T*>(stats) + (long long)pairs.i[q] * row_vecs;
  T* b = reinterpret_cast<T*>(stats) + (long long)pairs.j[q] * row_vecs;
  const long long base =
      (long long)blockIdx.x * (kThreads * kVecPerThread) + threadIdx.x;
  T x[kVecPerThread], y[kVecPerThread];
#pragma unroll
  for (int u = 0; u < kVecPerThread; ++u) {
    const long long v = base + (long long)u * kThreads;
    if (v < row_vecs) {
      x[u] = a[v];
      y[u] = b[v];
    }
  }
#pragma unroll
  for (int u = 0; u < kVecPerThread; ++u) {
    const long long v = base + (long long)u * kThreads;
    if (v < row_vecs) {
      const T m = mix(x[u], y[u]);
      a[v] = m;
      b[v] = m;
    }
  }
}

}  // namespace

// stats: device pointer to [n, row] float32 (bf16 == 0) or bfloat16
// (bf16 != 0), rows contiguous; row counts elements; pairs: HOST pointer
// to n_pairs (i, j) int32 pairs, 1 <= n_pairs <= kMaxPairs, all nodes
// distinct; vec != 0 when a row is a whole number of 16-byte vectors
// (row % 4 == 0 in float32, row % 8 == 0 in bf16) and stats is 16-byte
// aligned.
extern "C" int gossip_mix_pairs(void* stats, long long row, const int* pairs,
                                int n_pairs, int vec, int bf16,
                                void* stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs || row < 1)
    return (int)cudaErrorInvalidValue;
  Pairs p;
  for (int q = 0; q < n_pairs; ++q) {
    p.i[q] = pairs[2 * q];
    p.j[q] = pairs[2 * q + 1];
  }
  const long long per_vec = vec ? (bf16 ? 8 : 4) : 1;
  const long long row_vecs = row / per_vec;
  const long long per_block = (long long)kThreads * kVecPerThread;
  const dim3 grid((unsigned)((row_vecs + per_block - 1) / per_block),
                  (unsigned)n_pairs);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 && vec)
    mix_pairs_kernel<Bf16x8><<<grid, kThreads, 0, st>>>(stats, row_vecs, p);
  else if (bf16)
    mix_pairs_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(stats,
                                                               row_vecs, p);
  else if (vec)
    mix_pairs_kernel<float4><<<grid, kThreads, 0, st>>>(stats, row_vecs, p);
  else
    mix_pairs_kernel<float><<<grid, kThreads, 0, st>>>(stats, row_vecs, p);
  return (int)cudaGetLastError();
}
