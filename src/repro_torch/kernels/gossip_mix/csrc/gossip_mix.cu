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

template <typename T>
__global__ void mix_pairs_kernel(float* __restrict__ stats,
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

// stats: device pointer to [n, row] float32, rows contiguous; pairs: HOST
// pointer to n_pairs (i, j) int32 pairs, 1 <= n_pairs <= kMaxPairs, all
// nodes distinct; vec4 != 0 when row % 4 == 0 and stats is 16-byte aligned.
extern "C" int gossip_mix_pairs(float* stats, long long row,
                                const int* pairs, int n_pairs, int vec4,
                                void* stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs || row < 1)
    return (int)cudaErrorInvalidValue;
  Pairs p;
  for (int q = 0; q < n_pairs; ++q) {
    p.i[q] = pairs[2 * q];
    p.j[q] = pairs[2 * q + 1];
  }
  const long long row_vecs = vec4 ? row / 4 : row;
  const long long per_block = (long long)kThreads * kVecPerThread;
  const dim3 grid((unsigned)((row_vecs + per_block - 1) / per_block),
                  (unsigned)n_pairs);
  if (vec4)
    mix_pairs_kernel<float4><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        stats, row_vecs, p);
  else
    mix_pairs_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        stats, row_vecs, p);
  return (int)cudaGetLastError();
}
