// Count-weighted Gibbs sweeps over unique-token (CSR) documents, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lda_sparse/lda_sparse.py,
// sparse_block_kernel (reached through sparse_sweeps_pallas). Same function:
// a document is U slots of (word, count c); all c copies of a slot share one
// topic z, so its split is m_u = c * onehot(z). For each document, S sweeps
// that are sequential over its slots; at each slot remove m_u from n_dk, draw
// z from (n_dk + alpha) * beta_w[u] by inverse CDF on the pre-drawn uniform
// (count of cum_k < u * total), add c * onehot(z) back, and over the sweeps
// s >= burnin accumulate c * probs / max(total, 1e-30) and n_dk. Outputs
// are the mean over kept sweeps (per_unique [B, U, K], zero on padding
// slots), the final splits m [B, U, K] and the mean n_dk [B, K]. A slot
// with count 0 is skipped: in the plain version it subtracts 0, adds
// 0 * onehot and accumulates 0 * post, which changes nothing, so a
// document's chain ends at its own slots, not at the padded U.
//
// What bounds it on an H100. Bytes: beta_w rows and uniforms of the slots
// with c > 0, the counts and z0 in full; per_unique, m and ndk_mean written
// (at the full-width fan, B=1,000, U=48, K=100, S=30: about 16 MB in and
// 38 MB out, about 15 us at 3.35 TB/s). Operations: about 8*S*K per
// active slot, well under a microsecond. The floor of this design is the
// dependent chain, as in lda_gibbs, over the longest document's distinct
// words.
//
// Design: lda_gibbs's, a warp per document over the draw routine in
// ../../csrc/gibbs_warp.cuh, with the count as the weight; the splits m
// are written once at the end from the slots' final topics.

#include "gibbs_warp.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(gibbs_warp::kMaxWarps * 32, 1)
sparse_sweeps_kernel(const float* __restrict__ beta_w,    // [B, U, K]
                     const float* __restrict__ countf,    // [B, U]
                     const float* __restrict__ uniforms,  // [S, B, U]
                     const int* __restrict__ z0,          // [B, U]
                     float* __restrict__ per_unique,      // [B, U, K] out
                     float* __restrict__ m_out,           // [B, U, K] out
                     float* __restrict__ ndk_mean,        // [B, K] out
                     int B, int U, int K, int S, int burnin, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int b = blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= B) return;
  const gibbs_warp::Rows rows(smem + warp * gibbs_warp::warp_smem_bytes(U),
                              U);
  const float* c_doc = countf + (size_t)b * U;
  const gibbs_warp::Doc doc{beta_w + (size_t)b * U * K,
                            c_doc,
                            uniforms + (size_t)b * U,
                            (size_t)B * U,
                            z0 + (size_t)b * U,
                            per_unique + (size_t)b * U * K,
                            ndk_mean + (size_t)b * K,
                            U, K, S, burnin, alpha};
  gibbs_warp::sweep_document<G, gibbs_warp::CountRule>(doc, rows);
  constexpr int NJ = (G + 1) / 2;
  const int lane = threadIdx.x % 32;
  float* m_doc = m_out + (size_t)b * U * K;
  for (int i = 0; i < U; ++i) {
    const float c = c_doc[i];
    const int zi = rows.z[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      if (k < K) m_doc[(size_t)i * K + k] = k == zi ? c : 0.0f;
    }
  }
}

}  // namespace

extern "C" int lda_sparse_sweeps(const float* beta_w, const float* countf,
                                 const float* uniforms, const int* z0,
                                 float* per_unique, float* m_out,
                                 float* ndk_mean, int B, int U, int K, int S,
                                 int burnin, float alpha, void* stream) {
  return gibbs_warp::by_topics(K, [&](auto g) {
    return gibbs_warp::launch(sparse_sweeps_kernel<decltype(g)::value>, B, U,
                              stream, beta_w, countf, uniforms, z0,
                              per_unique, m_out, ndk_mean, B, U, K, S,
                              burnin, alpha);
  });
}
