// Collapsed-Gibbs sweeps over a batch of documents, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lda_gibbs/lda_gibbs.py,
// gibbs_block_kernel (reached through gibbs_sweeps_pallas). Same function:
// for each document, S sweeps that are sequential over its L positions; at
// each position remove z_i from n_dk, draw from (n_dk + alpha) * beta_w[i]
// by inverse CDF on the pre-drawn uniform (count of cum_k < u * total), add
// the draw back, and over the sweeps s >= burnin accumulate the
// Rao-Blackwell conditional probs / max(total, 1e-30) and n_dk. A position
// of mask 0 changes nothing and is skipped.
//
// What bounds it on an H100. Bytes are small: beta_w and per_pos are
// B*L*K*4 each, uniforms S*B*L*4 (at B=256, L=64, K=100, S=30: 6.6 MB
// + 6.6 MB + 2 MB, about 5 us at 3.35 TB/s), and operations are about
// 8*S*K per active position (microseconds at the card's rate). The floor
// of this design, which draws one after another, is the dependent chain:
// S draws per active position of the longest document, each K float32
// adds in the plain version's association.
//
// Design: a warp per document, over the draw routine shared with
// lda_sparse (../../csrc/gibbs_warp.cuh, where the design is described).

#include "gibbs_warp.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(gibbs_warp::kMaxWarps * 32, 1)
gibbs_sweeps_kernel(const float* __restrict__ beta_w,    // [B, L, K]
                    const float* __restrict__ maskf,     // [B, L]
                    const float* __restrict__ uniforms,  // [S, B, L]
                    const int* __restrict__ z0,          // [B, L]
                    float* __restrict__ per_pos,         // [B, L, K] out
                    int* __restrict__ z_out,             // [B, L] out
                    float* __restrict__ ndk_mean,        // [B, K] out
                    int B, int L, int K, int S, int burnin, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int b = blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= B) return;
  const gibbs_warp::Rows rows(smem + warp * gibbs_warp::warp_smem_bytes(L),
                              L);
  const gibbs_warp::Doc doc{beta_w + (size_t)b * L * K,
                            maskf + (size_t)b * L,
                            uniforms + (size_t)b * L,
                            (size_t)B * L,
                            z0 + (size_t)b * L,
                            per_pos + (size_t)b * L * K,
                            ndk_mean + (size_t)b * K,
                            L, K, S, burnin, alpha};
  gibbs_warp::sweep_document<G, gibbs_warp::MaskRule>(doc, rows);
  for (int i = threadIdx.x % 32; i < L; i += 32)
    z_out[(size_t)b * L + i] = rows.z[i];
}

}  // namespace

extern "C" int lda_gibbs_sweeps(const float* beta_w, const float* maskf,
                                const float* uniforms, const int* z0,
                                float* per_pos, int* z_out, float* ndk_mean,
                                int B, int L, int K, int S, int burnin,
                                float alpha, void* stream) {
  return gibbs_warp::by_topics(K, [&](auto g) {
    return gibbs_warp::launch(gibbs_sweeps_kernel<decltype(g)::value>, B, L,
                              stream, beta_w, maskf, uniforms, z0, per_pos,
                              z_out, ndk_mean, B, L, K, S, burnin, alpha);
  });
}
