// Left-to-right held-out scoring (Wallach et al. 2009, algorithm 3) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lda_l2r/lda_l2r.py,
// l2r_block_kernel (reached through l2r_scores_pallas). Same function: for
// each document and each position n, resample positions i < n of every
// particle from (n_k + alpha) * beta_w[i] (sequential running sum, uniform
// column i of uniform(k_rs, (P, L))), score log mean_p sum_k theta_hat[k] *
// beta_w[n, k], then draw z_n per particle from uniform(k_dr, (P,)), where
// (k_rs, k_dr) = split(fold_in(doc_key, n)). The threefry streams are made
// here from the per-document key words (csrc/threefry.cuh); nothing is
// pre-drawn. Output is the [L, B] per-position score matrix; the caller
// sums it over L. The weights are the dense layout's 0/1 mask or the unique
// layout's token counts (count_weighted, the reference's mode of the same
// name): a slot of count c removes and adds c copies and, with
// count_weighted, scores c * log p. A position of weight 0 scores 0 and
// changes nothing, so each document's scan ends at its last weighted
// position (the unique layout pads every document to U = L slots); the
// rest of its scores are written as 0.
//
// What bounds it on an H100. Bytes: beta_w B*L*K*4 read, L*B*4 written (at
// B=64, L=64, K=100: 1.6 MB, under a microsecond at 3.35 TB/s). Operations:
// per chain about E^2/2 resample steps (E the document's end) of ~4K float
// operations plus one 20-round threefry cipher (~2e6 per chain at E = 64).
// The bound is the dependent chain: E^2/2 sequential resample steps per
// particle, each a K-step running sum.
//
// Design. One block per document, one thread per particle (chain). n_k[K]
// and the current probabilities live in shared memory laid out
// [K][P] (conflict-free across the particles), z[L] as uint8 (K <= 128)
// [L][P]; beta_w rows are read through the cache, the same row by every
// particle of the block. Both draws use the fixed sequential association
// ((p0 + p1) + p2) + ..., as the plain torch version does, and nvcc runs
// with --fmad=false, so kernel and plain version make the same draws;
// the scores agree to an ulp of the mean over particles and of the log.
// The mean over particles is a fixed-order sum in shared memory by thread
// 0, never atomics. The chain itself is not split; more chains per
// thread and overlap of the resample steps are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

__global__ void l2r_scores_kernel(
    const long long* __restrict__ kd,    // [B, 2] key words (in int64)
    const float* __restrict__ beta_w,    // [B, L, K]
    const float* __restrict__ weights,   // [B, L] 0/1 mask or counts
    float* __restrict__ ll,              // [L, B] out
    int B, int L, int K, float alpha, float alpha_sum, int count_weighted) {
  extern __shared__ float smem[];
  const int P = blockDim.x;
  const int p = threadIdx.x;
  const int b = blockIdx.x;
  float* nk = smem;                   // [K][P]
  float* probs = smem + K * P;        // [K][P]
  float* pw = smem + 2 * K * P;       // [P]
  uint8_t* z = (uint8_t*)(pw + P);    // [L][P]

  const uint32_t k1 = (uint32_t)kd[2 * b];
  const uint32_t k2 = (uint32_t)kd[2 * b + 1];
  const float* bw_doc = beta_w + (size_t)b * L * K;
  const float* w_doc = weights + (size_t)b * L;
  for (int k = 0; k < K; ++k) nk[k * P + p] = 0.0f;
  for (int i = 0; i < L; ++i) z[i * P + p] = 0;
  int end = 0;                          // one past the last weighted slot
  for (int i = 0; i < L; ++i)
    if (w_doc[i] > 0.0f) end = i + 1;
  if (p == 0)
    for (int n = end; n < L; ++n) ll[(size_t)n * B + b] = 0.0f;

  for (int n = 0; n < end; ++n) {
    uint32_t n1, n2, rs1, rs2, dr1, dr2;
    tf3::fold_in(k1, k2, (uint32_t)n, n1, n2);
    tf3::split2(n1, n2, rs1, rs2, dr1, dr2);

    for (int i = 0; i < n; ++i) {       // resample positions i < n
      const float wf = w_doc[i];
      if (!(wf > 0.0f)) continue;       // weight 0 changes nothing
      const float u = tf3::uniform_column_at(rs1, rs2, P, L, p, i);
      const int zi = z[i * P + p];
      nk[zi * P + p] -= wf;
      const float* bw = bw_doc + (size_t)i * K;
      float total = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float pk = (nk[k * P + p] + alpha) * bw[k];
        probs[k * P + p] = pk;
        total += pk;
      }
      const float thresh = u * total;
      int nz = 0;
      float cum = 0.0f;
      for (int k = 0; k < K; ++k) {
        cum += probs[k * P + p];
        nz += cum < thresh ? 1 : 0;
      }
      nk[nz * P + p] += wf;
      z[i * P + p] = (uint8_t)nz;
    }

    // predictive probability of w_n under this particle
    const float* bw_n = bw_doc + (size_t)n * K;
    const float w_n = w_doc[n];
    float n_lt = 0.0f;
    for (int k = 0; k < K; ++k) n_lt += nk[k * P + p];
    const float denom = n_lt + alpha_sum;
    float p_w = 0.0f;
    for (int k = 0; k < K; ++k)
      p_w += ((nk[k * P + p] + alpha) / denom) * bw_n[k];
    pw[p] = p_w;
    __syncthreads();
    if (p == 0) {
      float s = 0.0f;
      for (int q = 0; q < P; ++q) s += pw[q];
      float raw = logf(fmaxf(s / (float)P, 1e-30f));
      if (count_weighted) raw = w_n * raw;
      ll[(size_t)n * B + b] = w_n > 0.0f ? raw : 0.0f;
    }

    // draw z_n for this particle
    const float u_dr = tf3::uniform_at(dr1, dr2, p, P);
    float total = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float pk = (nk[k * P + p] + alpha) * bw_n[k];
      probs[k * P + p] = pk;
      total += pk;
    }
    const float thresh = u_dr * total;
    int zn = 0;
    float cum = 0.0f;
    for (int k = 0; k < K; ++k) {
      cum += probs[k * P + p];
      zn += cum < thresh ? 1 : 0;
    }
    nk[zn * P + p] += w_n;
    if (w_n > 0.0f) z[n * P + p] = (uint8_t)zn;
    __syncthreads();                    // pw is rewritten at n + 1
  }
}

}  // namespace

extern "C" int lda_l2r_scores(const long long* kd, const float* beta_w,
                              const float* weights, float* ll, int B, int L,
                              int K, int P, float alpha, float alpha_sum,
                              int count_weighted, void* stream) {
  const size_t smem = (size_t)(2 * K * P + P) * sizeof(float) +
                      (size_t)L * P;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        l2r_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  l2r_scores_kernel<<<B, P, smem, (cudaStream_t)stream>>>(
      kd, beta_w, weights, ll, B, L, K, alpha, alpha_sum, count_weighted);
  return (int)cudaGetLastError();
}
