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
// slots), the final splits m [B, U, K] and the mean n_dk [B, K].
//
// What bounds it on an H100. Bytes: beta_w rows and uniforms of the slots
// with c > 0, the counts and z0 in full; per_unique, m and ndk_mean written
// (at the full-width fan, B=1,000, U about 40, K=100, S=30: about 16 MB in
// and 32 MB out, about 15 us at 3.35 TB/s). Operations: about 6*S*K per
// active slot (2e7 for that fan, well under a microsecond at 67 TFLOP/s).
// The real bound is the dependent chain: S * (active slots) draws per
// document, each a sequential K-step running sum, as in lda_gibbs, but
// over the document's distinct words instead of its positions.
//
// Design. lda_gibbs's, over slots: one thread per document (the chain
// cannot be split and keeps the plain version's association ((p0 + p1) +
// p2) + ..., with nvcc's --fmad=false, so the two make the same draws).
// n_dk, the kept-sweep n_dk sum and the current probabilities live in
// shared memory laid out [K][docs_per_block]; each slot's topic is an index
// (uint8, K <= 128) in shared memory laid out [U][docs_per_block], and m is
// written once at the end. The Rao-Blackwell accumulator is the per_unique
// output (each document owns its rows). A slot with count 0 is skipped: in
// the plain version it subtracts 0, adds 0 * onehot and accumulates
// 0 * post, which changes nothing, so a document's chain ends at its own
// slots, not at the padded U. Making it fast (a warp per document, several
// chains per thread) is later work, as for lda_gibbs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sparse_sweeps_kernel(
    const float* __restrict__ beta_w,    // [B, U, K]
    const float* __restrict__ countf,    // [B, U]
    const float* __restrict__ uniforms,  // [S, B, U]
    const int* __restrict__ z0,          // [B, U]
    float* __restrict__ per_unique,      // [B, U, K] out
    float* __restrict__ m_out,           // [B, U, K] out
    float* __restrict__ ndk_mean,        // [B, K] out
    int B, int U, int K, int S, int burnin, float alpha) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x * T + t;
  if (b >= B) return;  // ragged last block; no barrier below
  float* ndk = smem;                          // [K][T]
  float* ndk_acc = smem + K * T;              // [K][T]
  float* probs = smem + 2 * K * T;            // [K][T]
  uint8_t* zs = (uint8_t*)(smem + 3 * K * T);  // [U][T]

  const float* bw_doc = beta_w + (size_t)b * U * K;
  const float* c_doc = countf + (size_t)b * U;
  float* acc = per_unique + (size_t)b * U * K;

  for (int k = 0; k < K; ++k) {
    ndk[k * T + t] = 0.0f;
    ndk_acc[k * T + t] = 0.0f;
  }
  for (int i = 0; i < U; ++i) {
    const int zi = z0[(size_t)b * U + i];
    zs[i * T + t] = (uint8_t)zi;
    ndk[zi * T + t] += c_doc[i];
    for (int k = 0; k < K; ++k) acc[(size_t)i * K + k] = 0.0f;
  }

  for (int s = 0; s < S; ++s) {
    const bool keep = s >= burnin;
    const float* u_s = uniforms + ((size_t)s * B + b) * U;
    for (int i = 0; i < U; ++i) {
      const float c = c_doc[i];
      if (c == 0.0f) continue;  // a padding slot changes nothing
      ndk[zs[i * T + t] * T + t] -= c;
      const float* bw = bw_doc + (size_t)i * K;
      float total = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float p = (ndk[k * T + t] + alpha) * bw[k];
        probs[k * T + t] = p;
        total += p;
      }
      const float thresh = u_s[i] * total;
      int nz = 0;
      float cum = 0.0f;
      for (int k = 0; k < K; ++k) {
        cum += probs[k * T + t];
        nz += cum < thresh ? 1 : 0;
      }
      ndk[nz * T + t] += c;
      zs[i * T + t] = (uint8_t)nz;
      if (keep) {
        const float denom = fmaxf(total, 1e-30f);
        float* acc_i = acc + (size_t)i * K;
        for (int k = 0; k < K; ++k)
          acc_i[k] += c * (probs[k * T + t] / denom);
      }
    }
    if (keep)
      for (int k = 0; k < K; ++k) ndk_acc[k * T + t] += ndk[k * T + t];
  }

  const float n_keep = (float)(S - burnin);
  float* m_doc = m_out + (size_t)b * U * K;
  for (int i = 0; i < U; ++i) {
    const float c = c_doc[i];
    const float slot = c > 0.0f ? 1.0f : 0.0f;
    const int zi = zs[i * T + t];
    for (int k = 0; k < K; ++k) {
      float* a = acc + (size_t)i * K + k;
      *a = *a / n_keep * slot;
      m_doc[(size_t)i * K + k] = k == zi ? c : 0.0f;
    }
  }
  for (int k = 0; k < K; ++k)
    ndk_mean[(size_t)b * K + k] = ndk_acc[k * T + t] / n_keep;
}

}  // namespace

extern "C" int lda_sparse_sweeps(const float* beta_w, const float* countf,
                                 const float* uniforms, const int* z0,
                                 float* per_unique, float* m_out,
                                 float* ndk_mean, int B, int U, int K, int S,
                                 int burnin, float alpha, int docs_per_block,
                                 void* stream) {
  const int blocks = (B + docs_per_block - 1) / docs_per_block;
  const size_t smem = (size_t)3 * K * docs_per_block * sizeof(float) +
                      (size_t)U * docs_per_block;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sparse_sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sparse_sweeps_kernel<<<blocks, docs_per_block, smem,
                         (cudaStream_t)stream>>>(
      beta_w, countf, uniforms, z0, per_unique, m_out, ndk_mean, B, U, K, S,
      burnin, alpha);
  return (int)cudaGetLastError();
}
