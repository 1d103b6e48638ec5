// Collapsed-Gibbs sweeps over a batch of documents, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lda_gibbs/lda_gibbs.py,
// gibbs_block_kernel (reached through gibbs_sweeps_pallas). Same function:
// for each document, S sweeps that are sequential over its L positions; at
// each position remove z_i from n_dk, draw from (n_dk + alpha) * beta_w[i]
// by inverse CDF on the pre-drawn uniform (count of cum_k < u * total), add
// the draw back, and over the sweeps s >= burnin accumulate the
// Rao-Blackwell conditional probs / max(total, 1e-30) and n_dk.
//
// What bounds it on an H100. Bytes are small: beta_w and per_pos are
// B*L*K*4 each, uniforms S*B*L*4 (at B=256, L=64, K=100, S=30: 6.6 MB
// + 6.6 MB + 2 MB, about 5 us at 3.35 TB/s). Operations are about
// 6*S*L*K per document (1.2e6 at that shape, 3e8 for the batch: microseconds
// at the card's rate). The real bound is the dependent chain: S*L = 1920
// positions per document, each a sequential K-step running sum, so about
// 3*S*L*K dependent float operations (~6e5 at ~4 cycles each) per document.
//
// Design. One thread per document: the chain cannot be split, and the
// running sum is kept in one fixed association, ((p0 + p1) + p2) + ...,
// the one the plain torch version (repro_torch.core.estep) pins, so the
// kernel and the plain version make the same draws (nvcc runs with
// --fmad=false so every product and sum rounds as torch rounds it); the
// outputs agree to one ulp, from the final division by S - burnin. A warp
// per document with lanes over K would have to give up that association.
// Documents per block are chosen by the wrapper so that the batch spreads
// over the SMs; each thread's n_dk, kept-sweep n_dk sum and the current
// probabilities live in shared memory laid out [K][docs_per_block], so the
// lanes of a warp hit different banks. The Rao-Blackwell accumulator is the
// per_pos output itself (each document owns its rows, no races). The ragged
// last block is masked here: threads past B return. Making it fast (a warp
// per document with a warp scan, several chains per thread) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gibbs_sweeps_kernel(
    const float* __restrict__ beta_w,    // [B, L, K]
    const float* __restrict__ maskf,     // [B, L]
    const float* __restrict__ uniforms,  // [S, B, L]
    const int* __restrict__ z0,          // [B, L]
    float* __restrict__ per_pos,         // [B, L, K] out
    int* __restrict__ z_out,             // [B, L] out
    float* __restrict__ ndk_mean,        // [B, K] out
    int B, int L, int K, int S, int burnin, float alpha) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x * T + t;
  if (b >= B) return;  // ragged last block; no barrier below
  float* ndk = smem;                // [K][T]
  float* ndk_acc = smem + K * T;    // [K][T]
  float* probs = smem + 2 * K * T;  // [K][T]

  const float* bw_doc = beta_w + (size_t)b * L * K;
  const float* m_doc = maskf + (size_t)b * L;
  int* z = z_out + (size_t)b * L;
  float* acc = per_pos + (size_t)b * L * K;

  for (int k = 0; k < K; ++k) {
    ndk[k * T + t] = 0.0f;
    ndk_acc[k * T + t] = 0.0f;
  }
  for (int i = 0; i < L; ++i) {
    const int zi = z0[(size_t)b * L + i];
    z[i] = zi;
    ndk[zi * T + t] += m_doc[i];
    for (int k = 0; k < K; ++k) acc[(size_t)i * K + k] = 0.0f;
  }

  for (int s = 0; s < S; ++s) {
    const bool keep = s >= burnin;
    const float* u_s = uniforms + ((size_t)s * B + b) * L;
    for (int i = 0; i < L; ++i) {
      const float m = m_doc[i];
      if (m == 0.0f) continue;  // a masked position changes nothing
      const int zi = z[i];
      ndk[zi * T + t] -= m;
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
      if (!(m > 0.0f)) nz = zi;
      ndk[nz * T + t] += m;
      z[i] = nz;
      if (keep) {
        const float denom = fmaxf(total, 1e-30f);
        float* acc_i = acc + (size_t)i * K;
        for (int k = 0; k < K; ++k)
          acc_i[k] += m * (probs[k * T + t] / denom);
      }
    }
    if (keep)
      for (int k = 0; k < K; ++k) ndk_acc[k * T + t] += ndk[k * T + t];
  }

  const float n_keep = (float)(S - burnin);
  for (int i = 0; i < L; ++i) {
    const float m = m_doc[i];
    for (int k = 0; k < K; ++k) {
      float* a = acc + (size_t)i * K + k;
      *a = *a / n_keep * m;
    }
  }
  for (int k = 0; k < K; ++k)
    ndk_mean[(size_t)b * K + k] = ndk_acc[k * T + t] / n_keep;
}

}  // namespace

extern "C" int lda_gibbs_sweeps(const float* beta_w, const float* maskf,
                                const float* uniforms, const int* z0,
                                float* per_pos, int* z_out, float* ndk_mean,
                                int B, int L, int K, int S, int burnin,
                                float alpha, int docs_per_block,
                                void* stream) {
  const int blocks = (B + docs_per_block - 1) / docs_per_block;
  const size_t smem = (size_t)3 * K * docs_per_block * sizeof(float);
  gibbs_sweeps_kernel<<<blocks, docs_per_block, smem,
                        (cudaStream_t)stream>>>(
      beta_w, maskf, uniforms, z0, per_pos, z_out, ndk_mean, B, L, K, S,
      burnin, alpha);
  return (int)cudaGetLastError();
}
