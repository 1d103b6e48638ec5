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
// count_weighted, scores c * log p. A position of weight 0 scores 0 and is
// never resampled, so each document's scan ends at its last weighted
// position (the unique layout pads every document to U = L slots); a
// weight-0 position before it still resamples the positions before it, as
// the plain version does.
//
// What bounds it on an H100. Bytes: beta_w B*L*K*4 read, L*B*4 written (at
// B=64, L=64, K=100: 1.6 MB, under a microsecond at 3.35 TB/s). Operations:
// per particle about E^2/2 resample steps (E the document's active
// positions) of ~5K float operations. The plain version fixes one
// association of every running sum, ((p0 + p1) + p2) + ..., and the kernel
// keeps it (nvcc runs with --fmad=false), so each step is K dependent
// float32 adds, and a particle's steps depend on each other through n_k.
// The floor of this design, which makes a particle's steps one after
// another, is that chain: E(E+1)/2 K-add chains per particle of the longest
// document (the p_w sum runs beside the z_n draw).
//
// Design: a block per document, a warp per particle chain (W = min(P, 16)
// warps; warp w runs particles w, w + W, ... in turn). It takes from
// lda_gibbs and lda_sparse (../../csrc/gibbs_warp.cuh) the row loads, the
// shared reciprocal and the launch.
// - Lane l owns topics l + 32 j; the particle's n_k sits in the owners'
//   registers. Each lane writes its products into the warp's row in shared
//   memory (zero past K), and every lane runs the same K-add chain over
//   that row (broadcast float4 reads, unrolled over G = ceil(K / 16), a
//   template parameter). No lane stores the running sums: lane t keeps the
//   sum before product 4 t and rebuilds sums 4 t .. 4 t + 3 from it and its
//   own four products (the chain's bits), and the draw is the sum of four
//   __popc(__ballot_sync(cum < u * total)), the plain count(cum_k < u *
//   total). (Storing the row from every lane made each step wait on the
//   shared-memory pipe.)
// - The steps of a particle run as nested loops: per position n the
//   resamples of the active positions before it, in chunks of 32, then the
//   draw of z_n with its score if n is active, so a resample step has no
//   branch of its own. The next step's position, weight, topic and beta_w
//   row are loaded before the chain (rows through L1/L2: a block's warps
//   read the same rows in the same order; a document's rows, 102 KB at
//   L=256, K=100, are not staged in shared memory).
// - Threefry off the chain: lane t derives the keys of position n0 + t
//   (fold_in, split, the draw's uniform) once every 32 positions, and the
//   uniform of resample step s0 + t once every 32 steps of a position; a
//   step takes its uniform with __shfl_sync. The index mapping is the
//   reference's: uniform_column_at(k_rs, P, L, p, i), uniform_at(k_dr, p,
//   P).
// - No block barrier inside the scan. n_k holds integer-valued floats
//   (0/1 masks and integer counts, far below 2^24), so every association
//   of its sum gives the same bits, and n_lt is kept as an exact running
//   count of the weights drawn. theta_hat = (n_k + alpha) / denom takes
//   the shared reciprocal of gibbs_warp::Divider (IEEE division where it
//   is exact, the plain division elsewhere). The p_w sum runs in the draw
//   chain's loop. Lane 0 writes p_w to the document's scratch rows [P][L]
//   in device memory (any P fits). After the scan one barrier; then the
//   mean over particles in particle order, the log, the weighting and the
//   [L, B] stores, for all positions.
// - The chain wants its loads far ahead, so ptxas may use up to 128
//   registers (one block of 10 warps per SM). A batch of more blocks than
//   SMs runs in waves; the wrapper then passes the documents' order by
//   length, longest first, so that no long document starts late.

#include <stdint.h>

#include "gibbs_warp.cuh"
#include "threefry.cuh"

namespace {

using gibbs_warp::kFull;
using gibbs_warp::kMaxTopics;

// Shared bytes of a block for documents of L positions: its active list
// (weights as floats, positions as uint16), then per warp the products of
// the draw and those of p_w (floats), then the topic of every position
// (uint8).
__host__ __device__ constexpr size_t list_bytes(int L) {
  return ((size_t)6 * L + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t warp_bytes(int L) {
  return (size_t)2 * kMaxTopics * 4 + ((size_t)L + 15) / 16 * 16;
}

// The running sum of p[0 .. 16 G) in the plain version's association,
// ((p0 + p1) + p2) + ..., returned. Every lane of the warp runs it on the
// same row (broadcast float4 reads, unrolled: one straight run the
// compiler can load ahead of); lane t < 4 G keeps in `start` the sum
// before p[4 t], from which count_below rebuilds sums 4 t .. 4 t + 3.
// Nothing is stored. With `q`, the plain sum of q runs beside it in the
// same loop (the two do not depend on each other). p and q are zero past
// K, and adding +0 changes no sum.
template <int G, bool kQ>
__device__ __forceinline__ float chain_keep(const float* __restrict__ p,
                                           const float* __restrict__ q,
                                           int lane, float& start,
                                           float& q_sum) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float c = 0.0f, s = 0.0f;
  start = 0.0f;
#pragma unroll
  for (int t = 0; t < 4 * G; ++t) {
    const float4 v = p4[t];
    start = lane == t ? c : start;
    c = c + v.x;
    c = c + v.y;
    c = c + v.z;
    c = c + v.w;
    if (kQ) {
      const float4 w = q4[t];
      s = s + w.x;
      s = s + w.y;
      s = s + w.z;
      s = s + w.w;
    }
  }
  q_sum = s;
  return c;
}

// count(cum_k < thresh) over k < K, the plain version's draw: lane t
// rebuilds the running sums 4 t .. 4 t + 3 from `start` (the chain's own
// value) and its four products v = p[4 t .. 4 t + 3] (zero for t >= 4 G),
// so they are the chain's bits; one ballot for each of the four.
__device__ __forceinline__ int count_below(float4 v, float start,
                                          float thresh, int lane, int K) {
  const int k = 4 * lane;
  float c = start + v.x;
  int nz = __popc(__ballot_sync(kFull, k < K && c < thresh));
  c = c + v.y;
  nz += __popc(__ballot_sync(kFull, k + 1 < K && c < thresh));
  c = c + v.z;
  nz += __popc(__ballot_sync(kFull, k + 2 < K && c < thresh));
  c = c + v.w;
  nz += __popc(__ballot_sync(kFull, k + 3 < K && c < thresh));
  return nz;
}

// The warp's rows in shared memory.
struct WarpRows {
  float* p;     // [kMaxTopics] products of the draw
  float* q;     // [kMaxTopics] products of p_w
  uint8_t* z;   // [L] topic of every position
  __device__ explicit WarpRows(unsigned char* base)
      : p(reinterpret_cast<float*>(base)),
        q(p + kMaxTopics),
        z(reinterpret_cast<uint8_t*>(q + kMaxTopics)) {}
};

// One document's inputs, shared by its warps.
struct Doc {
  const float* bw;      // [L, K] beta_w rows
  const float* wgt;     // [E] weight of the a-th active position (shared)
  const uint16_t* pos;  // [E] the a-th active position (shared)
  int E, L, K, P;
  uint32_t k1, k2;      // the document's key words
  float alpha, alpha_sum;
};

// A particle between two steps: n_k (in the owners' registers), the
// running count of the weights drawn, and the next step's position, weight,
// topic and beta_w row, loaded one step ahead.
template <int NJ>
struct Particle {
  float ndk[NJ], bw[NJ];
  float n_lt, w;
  int i, zi;
};

// One step of a particle from uniform u: the resample of its active
// position pt.i (kDraw false), or the draw of z_n at n = pt.i and, into
// *pw_n, the p_w of the score (kDraw true). s1 is the next step's index in
// the active list.
template <int G, bool kDraw>
__device__ __forceinline__ void step(const Doc& d, const WarpRows& r,
                                     Particle<(G + 1) / 2>& pt, int s1,
                                     float u, float* pw_n, int lane) {
  constexpr int NJ = (G + 1) / 2;
  const int K = d.K;
  const int i1 = d.pos[s1];
  const float w1 = d.wgt[s1];
  int zi1 = r.z[i1];
  if (!kDraw) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (pt.zi == lane + 32 * j) pt.ndk[j] -= pt.w;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int k = lane + 32 * j;
    r.p[k] = k < K ? (pt.ndk[j] + d.alpha) * pt.bw[j] : 0.0f;
  }
  if (kDraw) {
    const gibbs_warp::Divider by(pt.n_lt + d.alpha_sum);
    float th[NJ];
    bool exact = true;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float e = pt.ndk[j] + d.alpha;
      th[j] = by.fast(e);
      exact = exact & by.ok(e);
    }
    if (!exact) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) th[j] = (pt.ndk[j] + d.alpha) / by.b;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      r.q[k] = k < K ? th[j] * pt.bw[j] : 0.0f;
    }
  }
  __syncwarp();
  float4 mine = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (lane < 4 * G) mine = reinterpret_cast<const float4*>(r.p)[lane];
  gibbs_warp::load_row(pt.bw, d.bw + (size_t)i1 * K, K, lane);
  float start, p_w;
  const float total = chain_keep<G, kDraw>(r.p, r.q, lane, start, p_w);
  if (kDraw && lane == 0) *pw_n = p_w;
  const int nz = count_below(mine, start, u * total, lane, K);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (nz == lane + 32 * j) pt.ndk[j] += pt.w;
  r.z[pt.i] = (uint8_t)nz;  // every lane, the same value
  if (kDraw) pt.n_lt += pt.w;  // exact: integer-valued weights
  if (i1 == pt.i) zi1 = nz;    // the next step resamples this position
  pt.i = i1;
  pt.w = w1;
  pt.zi = zi1;
}

// The scan of particle q by the calling warp; writes p_w of every active
// position n to pw[n].
template <int G>
__device__ void scan_particle(const Doc& d, const WarpRows& r, int q,
                              float* pw) {
  constexpr int NJ = (G + 1) / 2;
  const int lane = threadIdx.x & 31;
  const int first = d.pos[0], end = d.pos[d.E - 1] + 1;
  Particle<NJ> pt;
#pragma unroll
  for (int j = 0; j < NJ; ++j) pt.ndk[j] = 0.0f;
  pt.n_lt = 0.0f;
  pt.i = first;
  pt.w = d.wgt[0];
  pt.zi = 0;
  gibbs_warp::load_row(pt.bw, d.bw + (size_t)first * d.K, d.K, lane);
  // lane t: the resample key and the draw's uniform of position n0 + t
  uint32_t rs1_l = 0, rs2_l = 0;
  float udr_l = 0.0f;
  int a = 0;  // active positions before n
  // Position n: the resamples of the active positions before it, their
  // uniforms one cipher per lane for 32 steps, then the draw if n is
  // active. Every step's row is pos[s] (a draw's s is a, and pos[a] = n);
  // a < E, since n < end = pos[E - 1] + 1.
  for (int n = first; n < end; ++n) {
    const int slot = (n - first) & 31;
    if (slot == 0) {
      uint32_t f1, f2, dr1, dr2;
      tf3::fold_in(d.k1, d.k2, (uint32_t)(n + lane), f1, f2);
      tf3::split2(f1, f2, rs1_l, rs2_l, dr1, dr2);
      udr_l = tf3::uniform_at(dr1, dr2, (uint32_t)q, (uint32_t)d.P);
    }
    const bool act = d.pos[a] == n;
    const int steps = a + (act ? 1 : 0);
    const uint32_t rs1 = __shfl_sync(kFull, rs1_l, slot);
    const uint32_t rs2 = __shfl_sync(kFull, rs2_l, slot);
    for (int c = 0; c < a; c += 32) {
      const float u_l = tf3::uniform_column_at(
          rs1, rs2, (uint32_t)d.P, (uint32_t)d.L, (uint32_t)q,
          d.pos[min(c + lane, a - 1)]);
      const int c_end = min(c + 32, a);
      for (int s = c; s < c_end; ++s)
        step<G, false>(d, r, pt, s + 1 < steps ? s + 1 : 0,
                       __shfl_sync(kFull, u_l, s - c), nullptr, lane);
    }
    if (act) {
      step<G, true>(d, r, pt, 0, __shfl_sync(kFull, udr_l, slot), pw + n,
                    lane);
      ++a;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(gibbs_warp::kMaxWarps * 32, 1)
l2r_scores_kernel(const long long* __restrict__ kd,     // [B, 2] key words
                  const float* __restrict__ beta_w,     // [B, L, K]
                  const float* __restrict__ weights,    // [B, L] mask, counts
                  const long long* __restrict__ order,  // [B] or null
                  float* __restrict__ pw,               // [B, P, L] scratch
                  float* __restrict__ ll,               // [L, B] out
                  int B, int L, int K, int P, float alpha, float alpha_sum,
                  int count_weighted) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_act;
  const int b = order != nullptr ? (int)order[blockIdx.x] : blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32;
  const float* w_doc = weights + (size_t)b * L;
  float* wgt = reinterpret_cast<float*>(smem);
  uint16_t* pos = reinterpret_cast<uint16_t*>(wgt + L);
  float* pw_doc = pw + (size_t)b * P * L;

  // the active positions in order, and their weights
  if (warp == 0) {
    int e = 0;
    for (int base = 0; base < L; base += 32) {
      const int i = base + lane;
      const float w = i < L ? w_doc[i] : 0.0f;
      const bool act = w > 0.0f;
      const unsigned bits = __ballot_sync(kFull, act);
      if (act) {
        const int a = e + __popc(bits & ((1u << lane) - 1u));
        pos[a] = (uint16_t)i;
        wgt[a] = w;
      }
      e += __popc(bits);
    }
    if (lane == 0) n_act = e;
  }
  __syncthreads();
  if (n_act > 0) {
    const Doc d{beta_w + (size_t)b * L * K, wgt, pos, n_act, L, K, P,
                (uint32_t)kd[2 * b], (uint32_t)kd[2 * b + 1], alpha,
                alpha_sum};
    const WarpRows r(smem + list_bytes(L) + warp * warp_bytes(L));
    for (int q = warp; q < P; q += warps)
      scan_particle<G>(d, r, q, pw_doc + (size_t)q * L);
  }
  __syncthreads();

  // the mean over particles, ((p0 + p1) + p2) + ..., its log and weight
  for (int n = threadIdx.x; n < L; n += blockDim.x) {
    const float w = w_doc[n];
    float out = 0.0f;
    if (w > 0.0f) {
      float s = pw_doc[n];
      for (int q = 1; q < P; ++q) s += pw_doc[(size_t)q * L + n];
      out = logf(fmaxf(s / (float)P, 1e-30f));
      if (count_weighted) out = w * out;
    }
    ll[(size_t)n * B + b] = out;
  }
}

}  // namespace

// Returns a cudaError_t, or gibbs_warp::kTooLong when a block of one warp
// does not fit shared memory (documents of more than about 33,000
// positions on an H100).
extern "C" int lda_l2r_scores(const long long* kd, const float* beta_w,
                              const float* weights, const long long* order,
                              float* pw, float* ll, int B, int L, int K,
                              int P, float alpha, float alpha_sum,
                              int count_weighted, void* stream) {
  if (B < 1) return 0;
  int sms = 0, smem_max = 0;
  const cudaError_t e = gibbs_warp::device_limits(sms, smem_max);
  if (e != cudaSuccess) return (int)e;
  const size_t list = list_bytes(L), per_warp = warp_bytes(L);
  if (list + per_warp > (size_t)smem_max) return gibbs_warp::kTooLong;
  const int warps = std::max(
      1, std::min({P, gibbs_warp::kMaxWarps,
                   (int)(((size_t)smem_max - list) / per_warp)}));
  return gibbs_warp::by_topics(K, [&](auto g) {
    return gibbs_warp::launch_blocks(
        l2r_scores_kernel<decltype(g)::value>, B, warps,
        list + warps * per_warp, stream, kd, beta_w, weights, order, pw, ll,
        B, L, K, P, alpha, alpha_sum, count_weighted);
  });
}
