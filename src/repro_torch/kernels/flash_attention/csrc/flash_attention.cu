// Attention forward pass with GQA, causal mask, sliding window and logit
// softcap, for Hopper (sm_90a), in three variants chosen by the wrapper
// (ops.variant) from the dtype, Sq, D and the GQA group:
//   "decode" (decode_split.cuh): Sq * group <= 64 rows, both dtypes, every
//            D: the keys split over warps and, past 512 visible keys,
//            over blocks; no tensor cores (bound by the cache's bytes);
//   "wgmma"  (wgmma_prefill.cuh): bf16 at D in {64, 128, 256} above that:
//            TMA tiles and wgmma, warp-specialised;
//   "fma"    (this file): everything else, float32 prefill and bf16 at
//            D in {16, 32, 80}: float32 FMA tiles.
// Every variant takes causal and non-causal launches (whisper's encoder
// and its cross-attention are non-causal); D = 80 is zamba2's head.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py, _flash_kernel (reached through
// flash_attention_pallas). Same function: for each query row at absolute
// position q_offset + i and each key j < Sk,
//   s = softcap * tanh(scale * q.k / softcap)   (softcap > 0, else scale*q.k)
// kept where (!causal || q_offset + i >= j) && (q_offset + i) - j < window,
// softmax over the kept keys, times V; a row with no kept key gives 0.
// Query head h reads KV head h / (H / Hkv) in place (GQA, no copy).
// Inputs and output share one dtype, bf16 (the model's) or float32 (the
// tests'); every sum is float32.
//
// Layout: q and o [B, Sq, H, D], k and v [B, Sk, Hkv, D], contiguous, as
// the model produces them: the kernel reads head h's rows with a stride of
// H * D and needs no transpose. Keys past Sk are masked here, so the
// wrapper pads nothing.
//
// The "fma" variant, and what bounds it. Prefill at S = 8192, D = 256:
// 4 * Sq * keys * D operations per head over the visible pairs, some 0.3
// ms a layer at the bf16 tensor-core rate, against 100 MB of Q, K, V and
// O (0.03 ms): bound by operations. This variant does its products as
// float32 FMAs (float32 inputs must agree with the plain version to 2e-5,
// beyond what TF32 or bf16 tensor cores keep), so on bf16 at prefill it
// would sit far above the tensor-core bound: bf16 at D >= 64 goes to
// "wgmma".
//
// Design of "fma". One block of 256 threads (16 x 16) per (batch * head, 64-row
// query tile); the TPU's sequential key axis is a loop inside the block,
// with the online-softmax state (row max m, row sum l, the [64, D]
// accumulator) in registers. Thread (ty, tx) owns query rows 4ty..4ty+3:
// their 4 x 4 score block at key columns 4tx..4tx+3 and their output at
// dims tx + 16n, so a row's max and sum reduce over the 16 threads of one
// half-warp by shuffles and the rescale by alpha stays in the thread.
// Shared memory (float32): the Q tile transposed [D][68], one K/V buffer
// (K transposed [D][68], then V row-major [64][D]) and P transposed
// [64][68]; the padding keeps float4 reads aligned. 153 KB at D = 256,
// above the 48 KB default, so each launch raises the block's dynamic
// shared-memory limit first. Only the key tiles that hold a visible key of
// some row are visited (none past the last row's position, none wholly
// before the first row's window). Half-warps whose four rows all lie past
// Sq skip the arithmetic and only help load tiles. The window
// sentinel 1 << 30 stays in int32: positions and Sk are below 2^30 (the
// wrapper checks), and the tile range is computed in 64 bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_split.cuh"
#include "wgmma_prefill.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLd = 68;            // row length of the transposed tiles
constexpr float kNegInf = -1e30f;  // masked score (as the TPU kernel's)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, sq, sk, h, hkv;
  int q_offset;
  int window;
  int causal;
  float scale;
  float softcap;  // 0: none
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

constexpr int smem_bytes(int d) {
  return (2 * d * kLd + kBK * kLd) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // [D][kLd]  Q tile, transposed
  float* kv = qt + D * kLd;    // [D][kLd]  K tile transposed / [kBK][D] V
  float* pt = kv + D * kLd;    // [kBK][kLd] P tile, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bi = blockIdx.y / p.h;
  const int hi = blockIdx.y % p.h;
  const int hk = hi / (p.h / p.hkv);
  const int q0 = blockIdx.x * kBQ;
  const long long q_stride = (long long)p.h * D;     // between query rows
  const long long kv_stride = (long long)p.hkv * D;  // between key rows
  const T* qb = static_cast<const T*>(p.q) +
                ((long long)bi * p.sq * p.h + hi) * D;
  const T* kb = static_cast<const T*>(p.k) +
                ((long long)bi * p.sk * p.hkv + hk) * D;
  const T* vb = static_cast<const T*>(p.v) +
                ((long long)bi * p.sk * p.hkv + hk) * D;
  T* ob = static_cast<T*>(p.o) + ((long long)bi * p.sq * p.h + hi) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qt[d * kLd + r] =
        q0 + r < p.sq ? to_f(qb[(long long)(q0 + r) * q_stride + d]) : 0.f;
  }

  // the keys some row of this tile sees: [kmin, kmax]
  const int last_row = min(q0 + kBQ, p.sq) - 1;
  long long kmax = p.sk - 1;
  if (p.causal) kmax = min(kmax, (long long)p.q_offset + last_row);
  const long long kmin =
      max(0LL, (long long)p.q_offset + q0 - (long long)p.window + 1);

  // the half-warp of ty holds rows 4ty..4ty+3; it works if one is real
  const bool live = q0 + ty * 4 < p.sq;
  const unsigned lanes = 0xffffu << (16 * (ty & 1));
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[i][n] = 0.f;
  }

  const int k_first = kmin <= kmax ? (int)(kmin / kBK) * kBK : 0;
  const int k_end = kmin <= kmax ? (int)kmax + 1 : 0;
  for (int k0 = k_first; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's V and P reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      kv[d * kLd + c] =
          k0 + c < p.sk ? to_f(kb[(long long)(k0 + c) * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    if (live) {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(&qt[d * kLd + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&kv[d * kLd + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = p.q_offset + q0 + ty * 4 + i;
        float mx = kNegInf;
        unsigned ok = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx * 4 + j;
          float x = s[i][j] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          const bool keep = col < p.sk && (!p.causal || row >= col) &&
                            row - col < p.window;
          ok |= (unsigned)keep << j;
          s[i][j] = keep ? x : kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(lanes, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
          sum += s[i][j];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(lanes, sum, off);
        l[i] = alpha * l[i] + sum;
        m[i] = m_new;
#pragma unroll
        for (int n = 0; n < D / 16; ++n) acc[i][n] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(&pt[(tx * 4 + j) * kLd + ty * 4]) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();  // K reads done, P written

    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      kv[c * D + d] =
          k0 + c < p.sk ? to_f(vb[(long long)(k0 + c) * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    if (live) {
#pragma unroll 2
      for (int c = 0; c < kBK; ++c) {
        const float4 pv = *reinterpret_cast<const float4*>(&pt[c * kLd + ty * 4]);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          const float x = kv[c * D + tx + 16 * n];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(pr[i], x, acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      ob[(long long)r * q_stride + tx + 16 * n] = from_f<T>(acc[i][n] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.b * p.h);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o [B, Sq, H, D]; k, v [B, Sk, Hkv, D]; all bf16 (is_bf16) or float32,
// contiguous, 16-byte aligned. D in {16, 32, 64, 80, 128, 256}; H a multiple
// of Hkv. variant: 0 "fma", 1 "wgmma" (bf16, D >= 64), 2 "decode" (with
// n_split key splits; ws_acc / ws_ml its float32 workspace when
// n_split > 1); "wgmma" does not take D = 80. Launches on `stream` and
// returns cudaGetLastError(), or
// cudaErrorInvalidValue for a variant that does not take the inputs.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int sq,
                                   int sk, int h, int hkv, int d,
                                   int q_offset, int window, int causal,
                                   float scale, float softcap, int is_bf16,
                                   int variant, int n_split, void* ws_acc,
                                   void* ws_ml, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == 0) {
    const Params p{q, k, v, o, b, sq, sk, h, hkv, q_offset, window, causal,
                   scale, softcap};
    err = is_bf16 ? dispatch<__nv_bfloat16>(p, d, s)
                  : dispatch<float>(p, d, s);
  } else if (variant == 1) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    const wg::Params p{o, b, sq, sk, h, hkv, q_offset, window, causal,
                       scale, softcap};
    err = wg::dispatch(q, k, v, p, d, s);
  } else if (variant == 2) {
    const dec::Params p{q, k, v, o, static_cast<float*>(ws_acc),
                        static_cast<float*>(ws_ml), b, sq, sk, h, hkv,
                        q_offset, window, causal, scale, softcap, n_split};
    err = is_bf16 ? dec::dispatch<__nv_bfloat16>(p, d, s)
                  : dec::dispatch<float>(p, d, s);
  }
  return (int)err;
}
