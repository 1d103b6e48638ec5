// Variant "decode" of the attention forward pass: few query rows against
// a cache (Sq * group <= 64), bf16 or float32, every D. Included by
// flash_attention.cu; the function is the one described there.
//
// What bounds it. A decode step reads every visible cache row of K and V
// once and does 4 D operations per row and query head: bound by bytes,
// far from the tensor cores' regime, so this variant uses none.
//
// Design. One block of 8 warps per (batch, KV head, key split, row
// chunk). Its rows are the query rows that read that KV head: the group's
// query heads times the Sq positions (2 rows for gemma2-2b's decode), up
// to kRows of them a block; more rows take more blocks along z. The
// visible keys of the problem ([kmin, kmax], from the first row's window
// start to the last row's causal limit) are cut into n_split equal ranges
// (n_split = ceil(visible / ops.SPLIT_KEYS), computed by the wrapper), one a
// block along y; a block's range is cut again over its warps. A warp
// walks its keys kUnroll at a time with the lanes over D (each lane E
// contiguous elements, one vector load a row: E = D / 32, or at D = 16
// and D = 80 the least E that divides D with 32 E >= D, so 16 and 20
// lanes work and the rest hold zeros), reduces each dot product
// by shuffles and keeps, per row, its own running max, sum and
// accumulator in registers (scores in log2 units, every product an
// explicit fmaf). The warps merge through shared memory by the
// log-sum-exp rule. With one split the block writes O; with more it
// writes its unnormalised sums and (max, sum) per row to a float32
// workspace, and combine_kernel merges the splits the same way.

namespace dec {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMinusBig = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws_acc;  // [B * Hkv, n_split, rows, D] when n_split > 1
  float* ws_ml;   // [B * Hkv, n_split, rows, 2]
  int b, sq, sk, h, hkv;
  int q_offset, window, causal;
  float scale, softcap;
  int n_split;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Elements of one row a lane holds: the least E >= ceil(D / 32) that
// divides D (D / 32 for D in {32, 64, 128, 256}; 1 at D = 16; 4 at D = 80).
__host__ __device__ constexpr int lane_elems(int d) {
  int e = (d + 31) / 32;
  while (d % e != 0) ++e;
  return e;
}

// E contiguous elements of T at p (aligned to E * sizeof(T)) as floats.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[E]) {
  constexpr int kBytes = E * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < E / kPer; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kPer; ++e) out[c * kPer + e] = to_float(x[e]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_float(x[e]);
  } else if constexpr (kBytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_float(x[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_float(p[e]);
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D, int kRows>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const Params p) {
  constexpr int E = lane_elems(D);  // elements a lane holds
  constexpr int kUnroll = kRows <= 2 ? 4 : 2;
  extern __shared__ __align__(16) float smem[];
  float* sm_acc = smem;                          // [kWarps][kRows][D]
  float* sm_m = sm_acc + kWarps * kRows * D;     // [kWarps][kRows]
  float* sm_l = sm_m + kWarps * kRows;           // [kWarps][kRows]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bi = blockIdx.x / p.hkv;
  const int hk = blockIdx.x % p.hkv;
  const int split = blockIdx.y;
  const int group = p.h / p.hkv;
  const int rows = p.sq * group;
  const int r0 = blockIdx.z * kRows;
  const int n_rows = min(kRows, rows - r0);
  const bool lane_on = lane * E < D;  // D = 16 or 80: lanes idle
  const long long q_stride = (long long)p.h * D;
  const long long kv_stride = (long long)p.hkv * D;
  const T* kb = static_cast<const T*>(p.k) +
                ((long long)bi * p.sk * p.hkv + hk) * D + lane * E;
  const T* vb = static_cast<const T*>(p.v) +
                ((long long)bi * p.sk * p.hkv + hk) * D + lane * E;

  // row r of the chunk: query position i = (r0 + r) / group of head
  // hk * group + (r0 + r) % group
  float q[kRows][E];
  int pos[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int rr = r0 + min(r, n_rows - 1);
    const int i = rr / group, head = hk * group + rr % group;
    pos[r] = p.q_offset + i;
    if (r < n_rows && lane_on) {
      load_vec<T, E>(static_cast<const T*>(p.q) +
                         ((long long)bi * p.sq + i) * q_stride +
                         (long long)head * D + lane * E,
                     q[r]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) q[r][e] = 0.f;
    }
  }

  // the visible keys of the whole problem, [kmin, kmax]; the block's
  // split of them, and its warp's part of that
  long long kmax = p.sk - 1;
  if (p.causal) kmax = min(kmax, (long long)p.q_offset + p.sq - 1);
  const long long kmin =
      max(0LL, (long long)p.q_offset - (long long)p.window + 1);
  const long long n_keys = kmax >= kmin ? kmax - kmin + 1 : 0;
  const long long per_split = (n_keys + p.n_split - 1) / p.n_split;
  const long long ks = kmin + split * per_split;
  const long long ke = min(kmin + n_keys, ks + per_split);
  const long long per_warp = max(0LL, (ke - ks + kWarps - 1) / kWarps);
  const int w_start = (int)min(ke, ks + warp * per_warp);
  const int w_end = (int)min(ke, ks + (warp + 1) * per_warp);

  const bool softcap = p.softcap > 0.f;
  const float scale_log2 = p.scale * kLog2e;
  const float cap_log2 = p.softcap * kLog2e;
  const float scale_over_cap = softcap ? p.scale / p.softcap : 0.f;

  float m[kRows], l[kRows], acc[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMinusBig;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int c0 = w_start; c0 < w_end; c0 += kUnroll) {
    float kf[kUnroll][E], vf[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = min(c0 + u, w_end - 1);  // past the end: masked below
      if (lane_on) {
        load_vec<T, E>(kb + (long long)c * kv_stride, kf[u]);
        load_vec<T, E>(vb + (long long)c * kv_stride, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[kUnroll][kRows];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(q[r][e], kf[u][e], d);
        s[u][r] = d;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], off);

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float y[kUnroll];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u;
        const bool keep = c < w_end && c < p.sk &&
                          (!p.causal || pos[r] >= c) &&
                          pos[r] - c < p.window;
        const float x = softcap
                            ? cap_log2 * tanhf(s[u][r] * scale_over_cap)
                            : s[u][r] * scale_log2;
        y[u] = keep ? x : -INFINITY;
        mx = fmaxf(mx, y[u]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float pu = exp2f(y[u] - m_new);
        sum += pu;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pu, vf[u][e], acc[r][e]);
      }
      l[r] = fmaf(l[r], alpha, sum);
    }
  }

  // merge the warps: each writes its state, then the block sums
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        sm_acc[(warp * kRows + r) * D + lane * E + e] = acc[r][e];
    }
    if (lane == 0) {
      sm_m[warp * kRows + r] = m[r];
      sm_l[warp * kRows + r] = l[r];
    }
  }
  __syncthreads();

  T* ob = static_cast<T*>(p.o);
  for (int idx = threadIdx.x; idx < n_rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float mx = kMinusBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * kRows + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm_m[w * kRows + r] - mx);
      lsum = fmaf(sm_l[w * kRows + r], f, lsum);
      a = fmaf(sm_acc[(w * kRows + r) * D + d], f, a);
    }
    const int rr = r0 + r;
    if (p.n_split == 1) {
      const int i = rr / group, head = hk * group + rr % group;
      ob[((long long)bi * p.sq + i) * q_stride + (long long)head * D + d] =
          from_float<T>(lsum == 0.f ? 0.f : a / lsum);
    } else {
      const long long slot =
          ((long long)blockIdx.x * p.n_split + split) * rows + rr;
      p.ws_acc[slot * D + d] = a;
      if (d == 0) {
        p.ws_ml[slot * 2] = mx;
        p.ws_ml[slot * 2 + 1] = lsum;
      }
    }
  }
}

// Merges the n_split partial results of each (batch, KV head, row).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) combine_kernel(const Params p) {
  const int bi = blockIdx.x / p.hkv;
  const int hk = blockIdx.x % p.hkv;
  const int group = p.h / p.hkv;
  const int rows = p.sq * group;
  const long long q_stride = (long long)p.h * D;
  const long long base = (long long)blockIdx.x * p.n_split * rows;
  T* ob = static_cast<T*>(p.o);
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int rr = idx / D, d = idx % D;
    float mx = kMinusBig;
    for (int s = 0; s < p.n_split; ++s)
      mx = fmaxf(mx, p.ws_ml[(base + (long long)s * rows + rr) * 2]);
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < p.n_split; ++s) {
      const long long slot = base + (long long)s * rows + rr;
      const float f = exp2f(p.ws_ml[slot * 2] - mx);
      lsum = fmaf(p.ws_ml[slot * 2 + 1], f, lsum);
      a = fmaf(p.ws_acc[slot * D + d], f, a);
    }
    const int i = rr / group, head = hk * group + rr % group;
    ob[((long long)bi * p.sq + i) * q_stride + (long long)head * D + d] =
        from_float<T>(lsum == 0.f ? 0.f : a / lsum);
  }
}

template <typename T, int D, int kRows>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  const int smem =
      (kWarps * kRows * D + 2 * kWarps * kRows) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, kRows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = p.sq * (p.h / p.hkv);
  const dim3 grid(p.b * p.hkv, p.n_split, (rows + kRows - 1) / kRows);
  decode_kernel<T, D, kRows><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  combine_kernel<T, D><<<p.b * p.hkv, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int rows = p.sq * (p.h / p.hkv);
  return rows <= 2 ? launch_rows<T, D, 2>(p, stream)
                   : launch_rows<T, D, 8>(p, stream);
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

}  // namespace dec
