// Variant "wgmma" of the attention forward pass: bf16 prefill on the
// Hopper tensor cores, D in {64, 128, 256}. Included by flash_attention.cu;
// the function is the one described there.
//
// What bounds it. At S = 8192, D = 256 the visible pairs cost 4 D
// operations each: some 0.28 ms a layer at the bf16 tensor-core peak,
// against 0.03 ms for the bytes of Q, K, V and O. So the products run as
// wgmma on bf16 tiles (float32 sums) and the loads are TMA copies that
// overlap them.
//
// Design. One block of 384 threads per (batch x head, 128 query rows),
// warp-specialised. Warpgroup 0 is the producer: one thread loads the Q
// tile once, then K and V tiles of 64 keys into a ring of two stages,
// each stage a "full" mbarrier (TMA bytes) and an "empty" one (one arrive
// per consumer warp). Warpgroups 1 and 2 are consumers of 64 query rows
// each: S = Q K^T by wgmma from shared memory (both operands K-major), the
// online softmax in float32 registers, P rounded to bf16 in registers as
// the A operand of O += P V (V read MN-major through the transpose bit).
// setmaxnreg gives the producer 24 registers and each consumer 240: the O
// accumulator alone is D / 2 floats a thread (128 at D = 256).
//
// Shared memory, bf16, every tile stored as 64-column panels of 128-byte
// rows in TMA's 128-byte swizzle (the layout wgmma's descriptors name):
// Q 128 x D, and per stage K and V 64 x D: 192 KB at D = 256.
//
// Layout in place: q and o [B, Sq, H, D], k and v [B, Sk, Hkv, D]; 4-D
// tensor maps (D, heads, rows, B) whose row stride is H * D (or Hkv * D)
// load head h's rows and KV head h / group's without a copy. TMA fills
// rows past Sq and keys past Sk with zeros; the mask still removes those
// keys. The maps are encoded on the host per call by
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint (no -lcuda).
//
// Softmax: scores in log2 units, softcap * tanh(x / softcap) with
// tanh.approx.f32, exp2 with the scale folded into one fmaf; the causal,
// window and Sk masks only on tiles that cross a mask edge; only the key
// tiles that hold a visible key of some row of the block are loaded.
// A consumer skips (but releases) a tile none of its rows sees. Blocks
// are issued from the last query tile down, so the longest causal rows
// start first.

#include <cuda.h>

namespace wg {

constexpr int kBM = 128;         // query rows per block
constexpr int kBN = 64;          // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;    // producer warpgroup + 2 consumers
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMinusBig = -1e30f;  // the running max before any key

struct Params {
  void* o;
  int b, sq, sk, h, hkv;
  int q_offset, window, causal;
  float scale, softcap;
};

template <int D>
struct Smem {
  static constexpr int kPanels = D / 64;
  __nv_bfloat16 q[kPanels][kBM * 64];
  __nv_bfloat16 k[kStages][kPanels][kBN * 64];
  __nv_bfloat16 v[kStages][kPanels][kBN * 64];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};

template <int D>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<D>) + 1024;  // + alignment of the base to 1 KB
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// (No watchdog here: a trap in this loop makes ptxas serialise the wgmma
// and spill at D = 256.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptors of 128-byte-swizzled tiles. The high
// word is the same for every tile here: stride byte offset 1024 (8 rows
// of 128 bytes, in 16-byte units) and layout 1 (128B swizzle). The low
// word is the start address and the leading byte offset (16-byte units):
// unused for K-major tiles, the distance between 64-column panels for
// MN-major ones. Only low words are kept in registers; each wgmma builds
// its descriptors at the call.
constexpr uint32_t kDescHi = (1024u >> 4) | (1u << 30);
__device__ __forceinline__ uint32_t desc_lo(const void* p, uint32_t lbo) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Ties registers to this point, so no read of an accumulator moves above
// the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
// (K-major, 128B swizzle); accumulate unless scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint32_t a_lo,
                                           uint32_t b_lo, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%32, %35};\n"
      "mov.b64 db, {%33, %35};\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a_lo), "r"(b_lo), "r"(scale_d), "r"(kDescHi));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A from registers (bf16 pairs),
// B from shared memory MN-major (128B swizzle, the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint32_t b_lo, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%36, %38};\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo),
        "r"(scale_d), "r"(kDescHi));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A from registers (bf16 pairs),
// B from shared memory MN-major (128B swizzle, the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint32_t b_lo, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%68, %70};\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo),
        "r"(scale_d), "r"(kDescHi));
}

// D[64 x 256] (+)= A[64 x 16] * B[16 x 256], A from registers (bf16 pairs),
// B from shared memory MN-major (128B swizzle, the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint32_t b_lo, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%132, %134};\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo),
        "r"(scale_d), "r"(kDescHi));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t b_lo) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, b_lo, 1);
  else if constexpr (D == 128) wgmma_rs_n128(d, a, b_lo, 1);
  else wgmma_rs_n256(d, a, b_lo, 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const Params p) {
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bi = blockIdx.x / p.h;
  const int hi = blockIdx.x % p.h;
  const int hk = hi / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // last tile first

  // the keys some row of this block sees: [kmin, kmax], in 64-key tiles
  const int last_row = min(q0 + kBM, p.sq) - 1;
  long long kmax = p.sk - 1;
  if (p.causal) kmax = min(kmax, (long long)p.q_offset + last_row);
  const long long kmin =
      max(0LL, (long long)p.q_offset + q0 - (long long)p.window + 1);
  const int k_first = kmin <= kmax ? (int)(kmin / kBN) * kBN : 0;
  const int n_tiles =
      kmin <= kmax ? ((int)kmax - k_first) / kBN + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup index, warp-uniform by a shuffle: ptxas then sees each role
  // as one region and gives it the registers setmaxnreg asks for
  const int wg_id = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg_id == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kBM * D * 2);
      for (int c = 0; c < kPanels; ++c)
        tma_load_4d(sm.q[c], &tm_q, &sm.q_full, c * 64, hi, q0, bi);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kBN * D * 2);
        const int k0 = k_first + t * kBN;
        for (int c = 0; c < kPanels; ++c) {
          tma_load_4d(sm.k[s][c], &tm_k, &sm.full[s], c * 64, hk, k0, bi);
          tma_load_4d(sm.v[s][c], &tm_v, &sm.full[s], c * 64, hk, k0, bi);
        }
      }
      // stay until the consumers have released every stage in flight
      for (int t = max(0, n_tiles - kStages); t < n_tiles; ++t)
        mbar_wait(&sm.empty[t % kStages], (t / kStages) & 1);
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int g = wg_id - 1;
    const int t128 = threadIdx.x % 128;
    const int warp = t128 / 32, lane = t128 % 32;
    // this thread's two rows in the block, and their positions
    const int row_a = g * 64 + warp * 16 + lane / 4;
    const int pos_a = p.q_offset + q0 + row_a;
    const int pos_b = pos_a + 8;
    // positions of the warpgroup's first and last rows (rows past Sq
    // included: their output is dropped)
    const int wg_lo = p.q_offset + q0 + g * 64;
    const int wg_hi = wg_lo + 63;
    const bool softcap = p.softcap > 0.f;
    const float scale_log2 = p.scale * kLog2e;
    const float cap_log2 = p.softcap * kLog2e;
    const float scale_over_cap = softcap ? p.scale / p.softcap : 0.f;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = kMinusBig, m_b = kMinusBig;  // running max, log2 units
    float l_a = 0.f, l_b = 0.f;              // this thread's partial sums

    mbar_wait(&sm.q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = k_first + t * kBN;
      const int k_last = k0 + kBN - 1;
      // none of this warpgroup's rows sees a key of the tile: skip it
      const bool skip = k0 >= p.sk || (p.causal && k0 > wg_hi) ||
                        (long long)wg_lo - k_last >= (long long)p.window;
      // every row sees every key of the tile: no mask
      const bool full_tile = k_last < p.sk &&
                             (!p.causal || k_last <= wg_lo) &&
                             (long long)wg_hi - k0 < (long long)p.window;
      mbar_wait(&sm.full[s], (t / kStages) & 1);
      if (!skip) {
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        wgmma_fence();
        // 16 columns of D a step (32 bytes, 2 in the address field)
        const uint32_t qa = desc_lo(&sm.q[0][g * 64 * 64], 16);
        const uint32_t kb = desc_lo(sm.k[s][0], 16);
#pragma unroll
        for (int c = 0; c < kPanels; ++c) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(sc, qa + c * (kBM * 64 * 2 / 16) + 2 * kk,
                         kb + c * (kBN * 64 * 2 / 16) + 2 * kk,
                         (c | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scores to log2 units; masked ones to -inf
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool rb = (i / 2) % 2;
          float y = softcap ? cap_log2 * tanh_approx(sc[i] * scale_over_cap)
                            : sc[i];
          if (!full_tile) {
            const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
            const int pos = rb ? pos_b : pos_a;
            const bool keep = col < p.sk && (!p.causal || pos >= col) &&
                              pos - col < p.window;
            y = keep ? y : -INFINITY;
          }
          sc[i] = y;
          if (rb) mx_b = fmaxf(mx_b, y);
          else mx_a = fmaxf(mx_a, y);
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        // without a softcap the scores are raw q.k: the max in log2 units
        // is their max times scale * log2(e), and p = 2^(x s - m), one fmaf
        const float f = softcap ? 1.f : scale_log2;
        const float mn_a = fmaxf(m_a, mx_a * f);
        const float mn_b = fmaxf(m_b, mx_b * f);
        const float alpha_a = exp2f(m_a - mn_a);
        const float alpha_b = exp2f(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool rb = (i / 2) % 2;
          const float e = exp2f(fmaf(sc[i], f, -(rb ? mn_b : mn_a)));
          sc[i] = e;
          if (rb) sum_b += e;
          else sum_a += e;
        }
        l_a = fmaf(l_a, alpha_a, sum_a);
        l_b = fmaf(l_b, alpha_b, sum_b);
#pragma unroll
        for (int i = 0; i < D / 2; ++i)
          o[i] *= ((i / 2) % 2) ? alpha_b : alpha_a;

        // P as bf16 A fragments: the accumulator layout of S is the A
        // layout of a 64 x 16 slice, two columns to a register
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

        wgmma_fence();
        // 16 keys of V a step: rows 16 kk.. of every panel (LBO apart)
        const uint32_t vb = desc_lo(sm.v[s][0], kBN * 64 * 2);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<D>(o, pa[kk], vb + kk * (16 * 64 * 2 / 16));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    // epilogue: the quad's partial sums, then O / l straight to global
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
    const float inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
    const long long q_stride = (long long)p.h * D;
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) +
                        ((long long)bi * p.sq * p.h + hi) * D;
    const int r_a = q0 + row_a;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const bool rb = (i / 2) % 2;
      const int r = rb ? r_a + 8 : r_a;
      if (r >= p.sq) continue;
      const float inv = rb ? inv_b : inv_a;
      const int col = (i / 4) * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r * q_stride +
                                         col) =
          __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A bf16 [B, S, heads, D] tensor as boxes of 64 columns x `rows` rows of
// one head, 128-byte swizzled, zeros past its edges.
inline bool make_map(CUtensorMap* map, const void* ptr, int b, int s,
                     int heads, int d, int rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, p.b, p.sq, p.h, D, kBM) ||
      !make_map(&tk, k, p.b, p.sk, p.hkv, D, kBN) ||
      !make_map(&tv, v, p.b, p.sk, p.hkv, D, kBN))
    return cudaErrorInvalidValue;
  const int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h, (p.sq + kBM - 1) / kBM);
  flash_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

inline cudaError_t dispatch(const void* q, const void* k, const void* v,
                            const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<64>(q, k, v, p, stream);
    case 128: return launch<128>(q, k, v, p, stream);
    case 256: return launch<256>(q, k, v, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg
