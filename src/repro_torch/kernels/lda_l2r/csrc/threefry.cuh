// Threefry-2x32 on the device, bit for bit the stream of jax.random's
// non-partitionable threefry (repro_torch/core/threefry.py is the torch
// twin, repro/core/threefry.py the JAX one): the cipher, fold_in, split
// into two, and single values of a uniform draw, one cipher per value.
#pragma once
#include <stdint.h>

namespace tf3 {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

#define TF3_ROUND(d) \
  x0 += x1;          \
  x1 = rotl(x1, d);  \
  x1 ^= x0;

#define TF3_GROUP_A TF3_ROUND(13) TF3_ROUND(15) TF3_ROUND(26) TF3_ROUND(6)
#define TF3_GROUP_B TF3_ROUND(17) TF3_ROUND(29) TF3_ROUND(16) TF3_ROUND(24)

// 5 x 4 rounds; key schedule [k1, k2, k1 ^ k2 ^ parity] rotating one slot
// per group, the group index added to the second lane.
__device__ __forceinline__ void cipher(uint32_t k1, uint32_t k2, uint32_t x0,
                                       uint32_t x1, uint32_t& o0,
                                       uint32_t& o1) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x0 += k1;
  x1 += k2;
  TF3_GROUP_A
  x0 += k2;
  x1 += k3 + 1u;
  TF3_GROUP_B
  x0 += k3;
  x1 += k1 + 2u;
  TF3_GROUP_A
  x0 += k1;
  x1 += k2 + 3u;
  TF3_GROUP_B
  x0 += k2;
  x1 += k3 + 4u;
  TF3_GROUP_A
  x0 += k3;
  x1 += k1 + 5u;
  o0 = x0;
  o1 = x1;
}

#undef TF3_GROUP_A
#undef TF3_GROUP_B
#undef TF3_ROUND

// fold_in(key, data): cipher the single count `data`, halves [0] and [data].
__device__ __forceinline__ void fold_in(uint32_t k1, uint32_t k2,
                                        uint32_t data, uint32_t& n1,
                                        uint32_t& n2) {
  cipher(k1, k2, 0u, data, n1, n2);
}

// (a, b) = split(key): counts [0, 1] and [2, 3]; a = first words, b = second.
__device__ __forceinline__ void split2(uint32_t k1, uint32_t k2, uint32_t& a1,
                                       uint32_t& a2, uint32_t& b1,
                                       uint32_t& b2) {
  cipher(k1, k2, 0u, 2u, a1, b1);
  cipher(k1, k2, 1u, 3u, a2, b2);
}

// The word at flat position f of a size-n draw (halves pairing; odd n pads
// one zero count).
__device__ __forceinline__ uint32_t bits_at(uint32_t k1, uint32_t k2,
                                            uint32_t f, uint32_t n) {
  const uint32_t h = (n + 1u) / 2u;
  const uint32_t in1 = f < h ? f : f - h;
  uint32_t in2 = in1 + h;
  if (2u * h != n && in2 >= n) in2 = 0u;
  uint32_t o1, o2;
  cipher(k1, k2, in1, in2, o1, o2);
  return f < h ? o1 : o2;
}

// jax's float construction: top 23 bits under the exponent of 1.0, minus 1.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Value f of uniform(key, (n,)) — uniform_halves for one index.
__device__ __forceinline__ float uniform_at(uint32_t k1, uint32_t k2,
                                            uint32_t f, uint32_t n) {
  return uniform_from_bits(bits_at(k1, k2, f, n));
}

// Entry (row, col) of uniform(key, (p, l)) — uniform_column for one row.
__device__ __forceinline__ float uniform_column_at(uint32_t k1, uint32_t k2,
                                                   uint32_t p, uint32_t l,
                                                   uint32_t row,
                                                   uint32_t col) {
  return uniform_at(k1, k2, row * l + col, p * l);
}

}  // namespace tf3
