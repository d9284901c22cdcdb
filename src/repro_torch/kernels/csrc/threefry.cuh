// threefry2x32 as a device function: jax.random.uniform(key, (n,))[p], bit
// for bit, evaluated inside the pack kernels (per element, or per counter
// pair with both outputs kept).
//
// Port of the JAX package's kernels/prng.py (lines 41-82), which is itself
// jax's non-partitionable counter layout: a length-n draw hashes the pairs
// (j, j + h) with h = ceil(n / 2) and the odd-n pad slot folded to 0, so
// position p < h is output word 0 of pair (p, p + h) and p >= h is output
// word 1 of pair (p - h, p). All arithmetic is uint32 add / xor / rotate,
// which wraps exactly as jax's primitive does.
#pragma once

#include <cstdint>

namespace repro {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// The mantissa construction of jax.random.uniform: (bits >> 9 | 0x3F800000)
// as float, minus 1, floored at 0.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(0.0f, u);
}

// jax.random.uniform(key, (n,))[p] for p < n (hashes the whole pair that
// holds p and keeps one of its two words).
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint32_t p, uint32_t n) {
  const uint32_t h = (n >> 1) + (n & 1u);
  const bool first = p < h;
  const uint32_t j = first ? p : p - h;
  uint32_t x0 = j;
  uint32_t x1 = (h + j < n) ? h + j : 0u;
  threefry2x32(k0, k1, x0, x1);
  return bits_to_uniform(first ? x0 : x1);
}

// Both uniforms of counter pair j < h = ceil(n / 2) from ONE hash:
// u0 = jax.random.uniform(key, (n,))[j] and u1 = ...[j + h] (meaningless
// when j + h >= n, where the odd-n pad slot folds the counter to 0).
__device__ __forceinline__ void uniform_pair_at(uint32_t k0, uint32_t k1,
                                                uint32_t j, uint32_t n,
                                                float& u0, float& u1) {
  const uint32_t h = (n >> 1) + (n & 1u);
  uint32_t x0 = j;
  uint32_t x1 = (h + j < n) ? h + j : 0u;
  threefry2x32(k0, k1, x0, x1);
  u0 = bits_to_uniform(x0);
  u1 = bits_to_uniform(x1);
}

}  // namespace repro
