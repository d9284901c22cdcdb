// Word-wise packing of width-bit fields into uint32 words, little-endian:
// field i's low bit lands at bit-stream position i * width of its unit.
//
// A chunk of 32 fields spans exactly `width` whole words, so a warp that
// owns one chunk assembles its words without touching a neighbour's (the
// JAX package's kernels/ref.py pack_fields_tile / unpack_fields_tile).
#pragma once

#include <cstdint>

namespace repro {

// Word t (0 <= t < width) of a 32-field chunk whose codes sit in codes[0..31].
__device__ __forceinline__ uint32_t assemble_word(const uint32_t* codes,
                                                  int width, int t) {
  const int lo_bit = 32 * t;
  const int j0 = lo_bit / width;
  const int j1 = min(31, (lo_bit + 31) / width);
  uint32_t w = 0u;
  for (int j = j0; j <= j1; ++j) {
    const int s = j * width - lo_bit;
    const uint32_t f = codes[j];
    w |= (s >= 0) ? (f << s) : (f >> (-s));
  }
  return w;
}

// Field p of one unit's packed words (reads the one or two words it spans),
// for any width 1..32: every shift count stays in 0..31.
__device__ __forceinline__ uint32_t extract_field(const uint32_t* words,
                                                  long long p, int width) {
  const long long b = p * width;
  const long long w = b >> 5;
  const int s = static_cast<int>(b & 31);
  uint32_t f = words[w] >> s;
  if (s + width > 32) f |= words[w + 1] << (32 - s);  // s >= 1 here
  return f & (0xFFFFFFFFu >> (32 - width));
}

// The same for field p of staged words with p * width < 2**31 (a tile in
// shared memory): 32-bit index arithmetic.
__device__ __forceinline__ uint32_t extract_field(const uint32_t* words,
                                                  int p, int width) {
  const int b = p * width;
  const int w = b >> 5;
  const int s = b & 31;
  uint32_t f = words[w] >> s;
  if (s + width > 32) f |= words[w + 1] << (32 - s);  // s >= 1 here
  return f & (0xFFFFFFFFu >> (32 - width));
}

}  // namespace repro
