// Pieces shared by the grouped launches (hash_pack.cuh, unpack_tile.cuh,
// ballot_pack.cuh, sign.cu, pack.cu): a table of up to 32 buckets travels
// by value as a __grid_constant__ kernel parameter, each bucket's first
// block a prefix sum built by the caller (kernels/qsgd.py grouped_table,
// kernels/pack.py field_table, kernels/sign.py vote_table).
#pragma once

#include <cstdint>

namespace repro {

// The bucket of this block: the last of the `count` first blocks at or
// below blockIdx.x. The first blocks lie together at the front of a table,
// so the scan reads two constant-cache lines, not one per bucket.
__device__ __forceinline__ int bucket_of(const int* block_start, int count) {
  int k = 0;
  while (k + 1 < count &&
         static_cast<int>(blockIdx.x) >= block_start[k + 1])
    ++k;
  return k;
}

// True where p may be read or written as 16-byte vectors.
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace repro
