// The staged-tile ballot walk shared by the one-bit packs: the fused
// signSGD pack (sign.cu: x >= 0.0f over f32) and the bit pack (bits.cu:
// bit != 0 over int32 {0, 1}). One template over the element type and a
// predicate; bit p of a unit is pred(x[p]), it lands in word p / 32 at
// position p % 32, each unit packs into ceil(d / 32) words and the bits
// past d are 0.
//
// Grouped launch: a table of up to kBallotMaxBuckets buckets (input and
// output pointers, n, d, words and tiles per unit, and each bucket's first
// block, a prefix sum built by the caller, kernels/qsgd.py grouped_table
// over kernels/qsgd.py ballot_tiles) travels by value as a __grid_constant__
// kernel parameter, so one launch packs every bucket of a step without a
// host-to-device copy. A block finds its bucket with a scan over the first
// blocks (grouped.cuh), then its unit and tile with one 32-bit divide; no
// 64-bit divide remains.
//
// A tile is kBallotChunks = 64 consecutive 32-element chunks of one unit
// (2,048 elements); a chunk is exactly one output word, so no word has two
// writers. A block of 256 threads stages the tile's 4-byte elements in
// shared memory with coalesced loads: two 16-byte loads a thread where the
// row is 16-byte aligned (d % 4 == 0 and an aligned base), eight 4-byte
// loads otherwise, all issued before the barrier; elements at or past d are
// not read. Each warp then takes one __ballot_sync per 32 staged elements
// (lane i reads element i of the chunk: no bank conflicts) over 8
// consecutive chunks, keeps word r in lane r, and lanes 0-7 store the
// warp's 8 words: the block's 64 words leave as one coalesced 256-byte run.
// A layerwise resnet9 step is 68 tiles a worker, the stress shape
// (4 x 1,048,579) 2,052.
#pragma once

#include <cstdint>

#include "grouped.cuh"

namespace repro {

constexpr int kBallotThreads = 256;                      // threads a block
constexpr int kBallotChunks = 64;                        // 32-element chunks a tile
constexpr int kBallotTile = 32 * kBallotChunks;          // kernels/qsgd.py BALLOT_TILE
constexpr int kBallotChunksPerWarp = kBallotChunks / (kBallotThreads / 32);
constexpr int kBallotMaxBuckets = 32;                    // kernels/qsgd.py MAX_BUCKETS

struct BallotBucket {
  const void* x;         // (n, d) 4-byte elements
  uint32_t* out;         // (n, wpu) words
  int n, d, wpu, tiles;  // tiles per unit
};

struct BallotTable {
  int block_start[kBallotMaxBuckets];  // each bucket's first block
  BallotBucket b[kBallotMaxBuckets];
  int count;
};

// The table of `count` (1..kBallotMaxBuckets) buckets: `ptrs` holds their x
// pointers, then their out pointers; `sizes` their n, d, wpu, tiles per
// unit and first block, `count` of each in that order (kernels/qsgd.py
// launch_grouped).
inline BallotTable ballot_table(int count, void* const* ptrs,
                                const int* sizes) {
  BallotTable t;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    t.b[i] = BallotBucket{ptrs[i], static_cast<uint32_t*>(ptrs[count + i]),
                          sizes[i], sizes[count + i], sizes[2 * count + i],
                          sizes[3 * count + i]};
    t.block_start[i] = sizes[4 * count + i];
  }
  return t;
}

// The body of a pack kernel of kBallotThreads threads: this block's tile of
// its bucket, bit p set where pred(x[p]) holds.
template <class T, class Pred>
__device__ __forceinline__ void ballot_pack_tile(const BallotTable& t,
                                                 const Pred& pred) {
  static_assert(sizeof(T) == 4, "the walk stages 4-byte elements");
  __shared__ __align__(16) T xs[kBallotTile];
  const int k = bucket_of(t.block_start, t.count);
  const BallotBucket& b = t.b[k];
  const int local = static_cast<int>(blockIdx.x) - t.block_start[k];
  const int unit = local / b.tiles;
  const int tile = local - unit * b.tiles;
  const int e0 = tile * kBallotTile;             // the tile's first element
  const int ne = min(kBallotTile, b.d - e0);
  const T* src = static_cast<const T*>(b.x) +
                 static_cast<long long>(unit) * b.d + e0;

  // 1. stage the tile's elements, coalesced, every load of a thread issued
  //    before the first store to shared memory (the 16-byte copies move the
  //    bit patterns: a NaN or -0.0 stays what it was)
  if (b.d % 4 == 0 && aligned16(b.x)) {  // ne % 4 == 0 here
    uint4 v[kBallotTile / 4 / kBallotThreads];
#pragma unroll
    for (int r = 0; r < kBallotTile / 4 / kBallotThreads; ++r) {
      const int i = threadIdx.x + r * kBallotThreads;
      if (4 * i < ne) v[r] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    }
#pragma unroll
    for (int r = 0; r < kBallotTile / 4 / kBallotThreads; ++r) {
      const int i = threadIdx.x + r * kBallotThreads;
      if (4 * i < ne) reinterpret_cast<uint4*>(xs)[i] = v[r];
    }
  } else {
    T v[kBallotTile / kBallotThreads];
#pragma unroll
    for (int r = 0; r < kBallotTile / kBallotThreads; ++r) {
      const int i = threadIdx.x + r * kBallotThreads;
      if (i < ne) v[r] = __ldg(src + i);
    }
#pragma unroll
    for (int r = 0; r < kBallotTile / kBallotThreads; ++r) {
      const int i = threadIdx.x + r * kBallotThreads;
      if (i < ne) xs[i] = v[r];
    }
  }
  __syncthreads();

  // 2. one ballot a chunk: warp w owns chunks [8w, 8w + 8) of the tile,
  //    word r lands in lane r, and lanes 0-7 store the 8 words (words past
  //    wpu, beyond d, are not written)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = warp * kBallotChunksPerWarp;
  uint32_t mine = 0u;
#pragma unroll
  for (int r = 0; r < kBallotChunksPerWarp; ++r) {
    const int i = (c0 + r) * 32 + lane;
    const uint32_t w = __ballot_sync(0xFFFFFFFFu, i < ne && pred(xs[i]));
    if (lane == r) mine = w;
  }
  const int c = c0 + lane;                       // this lane's chunk
  if (lane < kBallotChunksPerWarp && 32 * c < ne)
    b.out[static_cast<long long>(unit) * b.wpu + tile * kBallotChunks + c] =
        mine;
}

}  // namespace repro
