// {0,1} bit <-> uint32 word packing for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's kernels/pack.py:
//   bits_pack   <- pack_bits_pallas   (pack.py:47, body _pack_kernel :32)
//   bits_unpack <- unpack_bits_pallas (pack.py:61, body _unpack_kernel :40)
// Bit p of unit i is bits[i, p] (an int32 in {0, 1}); it lands in word
// p / 32 of the unit at position p % 32 (little-endian), each unit packs
// into ceil(d / 32) uint32 words and the bits past d are 0. Unpack is the
// inverse and writes int32 {0, 1}. These serve the per-unit signSGD codec
// (core/wire.py SignSGDCodec.encode / decode), every fused=False bucket of
// it, and the non-fused majority vote. The (R, 512) tiling of the TPU
// version is gone: the contract is the bytes each unit produces.
//
// What bounds it on the card: bytes. Pack reads 4 B and writes 1/8 B per
// bit, unpack the reverse, with one compare or one shift per bit. The
// signSGD receive leg of one layerwise resnet9 step on 4 ranks
// (4 x 121,002 bits) moves about 2.0 MB, about 0.0006 ms at 3.35 TB/s, so
// every launch of the main path is latency-bound; at the stress shape
// (4 x 1,048,579 bits, 17.3 MB) the byte bound is about 0.0052 ms.
//
// Design. Pack is grouped over the buckets of a step: the staged-tile
// ballot walk of ballot_pack.cuh (shared with sign.cu's sign_pack) on int32
// with the predicate bit != 0. A table of up to 32 buckets travels by value
// as a __grid_constant__ kernel parameter, so one launch packs every
// bucket, the per-unit signSGD encode and the non-fused vote of a step
// included; a block finds its unit and tile with one 32-bit divide. A tile
// is 64 words of one unit (2,048 bits) staged in shared memory with 16-byte
// loads where d % 4 == 0 and the base is aligned, 4-byte loads otherwise;
// one __ballot_sync a 32-bit chunk, and lanes 0-7 of each warp store its 8
// words. The one-bucket pack is the same launch with one entry.
//   Unpack is grouped over the buckets of a step: the tile walk of
// unpack_tile.cuh (shared with the QSGD, TernGrad and signSGD unpacks) at
// width 1 with the emit bit -> int32 {0, 1}. A table of up to 32 buckets
// travels by value as a __grid_constant__ kernel parameter, so one launch
// decodes every bucket of a step, the allgather receive leg's gathered
// rows of every bucket included; a block finds its unit and tile with one
// 32-bit divide. A tile is 64 words of one unit (2,048 bits) staged in
// shared memory with coalesced loads plus a zero word; from the first
// 16-byte boundary of the tile's output on, four bits (a funnel shift of
// the two words that hold them) leave as one 16-byte store, so a row of
// any d and alignment is stored in vectors but for at most 3 bits at each
// end of a tile. The one-bucket unpack is the same launch with one entry.
#include <cuda_runtime.h>

#include <cstdint>

#include "ballot_pack.cuh"
#include "unpack_tile.cuh"

namespace {

// The predicate of the bit pack: a nonzero int32 is a set bit.
struct NonZero {
  __device__ __forceinline__ bool operator()(int32_t bit) const {
    return bit != 0;
  }
};

__global__ void __launch_bounds__(repro::kBallotThreads)
    bits_pack_kernel(const __grid_constant__ repro::BallotTable t) {
  repro::ballot_pack_tile<int32_t>(t, NonZero{});
}

// The emit of the bit unpack: the bit itself, as an int32.
struct Bit01 {
  static constexpr bool kFactor = false;
  __device__ __forceinline__ int32_t operator()(uint32_t bit, float) const {
    return static_cast<int32_t>(bit);
  }
};

__global__ void __launch_bounds__(repro::kUnpackThreads)
    bits_unpack_kernel(const __grid_constant__ repro::UnpackTable t) {
  repro::unpack_tile<1>(t, 1, Bit01{});
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream` of CUDA
// device `device` and returns cudaGetLastError(); `blocks` == 0 launches
// nothing.
// bits_pack_buckets: `count` (1..kBallotMaxBuckets) buckets. `ptrs` holds
// their bits pointers, then their out pointers; `sizes` their n, d, wpu,
// tiles per unit and first block, `count` of each in that order, as
// kernels/qsgd.py grouped_table computes them at width 1 over
// kernels/qsgd.py ballot_tiles; `blocks` in all.
extern "C" int bits_pack_buckets(int count, void* const* ptrs,
                                 const int* sizes, int blocks, int device,
                                 void* stream) {
  if (count < 1 || count > repro::kBallotMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const repro::BallotTable t = repro::ballot_table(count, ptrs, sizes);
  bits_pack_kernel<<<static_cast<unsigned>(blocks), repro::kBallotThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// bits_unpack_buckets: `count` (1..kUnpackMaxBuckets) buckets. `ptrs` holds their
// words and out pointers, `count` of each in that order; `sizes` their n,
// d, wpu, tiles per unit and first block, `count` of each, as
// kernels/qsgd.py grouped_table computes them at width 1 over
// unpack_tiles; `blocks` in all (0 launches nothing).
extern "C" int bits_unpack_buckets(int count, void* const* ptrs,
                                   const int* sizes, int blocks, int device,
                                   void* stream) {
  if (count < 1 || count > repro::kUnpackMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const repro::UnpackTable t = repro::unpack_table(count, ptrs, sizes, false);
  bits_unpack_kernel<<<static_cast<unsigned>(blocks), repro::kUnpackThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
