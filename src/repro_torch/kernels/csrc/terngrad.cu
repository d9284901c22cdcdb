// Fused TernGrad ternarize+pack and unpack+dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's kernels/terngrad.py:
//   terngrad_pack   <- terngrad_pack_pallas_rows   (terngrad.py:92, body _tern_pack_kernel :76)
//   terngrad_unpack <- terngrad_unpack_pallas_rows (terngrad.py:118)
// The 2-bit mirror of qsgd.cu: code = sign(x) * [u < |x| / scale] + 1 in
// {0, 1, 2}, with scale = max|x| + 1e-12 of the unit computed by the caller
// and u drawn in-kernel (bit-exact jax.random.bernoulli). Decode is
// (code - 1) * scale. Each unit packs into ceil(d / 16) uint32 words.
//
// What bounds it on the card. Pack moves 4 B read + 0.25 B written per
// element and hashes one threefry2x32 pair per two elements (~79 integer
// operations), so like QSGD it is launch-bound at the resnet9 main-path
// sizes and integer-throughput-bound at 4 x 2^20 elements. Unpack is
// bandwidth-bound (0.25 B read + 4 B written per element).
//
// Design. Pack: the hash-once tile walk of hash_pack.cuh (qsgd.cu's pack)
// over the ternary code at width 2: each counter pair hashed once with
// repro::uniform_pair_at, tiles of 480 pairs plus a halo chunk, one thread
// a word in whole 32-position chunks, every bucket of a step in one
// grouped launch (a __grid_constant__ table, no host-to-device copy); a
// block finds its unit and tile with one 32-bit divide, and the width is a
// constant, so a word's chunk is a shift. The one-bucket pack is the same
// launch with one entry.
//   Unpack: the tile walk of unpack_tile.cuh (qsgd.cu's unpack) with the
// emit (code - 1) * scale, QSGD's (code - levels) * fac at levels 1: every
// bucket of a step in one grouped launch, a tile's 128 words (2,048 codes)
// staged in shared memory with coalesced loads, one 32-bit divide a block
// for unit and tile, the width a constant (a code's word is a shift), and
// four values a funnel shift as one 16-byte store at any row alignment.
// The one-bucket unpack is the same launch with one entry.
//   Numerics: the IEEE divide __fdiv_rn(|x|, scale) and the multiply
// __fmul_rn, compiled with -fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash_pack.cuh"
#include "unpack_tile.cuh"

namespace {

constexpr int kWidth = 2;

// The code function of hash_pack_tile: sign(x) * [u < |x| / scale] + 1,
// so 2 for a kept x > 0, 0 for a kept x < 0 and 1 otherwise (-0.0 and NaN
// are never kept).
struct TernCode {
  __device__ __forceinline__ uint32_t operator()(float xv, float u,
                                                 float scale) const {
    const bool keep = u < __fdiv_rn(fabsf(xv), scale);
    return keep && xv > 0.0f ? 2u : keep && xv < 0.0f ? 0u : 1u;
  }
};

__global__ void __launch_bounds__(repro::kPackWarps * 32)
    terngrad_pack_kernel(const __grid_constant__ repro::PackTable t) {
  repro::hash_pack_tile(t, TernCode{}, kWidth);
}

__global__ void __launch_bounds__(repro::kUnpackThreads)
    terngrad_unpack_kernel(const __grid_constant__ repro::UnpackTable t) {
  repro::unpack_tile<kWidth>(t, kWidth, repro::Dequant{1});
}

}  // namespace

// C entry points (loaded with ctypes), as in qsgd.cu.
//
// terngrad_pack_buckets: `count` (1..kPackMaxBuckets) buckets. `ptrs` holds
// their x, k0, k1, scale and out pointers, `count` of each in that order;
// `sizes` their n, d, wpu, tiles per unit and first block, `count` of
// each, as kernels/qsgd.py bucket_table computes them at width 2; `blocks`
// in all (0 launches nothing).
extern "C" int terngrad_pack_buckets(int count, void* const* ptrs,
                                     const int* sizes, int blocks,
                                     int device, void* stream) {
  if (count < 1 || count > repro::kPackMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const repro::PackTable t = repro::pack_table(count, ptrs, sizes);
  terngrad_pack_kernel<<<static_cast<unsigned>(blocks),
                         repro::kPackWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// terngrad_unpack_buckets: `count` (1..kUnpackMaxBuckets) buckets. `ptrs`
// holds their words, scale and out pointers, `count` of each in that order;
// `sizes` their n, d, wpu, tiles per unit and first block, `count` of
// each, as kernels/qsgd.py unpack_table computes them at width 2; `blocks`
// in all (0 launches nothing).
extern "C" int terngrad_unpack_buckets(int count, void* const* ptrs,
                                       const int* sizes, int blocks,
                                       int device, void* stream) {
  if (count < 1 || count > repro::kUnpackMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const repro::UnpackTable t = repro::unpack_table(count, ptrs, sizes, true);
  terngrad_unpack_kernel<<<static_cast<unsigned>(blocks),
                           repro::kUnpackThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
