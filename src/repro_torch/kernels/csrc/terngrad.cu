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
// launch with one entry. Unpack runs one thread per element. Numerics: the
// IEEE divide __fdiv_rn(|x|, scale), compiled with -fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

#include "fields.cuh"
#include "hash_pack.cuh"

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

__global__ void terngrad_unpack_kernel(const uint32_t* __restrict__ words,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out, int n, int d,
                                       int wpu) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(n) * d) return;
  const int unit = static_cast<int>(i / d);
  const long long p = i % d;
  const uint32_t f = repro::extract_field(
      words + static_cast<long long>(unit) * wpu, p, kWidth);
  out[i] = __fmul_rn(static_cast<float>(static_cast<int>(f) - 1), scale[unit]);
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

extern "C" int terngrad_unpack(const void* words, const void* scale,
                               void* out, int n, int d, int wpu, int device,
                               void* stream) {
  const long long total = static_cast<long long>(n) * d;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  terngrad_unpack_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scale),
      static_cast<float*>(out), n, d, wpu);
  return static_cast<int>(cudaGetLastError());
}
