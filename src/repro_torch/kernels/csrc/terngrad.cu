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
// element and hashes one threefry2x32 pair per element (~77 integer
// operations), so like QSGD it is launch-bound at the resnet9 main-path
// sizes and integer-throughput-bound at 4 x 2^20 elements. Unpack is
// bandwidth-bound (0.25 B read + 4 B written per element).
//
// Design: the same warp-per-32-field-chunk pack and thread-per-element
// unpack as qsgd.cu; IEEE divide via __fdiv_rn, compiled with -fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

#include "fields.cuh"
#include "threefry.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kWidth = 2;

__global__ void terngrad_pack_kernel(const float* __restrict__ x,
                                     const uint32_t* __restrict__ k0,
                                     const uint32_t* __restrict__ k1,
                                     const float* __restrict__ scale,
                                     uint32_t* __restrict__ out, int n, int d,
                                     int wpu, int chunks) {
  __shared__ uint32_t codes[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= static_cast<long long>(n) * chunks) return;  // whole warp leaves
  const int unit = static_cast<int>(g / chunks);
  const int c = static_cast<int>(g % chunks);
  const int p = c * 32 + lane;
  uint32_t code = 0u;
  if (p < d) {
    const float xv = x[static_cast<long long>(unit) * d + p];
    const float u = repro::uniform_at(k0[unit], k1[unit], p, d);
    const bool keep = u < __fdiv_rn(fabsf(xv), scale[unit]);
    code = 1u;
    if (keep && xv > 0.0f) code = 2u;
    if (keep && xv < 0.0f) code = 0u;
  }
  codes[warp][lane] = code;
  __syncwarp();
  if (lane < kWidth) {
    const int word = c * kWidth + lane;
    if (word < wpu) {
      out[static_cast<long long>(unit) * wpu + word] =
          repro::assemble_word(codes[warp], kWidth, lane);
    }
  }
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
extern "C" int terngrad_pack(const void* x, const void* k0, const void* k1,
                             const void* scale, void* out, int n, int d,
                             int wpu, int device, void* stream) {
  const int chunks = (d + 31) / 32;
  const long long warps = static_cast<long long>(n) * chunks;
  if (warps == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  terngrad_pack_kernel<<<blocks, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(k0),
      static_cast<const uint32_t*>(k1), static_cast<const float*>(scale),
      static_cast<uint32_t*>(out), n, d, wpu, chunks);
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
