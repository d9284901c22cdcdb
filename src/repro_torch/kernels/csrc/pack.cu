// Width-parametric field pack / unpack for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's kernels/pack.py:
//   fields_pack   <- fields_pack_pallas   (pack.py:94, body _fields_pack_kernel :86)
//   fields_unpack <- fields_unpack_pallas (pack.py:111, body _fields_unpack_kernel :90)
// (n, k) uint32 fields of `width` bits (1..31) pack into
// wpu = ceil(k * width / 32) uint32 words per unit, little-endian: field i's
// low bit lands at bit i * width of its unit's words, and each unit's leg is
// padded to a whole word with zero bits. This is the natural codec's 9-bit
// code leg and the sparse codecs' ceil(log2 d)-bit index leg.
//
// What bounds it on the card: bytes. Pack reads 4 B and writes width/8 B per
// field (5.125 B at width 9), unpack the reverse; each field costs a few
// shifts and ors. Natural compression over one layerwise resnet9 step
// (4 x 121,002 fields at width 9) moves about 2.5 MB, about 0.00074 ms at
// 3.35 TB/s; the sparse index legs (about 1,210 records per worker at ratio
// 0.01) are a few kilobytes, so those launches are latency-bound.
//
// Design (simple and right first): pack runs one warp per 32-field chunk of
// a unit. A chunk spans exactly `width` whole words, so lanes load the 32
// fields (coalesced) into shared memory and lanes 0..width-1 each assemble
// one output word (fields.cuh assemble_word); no chunk touches another's
// words. Unpack runs one thread per field and reads the one or two words
// its bits span (fields.cuh extract_field).
#include <cuda_runtime.h>

#include <cstdint>

#include "fields.cuh"

namespace {

constexpr int kWarps = 8;  // warps (chunks) per pack block

__global__ void fields_pack_kernel(const uint32_t* __restrict__ f,
                                   uint32_t* __restrict__ out, int n, int k,
                                   int width, int wpu, int chunks) {
  __shared__ uint32_t codes[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= static_cast<long long>(n) * chunks) return;  // whole warp leaves
  const int unit = static_cast<int>(g / chunks);
  const int c = static_cast<int>(g % chunks);
  const int p = c * 32 + lane;
  codes[warp][lane] = p < k ? f[static_cast<long long>(unit) * k + p] : 0u;
  __syncwarp();
  if (lane < width) {
    const int word = c * width + lane;
    if (word < wpu) {
      out[static_cast<long long>(unit) * wpu + word] =
          repro::assemble_word(codes[warp], width, lane);
    }
  }
}

__global__ void fields_unpack_kernel(const uint32_t* __restrict__ words,
                                     uint32_t* __restrict__ out, int n, int k,
                                     int width, int wpu) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(n) * k) return;
  const int unit = static_cast<int>(i / k);
  const long long p = i % k;
  out[i] = repro::extract_field(words + static_cast<long long>(unit) * wpu, p,
                                width);
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream` of CUDA
// device `device` and returns cudaGetLastError(); empty inputs launch
// nothing.
extern "C" int fields_pack(const void* f, void* out, int n, int k, int width,
                           int wpu, int device, void* stream) {
  const int chunks = (k + 31) / 32;
  const long long warps = static_cast<long long>(n) * chunks;
  if (warps == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  fields_pack_kernel<<<blocks, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(f), static_cast<uint32_t*>(out), n, k,
      width, wpu, chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fields_unpack(const void* words, void* out, int n, int k,
                             int width, int wpu, int device, void* stream) {
  const long long total = static_cast<long long>(n) * k;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  fields_unpack_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), n, k,
      width, wpu);
  return static_cast<int>(cudaGetLastError());
}
