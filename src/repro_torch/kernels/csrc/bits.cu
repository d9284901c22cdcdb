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
// every launch of the main path is latency-bound.
//
// Design (simple and right first): pack runs one warp per output word;
// each lane loads one int32 (coalesced) and __ballot_sync assembles the
// word, which lane 0 writes (csrc/sign.cu's sign_pack with `bit != 0` for
// `x >= 0`). Unpack runs one thread per bit and reads the one word that
// holds it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps (output words) per pack block

__global__ void bits_pack_kernel(const int32_t* __restrict__ bits,
                                 uint32_t* __restrict__ out, int n, int d,
                                 int wpu) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= static_cast<long long>(n) * wpu) return;  // whole warp leaves
  const int unit = static_cast<int>(g / wpu);
  const int word = static_cast<int>(g % wpu);
  const int p = word * 32 + lane;
  const bool bit = p < d && bits[static_cast<long long>(unit) * d + p] != 0;
  const uint32_t w = __ballot_sync(0xFFFFFFFFu, bit);
  if (lane == 0) out[g] = w;
}

__global__ void bits_unpack_kernel(const uint32_t* __restrict__ words,
                                   int32_t* __restrict__ out, int n, int d,
                                   int wpu) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(n) * d) return;
  const int unit = static_cast<int>(i / d);
  const int p = static_cast<int>(i % d);
  const uint32_t w = words[static_cast<long long>(unit) * wpu + (p >> 5)];
  out[i] = static_cast<int32_t>((w >> (p & 31)) & 1u);
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream` of CUDA
// device `device` and returns cudaGetLastError(); empty inputs launch
// nothing.
extern "C" int bits_pack(const void* bits, void* out, int n, int d, int wpu,
                         int device, void* stream) {
  const long long warps = static_cast<long long>(n) * wpu;
  if (warps == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  bits_pack_kernel<<<blocks, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bits), static_cast<uint32_t*>(out), n, d,
      wpu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bits_unpack(const void* words, void* out, int n, int d,
                           int wpu, int device, void* stream) {
  const long long total = static_cast<long long>(n) * d;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  bits_unpack_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(out), n, d,
      wpu);
  return static_cast<int>(cudaGetLastError());
}
