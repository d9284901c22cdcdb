// Fused signSGD sign+pack and unpack+decode for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's kernels/sign.py:
//   sign_pack   <- sign_pack_pallas_rows   (sign.py:49, body _sign_pack_kernel :32)
//   sign_unpack <- sign_unpack_pallas_rows (sign.py:67, body _sign_unpack_kernel :40)
//   majority    <- majority_pallas         (sign.py:83, body _majority_kernel :45)
// Bit p of unit i is x[i, p] >= 0 (so -0.0 packs 1 and NaN packs 0); each
// unit packs into ceil(d / 32) uint32 words and bits past d are 0. Decode
// writes +1.0 for a set bit and -1.0 for a clear one. No statistic, no
// randomness: the (R, 512) tiling and row padding of the TPU version are
// gone, the contract is the bytes each unit produces.
//
// What bounds it on the card: bytes. Pack reads 4 B and writes 1/8 B per
// element, unpack the reverse, with one compare or one shift per element.
// One layerwise resnet9 step (4 x 121,002 elements) moves about 2.0 MB each
// way, about 0.0006 ms at 3.35 TB/s, so at the main-path sizes every
// launch is latency-bound; at 4 x 2^20 elements the byte bound is ~0.005 ms.
//
// Design (simple and right first): pack runs one warp per output word; each
// lane loads one element (coalesced) and __ballot_sync assembles the word,
// which lane 0 writes. Unpack runs one thread per element and reads the one
// word holding its bit.
//
// majority: (n, W) packed sign words of n workers -> (W,) words whose bit is
// set where at least half the workers' bits are (2 * count >= n, ties to
// +1), never unpacking a bit: the JAX package's ref.majority_words_ref word
// for word. One thread per word column keeps the per-bit counts in
// kPlanes word-wide bit planes in registers, adds each worker's word with
// a ripple carry, then runs the borrow chain of count - ceil(n / 2). Planes
// above bit_length(n) stay zero and leave the borrow unchanged, so a fixed
// kPlanes = 8 serves every n in 1..255. Zero padding columns vote 0. It
// reads n words and writes one per column, n - 1 + 2 * kPlanes word ops
// per worker and column: bytes bound it at the main-path sizes (4 workers x
// 3,783 words per layerwise step, about 0.00002 ms at 3.35 TB/s), so every
// launch there is latency-bound.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps (output words) per pack block
constexpr int kPlanes = 8;  // count bit planes: n <= 255 workers

__global__ void sign_pack_kernel(const float* __restrict__ x,
                                 uint32_t* __restrict__ out, int n, int d,
                                 int wpu) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= static_cast<long long>(n) * wpu) return;  // whole warp leaves
  const int unit = static_cast<int>(g / wpu);
  const int word = static_cast<int>(g % wpu);
  const int p = word * 32 + lane;
  const bool bit = p < d && x[static_cast<long long>(unit) * d + p] >= 0.0f;
  const uint32_t w = __ballot_sync(0xFFFFFFFFu, bit);
  if (lane == 0) out[g] = w;
}

__global__ void sign_unpack_kernel(const uint32_t* __restrict__ words,
                                   float* __restrict__ out, int n, int d,
                                   int wpu) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(n) * d) return;
  const int unit = static_cast<int>(i / d);
  const int p = static_cast<int>(i % d);
  const uint32_t w = words[static_cast<long long>(unit) * wpu + (p >> 5)];
  out[i] = ((w >> (p & 31)) & 1u) ? 1.0f : -1.0f;
}

__global__ void majority_kernel(const uint32_t* __restrict__ words,
                                uint32_t* __restrict__ out, int n, int W) {
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (col >= W) return;
  uint32_t planes[kPlanes];
#pragma unroll
  for (int pi = 0; pi < kPlanes; ++pi) planes[pi] = 0u;
  for (int i = 0; i < n; ++i) {
    uint32_t c = words[static_cast<long long>(i) * W + col];
#pragma unroll
    for (int pi = 0; pi < kPlanes; ++pi) {  // ripple-carry add one bit
      const uint32_t a = planes[pi];
      planes[pi] = a ^ c;
      c = a & c;
    }
  }
  const int thr = (n + 1) / 2;
  uint32_t borrow = 0u;
#pragma unroll
  for (int pi = 0; pi < kPlanes; ++pi) {  // borrow of count - thr
    borrow = ((thr >> pi) & 1) ? (~planes[pi] | borrow)
                               : (~planes[pi] & borrow);
  }
  out[col] = ~borrow;  // count >= thr
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream` of CUDA
// device `device` and returns cudaGetLastError(); empty inputs launch
// nothing.
extern "C" int sign_pack(const void* x, void* out, int n, int d, int wpu,
                         int device, void* stream) {
  const long long warps = static_cast<long long>(n) * wpu;
  if (warps == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  sign_pack_kernel<<<blocks, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(out), n, d, wpu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sign_unpack(const void* words, void* out, int n, int d,
                           int wpu, int device, void* stream) {
  const long long total = static_cast<long long>(n) * d;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  sign_unpack_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<float*>(out), n, d,
      wpu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int majority(const void* words, void* out, int n, int W, int device,
                        void* stream) {
  if (W == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((W + threads - 1) / threads);
  majority_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), n, W);
  return static_cast<int>(cudaGetLastError());
}
