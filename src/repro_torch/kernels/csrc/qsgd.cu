// Fused QSGD quantize+pack and unpack+dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's kernels/qsgd.py:
//   qsgd_pack   <- qsgd_pack_pallas_rows   (qsgd.py:122, body _qsgd_pack_kernel :107)
//   qsgd_unpack <- qsgd_unpack_pallas_rows (qsgd.py:151)
// The (R, 512) tiling and PACK_R row padding of the TPU version are gone:
// the contract is the bytes each unit produces. A unit of dimension d packs
// into wpu = ceil(d * width / 32) uint32 words; positions >= d pack as 0.
//
// What bounds it on the card. Pack moves 4 B read + width/8 B written per
// element (4.75 B at width 6, QSGD(16)) and evaluates one threefry2x32 hash
// per element (~77 integer operations: 20 rounds of add/rotate/xor plus the
// key injections). At the resnet9 main-path sizes (<= 4 x 121,002 elements)
// launch latency dominates; at 4 x 2^20 elements the integer throughput of
// the hash, not memory bandwidth, is the bound. Unpack is bandwidth-bound
// (width/8 B read + 4 B written per element).
//
// Design (simple and right first): pack runs one warp per 32-field chunk of
// a unit; each lane computes one code, the codes are staged in shared
// memory, and lanes 0..width-1 each assemble one output word, so both the
// f32 reads and the word writes are coalesced. Unpack runs one thread per
// element and reads the one or two words its field spans. Each element
// hashes its own counter pair, so every pair is hashed twice (once for p,
// once for p + h); computing both outputs once would halve the hashing.
//
// Numerics: y = |x| / nrm * levels needs an IEEE divide and no FMA
// contraction, so the arithmetic uses the _rn intrinsics and the file is
// compiled with -fmad=false (never --use_fast_math). The division
// nrm / levels of the decode stays with the caller.
#include <cuda_runtime.h>

#include <cstdint>

#include "fields.cuh"
#include "threefry.cuh"

namespace {

constexpr int kWarps = 8;  // warps (chunks) per pack block

__global__ void qsgd_pack_kernel(const float* __restrict__ x,
                                 const uint32_t* __restrict__ k0,
                                 const uint32_t* __restrict__ k1,
                                 const float* __restrict__ nrm,
                                 uint32_t* __restrict__ out, int n, int d,
                                 int levels, int width, int wpu, int chunks) {
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
    const float y = __fmul_rn(__fdiv_rn(fabsf(xv), nrm[unit]),
                              static_cast<float>(levels));
    const float lo = floorf(y);
    const float lev = (u < __fsub_rn(y, lo)) ? __fadd_rn(lo, 1.0f) : lo;
    const int q = static_cast<int>(lev);
    code = static_cast<uint32_t>(xv > 0.0f ? levels + q
                                 : xv < 0.0f ? levels - q : levels);
  }
  codes[warp][lane] = code;
  __syncwarp();
  if (lane < width) {
    const int word = c * width + lane;
    if (word < wpu) {
      out[static_cast<long long>(unit) * wpu + word] =
          repro::assemble_word(codes[warp], width, lane);
    }
  }
}

__global__ void qsgd_unpack_kernel(const uint32_t* __restrict__ words,
                                   const float* __restrict__ fac,
                                   float* __restrict__ out, int n, int d,
                                   int levels, int width, int wpu) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(n) * d) return;
  const int unit = static_cast<int>(i / d);
  const long long p = i % d;
  const uint32_t f = repro::extract_field(
      words + static_cast<long long>(unit) * wpu, p, width);
  out[i] = __fmul_rn(static_cast<float>(static_cast<int>(f) - levels),
                     fac[unit]);
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream` of CUDA
// device `device` and returns cudaGetLastError(); empty inputs launch
// nothing.
extern "C" int qsgd_pack(const void* x, const void* k0, const void* k1,
                         const void* nrm, void* out, int n, int d, int levels,
                         int width, int wpu, int device, void* stream) {
  const int chunks = (d + 31) / 32;
  const long long warps = static_cast<long long>(n) * chunks;
  if (warps == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  qsgd_pack_kernel<<<blocks, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(k0),
      static_cast<const uint32_t*>(k1), static_cast<const float*>(nrm),
      static_cast<uint32_t*>(out), n, d, levels, width, wpu, chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsgd_unpack(const void* words, const void* fac, void* out,
                           int n, int d, int levels, int width, int wpu,
                           int device, void* stream) {
  const long long total = static_cast<long long>(n) * d;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  qsgd_unpack_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(fac),
      static_cast<float*>(out), n, d, levels, width, wpu);
  return static_cast<int>(cudaGetLastError());
}
