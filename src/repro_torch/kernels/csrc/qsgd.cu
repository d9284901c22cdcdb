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
// per pair of elements (~79 integer operations: 20 rounds of add/rotate/xor
// plus the key injections). At the resnet9 main-path sizes (<= 4 x 121,002
// elements) launch latency dominates, so one launch serves every bucket of
// a step; at 4 x 2^20 elements the integer throughput of the hash, not
// memory bandwidth, is the bound. Unpack is bandwidth-bound
// (width/8 B read + 4 B written per element).
//
// Design. Pack: the hash-once tile walk of hash_pack.cuh over qsgd_code
// (the TernGrad pack of terngrad.cu is the same walk over its own code):
// each counter pair hashed once, tiles of 480 pairs plus a halo chunk, one
// thread a word in whole 32-position chunks, every bucket of a step in one
// grouped launch (a __grid_constant__ table, no host-to-device copy, CUDA
// graph capturable). At the resnet9 sizes the launch is latency-bound: two
// pairs a thread keep a step's blocks (508 entire-model, 540 layerwise)
// within one wave of the card. The one-bucket pack is the same launch with
// one entry.
//
// Unpack: the tile walk of unpack_tile.cuh (shared with the TernGrad,
// bit and signSGD unpacks) with the emit (code - levels) * fac, grouped the
// same way (its own table: words, fac and out pointers, n, d, words and
// tiles per unit, first blocks; levels and width one per launch). A tile
// is 64 chunks of 32 codes, its 64 x width words staged in shared memory
// with coalesced loads; the values leave as 16-byte stores at any row
// alignment, four codes a funnel shift at width <= 8.
//
// Numerics: y = |x| / nrm * levels needs an IEEE divide and no FMA
// contraction, so the arithmetic uses the _rn intrinsics and the file is
// compiled with -fmad=false (never --use_fast_math). The division
// nrm / levels of the decode stays with the caller.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash_pack.cuh"
#include "unpack_tile.cuh"

namespace {

constexpr int kMaxBuckets = repro::kPackMaxBuckets;  // kernels/qsgd.py MAX_BUCKETS
constexpr int kMaxUnpackWidth = 31;  // kernels/qsgd.py MAX_UNPACK_WIDTH

// sign(x) * stochastic_round(|x| / nrm * levels) + levels, u the uniform.
__device__ __forceinline__ uint32_t qsgd_code(float xv, float u, float nrm,
                                              int levels) {
  const float y = __fmul_rn(__fdiv_rn(fabsf(xv), nrm),
                            static_cast<float>(levels));
  const float lo = floorf(y);
  const float lev = (u < __fsub_rn(y, lo)) ? __fadd_rn(lo, 1.0f) : lo;
  const int q = static_cast<int>(lev);
  return static_cast<uint32_t>(xv > 0.0f ? levels + q
                               : xv < 0.0f ? levels - q : levels);
}

// The code function of hash_pack_tile.
struct QsgdCode {
  int levels;
  __device__ __forceinline__ uint32_t operator()(float xv, float u,
                                                 float nrm) const {
    return qsgd_code(xv, u, nrm, levels);
  }
};

__global__ void __launch_bounds__(repro::kPackWarps * 32)
    qsgd_pack_kernel(const __grid_constant__ repro::PackTable t, int levels,
                     int width) {
  repro::hash_pack_tile(t, QsgdCode{levels}, width);
}

__global__ void __launch_bounds__(repro::kUnpackThreads)
    qsgd_unpack_kernel(const __grid_constant__ repro::UnpackTable t,
                       int levels, int width) {
  repro::unpack_tile<kMaxUnpackWidth>(t, width, repro::Dequant{levels});
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream` of CUDA
// device `device` and returns cudaGetLastError(); `blocks` == 0 launches
// nothing.
//
// qsgd_pack_buckets: `count` (1..kMaxBuckets) buckets. `ptrs` holds their
// x, k0, k1, nrm and out pointers, `count` of each in that order; `sizes`
// their n, d, wpu, tiles per unit and first block, `count` of each, as
// kernels/qsgd.py bucket_table computes them; `blocks` in all.
extern "C" int qsgd_pack_buckets(int count, void* const* ptrs,
                                 const int* sizes, int blocks, int levels,
                                 int width, int device, void* stream) {
  if (count < 1 || count > kMaxBuckets || width < 1 || width > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const repro::PackTable t = repro::pack_table(count, ptrs, sizes);
  qsgd_pack_kernel<<<static_cast<unsigned>(blocks), repro::kPackWarps * 32,
                     0, static_cast<cudaStream_t>(stream)>>>(t, levels,
                                                              width);
  return static_cast<int>(cudaGetLastError());
}

// qsgd_unpack_buckets: `count` (1..kMaxBuckets) buckets. `ptrs` holds their
// words, fac and out pointers, `count` of each in that order; `sizes` their
// n, d, wpu, tiles per unit and first block, `count` of each, as
// kernels/qsgd.py unpack_table computes them; `blocks` in all.
extern "C" int qsgd_unpack_buckets(int count, void* const* ptrs,
                                   const int* sizes, int blocks, int levels,
                                   int width, int device, void* stream) {
  if (count < 1 || count > kMaxBuckets || width < 1 ||
      width > kMaxUnpackWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const repro::UnpackTable t = repro::unpack_table(count, ptrs, sizes, true);
  qsgd_unpack_kernel<<<static_cast<unsigned>(blocks), repro::kUnpackThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(t, levels,
                                                               width);
  return static_cast<int>(cudaGetLastError());
}
