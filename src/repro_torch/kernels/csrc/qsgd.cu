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
// Unpack is grouped the same way (its own table: words, factor and out
// pointers, n, d, words and tiles per unit, first blocks; levels and width
// one per launch), and a block finds its unit and tile with one 32-bit
// divide. A tile is kUnpackChunks = 64 consecutive 32-code chunks of one
// unit (2,048 codes); a chunk spans exactly `width` words, so the tile's
// 64 x width words are contiguous in their row and no element has two
// writers. A block of 256 threads stages the tile's words in shared memory
// with coalesced 4-byte loads, reads its unit's factor once, then each
// thread extracts codes from shared memory (fields.cuh extract_field,
// 32-bit) and stores (code - levels) * fac coalesced, four consecutive
// elements as one 16-byte store where the output row is 16-byte aligned
// (d % 4 == 0 and an aligned base). A layerwise resnet9 step is 68 tiles a
// worker, the stress shape (4 x 1,048,579) 2,052.
//
// Numerics: y = |x| / nrm * levels needs an IEEE divide and no FMA
// contraction, so the arithmetic uses the _rn intrinsics and the file is
// compiled with -fmad=false (never --use_fast_math). The division
// nrm / levels of the decode stays with the caller.
#include <cuda_runtime.h>

#include <cstdint>

#include "fields.cuh"
#include "grouped.cuh"
#include "hash_pack.cuh"

namespace {

constexpr int kMaxBuckets = repro::kPackMaxBuckets;  // kernels/qsgd.py MAX_BUCKETS
constexpr int kThreads = 256;                 // unpack block
constexpr int kUnpackChunks = 64;             // 32-code chunks a tile
constexpr int kUnpackTile = 32 * kUnpackChunks;  // kernels/qsgd.py TILE_CODES
constexpr int kMaxUnpackWidth = 31;  // kernels/qsgd.py MAX_UNPACK_WIDTH

struct UnpackBucket {
  const uint32_t* words;  // (n, wpu) words
  const float* fac;       // (n,) nrm / levels
  float* out;             // (n, d) values
  int n, d, wpu, tiles;   // tiles per unit
};

struct UnpackTable {
  int block_start[kMaxBuckets];  // each bucket's first block in the launch
  UnpackBucket b[kMaxBuckets];
  int count;
};

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

// (code - levels) * fac of staged code p
__device__ __forceinline__ float dequant(const uint32_t* words, int p,
                                         int width, int levels, float fac) {
  const uint32_t f = repro::extract_field(words, p, width);
  return __fmul_rn(static_cast<float>(static_cast<int>(f) - levels), fac);
}

__global__ void __launch_bounds__(kThreads)
    qsgd_unpack_kernel(const __grid_constant__ UnpackTable t, int levels,
                       int width) {
  __shared__ uint32_t words[kUnpackChunks * kMaxUnpackWidth];
  const int k = repro::bucket_of(t.block_start, t.count);
  const UnpackBucket& b = t.b[k];
  const int local = static_cast<int>(blockIdx.x) - t.block_start[k];
  const int unit = local / b.tiles;
  const int tile = local - unit * b.tiles;
  const int w0 = tile * kUnpackChunks * width;   // the tile's first word
  const int nw = min(kUnpackChunks * width, b.wpu - w0);
  const uint32_t* src = b.words + static_cast<long long>(unit) * b.wpu + w0;

  // 1. stage the tile's words, coalesced; a code < d reads no word past the
  //    tile's last (64 chunks span exactly 64 * width words)
  for (int i = threadIdx.x; i < nw; i += kThreads) words[i] = __ldg(src + i);
  const float fac = __ldg(b.fac + unit);
  __syncthreads();

  // 2. extract, dequantize and store the tile's elements, coalesced
  const int f0 = tile * kUnpackTile;
  const int nf = min(kUnpackTile, b.d - f0);
  float* dst = b.out + static_cast<long long>(unit) * b.d + f0;
  if (b.d % 4 == 0 && repro::aligned16(b.out)) {  // nf % 4 == 0 here
    for (int v = threadIdx.x; 4 * v < nf; v += kThreads) {
      const int p = 4 * v;
      reinterpret_cast<float4*>(dst)[v] = make_float4(
          dequant(words, p, width, levels, fac),
          dequant(words, p + 1, width, levels, fac),
          dequant(words, p + 2, width, levels, fac),
          dequant(words, p + 3, width, levels, fac));
    }
  } else {
    for (int p = threadIdx.x; p < nf; p += kThreads)
      dst[p] = dequant(words, p, width, levels, fac);
  }
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
  UnpackTable t;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    t.b[i] = UnpackBucket{static_cast<const uint32_t*>(ptrs[i]),
                          static_cast<const float*>(ptrs[count + i]),
                          static_cast<float*>(ptrs[2 * count + i]),
                          sizes[i], sizes[count + i], sizes[2 * count + i],
                          sizes[3 * count + i]};
    t.block_start[i] = sizes[4 * count + i];
  }
  qsgd_unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(t, levels,
                                                            width);
  return static_cast<int>(cudaGetLastError());
}
