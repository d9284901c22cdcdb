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
// Design. sign_pack is grouped over the buckets of a step: a table of up to
// kMaxBuckets buckets (pointers, n, d, words and tiles per unit, and each
// bucket's first block, a prefix sum built by the caller) travels by value
// as a __grid_constant__ kernel parameter, so one launch packs every bucket
// without a host-to-device copy (and a CUDA graph can capture it). A block
// finds its bucket by a scan over the block starts, then its unit and tile
// with one 32-bit divide; no 64-bit divide remains. The one-bucket pack is
// the same launch with one entry.
//   A tile is kPackChunks = 64 consecutive 32-element chunks of one unit
// (2,048 elements); a chunk is exactly one output word, so no word has two
// writers. A block of 256 threads stages the tile's floats in shared memory
// with coalesced loads: two 16-byte loads a thread where the row is 16-byte
// aligned (d % 4 == 0 and an aligned base), eight 4-byte loads otherwise,
// all issued before the barrier; elements at or past d are not read. Each
// warp then takes one __ballot_sync per 32 staged elements (lane i reads
// element i of the chunk: no bank conflicts) over 8 consecutive chunks,
// keeps word r in lane r, and lanes 0-7 store the warp's 8 words: the
// block's 64 words go out as one coalesced 256-byte run. A layerwise resnet9
// step is 68 tiles a worker, the stress shape (4 x 1,048,579) 2,052.
//   Unpack is the bit unpack's walk (unpack_tile.cuh, shared with
// bits.cu and the QSGD and TernGrad unpacks) with the emit bit -> +1.0f /
// -1.0f: every bucket of a step in one grouped launch, a tile's 64 words
// (2,048 bits) staged in shared memory plus a zero word, and from the
// tile's first 16-byte output boundary on four values a funnel shift as
// one 16-byte store, at most 3 scalar stores at each tile end, so any d
// and any row alignment is served. The one-bucket unpack is the same
// launch with one entry.
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

#include "grouped.cuh"
#include "unpack_tile.cuh"

namespace {

constexpr int kThreads = 256;                 // pack block
constexpr int kPackChunks = 64;               // 32-element chunks a tile
constexpr int kPackTile = 32 * kPackChunks;   // kernels/sign.py TILE_ELEMS
constexpr int kChunksPerWarp = kPackChunks / (kThreads / 32);
constexpr int kMaxBuckets = 32;               // kernels/qsgd.py MAX_BUCKETS
constexpr int kPlanes = 8;  // count bit planes: n <= 255 workers

struct SignBucket {
  const float* x;      // (n, d) units
  uint32_t* out;       // (n, wpu) words
  int n, d, wpu, tiles;  // tiles per unit
};

struct SignTable {
  int block_start[kMaxBuckets];  // each bucket's first block in the launch
  SignBucket b[kMaxBuckets];
  int count;
};

__global__ void __launch_bounds__(kThreads)
    sign_pack_kernel(const __grid_constant__ SignTable t) {
  __shared__ __align__(16) float xs[kPackTile];
  const int k = repro::bucket_of(t.block_start, t.count);
  const SignBucket& b = t.b[k];
  const int local = static_cast<int>(blockIdx.x) - t.block_start[k];
  const int unit = local / b.tiles;
  const int tile = local - unit * b.tiles;
  const int e0 = tile * kPackTile;               // the tile's first element
  const int ne = min(kPackTile, b.d - e0);
  const float* src = b.x + static_cast<long long>(unit) * b.d + e0;

  // 1. stage the tile's elements, coalesced, every load of a thread issued
  //    before the first store to shared memory
  if (b.d % 4 == 0 && repro::aligned16(b.x)) {  // ne % 4 == 0 here
    float4 v[kPackTile / 4 / kThreads];
#pragma unroll
    for (int r = 0; r < kPackTile / 4 / kThreads; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (4 * i < ne) v[r] = __ldg(reinterpret_cast<const float4*>(src) + i);
    }
#pragma unroll
    for (int r = 0; r < kPackTile / 4 / kThreads; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (4 * i < ne) reinterpret_cast<float4*>(xs)[i] = v[r];
    }
  } else {
    float v[kPackTile / kThreads];
#pragma unroll
    for (int r = 0; r < kPackTile / kThreads; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (i < ne) v[r] = __ldg(src + i);
    }
#pragma unroll
    for (int r = 0; r < kPackTile / kThreads; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (i < ne) xs[i] = v[r];
    }
  }
  __syncthreads();

  // 2. one ballot a chunk: warp w owns chunks [8w, 8w + 8) of the tile,
  //    word r lands in lane r, and lanes 0-7 store the 8 words (words past
  //    wpu, beyond d, are not written)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = warp * kChunksPerWarp;
  uint32_t mine = 0u;
#pragma unroll
  for (int r = 0; r < kChunksPerWarp; ++r) {
    const int i = (c0 + r) * 32 + lane;
    const uint32_t w = __ballot_sync(0xFFFFFFFFu, i < ne && xs[i] >= 0.0f);
    if (lane == r) mine = w;
  }
  const int c = c0 + lane;                       // this lane's chunk
  if (lane < kChunksPerWarp && 32 * c < ne)
    b.out[static_cast<long long>(unit) * b.wpu + tile * kPackChunks + c] =
        mine;
}

// The emit of the signSGD decode: a set bit is +1, a clear one -1
// (the reference's 2 * code - 1 as f32).
struct SignPm {
  static constexpr bool kFactor = false;
  __device__ __forceinline__ float operator()(uint32_t bit, float) const {
    return bit ? 1.0f : -1.0f;
  }
};

__global__ void __launch_bounds__(repro::kUnpackThreads)
    sign_unpack_kernel(const __grid_constant__ repro::UnpackTable t) {
  repro::unpack_tile<1>(t, 1, SignPm{});
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
// device `device` and returns cudaGetLastError(); empty inputs (or
// `blocks` == 0) launch nothing.
// sign_pack_buckets: `count` (1..kMaxBuckets) buckets. `ptrs` holds their
// x pointers, then their out pointers; `sizes` their n, d, wpu, tiles per
// unit and first block, `count` of each in that order, as kernels/sign.py
// sign_table computes them; `blocks` in all.
extern "C" int sign_pack_buckets(int count, void* const* ptrs,
                                 const int* sizes, int blocks, int device,
                                 void* stream) {
  if (count < 1 || count > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  SignTable t;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    t.b[i] = SignBucket{static_cast<const float*>(ptrs[i]),
                        static_cast<uint32_t*>(ptrs[count + i]), sizes[i],
                        sizes[count + i], sizes[2 * count + i],
                        sizes[3 * count + i]};
    t.block_start[i] = sizes[4 * count + i];
  }
  sign_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// sign_unpack_buckets: `count` (1..kMaxBuckets) buckets. `ptrs` holds their
// words and out pointers, `count` of each in that order; `sizes` their n,
// d, wpu, tiles per unit and first block, `count` of each, as
// kernels/qsgd.py grouped_table computes them at width 1 over
// unpack_tiles; `blocks` in all.
extern "C" int sign_unpack_buckets(int count, void* const* ptrs,
                                   const int* sizes, int blocks, int device,
                                   void* stream) {
  if (count < 1 || count > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const repro::UnpackTable t = repro::unpack_table(count, ptrs, sizes, false);
  sign_unpack_kernel<<<static_cast<unsigned>(blocks), repro::kUnpackThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(t);
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
