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
// every launch of the main path is latency-bound; at the stress shape
// (4 x 1,048,579 bits, 17.3 MB) the byte bound is about 0.0052 ms.
//
// Design. Pack runs one warp per output word; each lane loads one int32
// (coalesced) and __ballot_sync assembles the word, which lane 0 writes
// (csrc/sign.cu's sign_pack with `bit != 0` for `x >= 0`).
//   Unpack is grouped over the buckets of a step: a table of up to
// kMaxBuckets buckets (words and out pointers, n, d, words and tiles per
// unit, and each bucket's first block, a prefix sum built by the caller,
// kernels/qsgd.py grouped_table) travels by value as a __grid_constant__
// kernel parameter (grouped.cuh), so one launch decodes every bucket of a
// step, the allgather receive leg's gathered rows of every bucket
// included. A block finds its bucket by a scan over the block starts, then
// its unit and tile with one 32-bit divide; no 64-bit divide remains. A
// tile is kTileWords = 64 words of one unit (2,048 bits), so no word is
// read across tiles. A block of 256 threads stages the tile's words in
// shared memory with coalesced loads, then writes the tile's bits as int32
// {0, 1}, coalesced: from the first 16-byte boundary of the tile's output
// on, four consecutive bits (a funnel shift of the two words that hold
// them) as one 16-byte store, so a row of any d and alignment is stored in
// vectors but for at most 3 bits at each end of a tile. The one-bucket unpack
// is the same launch with one entry. A layerwise resnet9 step on 4 ranks
// is 68 tiles a worker, the stress shape 2,052.
#include <cuda_runtime.h>

#include <cstdint>

#include "grouped.cuh"

namespace {

constexpr int kWarps = 8;  // warps (output words) per pack block
constexpr int kThreads = 256;                 // unpack block
constexpr int kTileWords = 64;                // words an unpack tile owns
constexpr int kTileBits = 32 * kTileWords;    // kernels/pack.py TILE_BITS
constexpr int kMaxBuckets = 32;               // kernels/qsgd.py MAX_BUCKETS

struct BitsBucket {
  const uint32_t* words;  // (n, wpu) words
  int32_t* out;           // (n, d) bits
  int n, d, wpu, tiles;   // tiles per unit
};

struct BitsTable {
  int block_start[kMaxBuckets];  // each bucket's first block in the launch
  BitsBucket b[kMaxBuckets];
  int count;
};

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

// Bit p of the staged words, as an int32 {0, 1}.
__device__ __forceinline__ int32_t bit_at(const uint32_t* words, int p) {
  return static_cast<int32_t>((words[p >> 5] >> (p & 31)) & 1u);
}

__global__ void __launch_bounds__(kThreads)
    bits_unpack_kernel(const __grid_constant__ BitsTable t) {
  __shared__ uint32_t words[kTileWords + 1];  // + a zero word past the tile
  const int k = repro::bucket_of(t.block_start, t.count);
  const BitsBucket& b = t.b[k];
  const int local = static_cast<int>(blockIdx.x) - t.block_start[k];
  const int unit = local / b.tiles;
  const int tile = local - unit * b.tiles;
  const int w0 = tile * kTileWords;              // the tile's first word
  const int nw = min(kTileWords, b.wpu - w0);

  // 1. stage the tile's words, coalesced
  const uint32_t* src = b.words + static_cast<long long>(unit) * b.wpu + w0;
  const int i = static_cast<int>(threadIdx.x);
  if (i <= kTileWords) words[i] = i < nw ? __ldg(src + i) : 0u;
  __syncthreads();

  // 2. store the tile's bits, coalesced: from the first 16-byte boundary of
  //    the tile's output on, four bits (one funnel shift of the two words
  //    that hold them) as one 16-byte store; the up to 3 bits before that
  //    boundary and the up to 3 after the last whole vector one 4-byte
  //    store each
  const int f0 = tile * kTileBits;
  const int nf = min(kTileBits, b.d - f0);
  int32_t* dst = b.out + static_cast<long long>(unit) * b.d + f0;
  const int head = min(
      nf, static_cast<int>((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) &
                           15u) >> 2);
  const int nv = (nf - head) >> 2;
  int4* vec = reinterpret_cast<int4*>(dst + head);
  for (int v = i; v < nv; v += kThreads) {
    const int p = head + 4 * v;
    const uint32_t q =
        __funnelshift_r(words[p >> 5], words[(p >> 5) + 1], p & 31);
    vec[v] = make_int4(static_cast<int32_t>(q & 1u),
                       static_cast<int32_t>((q >> 1) & 1u),
                       static_cast<int32_t>((q >> 2) & 1u),
                       static_cast<int32_t>((q >> 3) & 1u));
  }
  const int tail = head + 4 * nv;  // nf - tail <= 3
  if (i < head) dst[i] = bit_at(words, i);
  const int r = tail + i - 4;     // threads 4..6 store the tail
  if (i >= 4 && r < nf) dst[r] = bit_at(words, r);
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

// bits_unpack_buckets: `count` (1..kMaxBuckets) buckets. `ptrs` holds their
// words and out pointers, `count` of each in that order; `sizes` their n,
// d, wpu, tiles per unit and first block, `count` of each, as
// kernels/qsgd.py grouped_table computes them at width 1 over
// kernels/pack.py bits_tiles; `blocks` in all (0 launches nothing).
extern "C" int bits_unpack_buckets(int count, void* const* ptrs,
                                   const int* sizes, int blocks, int device,
                                   void* stream) {
  if (count < 1 || count > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  BitsTable t;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    t.b[i] = BitsBucket{static_cast<const uint32_t*>(ptrs[i]),
                        static_cast<int32_t*>(ptrs[count + i]), sizes[i],
                        sizes[count + i], sizes[2 * count + i],
                        sizes[3 * count + i]};
    t.block_start[i] = sizes[4 * count + i];
  }
  bits_unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
