// Width-parametric field pack / unpack for Hopper (sm_90a), grouped over
// the buckets of a step.
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
// 0.01) are a few kilobytes. At those sizes one launch costs more than its
// bytes, so one launch serves every bucket of a step.
//
// Design. A tile is kTileChunks = 64 consecutive 32-field chunks of one
// unit (2,048 fields). A chunk spans exactly `width` whole words, so a
// tile's fields and its kTileChunks * width words are both contiguous in
// their rows and no word belongs to two tiles: one writer a word, no
// atomics, no zero-fill pass. A block of 256 threads owns one tile, 8
// fields a thread.
//   pack:   stage the tile's fields in shared memory with coalesced loads
//           (two 16-byte loads a thread where the row is 16-byte aligned:
//           k % 4 == 0 and an aligned base; 4-byte loads otherwise, fields
//           past k as 0), then every thread assembles and stores
//           consecutive words of the tile (fields.cuh assemble_word on the
//           staged codes): the stores are coalesced and no lane idles
//           while words remain.
//   unpack: stage the tile's words with coalesced 4-byte loads, then each
//           thread extracts its fields from shared memory (fields.cuh
//           extract_field) and stores them coalesced, four consecutive
//           fields as one 16-byte store where the output row is aligned.
// A layerwise resnet9 step is 272 tiles (68 a worker), a quarter of one
// wave of the card's 132 SMs at 8 blocks an SM; the stress shape
// (4 x 1,048,579) is 2,052 tiles, two waves with 8 KB of loads a block in
// flight. Against 1,024-field tiles (4 fields a thread, one load in
// flight) the stress shape gains from the second load and a layerwise
// step, bound by launch latency, loses a fraction of a microsecond.
//
// Grouped launch: a table of up to kMaxBuckets buckets (pointers, n, k,
// width, words and tiles per unit, and each bucket's first block, a prefix
// sum built by the caller) travels by value as a __grid_constant__ kernel
// parameter, so one launch serves every bucket of a step without a
// host-to-device copy (and a CUDA graph can capture it). A block finds its
// bucket by a scan over the block starts, then its unit and tile with one
// 32-bit divide; no 64-bit divide remains. The one-bucket call is the same
// launch with one entry.
#include <cuda_runtime.h>

#include <cstdint>

#include "fields.cuh"
#include "grouped.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileChunks = 64;                  // 32-field chunks a tile
constexpr int kTileFields = 32 * kTileChunks;    // kernels/pack.py TILE_FIELDS
constexpr int kMaxWidth = 31;
constexpr int kMaxBuckets = 32;                  // kernels/pack.py MAX_BUCKETS

struct FieldBucket {
  const uint32_t* in;   // pack: (n, k) fields; unpack: (n, wpu) words
  uint32_t* out;        // pack: (n, wpu) words; unpack: (n, k) fields
  int n, k, width, wpu, tiles;  // tiles per unit
};

struct FieldTable {
  int block_start[kMaxBuckets];  // each bucket's first block in the launch
  FieldBucket b[kMaxBuckets];
  int count;
};

// This block's bucket (a copy in registers), unit and tile.
struct Place {
  FieldBucket b;
  int unit, tile;
};

__device__ __forceinline__ Place find(const FieldTable& t) {
  const int i = repro::bucket_of(t.block_start, t.count);
  const FieldBucket b = t.b[i];
  const int local = static_cast<int>(blockIdx.x) - t.block_start[i];
  const int unit = local / b.tiles;
  return Place{b, unit, local - unit * b.tiles};
}

__global__ void __launch_bounds__(kThreads)
    fields_pack_kernel(const __grid_constant__ FieldTable t) {
  __shared__ __align__(16) uint32_t codes[kTileFields];
  const Place at = find(t);
  const FieldBucket& b = at.b;
  const int width = b.width;
  const int f0 = at.tile * kTileFields;         // the tile's first field
  const int nf = min(kTileFields, b.k - f0);
  const uint32_t* src = b.in + static_cast<long long>(at.unit) * b.k + f0;

  // 1. stage the tile's fields (0 past k), coalesced
  if (b.k % 4 == 0 && repro::aligned16(b.in)) {  // nf % 4 == 0 here
    for (int v = threadIdx.x; v < kTileFields / 4; v += kThreads) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (4 * v < nf) q = __ldg(reinterpret_cast<const uint4*>(src) + v);
      reinterpret_cast<uint4*>(codes)[v] = q;
    }
  } else {
    for (int i = threadIdx.x; i < kTileFields; i += kThreads)
      codes[i] = i < nf ? __ldg(src + i) : 0u;
  }
  __syncthreads();

  // 2. every thread assembles consecutive words of the tile; words past
  //    wpu (beyond k) are not written
  const int w0 = at.tile * kTileChunks * width;  // the tile's first word
  const int nw = min(kTileChunks * width, b.wpu - w0);
  uint32_t* dst = b.out + static_cast<long long>(at.unit) * b.wpu + w0;
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    const int c = w / width;                     // the word's chunk
    dst[w] = repro::assemble_word(codes + 32 * c, width, w - c * width);
  }
}

__global__ void __launch_bounds__(kThreads)
    fields_unpack_kernel(const __grid_constant__ FieldTable t) {
  __shared__ uint32_t words[kTileChunks * kMaxWidth];
  const Place at = find(t);
  const FieldBucket& b = at.b;
  const int width = b.width;
  const int w0 = at.tile * kTileChunks * width;
  const int nw = min(kTileChunks * width, b.wpu - w0);
  const uint32_t* src = b.in + static_cast<long long>(at.unit) * b.wpu + w0;

  // 1. stage the tile's words, coalesced; a field < k reads no word past
  //    the tile's last (a tile of 64 chunks spans exactly 64 * width words)
  for (int i = threadIdx.x; i < nw; i += kThreads) words[i] = __ldg(src + i);
  __syncthreads();

  // 2. extract and store the tile's fields, coalesced
  const int f0 = at.tile * kTileFields;
  const int nf = min(kTileFields, b.k - f0);
  uint32_t* dst = b.out + static_cast<long long>(at.unit) * b.k + f0;
  if (b.k % 4 == 0 && repro::aligned16(b.out)) {  // nf % 4 == 0 here
    for (int v = threadIdx.x; 4 * v < nf; v += kThreads) {
      const int p = 4 * v;
      reinterpret_cast<uint4*>(dst)[v] = make_uint4(
          repro::extract_field(words, p, width),
          repro::extract_field(words, p + 1, width),
          repro::extract_field(words, p + 2, width),
          repro::extract_field(words, p + 3, width));
    }
  } else {
    for (int p = threadIdx.x; p < nf; p += kThreads)
      dst[p] = repro::extract_field(words, p, width);
  }
}

// The table of `count` buckets: `ptrs` holds their in pointers, then their
// out pointers; `sizes` their n, k, width, wpu, tiles per unit and first
// block, `count` of each in that order (kernels/pack.py field_table).
int launch(bool pack, int count, void* const* ptrs, const int* sizes,
           int blocks, int device, void* stream) {
  if (count < 1 || count > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  FieldTable t;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    const int width = sizes[2 * count + i];
    if (width < 1 || width > kMaxWidth)
      return static_cast<int>(cudaErrorInvalidValue);
    t.b[i] = FieldBucket{static_cast<const uint32_t*>(ptrs[i]),
                         static_cast<uint32_t*>(ptrs[count + i]),
                         sizes[i], sizes[count + i], width,
                         sizes[3 * count + i], sizes[4 * count + i]};
    t.block_start[i] = sizes[5 * count + i];
  }
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pack)
    fields_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(t);
  else
    fields_unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream` of CUDA
// device `device` and returns cudaGetLastError(); `blocks` == 0 launches
// nothing. `count` is 1..kMaxBuckets, each bucket non-empty (n, k >= 1).
extern "C" int fields_pack_buckets(int count, void* const* ptrs,
                                   const int* sizes, int blocks, int device,
                                   void* stream) {
  return launch(true, count, ptrs, sizes, blocks, device, stream);
}

extern "C" int fields_unpack_buckets(int count, void* const* ptrs,
                                     const int* sizes, int blocks, int device,
                                     void* stream) {
  return launch(false, count, ptrs, sizes, blocks, device, stream);
}
