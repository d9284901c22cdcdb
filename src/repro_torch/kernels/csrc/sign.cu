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
// Design. sign_pack is the staged-tile ballot walk of ballot_pack.cuh
// (shared with bits.cu's bit pack) on f32 with the predicate x >= 0.0f:
// every bucket of a step in one grouped launch (a __grid_constant__ table
// of up to 32 buckets, one 32-bit divide a block), 2,048-element tiles
// staged in shared memory with 16-byte loads where d % 4 == 0 and the base
// is aligned, 4-byte loads otherwise, one __ballot_sync a 32-element chunk,
// and lanes 0-7 of each warp storing its 8 words. The one-bucket pack is
// the same launch with one entry.
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
// for word. Grouped like the packs: a __grid_constant__ table of up to 32
// buckets, each its own (n_i, W_i) block of words, one launch for every
// bucket of a step (a one-bucket launch is a table of one); a
// block finds its bucket with the scan of grouped.cuh and owns kVoteCols =
// 128 word columns of it (its tile: no divide), one a thread, so every
// warp-wide 4-byte load and store is one coalesced 128-byte run at any W
// and any alignment. Workers go in groups of kVoteGroup = 8: a group's
// loads are all issued before its adds. Per column the per-bit counts
// live in kPlanes word-wide bit planes in registers; each worker's word
// goes in with a ripple carry, then the borrow chain of count -
// ceil(n / 2) gives the vote. Planes above bit_length(n) stay zero and
// leave the borrow unchanged, so a fixed kPlanes = 8 serves every n in
// 1..255; the first group adds into planes known to be zero, so the
// compiler drops the steps on zero planes (worker j of it costs
// bit_length(j + 1) steps a column, not 8). Zero padding columns vote 0.
//   What bounds it: bytes, n words read and one written a column (4
// workers x 3,783 words a layerwise step, about 0.00002 ms at 3.35 TB/s),
// so every launch of the main path is latency: on an H100 a thread's
// serial adds showed in the time, so the design keeps them few (one
// column a thread, 128-thread blocks). 16-byte accesses of 4 columns a
// thread timed no faster than this body on an H100 at the main-path
// shapes, with three times the registers.
#include <cuda_runtime.h>

#include <cstdint>

#include "ballot_pack.cuh"
#include "grouped.cuh"
#include "unpack_tile.cuh"

namespace {

constexpr int kMaxBuckets = 32;        // kernels/qsgd.py MAX_BUCKETS
constexpr int kPlanes = 8;             // count bit planes: n <= 255 workers
constexpr int kVoteThreads = 128;      // majority block
constexpr int kVoteCols = kVoteThreads;  // kernels/sign.py VOTE_COLS
constexpr int kVoteGroup = 8;          // workers whose loads issue together

// The predicate of the signSGD pack: x >= 0 (-0.0 packs 1, NaN packs 0).
struct NonNegative {
  __device__ __forceinline__ bool operator()(float x) const {
    return x >= 0.0f;
  }
};

__global__ void __launch_bounds__(repro::kBallotThreads)
    sign_pack_kernel(const __grid_constant__ repro::BallotTable t) {
  repro::ballot_pack_tile<float>(t, NonNegative{});
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

struct VoteBucket {
  const uint32_t* words;  // (n, W) workers' words
  uint32_t* out;          // (W,) votes
  int n, W;
};

struct VoteTable {
  int block_start[kMaxBuckets];  // each bucket's first block
  VoteBucket b[kMaxBuckets];
  int count;
};

// Ripple-carry add of one word (a bit per column) into the bit planes.
__device__ __forceinline__ void add_word(uint32_t (&planes)[kPlanes],
                                         uint32_t c) {
#pragma unroll
  for (int pi = 0; pi < kPlanes; ++pi) {
    const uint32_t a = planes[pi];
    planes[pi] = a ^ c;
    c = a & c;
  }
}

// The vote of counts held in bit planes: count >= thr, by the borrow chain
// of count - thr.
__device__ __forceinline__ uint32_t vote(const uint32_t (&planes)[kPlanes],
                                         int thr) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int pi = 0; pi < kPlanes; ++pi)
    borrow = ((thr >> pi) & 1) ? (~planes[pi] | borrow)
                               : (~planes[pi] & borrow);
  return ~borrow;
}

__global__ void __launch_bounds__(kVoteThreads)
    majority_kernel(const __grid_constant__ VoteTable t) {
  const int k = repro::bucket_of(t.block_start, t.count);
  const VoteBucket& b = t.b[k];
  const int n = b.n, W = b.W;
  const int c = (static_cast<int>(blockIdx.x) - t.block_start[k]) *
                    kVoteCols +
                static_cast<int>(threadIdx.x);   // this thread's column
  if (c >= W) return;
  uint32_t planes[kPlanes];
#pragma unroll
  for (int pi = 0; pi < kPlanes; ++pi) planes[pi] = 0u;
  uint32_t v[kVoteGroup];
  auto load = [&](int i0) {         // every load of a group, then the adds
#pragma unroll
    for (int j = 0; j < kVoteGroup; ++j) {
      if (i0 + j >= n) break;       // the same for every thread
      v[j] = __ldg(b.words + static_cast<long long>(i0 + j) * W + c);
    }
  };
  auto add = [&](int i0) {
#pragma unroll
    for (int j = 0; j < kVoteGroup; ++j) {
      if (i0 + j >= n) break;
      add_word(planes, v[j]);
    }
  };
  // the first group on planes known to be zero: the compiler drops the
  // steps that add into a zero plane, so worker j costs bit_length(j + 1)
  // steps, not kPlanes
  load(0);
  add(0);
  for (int i0 = kVoteGroup; i0 < n; i0 += kVoteGroup) {
    load(i0);
    add(i0);
  }
  b.out[c] = vote(planes, (n + 1) / 2);
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream` of CUDA
// device `device` and returns cudaGetLastError(); `blocks` == 0 launches
// nothing.
// sign_pack_buckets: `count` (1..kMaxBuckets) buckets. `ptrs` holds their
// x pointers, then their out pointers; `sizes` their n, d, wpu, tiles per
// unit and first block, `count` of each in that order, as kernels/sign.py
// sign_table computes them; `blocks` in all.
extern "C" int sign_pack_buckets(int count, void* const* ptrs,
                                 const int* sizes, int blocks, int device,
                                 void* stream) {
  if (count < 1 || count > repro::kBallotMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const repro::BallotTable t = repro::ballot_table(count, ptrs, sizes);
  sign_pack_kernel<<<static_cast<unsigned>(blocks), repro::kBallotThreads, 0,
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

// majority_buckets: `count` (1..kMaxBuckets) buckets, each an (n, W)
// row-major block of n workers' words. `ptrs` holds their words pointers,
// then their out pointers; `sizes` the rows of kernels/sign.py vote_table
// (one output row of W words a bucket: 1, W, wpu, tiles and first block,
// ceil(W / kVoteCols) blocks a bucket), then their n (1..255), `count` of
// each in that order (kernels/qsgd.py launch_grouped with `extra`);
// `blocks` in all.
extern "C" int majority_buckets(int count, void* const* ptrs,
                                const int* sizes, int blocks, int device,
                                void* stream) {
  if (count < 1 || count > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* voters = sizes + 5 * count;
  for (int i = 0; i < count; ++i)
    if (voters[i] < 1 || voters[i] > (1 << kPlanes) - 1)
      return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  VoteTable t;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    t.b[i] = VoteBucket{static_cast<const uint32_t*>(ptrs[i]),
                        static_cast<uint32_t*>(ptrs[count + i]), voters[i],
                        sizes[count + i]};
    t.block_start[i] = sizes[4 * count + i];
  }
  majority_kernel<<<static_cast<unsigned>(blocks), kVoteThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
