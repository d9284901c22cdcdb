// The hash-once tile walk shared by the stochastic packs, QSGD (qsgd.cu)
// and TernGrad (terngrad.cu): one template over the code function, which
// maps an element, its uniform and its unit's statistic to a code of
// `width` bits.
//
// Position p < h = ceil(d / 2) is output word 0 of counter pair (p, p + h)
// and p >= h word 1 of pair (p - h, p) (threefry.cuh), so one hash of pair
// j gives the uniforms of positions j and j + h (repro::uniform_pair_at).
// A block of 256 threads takes a tile of kPackTilePairs = 480 = 15 x 32
// pairs of one unit plus a halo chunk of the next 32 pairs, two pairs a
// thread, hashes each once and stages the codes of both halves in shared
// memory. Words are written one a thread, in 32-position chunks (a chunk
// spans exactly `width` words, so no word has two writers): the tile's 15
// chunks of the lower half, and the 15 upper-half chunks whose first pair
// falls in its range; their codes are 32 consecutive staged codes from any
// offset (h need not be a multiple of 32), which the halo chunk completes.
// The one chunk holding position h (when h % 32 != 0) mixes both halves;
// one warp hashes its 32 positions directly. So a pair is hashed once,
// plus 32 halo pairs a tile and at most 32 a unit. Positions at or past d
// code 0 (zero word padding); words past the unit's last are not written.
//
// Grouped launch: a table of up to kPackMaxBuckets buckets (pointers,
// sizes, tiles per unit and the first block of each bucket, a prefix sum
// built by the caller, kernels/qsgd.py grouped_table) travels by value as
// a __grid_constant__ kernel parameter; a block finds its bucket by a scan
// over the block starts (grouped.cuh), then its unit and tile with one
// 32-bit divide.
#pragma once

#include <cstdint>

#include "fields.cuh"
#include "grouped.cuh"
#include "threefry.cuh"

namespace repro {

constexpr int kPackWarps = 8;                          // warps a block
constexpr int kPackTileChunks = 15;                    // 32-pair chunks a tile owns
constexpr int kPackHashChunks = kPackTileChunks + 1;   // + the halo chunk
constexpr int kPackTilePairs = 32 * kPackTileChunks;   // kernels/qsgd.py TILE_PAIRS
constexpr int kPackMaxBuckets = 32;                    // kernels/qsgd.py MAX_BUCKETS

struct PackBucket {
  const float* x;          // (n, d) units
  const uint32_t* k0;      // (n,) key words
  const uint32_t* k1;
  const float* stat;       // (n,) unit statistics, +1e-12 included
  uint32_t* out;           // (n, wpu) words
  int n, d, wpu, tiles;    // tiles per unit
};

struct PackTable {
  int block_start[kPackMaxBuckets];  // each bucket's first block
  PackBucket b[kPackMaxBuckets];
  int count;
};

// The table of `count` (1..kPackMaxBuckets) buckets: `ptrs` holds their x,
// k0, k1, stat and out pointers, `count` of each in that order; `sizes`
// their n, d, wpu, tiles per unit and first block, `count` of each
// (kernels/qsgd.py launch_grouped).
inline PackTable pack_table(int count, void* const* ptrs, const int* sizes) {
  PackTable t;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    t.b[i] = PackBucket{static_cast<const float*>(ptrs[i]),
                        static_cast<const uint32_t*>(ptrs[count + i]),
                        static_cast<const uint32_t*>(ptrs[2 * count + i]),
                        static_cast<const float*>(ptrs[3 * count + i]),
                        static_cast<uint32_t*>(ptrs[4 * count + i]),
                        sizes[i], sizes[count + i], sizes[2 * count + i],
                        sizes[3 * count + i]};
    t.block_start[i] = sizes[4 * count + i];
  }
  return t;
}

// The body of a pack kernel of kPackWarps warps: this block's tile of its
// bucket, codes code(x, u, stat) of `width` bits.
template <class Code>
__device__ __forceinline__ void hash_pack_tile(const PackTable& t,
                                               const Code& code, int width) {
  __shared__ uint32_t lo[kPackHashChunks * 32];  // code of position j0 + i
  __shared__ uint32_t hi[kPackHashChunks * 32];  // code of position j0 + i + h
  __shared__ uint32_t mixed[32];                 // codes of chunk qm
  const int k = bucket_of(t.block_start, t.count);
  const PackBucket& b = t.b[k];
  const int local = static_cast<int>(blockIdx.x) - t.block_start[k];
  const int unit = local / b.tiles;
  const int tile = local - unit * b.tiles;
  const int d = b.d;
  const int h = (d + 1) >> 1;
  const float* xu = b.x + static_cast<long long>(unit) * d;
  uint32_t* ou = b.out + static_cast<long long>(unit) * b.wpu;
  const uint32_t k0 = b.k0[unit], k1 = b.k1[unit];
  const float stat = b.stat[unit];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = tile * kPackTilePairs;
  const int ql0 = tile * kPackTileChunks;     // the tile's first lower chunk
  const int qm = (h & 31) ? h >> 5 : -1;      // the chunk holding position h
  const bool has_mixed = qm >= ql0 && qm < ql0 + kPackTileChunks;

  // 1. hash each pair of the tile and the halo chunk once (two pairs a
  //    thread, independent, so their hashes interleave): both codes
#pragma unroll
  for (int r = 0; r < kPackHashChunks / kPackWarps; ++r) {
    const int i = (warp + r * kPackWarps) * 32 + lane;
    const int j = j0 + i;
    uint32_t cl = 0u, ch = 0u;
    if (j < h) {
      float u0, u1;
      uniform_pair_at(k0, k1, j, d, u0, u1);
      cl = code(xu[j], u0, stat);
      if (j + h < d) ch = code(xu[j + h], u1, stat);
    }
    lo[i] = cl;
    hi[i] = ch;
  }
  if (has_mixed && warp == kPackWarps - 1) {  // both halves: per position
    const int p = 32 * qm + lane;
    mixed[lane] = p < d ? code(xu[p], uniform_at(k0, k1, p, d), stat) : 0u;
  }
  __syncthreads();

  // 2. one thread a word over two runs of whole chunks (a chunk spans
  //    exactly `width` words): the lower run, chunks [ql0, min(ql0 + 15,
  //    h / 32)) entirely below h, then chunk qm; the upper run, the 15
  //    chunks q >= q0 = ceil((j0 + h) / 32) whose first pair 32q - h lies
  //    in [j0, j0 + 480), codes hi[o .. o + 31] with o = 32q - h - j0 <=
  //    479 (the halo chunk completes them). Words past wpu (beyond d) are
  //    not written.
  const int ql1 = has_mixed ? qm + 1 : min(ql0 + kPackTileChunks, h >> 5);
  const int nl = max(0, ql1 - ql0) * width;
  const int q0 = (j0 + h + 31) >> 5;
  const int nu =
      max(0, min(q0 + kPackTileChunks, (d + 31) >> 5) - q0) * width;
  for (int i = threadIdx.x; i < nl + nu; i += blockDim.x) {
    const bool upper = i >= nl;
    const int word = upper ? q0 * width + (i - nl) : ql0 * width + i;
    if (word >= b.wpu) continue;
    const int q = word / width;
    const uint32_t* codes = upper ? hi + (32 * q - h - j0)
                            : q == qm ? mixed : lo + 32 * (q - ql0);
    ou[word] = assemble_word(codes, width, word - q * width);
  }
}

}  // namespace repro
