// The unpack tile walk shared by the four grouped unpacks: the QSGD and
// TernGrad decodes (qsgd.cu, terngrad.cu: width-bit codes dequantized as
// (code - offset) * factor), the bit unpack (bits.cu: bit -> int32 {0, 1})
// and the signSGD decode (sign.cu: bit -> f32 +1 / -1). One template over
// an emit functor, which maps a code and its unit's factor to the 4-byte
// value stored.
//
// Grouped launch: a table of up to kUnpackMaxBuckets buckets (words, factor
// and out pointers, n, d, words and tiles per unit, and each bucket's first
// block, a prefix sum built by the caller, kernels/qsgd.py grouped_table)
// travels by value as a __grid_constant__ kernel parameter, so one launch
// decodes every bucket of a step without a host-to-device copy (and a CUDA
// graph can capture it). A block finds its bucket by a scan over the first
// blocks (grouped.cuh), then its unit and tile with one 32-bit divide; no
// 64-bit divide remains.
//
// A tile is kUnpackChunks = 64 consecutive 32-code chunks of one unit
// (2,048 codes); a chunk spans exactly `width` words, so the tile's
// 64 x width words are contiguous in their row and no element has two
// writers. A block of 256 threads stages the tile's words in shared memory
// with coalesced 4-byte loads, plus a zero word past them, and reads its
// unit's factor once. It then stores the tile's values coalesced: from the
// first 16-byte boundary of the tile's output on, four consecutive values
// as one 16-byte store, and the up to 3 values before that boundary and
// the up to 3 after the last whole vector one 4-byte store each, so a row
// of any d and any alignment is stored in vectors but for at most 3 values
// at each end of a tile. At width <= 8 the four codes of a vector are one
// funnel shift of the two staged words that hold them (the zero word
// serves the tile's last vector); wider codes are extracted one by one.
// A constant width (TernGrad's 2, the bits' 1) folds the word index of a
// code into a shift. A layerwise resnet9 step on 4 workers is 68 tiles a
// worker, the stress shape (4 x 1,048,579) 2,052.
#pragma once

#include <cstdint>

#include "fields.cuh"
#include "grouped.cuh"

namespace repro {

constexpr int kUnpackThreads = 256;                  // threads a block
constexpr int kUnpackChunks = 64;                    // 32-code chunks a tile
constexpr int kUnpackTile = 32 * kUnpackChunks;      // kernels/qsgd.py TILE_CODES
constexpr int kUnpackMaxBuckets = 32;                // kernels/qsgd.py MAX_BUCKETS

struct UnpackBucket {
  const uint32_t* words;  // (n, wpu) words
  const float* fac;       // (n,) unit factors (null where the emit takes none)
  void* out;              // (n, d) 4-byte values
  int n, d, wpu, tiles;   // tiles per unit
};

struct UnpackTable {
  int block_start[kUnpackMaxBuckets];  // each bucket's first block
  UnpackBucket b[kUnpackMaxBuckets];
  int count;
};

// The table of `count` (1..kUnpackMaxBuckets) buckets: `ptrs` holds their
// words, factor (only `with_fac`) and out pointers, `count` of each in that
// order; `sizes` their n, d, wpu, tiles per unit and first block, `count`
// of each (kernels/qsgd.py launch_grouped).
inline UnpackTable unpack_table(int count, void* const* ptrs,
                                const int* sizes, bool with_fac) {
  UnpackTable t;
  t.count = count;
  const int out = with_fac ? 2 : 1;
  for (int i = 0; i < count; ++i) {
    t.b[i] = UnpackBucket{
        static_cast<const uint32_t*>(ptrs[i]),
        with_fac ? static_cast<const float*>(ptrs[count + i]) : nullptr,
        ptrs[out * count + i], sizes[i], sizes[count + i],
        sizes[2 * count + i], sizes[3 * count + i]};
    t.block_start[i] = sizes[4 * count + i];
  }
  return t;
}

// The emit of the QSGD and TernGrad decodes: (code - offset) * fac, one
// IEEE multiply (the reference's f32 arithmetic; fac = nrm / levels or the
// TernGrad scale, divided by the caller).
struct Dequant {
  static constexpr bool kFactor = true;
  int offset;
  __device__ __forceinline__ float operator()(uint32_t code,
                                              float fac) const {
    return __fmul_rn(static_cast<float>(static_cast<int>(code) - offset),
                     fac);
  }
};

__device__ __forceinline__ float4 vec4(float a, float b, float c, float d) {
  return make_float4(a, b, c, d);
}

__device__ __forceinline__ int4 vec4(int32_t a, int32_t b, int32_t c,
                                     int32_t d) {
  return make_int4(a, b, c, d);
}

// The body of an unpack kernel of kUnpackThreads threads: this block's tile
// of its bucket, codes of `width` <= kMaxWidth bits, each stored as
// emit(code, its unit's factor).
template <int kMaxWidth, class Emit>
__device__ __forceinline__ void unpack_tile(const UnpackTable& t, int width,
                                            const Emit& emit) {
  __shared__ uint32_t words[kUnpackChunks * kMaxWidth + 1];  // + a zero word
  const int k = bucket_of(t.block_start, t.count);
  const UnpackBucket& b = t.b[k];
  const int local = static_cast<int>(blockIdx.x) - t.block_start[k];
  const int unit = local / b.tiles;
  const int tile = local - unit * b.tiles;
  const int tw = kUnpackChunks * width;          // words a whole tile holds
  const int w0 = tile * tw;                      // the tile's first word
  const int nw = min(tw, b.wpu - w0);
  const int i = static_cast<int>(threadIdx.x);

  // 1. stage the tile's words, coalesced, and zeros up to one word past a
  //    whole tile; a code < d reads no word past them. Below width 4 one
  //    pass of the block covers them; on an H100 that pass, written out,
  //    beat the loop form by 1-3% in the bit unpack, and the loop beat
  //    unrolled passes (8 at width 31) in the width-6 QSGD decode
  const uint32_t* src = b.words + static_cast<long long>(unit) * b.wpu + w0;
  if (kUnpackChunks * kMaxWidth < kUnpackThreads) {
    if (i <= tw) words[i] = i < nw ? __ldg(src + i) : 0u;
  } else {
    for (int j = i; j <= tw; j += kUnpackThreads)
      words[j] = j < nw ? __ldg(src + j) : 0u;
  }
  const float fac = Emit::kFactor ? __ldg(b.fac + unit) : 0.0f;
  __syncthreads();

  // 2. store the tile's values, coalesced: 16-byte vectors from the first
  //    16-byte boundary of the tile's output on, 4-byte stores for the up
  //    to 3 values before it and the up to 3 after the last whole vector
  using Out = decltype(emit(0u, 0.0f));
  using Vec = decltype(vec4(Out(), Out(), Out(), Out()));
  const int f0 = tile * kUnpackTile;
  const int nf = min(kUnpackTile, b.d - f0);
  Out* dst = static_cast<Out*>(b.out) + static_cast<long long>(unit) * b.d +
             f0;
  const int misalign =
      static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15u);
  const int head = min(nf, ((16 - misalign) & 15) >> 2);
  const int nv = (nf - head) >> 2;
  Vec* vec = reinterpret_cast<Vec*>(dst + head);
  for (int v = i; v < nv; v += kUnpackThreads) {
    const int p = head + 4 * v;
    if (width <= 8) {            // four codes in one funnel shift
      const int bit = p * width;
      const uint32_t q = __funnelshift_r(words[bit >> 5],
                                         words[(bit >> 5) + 1], bit & 31);
      const uint32_t m = (1u << width) - 1u;
      vec[v] = vec4(emit(q & m, fac), emit((q >> width) & m, fac),
                    emit((q >> (2 * width)) & m, fac),
                    emit((q >> (3 * width)) & m, fac));
    } else {
      vec[v] = vec4(emit(extract_field(words, p, width), fac),
                    emit(extract_field(words, p + 1, width), fac),
                    emit(extract_field(words, p + 2, width), fac),
                    emit(extract_field(words, p + 3, width), fac));
    }
  }
  const int tail = head + 4 * nv;  // nf - tail <= 3
  if (i < head) dst[i] = emit(extract_field(words, i, width), fac);
  const int r = tail + i - 4;      // threads 4..6 store the tail
  if (i >= 4 && r < nf) dst[r] = emit(extract_field(words, r, width), fac);
}

}  // namespace repro
