// Compress-only QSGD and TernGrad quantize+dequantize for Hopper (sm_90a).
//
// Replaces four TPU kernels of the JAX package:
//   qsgd_compress_buckets     <- qsgd_pallas_rows     (kernels/qsgd.py:67)
//                                qsgd_pallas          (kernels/qsgd.py:173)
//   terngrad_compress_buckets <- terngrad_pallas_rows (kernels/terngrad.py:48)
//                                terngrad_pallas      (kernels/terngrad.py:138)
// Each Pallas pair differs only in where the statistic lives: one scalar
// for the whole input, or one value per tile row. Here a bucket is (n, d)
// units with one statistic each, so a whole input is one unit of d
// elements with a (1,) statistic, and one kernel serves both.
//
//   QSGD:     n = max(stat, 1e-12);
//             out = sign(x) * floor(fma(|x| / n, levels, u)) * (n * f32(1 / levels))
//   TernGrad: s = max(stat, 1e-12); out = sign(x) * [u < |x| / s] * s
//
// This is what the reference's jitted code computes on XLA's CPU backend,
// the port's reference: it contracts |x| / n * levels + u into one fma,
// turns n / levels into a multiply by the rounded reciprocal (the caller
// passes it in as inv_levels), and compiles the multiply by the 0/1 mask
// [u < |x| / s] into a select, so a dropped TernGrad entry is (+0.0) * s,
// never -0.0 or NaN. The one fused operation is the explicit fmaf.
//
// The uniforms are drawn here, bit for bit those of the reference: a unit's
// u[p] is jax.random.uniform(key, (N,))[p], with N the unit's draw length,
// longer than d (the reference draws over its padded tile: N = 512 *
// ceil(d / 512) for a UnitPlan unit, N = 131,072 * ceil(d / 131,072) for a
// whole input). N is even, so with h = N / 2 counter pair j < h gives the
// uniforms of positions j and j + h from one hash (threefry.cuh
// uniform_pair_at); where d <= h the second is not needed.
//
// What bounds it on the card: 8 B moved per element (x read, the output
// written) plus 12 B a unit (two key words and the statistic), against
// one threefry2x32 hash (~79 integer operations) per pair of positions
// below min(d, h) and ~8 fp32 operations an element: at 2^20 elements the
// integer throughput of the hash is the bound, at the resnet9 bucket sizes
// the latency of one thread's chain (table scan, divide, loads, hash, IEEE
// divides, stores) after the launch.
//
// Design: one grouped launch for up to kMaxBuckets buckets (a
// __grid_constant__ table, grouped.cuh). A block of 256 threads owns a
// tile of 256 * kPairs counter pairs of one unit, kPairs a thread; it
// finds its bucket by a scan of the first blocks, its unit and tile with
// one 32-bit divide. A thread loads the entries of its pairs first, then
// hashes the pairs, then quantizes and stores. Both halves of a tile
// (positions [j0, j0 + tile) and [j0 + h, j0 + h + tile)) are coalesced
// runs. Two walks, chosen by the caller for each call (kernels/qsgd.py
// pairs_per_thread): kPairs = 1 while a call's pairs fit in one wave of the
// card's resident threads, so each thread's chain is as short as it can
// be; kPairs = 4 beyond, where a thread takes 4 consecutive pairs and,
// where d % 4 == 0, h % 4 == 0 and x and out start on 16-byte boundaries,
// loads and stores each half as one 16-byte vector (all 4 positions are in
// range or none is), otherwise the pairs j0 + tid + 256 r with 4-byte
// accesses. (On an H100 the two cross at about 2^18 pairs a call.) The
// output is dense f32, so no shared memory is needed. IEEE divide and
// multiply via the _rn intrinsics, compiled with -fmad=false, so every
// other operation rounds on its own. sign_of keeps +-0.0 and NaN as
// jnp.sign does, and at_least_eps keeps a NaN statistic.
#include <cuda_runtime.h>

#include <cstdint>

#include "grouped.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;    // kernels/qsgd.py COMPRESS_THREADS
constexpr int kMaxBuckets = 32;  // kernels/qsgd.py MAX_BUCKETS

// f32(1e-12), the reference's _EPS (0x2b8cbccc)
__device__ __forceinline__ float eps() { return __int_as_float(0x2b8cbccc); }

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
}

// jnp.maximum(s, eps): a NaN statistic stays NaN
__device__ __forceinline__ float at_least_eps(float s) {
  return s < eps() ? eps() : s;
}

// sign(x) * floor(fma(|x| / n, levels, u)) * (n * inv_levels)
struct QsgdQuant {
  float levels, inv_levels;
  __device__ __forceinline__ float operator()(float xv, float u,
                                              float n) const {
    const float lev = floorf(fmaf(__fdiv_rn(fabsf(xv), n), levels, u));
    return __fmul_rn(__fmul_rn(sign_of(xv), lev), __fmul_rn(n, inv_levels));
  }
};

// sign(x) * [u < |x| / s] * s, the mask a select (a dropped entry is +0.0)
struct TernQuant {
  __device__ __forceinline__ float operator()(float xv, float u,
                                              float s) const {
    const bool keep = u < __fdiv_rn(fabsf(xv), s);
    return __fmul_rn(keep ? sign_of(xv) : 0.0f, s);
  }
};

struct Bucket {
  const float* x;        // (n, d) units
  const uint32_t* k0;    // (n,) key words
  const uint32_t* k1;
  const float* stat;     // (n,) unit statistics (l2 norm or max|x|)
  float* out;            // (n, d)
  int n, d, tiles, draw;  // tiles per unit, the draw length N (even, >= d)
};

struct Table {
  int block_start[kMaxBuckets];  // each bucket's first block
  Bucket b[kMaxBuckets];
  int count;
};

// The table of `count` (1..kMaxBuckets) buckets: `ptrs` holds their x, k0,
// k1, stat and out pointers, `count` of each in that order; `sizes` their
// n, d, wpu (unused: the output is dense), tiles per unit, first block and
// draw length, `count` of each (kernels/qsgd.py launch_grouped with the
// draw lengths as `extra`).
Table make_table(int count, void* const* ptrs, const int* sizes) {
  Table t;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    t.b[i] = Bucket{static_cast<const float*>(ptrs[i]),
                    static_cast<const uint32_t*>(ptrs[count + i]),
                    static_cast<const uint32_t*>(ptrs[2 * count + i]),
                    static_cast<const float*>(ptrs[3 * count + i]),
                    static_cast<float*>(ptrs[4 * count + i]),
                    sizes[i], sizes[count + i], sizes[3 * count + i],
                    sizes[5 * count + i]};
    t.block_start[i] = sizes[4 * count + i];
  }
  return t;
}

// This block's tile of its bucket. Each thread loads the entries of its
// kPairs pairs (lower position j, and j + h where j + h < d) first, so
// that the loads are in flight while it hashes the pairs, then quantizes
// and stores them.
template <int kPairs, class Quant>
__device__ __forceinline__ void compress_tile(const Table& t,
                                              const Quant& quant) {
  const int k = repro::bucket_of(t.block_start, t.count);
  const Bucket& b = t.b[k];
  const int local = static_cast<int>(blockIdx.x) - t.block_start[k];
  const int unit = local / b.tiles;
  const int tile = local - unit * b.tiles;
  const int d = b.d;
  const int h = b.draw >> 1;
  const int pairs = min(d, h);
  const long long base = static_cast<long long>(unit) * d;
  const float* xu = b.x + base;
  float* ou = b.out + base;
  const int j0 = tile * kThreads * kPairs;
  const bool vec = kPairs == 4 && (d & 3) == 0 && (h & 3) == 0 &&
                   repro::aligned16(b.x) && repro::aligned16(b.out);
  // vec: pairs j, j + 1, j + 2, j + 3; else j, j + 256, j + 512, j + 768
  const int j = vec ? j0 + 4 * static_cast<int>(threadIdx.x)
                    : j0 + static_cast<int>(threadIdx.x);
  const int step = vec ? 1 : kThreads;

  float lo[kPairs] = {}, hi[kPairs] = {};
  if constexpr (kPairs == 4) {
    if (vec) {  // all 4 positions of a half in range, or none
      if (j < pairs) {
        const float4 v = *reinterpret_cast<const float4*>(xu + j);
        lo[0] = v.x, lo[1] = v.y, lo[2] = v.z, lo[3] = v.w;
        if (j + h < d) {
          const float4 w = *reinterpret_cast<const float4*>(xu + j + h);
          hi[0] = w.x, hi[1] = w.y, hi[2] = w.z, hi[3] = w.w;
        }
      }
    }
  }
  if (!vec) {
#pragma unroll
    for (int r = 0; r < kPairs; ++r) {
      const int p = j + r * step;
      if (p < pairs) {
        lo[r] = xu[p];
        if (p + h < d) hi[r] = xu[p + h];
      }
    }
  }
  const uint32_t k0 = b.k0[unit], k1 = b.k1[unit];
  const float stat = at_least_eps(b.stat[unit]);
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    float u0, u1;
    repro::uniform_pair_at(k0, k1, static_cast<uint32_t>(j + r * step),
                           static_cast<uint32_t>(b.draw), u0, u1);
    lo[r] = quant(lo[r], u0, stat);
    hi[r] = quant(hi[r], u1, stat);
  }

  if constexpr (kPairs == 4) {
    if (vec) {
      if (j < pairs) {
        *reinterpret_cast<float4*>(ou + j) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
        if (j + h < d)
          *reinterpret_cast<float4*>(ou + j + h) =
              make_float4(hi[0], hi[1], hi[2], hi[3]);
      }
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    const int p = j + r * step;
    if (p < pairs) {
      ou[p] = lo[r];
      if (p + h < d) ou[p + h] = hi[r];
    }
  }
}

template <int kPairs>
__global__ void __launch_bounds__(kThreads)
    qsgd_compress_kernel(const __grid_constant__ Table t, float levels,
                         float inv_levels) {
  compress_tile<kPairs>(t, QsgdQuant{levels, inv_levels});
}

template <int kPairs>
__global__ void __launch_bounds__(kThreads)
    terngrad_compress_kernel(const __grid_constant__ Table t) {
  compress_tile<kPairs>(t, TernQuant{});
}

}  // namespace

// C entry points (loaded with ctypes): `count` (1..kMaxBuckets) buckets,
// `ptrs` their x, k0, k1, stat and out pointers, `count` of each in that
// order; `sizes` their n, d, wpu, tiles per unit, first block and draw
// length, `count` of each (kernels/qsgd.py compress_tiles at
// `pairs_per_thread`, 1 or 4); `blocks` in all (0 launches nothing).
// Launch on `stream` of `device`; return cudaGetLastError().
extern "C" int qsgd_compress_buckets(int count, void* const* ptrs,
                                     const int* sizes, int blocks,
                                     int pairs_per_thread, int levels,
                                     float inv_levels, int device,
                                     void* stream) {
  if (count < 1 || count > kMaxBuckets ||
      (pairs_per_thread != 1 && pairs_per_thread != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Table t = make_table(count, ptrs, sizes);
  const auto kernel = pairs_per_thread == 4 ? qsgd_compress_kernel<4>
                                            : qsgd_compress_kernel<1>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float>(levels), inv_levels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int terngrad_compress_buckets(int count, void* const* ptrs,
                                         const int* sizes, int blocks,
                                         int pairs_per_thread, int device,
                                         void* stream) {
  if (count < 1 || count > kMaxBuckets ||
      (pairs_per_thread != 1 && pairs_per_thread != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Table t = make_table(count, ptrs, sizes);
  const auto kernel = pairs_per_thread == 4 ? terngrad_compress_kernel<4>
                                            : terngrad_compress_kernel<1>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
