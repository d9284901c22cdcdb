// Compress-only QSGD and TernGrad quantize+dequantize for Hopper (sm_90a).
//
// Replaces four TPU kernels of the JAX package:
//   qsgd_compress_rows     <- qsgd_pallas_rows     (kernels/qsgd.py:67)
//                             qsgd_pallas          (kernels/qsgd.py:173)
//   terngrad_compress_rows <- terngrad_pallas_rows (kernels/terngrad.py:48)
//                             terngrad_pallas      (kernels/terngrad.py:138)
// Each Pallas pair differs only in where the statistic lives: one scalar for
// the whole input, or one value per tile row. Here the statistic of row r is
// stat[r * stat_stride], so a scalar is a column with stride 0 and one kernel
// serves both. Rows are whatever the caller makes them: compression units
// (stride 1) or the 512-wide rows of a flat input (stride 0). The noise is an
// input, as in the TPU kernels; the caller draws it.
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
// What bounds it on the card: 12 B moved per element (x and the noise read,
// the output written) against ~8 fp32 operations, so memory bandwidth; at
// the resnet9 bucket sizes launch latency dominates.
//
// Design: one thread per element in a grid-stride loop, coalesced f32 loads
// and stores. IEEE divide and multiply via the _rn intrinsics, compiled with
// -fmad=false, so every other operation rounds on its own. sign()
// keeps +-0.0 and NaN as jnp.sign does, and max(stat, eps) keeps a NaN.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// f32(1e-12), the reference's _EPS (0x2b8cbccc)
__device__ __forceinline__ float eps() { return __int_as_float(0x2b8cbccc); }

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
}

// jnp.maximum(s, eps): a NaN statistic stays NaN
__device__ __forceinline__ float at_least_eps(float s) {
  return s < eps() ? eps() : s;
}

__global__ void qsgd_compress_kernel(const float* __restrict__ x,
                                     const float* __restrict__ noise,
                                     const float* __restrict__ stat,
                                     float* __restrict__ out, long long total,
                                     int cols, int stat_stride, float levels,
                                     float inv_levels) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += step) {
    const float n = at_least_eps(stat[(i / cols) * stat_stride]);
    const float xv = x[i];
    const float lev = floorf(fmaf(__fdiv_rn(fabsf(xv), n), levels, noise[i]));
    out[i] = __fmul_rn(__fmul_rn(sign_of(xv), lev), __fmul_rn(n, inv_levels));
  }
}

__global__ void terngrad_compress_kernel(const float* __restrict__ x,
                                         const float* __restrict__ noise,
                                         const float* __restrict__ stat,
                                         float* __restrict__ out,
                                         long long total, int cols,
                                         int stat_stride) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += step) {
    const float s = at_least_eps(stat[(i / cols) * stat_stride]);
    const float xv = x[i];
    const bool keep = noise[i] < __fdiv_rn(fabsf(xv), s);
    out[i] = __fmul_rn(keep ? sign_of(xv) : 0.0f, s);
  }
}

unsigned grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 65535LL * 16 ? blocks : 65535LL * 16);
}

}  // namespace

// C entry points (loaded with ctypes): x, noise and out are (rows, cols) f32,
// stat holds the per-row statistic at rows * stat_stride (stride 0: one
// scalar). Launch on `stream` of `device`; return cudaGetLastError().
extern "C" int qsgd_compress_rows(const void* x, const void* noise,
                                  const void* stat, void* out, int rows,
                                  int cols, int stat_stride, int levels,
                                  float inv_levels, int device, void* stream) {
  const long long total = static_cast<long long>(rows) * cols;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  qsgd_compress_kernel<<<grid_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise),
      static_cast<const float*>(stat), static_cast<float*>(out), total, cols,
      stat_stride, static_cast<float>(levels), inv_levels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int terngrad_compress_rows(const void* x, const void* noise,
                                      const void* stat, void* out, int rows,
                                      int cols, int stat_stride, int device,
                                      void* stream) {
  const long long total = static_cast<long long>(rows) * cols;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  terngrad_compress_kernel<<<grid_for(total), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise),
      static_cast<const float*>(stat), static_cast<float*>(out), total, cols,
      stat_stride);
  return static_cast<int>(cudaGetLastError());
}
