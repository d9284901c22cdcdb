// Block-local top-k mask for Hopper (sm_90a).
//
// Replaces the TPU kernel topk_mask_pallas (the JAX package's
// kernels/topk_mask.py:43, body _topk_kernel :25). Each 512-wide row keeps
// the entries with |x| >= lo, where lo comes from 24 bisection halvings of
// [0, row max]: thr = 0.5 * (lo + hi); if count(|x| >= thr) > k then lo = thr
// else hi = thr. Ties at the threshold keep more than k, as in the reference.
// A dropped entry is +0.0: XLA compiles the reference's multiply by the 0/1
// mask into a select.
//
// What bounds it on the card: 8 B moved per element (x read, the masked row
// written) against ~27 fp32 operations (abs, max, 24 bisection compares, the
// final compare) and 24 integer adds per element, so the two bounds are
// close; at the main-path sizes (237 rows for resnet9's 121,002 parameters)
// launch latency dominates.
//
// Design: one warp per row, the row in registers (16 values a lane, loaded
// lane-interleaved so each load instruction is coalesced). The row max and
// each of the 24 counts are warp butterflies (__shfl_xor_sync), so every lane
// holds the same lo / hi and no shared memory or block barrier is needed.
// Every step is exact (max, compare, integer count, and the same rounded
// 0.5 * (lo + hi) as the reference), so the result is bitwise the reference's.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 512;
constexpr int kPerLane = kCols / 32;
constexpr int kIters = 24;
constexpr int kWarps = 8;  // rows per block
constexpr unsigned kFull = 0xffffffffu;

// max that keeps a NaN, as jnp.max / torch.amax do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void topk_mask_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int rows, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const float* xr = x + row * kCols;
  float v[kPerLane];
  float mag[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    v[j] = xr[lane + 32 * j];
    mag[j] = fabsf(v[j]);
  }
  float hi = mag[0];
#pragma unroll
  for (int j = 1; j < kPerLane; ++j) hi = nan_max(hi, mag[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    hi = nan_max(hi, __shfl_xor_sync(kFull, hi, off));
  float lo = 0.0f;
  for (int it = 0; it < kIters; ++it) {
    const float thr = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) cnt += mag[j] >= thr ? 1 : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_xor_sync(kFull, cnt, off);
    const bool pred = cnt > k;
    lo = pred ? thr : lo;
    hi = pred ? hi : thr;
  }
  float* orow = out + row * kCols;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    orow[lane + 32 * j] = mag[j] >= lo ? v[j] : 0.0f;
}

}  // namespace

// C entry point (loaded with ctypes): x and out are (rows, 512) f32.
extern "C" int topk_mask(const void* x, void* out, int rows, int k,
                         int device, void* stream) {
  if (rows == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  topk_mask_kernel<<<blocks, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, k);
  return static_cast<int>(cudaGetLastError());
}
