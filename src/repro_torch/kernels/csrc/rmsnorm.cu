// Row-wise RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel rmsnorm_pallas (the JAX package's
// kernels/rmsnorm.py:21, body _rmsnorm_kernel :14):
//   out = x * rsqrt(mean(x * x) + eps) * gamma, in f32, cast to x's dtype.
// x is f32 or bf16, gamma f32 (the caller casts it), D a multiple of 128.
//
// What bounds it on the card: 2 * elt bytes moved per element (x read once,
// out written once; 4 B of gamma per column) against 4 fp32 operations per
// element, so memory bandwidth: (4096, 3072) bf16 moves 50 MB, 15 us at
// 3.35 TB/s.
//
// Design (simple first): one block of 256 threads per row. Each thread sums
// the squares of its columns (strided by the block, so loads coalesce), a
// warp butterfly and one shared-memory pass give the row sum, mean = sum / D
// and r = 1 / sqrt(mean + eps) correctly rounded (__frsqrt_rn). The second
// pass reads x again (from L1/L2) and writes x * r * gamma, rounded to bf16
// with round-to-nearest-even where x is bf16. The sum is taken in another
// order than torch's or XLA's reduction, so results agree to a stated
// tolerance, not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ gamma,
                               T* __restrict__ out, int D, float eps) {
  __shared__ float part[kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * D;
  const T* xr = x + base;
  T* orow = out + base;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const float v = load(xr, c);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  acc = warp_sum(acc);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kThreads / 32 ? part[lane] : 0.0f);
    if (lane == 0) part[0] = acc;
  }
  __syncthreads();
  const float ms = __fdiv_rn(part[0], static_cast<float>(D));
  const float r = __frsqrt_rn(__fadd_rn(ms, eps));
  for (int c = threadIdx.x; c < D; c += kThreads)
    store(orow, c, __fmul_rn(__fmul_rn(load(xr, c), r), gamma[c]));
}

}  // namespace

// C entry point (loaded with ctypes): x and out are (rows, D), f32 when
// is_bf16 is 0 and bf16 otherwise; gamma is (D,) f32.
extern "C" int rmsnorm(const void* x, const void* gamma, void* out, int rows,
                       int D, int is_bf16, float eps, int device,
                       void* stream) {
  if (rows == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    rmsnorm_kernel<<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
        static_cast<__nv_bfloat16*>(out), D, eps);
  } else {
    rmsnorm_kernel<<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<float*>(out), D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
