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
// Design. A row is nvec 16-byte vectors (8 bf16 or 4 f32). Each thread
// of a block owns vectors tid, tid + blockDim, ... (VPT of them, a
// template parameter the wrapper picks from D: at D = 3072, 128 threads x
// 3 vectors in bf16 and x 6 in f32), so neighbouring threads load
// neighbouring 16 bytes. The row is read ONCE: its vectors stay in
// registers through the reduction and the outputs leave as 16-byte
// stores. The grid holds as many blocks as fit on the SMs at once, each
// looping over rows, so each thread loads its gamma slice into registers
// once for all its rows, and issues the loads of its next row before it
// reduces the current one, so a row's memory latency overlaps the
// previous row's barrier and stores. The row sum: each thread's squares
// in order, a warp butterfly, one shared-memory pass (double-buffered by
// row parity, so one barrier a row); mean = sum / D and r = 1 / sqrt(mean
// + eps) correctly rounded (__frsqrt_rn), outputs x * r * gamma rounded to
// bf16 with round-to-nearest-even (__float2bfloat16_rn) where x is bf16.
//
// Rows wider than 512 threads x 8 vectors take the looped kernel: the same
// reduction, the row read a second time for the outputs and gamma read
// from global memory. The sums are taken in another order than torch's or
// XLA's reduction, so results agree to a stated tolerance, not bitwise.
//
// The 16-byte accesses need x, out and gamma 16-byte aligned: the wrapper
// checks and raises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;

template <typename T>
struct Lanes;  // elements of T in one 16-byte vector
template <>
struct Lanes<float> {
  static constexpr int n = 4;
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32 bits.
// Element 2i is the low half of word i (little-endian).
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The row's sum of squares from each thread's partial `acc` (every thread
// returns the same value): warp butterfly, then one pass over the warps'
// sums in part[parity], which alternates by row so one barrier a row
// suffices.
__device__ __forceinline__ float block_sum(float acc, float (*part)[32],
                                           int parity) {
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) part[parity][threadIdx.x >> 5] = acc;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
    total = __fadd_rn(total, part[parity][w]);
  return total;
}

__device__ __forceinline__ float inv_rms(float total, int D, float eps) {
  return __frsqrt_rn(__fadd_rn(__fdiv_rn(total, static_cast<float>(D)), eps));
}

// This thread's VPT vectors of row r (zeros past the row or past rows).
template <int VPT>
__device__ __forceinline__ void load_row(const uint4* __restrict__ x, int r,
                                         int rows, int nvec,
                                         uint4 (&raw)[VPT]) {
  const uint4* xr = x + static_cast<long long>(r) * nvec;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int c = threadIdx.x + v * blockDim.x;
    raw[v] = (r < rows && c < nvec) ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_registers(const uint4* __restrict__ x,
                      const float4* __restrict__ gamma,
                      uint4* __restrict__ out, int rows, int nvec, int D,
                      float eps) {
  constexpr int E = Lanes<T>::n;
  constexpr int G = E / 4;  // float4s of gamma per vector
  __shared__ float part[2][32];
  float g[VPT][E];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int c = threadIdx.x + v * blockDim.x;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float4 q = c < nvec ? gamma[c * G + i]
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      g[v][4 * i] = q.x;
      g[v][4 * i + 1] = q.y;
      g[v][4 * i + 2] = q.z;
      g[v][4 * i + 3] = q.w;
    }
  }
  uint4 raw[VPT];
  load_row(x, blockIdx.x, rows, nvec, raw);
  int parity = 0;
  for (int r = blockIdx.x; r < rows; r += gridDim.x, parity ^= 1) {
    uint4 next[VPT];  // the block's next row, in flight during this one
    load_row(x, r + gridDim.x, rows, nvec, next);
    uint4* orow = out + static_cast<long long>(r) * nvec;
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      float f[E];
      unpack(raw[v], f);
#pragma unroll
      for (int e = 0; e < E; ++e) acc = __fadd_rn(acc, __fmul_rn(f[e], f[e]));
    }
    const float rs = inv_rms(block_sum(acc, part, parity), D, eps);
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int c = threadIdx.x + v * blockDim.x;
      if (c < nvec) {
        float f[E];
        unpack(raw[v], f);
#pragma unroll
        for (int e = 0; e < E; ++e)
          f[e] = __fmul_rn(__fmul_rn(f[e], rs), g[v][e]);
        orow[c] = pack(f);
      }
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) raw[v] = next[v];
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_looped(const uint4* __restrict__ x,
                   const float4* __restrict__ gamma,
                   uint4* __restrict__ out, int rows, int nvec, int D,
                   float eps) {
  constexpr int E = Lanes<T>::n;
  constexpr int G = E / 4;
  __shared__ float part[2][32];
  int parity = 0;
  for (int r = blockIdx.x; r < rows; r += gridDim.x, parity ^= 1) {
    const uint4* xr = x + static_cast<long long>(r) * nvec;
    uint4* orow = out + static_cast<long long>(r) * nvec;
    float acc = 0.0f;
    for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
      float f[E];
      unpack(xr[c], f);
#pragma unroll
      for (int e = 0; e < E; ++e) acc = __fadd_rn(acc, __fmul_rn(f[e], f[e]));
    }
    const float rs = inv_rms(block_sum(acc, part, parity), D, eps);
    for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
      float f[E];
      unpack(xr[c], f);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float4 q = gamma[c * G + i];
        f[4 * i] = __fmul_rn(__fmul_rn(f[4 * i], rs), q.x);
        f[4 * i + 1] = __fmul_rn(__fmul_rn(f[4 * i + 1], rs), q.y);
        f[4 * i + 2] = __fmul_rn(__fmul_rn(f[4 * i + 2], rs), q.z);
        f[4 * i + 3] = __fmul_rn(__fmul_rn(f[4 * i + 3], rs), q.w);
      }
      orow[c] = pack(f);
    }
  }
}

using Kernel = void (*)(const uint4*, const float4*, uint4*, int, int, int,
                        float);

template <typename T>
Kernel pick(int vpt) {
  switch (vpt) {
    case 0: return rmsnorm_looped<T>;
    case 1: return rmsnorm_registers<T, 1>;
    case 2: return rmsnorm_registers<T, 2>;
    case 3: return rmsnorm_registers<T, 3>;
    case 4: return rmsnorm_registers<T, 4>;
    case 5: return rmsnorm_registers<T, 5>;
    case 6: return rmsnorm_registers<T, 6>;
    case 7: return rmsnorm_registers<T, 7>;
    case 8: return rmsnorm_registers<T, 8>;
    default: return nullptr;
  }
}

// Blocks of `threads` of kernel k that fit on `device` at once, computed at
// a kernel's first launch and then looked up, so a launch inside a CUDA
// graph capture makes no occupancy query.
cudaError_t resident_blocks(Kernel k, int threads, int device, int* out) {
  struct Entry {
    Kernel k;
    int threads, device, blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].k == k && cache[i].threads == threads &&
        cache[i].device == device) {
      *out = cache[i].blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(k), threads, 0);
  if (err != cudaSuccess) return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (used < 64) cache[used++] = Entry{k, threads, device, *out};
  return cudaSuccess;
}

}  // namespace

// C entry point (loaded with ctypes): x and out are (rows, D), f32 when
// is_bf16 is 0 and bf16 otherwise, gamma (D,) f32, all 16-byte aligned.
// `vpt` is the vectors a thread keeps in registers (1..8), or 0 for the
// looped kernel; `threads` the block size (a multiple of 32, <= 512). The
// grid is as many blocks as fit on the card at once, capped at rows.
extern "C" int rmsnorm(const void* x, const void* gamma, void* out, int rows,
                       int D, int is_bf16, int vpt, int threads, float eps,
                       int device, void* stream) {
  if (rows == 0) return 0;
  const Kernel k = is_bf16 ? pick<__nv_bfloat16>(vpt) : pick<float>(vpt);
  if (k == nullptr || threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int fit = 0;
  err = resident_blocks(k, threads, device, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = fit < rows ? fit : rows;
  const int nvec = D * (is_bf16 ? 2 : 4) / 16;
  k<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const float4*>(gamma),
      static_cast<uint4*>(out), rows, nvec, D, eps);
  return static_cast<int>(cudaGetLastError());
}
