// Block-local top-k mask for Hopper (sm_90a).
//
// Replaces the TPU kernel topk_mask_pallas (the JAX package's
// kernels/topk_mask.py:43, body _topk_kernel :25) together with the
// padding and casts around it in blockwise_topk (kernels/ops.py:82). A flat
// input of d elements is cut into rows of 512; each row keeps the entries
// with |x| >= lo, where lo comes from 24 bisection halvings of [0, row
// max]: thr = 0.5 * (lo + hi); if count(|x| >= thr) > k then lo = thr else
// hi = thr. Ties at the threshold keep more than k, as in the reference. A
// dropped entry is +0.0: XLA compiles the reference's multiply by the 0/1
// mask into a select. The tail row's lanes past d read +0.0 (the
// reference's zero padding, without the padded copy) and store nothing.
// The element type is f32 or bf16 (its bits as uint16_t): the magnitudes
// are compared in f32, and a kept bf16 value is its own bits, so this is
// bitwise the reference's cast to f32, select and cast back.
//
// What bounds it on the card: 8 B moved per element (4 B for bf16) against
// ~27 fp32 operations and 24 integer adds an element, so the two bounds
// are close; but at the main-path sizes (237 rows for resnet9's 121,002
// parameters, one warp a row on 132 SMs) the time is each warp's serial
// chain. The first design counted all 16 values of a lane at every one of
// the 24 steps: 16 compares and selects and an add chain, then a 5-stage
// __shfl_xor_sync butterfly (a shuffle and a dependent add a stage), some
// 130-250 cycles a step; at 2^20 entries (2,048 rows, ~16 warps an SM)
// those instructions fill the issue slots too.
//
// Design: one warp a row, the row in registers (16 values a lane), two
// rows a block. The row max is one __reduce_max_sync on the bit patterns
// of |x| (non-negative floats sort as unsigned integers, and fabsf's NaN
// sorts above +inf, so the max is NaN where the reference's is; its payload
// never reaches the output). A count is each lane's counts in 10-bit
// fields of a word (a row's count is <= 512, so no field carries) summed
// with one __reduce_add_sync. Every threshold lies in [lo, hi] (the rounded
// midpoint of two non-negative floats, while lo + hi cannot overflow), so
// count(|x| >= thr) = count(|x| >= hi) + the count over the entries in
// [lo, hi) alone. The first step counts its threshold and hi in one word;
// from then on a step knows count(|x| >= lo) and count(|x| >= hi), hence
// how many entries are still in [lo, hi). While more than kListMax are, a
// step counts the whole row; once at most kListMax are (after 1-4 steps
// on a Gaussian row), the warp writes them to a list in shared memory (a
// ballot a value), each lane takes two, and every remaining step counts
// two values a lane, offset by count(|x| >= hi). A row whose max is 2^126
// or more (inf and NaN included) counts the whole row at every step, and
// so does a row that keeps more than kListMax entries in [lo, hi) (ties,
// or the zeros of a row with at most k nonzeros); on 2,048 such sparse
// rows it is still a little faster than the first design.
// Counting the thresholds of L = 2 or 3 steps in one pass (a tree of
// 2^L - 1, three counts a word) and 4 or 8 rows a block are timed against
// this by tools/topk_rounds_probe.py: never faster by more than 0.0002 ms,
// L = 2 and 3 slower from 1,056 rows on, so the kernel keeps one step a
// count on 2 rows a block. Rows wholly below d, from 16-byte-aligned x and
// out, load and store 16-byte vectors; the tail row and misaligned views
// use 2- or 4-byte accesses. Every step is exact (max, compares, integer
// counts, the rounded midpoint), so the result is bitwise the reference's.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 512;
constexpr int kPerLane = kCols / 32;
constexpr int kIters = 24;
constexpr int kFieldBits = 10;     // a row's count is <= 512 < 2^10
constexpr unsigned kFieldMask = (1u << kFieldBits) - 1;
constexpr int kListMax = 64;       // entries of [lo, hi) listed, 2 a lane
constexpr unsigned kListBelow = 0x7e800000u;  // 2^126: lo + hi stays finite
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 2;           // rows (warps) a block

// f32 and bf16 (as its bits) to f32 and back; a kept value is its own
// bits, a dropped one +0.0, so the conversion back is exact
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, uint16_t* p) {
  *p = static_cast<uint16_t>(__float_as_uint(v) >> 16);
}

// The row in registers. Vector path: lane l holds the 16-byte vectors
// l + 32 q of the row (4 of f32, 2 of bf16), each load coalesced. Scalar
// path: lane l holds elements l + 32 j, +0.0 past the row's `live`.
__device__ __forceinline__ void load_vec(const float* xr, int lane,
                                         float (&v)[kPerLane]) {
  const float4* p = reinterpret_cast<const float4*>(xr);
#pragma unroll
  for (int q = 0; q < kPerLane / 4; ++q) {
    const float4 a = p[lane + 32 * q];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}
__device__ __forceinline__ void load_vec(const uint16_t* xr, int lane,
                                         float (&v)[kPerLane]) {
  const uint4* p = reinterpret_cast<const uint4*>(xr);
#pragma unroll
  for (int q = 0; q < kPerLane / 8; ++q) {
    const uint4 a = p[lane + 32 * q];
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[8 * q + 2 * e] = __uint_as_float(w[e] << 16);
      v[8 * q + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}
__device__ __forceinline__ void store_vec(float* orow, int lane,
                                          const float (&v)[kPerLane]) {
  float4* p = reinterpret_cast<float4*>(orow);
#pragma unroll
  for (int q = 0; q < kPerLane / 4; ++q)
    p[lane + 32 * q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                   v[4 * q + 3]);
}
__device__ __forceinline__ void store_vec(uint16_t* orow, int lane,
                                          const float (&v)[kPerLane]) {
  uint4* p = reinterpret_cast<uint4*>(orow);
#pragma unroll
  for (int q = 0; q < kPerLane / 8; ++q) {
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = (__float_as_uint(v[8 * q + 2 * e]) >> 16) |
             (__float_as_uint(v[8 * q + 2 * e + 1]) & 0xffff0000u);
    p[lane + 32 * q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

__device__ __forceinline__ int field(unsigned word, int f) {
  return static_cast<int>((word >> (kFieldBits * f)) & kFieldMask);
}

// The warp's count of |v| >= t[f] in field f, for F <= 3 thresholds: each
// lane's counts packed into one word, summed with one redux.sync.
template <int F, int N>
__device__ __forceinline__ unsigned warp_counts(const float (&v)[N],
                                                const float (&t)[F]) {
  unsigned c[F];
#pragma unroll
  for (int f = 0; f < F; ++f) c[f] = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float m = fabsf(v[j]);
#pragma unroll
    for (int f = 0; f < F; ++f) c[f] += m >= t[f] ? 1u : 0u;
  }
  unsigned packed = 0;
#pragma unroll
  for (int f = 0; f < F; ++f) packed |= c[f] << (kFieldBits * f);
  return __reduce_add_sync(kFull, packed);
}

// One bisection step over the values v (N a lane), its count taken
// against k.
template <int N>
__device__ __forceinline__ void bisect(const float (&v)[N], float& lo,
                                       float& hi, int k) {
  const float t[1] = {midpoint(lo, hi)};
  if (field(warp_counts(v, t), 0) > k) {
    lo = t[0];
  } else {
    hi = t[0];
  }
}

// The 24 steps of one row (v its 16 values a lane) -> lo.
__device__ __forceinline__ float threshold(const float (&v)[kPerLane], int k,
                                           float* list, int lane) {
  unsigned mbits = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    mbits = max(mbits, __float_as_uint(fabsf(v[j])));
  mbits = __reduce_max_sync(kFull, mbits);
  float hi = __uint_as_float(mbits);
  float lo = 0.0f;
  k = max(k, -1);  // every count is > k for k < 0, and k - 512 stays an int
  if (mbits >= kListBelow) {
    for (int s = 0; s < kIters; ++s) bisect(v, lo, hi, k);
    return lo;
  }
  // the first step, with count(|x| >= hi) beside its own
  const float t0[2] = {midpoint(lo, hi), hi};
  const unsigned w0 = warp_counts(v, t0);
  int at_lo = kCols, at_hi = field(w0, 1);  // count(|x| >= lo), (>= hi)
  if (field(w0, 0) > k) {
    lo = t0[0];
    at_lo = field(w0, 0);
  } else {
    hi = t0[0];
    at_hi = field(w0, 0);
  }
  int step = 1;
  for (; step < kIters && at_lo - at_hi > kListMax; ++step) {
    const float t[1] = {midpoint(lo, hi)};
    const int c = field(warp_counts(v, t), 0);
    if (c > k) {
      lo = t[0];
      at_lo = c;
    } else {
      hi = t[0];
      at_hi = c;
    }
  }
  if (step == kIters) return lo;
  // list the entries of [lo, hi): at most kListMax
  const unsigned below = (1u << lane) - 1;
  int n = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float m = fabsf(v[j]);
    const bool in = m >= lo && m < hi;
    const unsigned ballot = __ballot_sync(kFull, in);
    const int at = n + __popc(ballot & below);
    if (in && at < kListMax) list[at] = m;
    n += __popc(ballot);
  }
  __syncwarp();
  const float none = __uint_as_float(0x7fffffffu);  // a NaN: never counted
  const float w[2] = {lane < n ? list[lane] : none,
                      lane + 32 < n ? list[lane + 32] : none};
  const int kl = k - at_hi;  // the list's count against k less count(>= hi)
  for (; step < kIters; ++step) bisect(w, lo, hi, kl);
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(32 * kRows)
    topk_mask_kernel(const T* __restrict__ x, T* __restrict__ out,
                     long long d, int k, int vec) {
  __shared__ float lists[kRows][kListMax];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kRows + warp) * kCols;
  if (base >= d) return;  // the whole warp leaves together
  const T* xr = x + base;
  T* orow = out + base;
  const bool whole = vec && base + kCols <= d;
  const int live = static_cast<int>(min(d - base,
                                        static_cast<long long>(kCols)));
  float v[kPerLane];
  if (whole) {
    load_vec(xr, lane, v);
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      v[j] = lane + 32 * j < live ? to_f32(xr[lane + 32 * j]) : 0.0f;
  }
  const float lo = threshold(v, k, lists[warp], lane);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) v[j] = fabsf(v[j]) >= lo ? v[j] : 0.0f;
  if (whole) {
    store_vec(orow, lane, v);
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (lane + 32 * j < live) from_f32(v[j], orow + lane + 32 * j);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long d, int k,
                   cudaStream_t stream) {
  const long long rows = (d + kCols - 1) / kCols;
  const long long blocks = (rows + kRows - 1) / kRows;
  const int vec = ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  topk_mask_kernel<T><<<static_cast<unsigned>(blocks), 32 * kRows, 0,
                        stream>>>(static_cast<const T*>(x),
                                  static_cast<T*>(out), d, k, vec);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes): x and out hold d contiguous elements
// of elt_bytes (4: f32, 2: bf16).
extern "C" int topk_mask_flat(const void* x, void* out, long long d, int k,
                              int elt_bytes, int device, void* stream) {
  if (d < 0 || (elt_bytes != 2 && elt_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(elt_bytes == 4
                              ? launch<float>(x, out, d, k, s)
                              : launch<uint16_t>(x, out, d, k, s));
}
