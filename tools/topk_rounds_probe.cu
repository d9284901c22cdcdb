// Timing probe for the design choices of src/repro_torch/kernels/csrc/
// topk_mask.cu, built beside it by tools/topk_rounds_probe.py. Not part of
// the port: the kernel ships one of these choices.
//
// Every instance computes the reference's threshold (24 halvings of
// [0, row max]) over (rows, 512) f32, each row in one warp's registers,
// with the shipped kernel's helpers (included below), by one of:
//   list = 0: every step counts the whole row;
//   list = 1: the shipped scheme (whole-row steps until at most kListMax
//             entries lie in [lo, hi), then steps over that list);
// the steps counted `levels` (L) at a time: the 2^L - 1 thresholds of the
// next L steps (the tree of rounded midpoints rooted at (lo, hi)) counted
// in one pass, three 10-bit counts a word and one redux.sync a word, then
// the L steps taken on the counts (on the list, the last round takes what
// is left); and 2, 4 or 8 rows (warps) a block. Rows are whole and x and
// out 16-byte aligned (16-byte loads and stores only).
#include "../src/repro_torch/kernels/csrc/topk_mask.cu"

namespace {

// The warp's counts of |v| >= t[n] for the Nodes thresholds t.
template <int Nodes, int N>
__device__ __forceinline__ void count_nodes(const float (&v)[N],
                                            const float* t, int* c) {
  if constexpr (Nodes > 0) {
    constexpr int F = Nodes < 3 ? Nodes : 3;
    float tf[F];
#pragma unroll
    for (int f = 0; f < F; ++f) tf[f] = t[f];
    const unsigned w = warp_counts(v, tf);
#pragma unroll
    for (int f = 0; f < F; ++f) c[f] = field(w, f);
    count_nodes<Nodes - F>(v, t + F, c + F);
  }
}

// min(L, take) bisection steps over the values v, their thresholds
// counted in one pass.
template <int L, int N>
__device__ __forceinline__ void round_steps(const float (&v)[N], float& lo,
                                            float& hi, int k, int take) {
  constexpr int kNodes = (1 << L) - 1;
  float a[kNodes], b[kNodes], t[kNodes];
  a[0] = lo;
  b[0] = hi;
#pragma unroll
  for (int n = 0; n < kNodes; ++n) {
    t[n] = midpoint(a[n], b[n]);
    if (2 * n + 2 < kNodes) {
      a[2 * n + 1] = a[n];
      b[2 * n + 1] = t[n];
      a[2 * n + 2] = t[n];
      b[2 * n + 2] = b[n];
    }
  }
  int c[kNodes];
  count_nodes<kNodes>(v, t, c);
  int node = 0;
#pragma unroll
  for (int s = 0; s < L; ++s) {
    if (s < take) {
      int cn = 0;
#pragma unroll
      for (int j = 0; j < kNodes; ++j) cn = j == node ? c[j] : cn;
      const float tn = midpoint(lo, hi);  // == t[node]
      const bool more = cn > k;
      if (more) {
        lo = tn;
      } else {
        hi = tn;
      }
      node = 2 * node + 1 + (more ? 1 : 0);
    }
  }
}

template <bool kList, int L>
__device__ __forceinline__ float probe_threshold(const float (&v)[kPerLane],
                                                 int k, float* list,
                                                 int lane) {
  unsigned mbits = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    mbits = max(mbits, __float_as_uint(fabsf(v[j])));
  mbits = __reduce_max_sync(kFull, mbits);
  float hi = __uint_as_float(mbits);
  float lo = 0.0f;
  if constexpr (!kList) {
    for (int s = 0; s < kIters; s += L)
      round_steps<L>(v, lo, hi, k, kIters - s);
    return lo;
  } else {
    // csrc/topk_mask.cu threshold, the listed steps in rounds of L
    k = max(k, -1);
    if (mbits >= kListBelow) {
      for (int s = 0; s < kIters; ++s) bisect(v, lo, hi, k);
      return lo;
    }
    const float t0[2] = {midpoint(lo, hi), hi};
    const unsigned w0 = warp_counts(v, t0);
    int at_lo = kCols, at_hi = field(w0, 1);
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
    const float none = __uint_as_float(0x7fffffffu);
    const float w[2] = {lane < n ? list[lane] : none,
                        lane + 32 < n ? list[lane + 32] : none};
    for (; step < kIters; step += L)
      round_steps<L>(w, lo, hi, k - at_hi, kIters - step);
    return lo;
  }
}

template <bool kList, int L, int R>
__global__ void __launch_bounds__(32 * R)
    topk_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int rows, int k) {
  __shared__ float lists[kList ? R : 1][kListMax];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * R + warp;
  if (row >= rows) return;
  const long long base = static_cast<long long>(row) * kCols;
  float v[kPerLane];
  load_vec(x + base, lane, v);
  const float lo = probe_threshold<kList, L>(v, k, lists[kList ? warp : 0],
                                             lane);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) v[j] = fabsf(v[j]) >= lo ? v[j] : 0.0f;
  store_vec(out + base, lane, v);
}

template <bool kList, int L, int R>
cudaError_t launch_probe(const float* x, float* out, int rows, int k,
                         cudaStream_t stream) {
  topk_probe_kernel<kList, L, R>
      <<<(rows + R - 1) / R, 32 * R, 0, stream>>>(x, out, rows, k);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const float*, float*, int, int, cudaStream_t);

#define PROBE_ROWS(A, L) \
  { launch_probe<A, L, 2>, launch_probe<A, L, 4>, launch_probe<A, L, 8> }
#define PROBE_LEVELS(A) \
  { PROBE_ROWS(A, 1), PROBE_ROWS(A, 2), PROBE_ROWS(A, 3) }
// [list][levels - 1][rows a block: 2, 4, 8]
const Launch kLaunch[2][3][3] = {PROBE_LEVELS(false), PROBE_LEVELS(true)};
#undef PROBE_LEVELS
#undef PROBE_ROWS

}  // namespace

// C entry point (loaded with ctypes): x and out are (rows, 512) f32, both
// 16-byte aligned; list 0 or 1, levels 1-3, rows_a_block 2, 4 or 8.
extern "C" int topk_probe(const void* x, void* out, int rows, int k,
                          int list, int levels, int rows_a_block, int device,
                          void* stream) {
  const int r = rows_a_block == 2 ? 0 : rows_a_block == 4 ? 1
              : rows_a_block == 8 ? 2 : -1;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (rows < 0 || list < 0 || list > 1 || levels < 1 || levels > 3 ||
      r < 0 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return static_cast<int>(kLaunch[list][levels - 1][r](
      static_cast<const float*>(x), static_cast<float*>(out), rows, k,
      static_cast<cudaStream_t>(stream)));
}
