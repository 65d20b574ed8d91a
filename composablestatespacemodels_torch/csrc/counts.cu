// K1: monotone systematic-resampling counts from the weights.
//
// Replaces ops/scan_kernel.py::systematic_counts_cols of the JAX package
// (:550; _counts_cols_kernel :196, _counts_compute :125, _cummax_body :75)
// and, by value, its flat form systematic_counts_fused (:493):
//
//   cdf    = inclusive_prefix(w / total)
//   c      = clip(ceil(n*cdf - u), 0, n),  c[N-1] = n
//   counts = exact int32 running max of c
//
// `total` and `u` are device scalars, so no step synchronises with the host.
// n*cdf and -u are rounded separately (__fmul_rn / __fsub_rn), as the plain
// version rounds them.  The prefix accumulates in float64 and rounds each
// entry to float32, as the plain version (inference/resampling.py::_cumsum)
// does: both then see the float32 rounding of the exact prefix whatever the
// summation order, and their counts agree except where a float64 prefix lies
// within ~1e-16 of a float32 rounding boundary.
//
// What bounds it on the H100: memory, one 4 MiB read of the weights and one
// 4 MiB write of the counts at N = 2^20 (~2.5 us at 3.35 TB/s); at that size
// the three launches cost more than the traffic.  The TPU kernel walks its
// grid in order and carries the prefix and the running max in SMEM from
// block to block; Hopper blocks run in parallel, so this is a three-pass
// scan:
//   1. counts_block_sums: each 4096-element tile's sum of w/total (float64);
//   2. counts_scan: each tile adds up the sums of the tiles before it (at
//      most a few thousand float64 reads from L2), scans its own elements,
//      writes counts running-maxed within the tile, and its tile maximum;
//   3. counts_carry: each tile takes the maximum of the tiles before it and
//      raises its counts to it -- a no-op, left after one read, unless a
//      float rounding dip crossed the tile boundary.
// The TPU's column-packed count layouts and lane-replicated scalars do not
// carry over: the output is flat int32 [N], which K2 reads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace cssm {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Deterministic block reductions and scans (fixed association order).
__device__ __forceinline__ double block_sum(double v, double* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double t = smem[lane];
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(kFull, t, o);
    if (lane == 0) smem[0] = t;
  }
  __syncthreads();
  const double total = smem[0];
  __syncthreads();
  return total;
}

__device__ __forceinline__ int block_max(int v, int* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(kFull, v, o));
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = smem[lane];
    for (int o = 16; o > 0; o >>= 1) t = max(t, __shfl_down_sync(kFull, t, o));
    if (lane == 0) smem[0] = t;
  }
  __syncthreads();
  const int m = smem[0];
  __syncthreads();
  return m;
}

__device__ __forceinline__ double block_exclusive_sum(double v, double* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double wi = smem[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const double t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    double we = __shfl_up_sync(kFull, wi, 1);
    smem[lane] = lane == 0 ? 0.0 : we;
  }
  __syncthreads();
  double ex = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) ex = 0.0;
  const double res = smem[warp] + ex;
  __syncthreads();
  return res;
}

__device__ __forceinline__ int block_exclusive_max(int v, int* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = max(incl, t);
  }
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int wi = smem[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi = max(wi, t);
    }
    const int we = __shfl_up_sync(kFull, wi, 1);
    smem[lane] = lane == 0 ? 0 : we;
  }
  __syncthreads();
  int ex = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) ex = 0;
  const int res = max(smem[warp], ex);
  __syncthreads();
  return res;
}

__global__ void __launch_bounds__(kThreads)
    counts_block_sums(const float* __restrict__ w,
                      const float* __restrict__ total,
                      double* __restrict__ bsum, int64_t n) {
  __shared__ double smem[kWarps];
  const float tot = __ldg(total);
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x * kItems;
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < n) acc += (double)__fdiv_rn(__ldg(w + i), tot);
  }
  const double s = block_sum(acc, smem);
  if (threadIdx.x == 0) bsum[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
    counts_scan(const float* __restrict__ w, const float* __restrict__ total,
                const float* __restrict__ u, const double* __restrict__ bsum,
                int* __restrict__ counts, int* __restrict__ bmax, int64_t n) {
  __shared__ double dsm[kWarps];
  __shared__ int ism[kWarps];
  const int b = blockIdx.x;
  double part = 0.0;
  for (int k = threadIdx.x; k < b; k += kThreads) part += bsum[k];
  const double offset = block_sum(part, dsm);

  const float tot = __ldg(total), uu = __ldg(u);
  const float nf = (float)n;
  const int64_t base = (int64_t)b * kTile + threadIdx.x * kItems;
  float xv[kItems];
  double tsum = 0.0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    xv[k] = i < n ? __fdiv_rn(__ldg(w + i), tot) : 0.f;
    tsum += (double)xv[k];
  }
  double p = offset + block_exclusive_sum(tsum, dsm);
  int c[kItems];
  int run = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    p += (double)xv[k];
    const float cdf = __double2float_rn(p);
    float v = ceilf(__fsub_rn(__fmul_rn(nf, cdf), uu));
    v = fminf(fmaxf(v, 0.f), nf);
    int ci = (int)v;
    if (i == n - 1) ci = (int)n;
    if (i >= n) ci = 0;
    run = max(run, ci);
    c[k] = run;
  }
  const int ex = block_exclusive_max(run, ism);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < n) counts[i] = max(c[k], ex);
  }
  if (threadIdx.x == kThreads - 1) bmax[b] = max(run, ex);
}

__global__ void __launch_bounds__(kThreads)
    counts_carry(int* __restrict__ counts, const int* __restrict__ bmax,
                 int64_t n) {
  __shared__ int ism[kWarps];
  __shared__ int need;
  const int b = blockIdx.x + 1;
  int part = 0;
  for (int k = threadIdx.x; k < b; k += kThreads) part = max(part, bmax[k]);
  const int carry = block_max(part, ism);
  const int64_t start = (int64_t)b * kTile;
  if (threadIdx.x == 0) need = counts[start] < carry;
  __syncthreads();
  if (!need) return;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = start + threadIdx.x * kItems + k;
    if (i < n) counts[i] = max(counts[i], carry);
  }
}

}  // namespace cssm

extern "C" int cssm_systematic_counts(const void* w, const void* total,
                                      const void* u, void* counts, void* bsum,
                                      void* bmax, int64_t n, int device,
                                      void* stream) {
  using namespace cssm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + kTile - 1) / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  counts_block_sums<<<blocks, kThreads, 0, s>>>(
      (const float*)w, (const float*)total, (double*)bsum, n);
  counts_scan<<<blocks, kThreads, 0, s>>>(
      (const float*)w, (const float*)total, (const float*)u,
      (const double*)bsum, (int*)counts, (int*)bmax, n);
  if (blocks > 1) {
    counts_carry<<<blocks - 1, kThreads, 0, s>>>((int*)counts,
                                                 (const int*)bmax, n);
  }
  return (int)cudaGetLastError();
}
