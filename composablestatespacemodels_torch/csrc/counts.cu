// K1: monotone systematic-resampling counts from the weights; K6 batched:
// the same counts for B chains at once.
//
// K1 replaces ops/scan_kernel.py::systematic_counts_cols of the JAX package
// (:550; _counts_cols_kernel :196, _counts_compute :125, _cummax_body :75)
// and, by value, its flat form systematic_counts_fused (:493).  K6 batched
// replaces the batched form under vmap, _counts_packed_call (:302; kernel
// _counts_kernel_packed :234), which pmmh_chains reaches when it vmaps the
// filter over chains.  Per row (chain):
//
//   cdf    = inclusive_prefix(w / total)
//   c      = clip(ceil(n*cdf - u), 0, n),  c[N-1] = n
//   counts = exact int32 running max of c
//
// `total` and `u` are device scalars, so no step synchronises with the host.
// n*cdf and -u are rounded separately (__fmul_rn / __fsub_rn), as the plain
// version rounds them.  The prefix accumulates in float64 in the fixed order
// of scan.cuh and rounds each entry to float32; the plain version
// (inference/resampling.py::_cumsum_ref) replays that order, so kernel and
// plain version see the same cdf bits.
//
// What bounds it on the H100: memory, one 4 MiB read of the weights and one
// 4 MiB write of the counts at N = 2^20 (~2.5 us at 3.35 TB/s); at that size
// the three launches cost more than the traffic.  The three-pass tile scan
// (tile sums of w/total; the tile's prefix, its counts and their running
// max; the running-max carry across tiles) is scan.cuh's, which K7a and K7b
// (scan.cu) share.  The TPU's column-packed count layouts and lane-replicated scalars do not
// carry over: the output is flat int32 [N], which K2 reads.
//
// K6 batched is K1 with the chain axis in the grid: grid (tiles, B), row b
// reads w[b, :], total[b] and u[b] and writes counts[b, :], in the same
// three passes.  Row b therefore equals K1 on row b bit for bit.  At the
// PMMH shape (N = 100, B = 256) every row is one tile: 2 launches of 256
// blocks, launch latency rather than bytes (100 KiB in, 100 KiB out).  The
// TPU packs several chains into one block-diagonal MXU pass; on Hopper one
// block per row does it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace cssm {

// w[i] / total, rounded as the plain version's float32 division; row r
// reads w[r, :] and total[r].
struct NormalisedWeight {
  const float* w;
  const float* total;
  int64_t n;
  __device__ __forceinline__ NormalisedWeight row(int r) const {
    return {w + (int64_t)r * n, total + r, n};
  }
  __device__ __forceinline__ float operator()(int64_t i) const {
    return __fdiv_rn(__ldg(w + i), __ldg(total));
  }
};

// Grid (tiles, rows): tile blockIdx.x of row blockIdx.y.
__global__ void __launch_bounds__(kThreads)
    counts_scan(NormalisedWeight rows, const float* __restrict__ u,
                const double* __restrict__ bsum, int* __restrict__ counts,
                int* __restrict__ bmax, int64_t n) {
  __shared__ double dsm[kWarps];
  __shared__ int ism[kWarps];
  const int64_t row = blockIdx.y, tiles = gridDim.x, b = blockIdx.x;
  float cdf[kItems];
  tile_prefix(rows.row(row), bsum + row * tiles, n, b, cdf, dsm);
  const float uu = __ldg(u + row);
  const float nf = (float)n;
  const int64_t base = b * kTile + threadIdx.x * kItems;
  int c[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    float v = ceilf(__fsub_rn(__fmul_rn(nf, cdf[k]), uu));
    v = fminf(fmaxf(v, 0.f), nf);
    c[k] = base + k == n - 1 ? (int)n : (int)v;
  }
  tile_cummax_store(c, counts + row * n, bmax + row * tiles, n, b, ism);
}

// The three passes over `rows` rows of n weights each.
int launch_counts(const void* w, const void* total, const void* u,
                  void* counts, void* bsum, void* bmax, int64_t rows,
                  int64_t n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)rows);
  cudaStream_t s = (cudaStream_t)stream;
  const NormalisedWeight load{(const float*)w, (const float*)total, n};
  tile_sums<<<grid, kThreads, 0, s>>>(load, (double*)bsum, n);
  counts_scan<<<grid, kThreads, 0, s>>>(load, (const float*)u,
                                        (const double*)bsum, (int*)counts,
                                        (int*)bmax, n);
  if (grid.x > 1) {
    cummax_carry<int><<<dim3(grid.x - 1, grid.y), kThreads, 0, s>>>(
        (int*)counts, (const int*)bmax, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace cssm

extern "C" int cssm_systematic_counts(const void* w, const void* total,
                                      const void* u, void* counts, void* bsum,
                                      void* bmax, int64_t n, int device,
                                      void* stream) {
  return cssm::launch_counts(w, total, u, counts, bsum, bmax, 1, n, device,
                             stream);
}

// K6 batched: w [rows, n], total [rows], u [rows] -> counts [rows, n]; bsum
// and bmax hold rows x tiles entries.
extern "C" int cssm_systematic_counts_batched(const void* w, const void* total,
                                              const void* u, void* counts,
                                              void* bsum, void* bmax,
                                              int64_t rows, int64_t n,
                                              int device, void* stream) {
  return cssm::launch_counts(w, total, u, counts, bsum, bmax, rows, n, device,
                             stream);
}
