// K1: monotone systematic-resampling counts from the weights, in one
// launch; K6 batched: the same counts for B chains at once.
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
// 4 MiB write of the counts at N = 2^20 (~2.5 us at 3.35 TB/s); below ~10 us
// the launch and the host.  K1 is one launch on scan.cuh's one-launch scan
// (K7a's): a block takes its tile from the ticket counter, loads its 4096
// weights once (one 16-byte load per thread where aligned) and divides
// them by total, publishes the tile's float64 sum, adds the earlier tiles'
// sums in the three-pass order, scans the tile and forms its counts and
// their running max within the tile.  Then it publishes the tile maximum
// under a second epoch-tagged flag and takes the maximum of the tiles
// before it (publish_and_carry), which is the carry of the running max, and
// writes the counts once.  Tile sums, maxima and flags live in the
// workspace that the wrapper keeps per device and stream, so a call
// allocates only its counts.  The TPU's column-packed count layouts and
// lane-replicated scalars do not carry over: the output is flat int32 [N],
// which K2 and K4 read.
//
// K6 batched is K1 with the chain axis in the grid: grid (tiles, B), row b
// reads w[b, :], total[b] and u[b] and writes counts[b, :], in scan.cuh's
// three passes (tile_sums, counts_scan, cummax_carry), which add and max
// in the same orders.  Row b therefore equals K1 on row b bit for bit.  At
// the PMMH shape (N = 100, B = 256) every row is one tile: 2 launches of
// 256 blocks, launch latency rather than bytes (100 KiB in, 100 KiB out).
// The TPU packs several chains into one block-diagonal MXU pass; on Hopper
// one block per row does it.
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

// clip(ceil(n*cdf - u), 0, n) of element i, n at i == n - 1.
__device__ __forceinline__ int systematic_count(float cdf, float u, float nf,
                                                int64_t i, int64_t n) {
  float v = ceilf(__fsub_rn(__fmul_rn(nf, cdf), u));
  v = fminf(fmaxf(v, 0.f), nf);
  return i == n - 1 ? (int)n : (int)v;
}

// K1 in one launch: see scan.cuh's one-launch scan for the workspace,
// tickets and flags.
__global__ void __launch_bounds__(kThreads)
    counts_one_launch(const float* __restrict__ w,
                      const float* __restrict__ total,
                      const float* __restrict__ u, int* __restrict__ counts,
                      int64_t n, ScanWorkspace ws, unsigned long long epoch,
                      unsigned long long tiles) {
  __shared__ double dsm[kWarps];
  __shared__ int ism[kWarps];
  __shared__ unsigned long long slot;
  const int64_t b = take_tile(ws, &slot);
  const int64_t base = b * kTile + threadIdx.x * kItems;
  const bool whole = base + kItems <= n;
  float raw[kItems];
  if (whole && ((uintptr_t)w & 15) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(w + base));
    raw[0] = q.x;
    raw[1] = q.y;
    raw[2] = q.z;
    raw[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      raw[k] = base + k < n ? __ldg(w + base + k) : 0.f;
    }
  }
  const float tot = __ldg(total);
  float v[kItems];
  double tsum = 0.0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    // tile_prefix's items (0 past n); thread_sum's order, in which the
    // items past n add 0.0 and change no sum
    v[k] = base + k < n ? __fdiv_rn(raw[k], tot) : 0.f;
    tsum += (double)v[k];
  }
  const double offset =
      publish_and_offset(ws, epoch, b, block_sum(tsum, dsm), dsm);
  // tile_prefix's order: the offset, the tile's exclusive scan, the items
  double p = offset + block_exclusive_sum(tsum, dsm);
  const float uu = __ldg(u);
  const float nf = (float)n;
  // tile_cummax_store's running max within the thread, then the tile
  int c[kItems];
  int run = INT_MIN;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    p += (double)v[k];
    const int ck = base + k < n ? systematic_count(__double2float_rn(p), uu,
                                                   nf, base + k, n)
                                : INT_MIN;
    run = max(run, ck);
    c[k] = run;
  }
  const int ex = block_exclusive_max(run, ism);
  // at thread kThreads - 1, max(run, ex) is the tile's maximum
  const int carry = publish_and_carry(ws, epoch, b, max(run, ex), ism);
  const int lift = max(ex, carry);
#pragma unroll
  for (int k = 0; k < kItems; ++k) c[k] = max(c[k], lift);
  if (whole && ((uintptr_t)counts & 15) == 0) {
    *reinterpret_cast<int4*>(counts + base) = make_int4(c[0], c[1], c[2],
                                                        c[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k < n) counts[base + k] = c[k];
    }
  }
  finish_tile(ws, tiles);
}

// Pass 2 of K6 batched.  Grid (tiles, rows): tile blockIdx.x of row
// blockIdx.y.
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
    c[k] = systematic_count(cdf[k], uu, nf, base + k, n);
  }
  tile_cummax_store(c, counts + row * n, bmax + row * tiles, n, b, ism);
}

}  // namespace cssm

// K1.  ws: the shared scan workspace of `capacity` tiles (ticket, done, a
// flag and a sum per tile, then a flag and a maximum per tile), zeroed when
// it was made; epoch: a value this workspace has not seen, never 0.  Sets
// the device only when it is not the current one.
extern "C" int cssm_systematic_counts(const void* w, const void* total,
                                      const void* u, void* counts, void* ws,
                                      int64_t capacity, int64_t n,
                                      unsigned long long epoch, int device,
                                      void* stream) {
  using namespace cssm;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (n <= 0 || epoch == 0 || tiles > capacity) {
    return (int)cudaErrorInvalidValue;
  }
  auto* words = (unsigned long long*)ws;
  const ScanWorkspace wsp{words, words + 1, (ScanTile*)(words + 2),
                          (ScanMax*)(words + 2 + 2 * capacity)};
  counts_one_launch<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)total, (const float*)u, (int*)counts, n,
      wsp, epoch, (unsigned long long)tiles);
  return (int)cudaGetLastError();
}

// K6 batched: w [rows, n], total [rows], u [rows] -> counts [rows, n] in
// three passes; bsum and bmax hold rows x tiles entries.
extern "C" int cssm_systematic_counts_batched(const void* w, const void* total,
                                              const void* u, void* counts,
                                              void* bsum, void* bmax,
                                              int64_t rows, int64_t n,
                                              int device, void* stream) {
  using namespace cssm;
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
