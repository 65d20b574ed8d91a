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
// K6 batched is K1 on each row of [B, N]: row b reads w[b, :], total[b]
// and u[b] and writes counts[b, :], adding and maxing in K1's orders, so
// row b equals K1 on row b bit for bit.  At PMMH's shapes (N = 100 to
// 1024, B = 256) every row is one tile, and the call is launch latency
// rather than bytes (100 KiB in, 100 KiB out at [256, 100]).  A row of
// n <= kTile needs no tile sums (no tile comes before it) and only
// ceil(n / 128) warps of the tile (scan.cuh, short tiles), so such a call
// is one launch of counts_short_rows with no workspace: one block of
// ceil(n / 128) warps per row, or, for n <= 128, one warp per row and
// kShortRows rows to a block, with no barrier.  Rows longer than a tile
// keep scan.cuh's three passes (tile_sums, counts_scan, cummax_carry):
// three launches and a workspace of tile sums and maxima.  The TPU packs
// several chains into one block-diagonal MXU pass; on Hopper a block, or a
// warp, per row does it.
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
  int c[kItems];
  tile_counts(v, offset, __ldg(u), base, n, dsm, ism, c);
  // at thread kThreads - 1, c[kItems - 1] is the tile's maximum
  const int carry = publish_and_carry(ws, epoch, b, c[kItems - 1], ism);
#pragma unroll
  for (int k = 0; k < kItems; ++k) c[k] = max(c[k], carry);
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

// Rows of n <= 128 to a block in K6 batched's one launch, one warp each
// (on an H100 at [256, 100], 1, 2, 4 and 8 rows a block ran within 0.0001
// ms of each other, 4 the fastest).
constexpr int kShortRows = 4;

// K6 batched on rows of n <= kTile in one launch.  A group of `warps` =
// ceil(n / 128) warps scans one row, thread t holding the row's items
// 4t..4t+3 as in K1's tile; with warps == 1 a block holds several groups
// (rows), each a warp on its own.
__global__ void __launch_bounds__(kThreads)
    counts_short_rows(const float* __restrict__ w,
                      const float* __restrict__ total,
                      const float* __restrict__ u, int* __restrict__ counts,
                      int64_t rows, int64_t n, int warps) {
  __shared__ double dsm[kWarps];
  __shared__ int ism[kWarps];
  const int group = threadIdx.x / (32 * warps);
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / (32 * warps)) +
                      group;
  if (row >= rows) return;  // whole groups: only for warps == 1, no barrier
  const int64_t base = (int64_t)(threadIdx.x - group * 32 * warps) * kItems;
  const bool whole = base + kItems <= n;
  w += row * n;
  counts += row * n;
  float raw[kItems];
  if (whole && ((uintptr_t)(w + base) & 15) == 0) {
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
  const float tot = __ldg(total + row);
  float v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = base + k < n ? __fdiv_rn(raw[k], tot) : 0.f;
  }
  // the offset is 0.0: no tile comes before
  int c[kItems];
  tile_counts(v, 0.0, __ldg(u + row), base, n, dsm, ism, c, warps);
  if (whole && ((uintptr_t)(counts + base) & 15) == 0) {
    *reinterpret_cast<int4*>(counts + base) = make_int4(c[0], c[1], c[2],
                                                        c[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k < n) counts[base + k] = c[k];
    }
  }
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

// K6 batched: w [rows, n], total [rows], u [rows] -> counts [rows, n].
// Rows of n <= kTile: one launch, bsum and bmax unused (may be null); rows
// of n <= 128 go kShortRows to a block.  Longer rows: three passes, bsum
// and bmax hold rows x tiles entries.  Sets the device only when it is not
// the current one.
extern "C" int cssm_systematic_counts_batched(const void* w, const void* total,
                                              const void* u, void* counts,
                                              void* bsum, void* bmax,
                                              int64_t rows, int64_t n,
                                              int device, void* stream) {
  using namespace cssm;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= kTile) {
    const int warps = (int)((n + 32 * kItems - 1) / (32 * kItems));
    const int per_block = warps == 1 ? kShortRows : 1;
    counts_short_rows<<<(unsigned)((rows + per_block - 1) / per_block),
                        32 * warps * per_block, 0, s>>>(
        (const float*)w, (const float*)total, (const float*)u, (int*)counts,
        rows, n, warps);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)rows);
  const NormalisedWeight load{(const float*)w, (const float*)total, n};
  tile_sums<<<grid, kThreads, 0, s>>>(load, (double*)bsum, n);
  counts_scan<<<grid, kThreads, 0, s>>>(load, (const float*)u,
                                        (const double*)bsum, (int*)counts,
                                        (int*)bmax, n);
  cummax_carry<int><<<dim3(grid.x - 1, grid.y), kThreads, 0, s>>>(
      (int*)counts, (const int*)bmax, n);
  return (int)cudaGetLastError();
}
