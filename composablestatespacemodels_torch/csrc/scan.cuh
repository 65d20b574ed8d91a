// The one tile scan behind every prefix producer of the port: K1 and K6
// batched (counts.cu), K7a / K7b (scan.cu) and the per-step prefix of K8
// (sweep.cu).
//
// The JAX package keeps one prefix implementation for every count producer
// (ops/scan_kernel.py:617-620), because a float32 prefix moves by ulps with
// its summation order and an ulp moves a count at ties.  Here the kernels
// share this header: a fixed tile of kThreads x kItems elements, a float64
// prefix rounded to float32 per entry, and an exact int32 running max.  The
// TPU walks its grid in order and carries the prefix and the running max in
// SMEM; Hopper blocks run in parallel.  K6 batched on rows longer than a
// tile scans in passes:
//   1. tile_sums: each tile's float64 sum;
//   2. tile_prefix (+ tile_cummax_store): each tile adds up the sums of the
//      tiles before it, scans its own elements and, for the running max,
//      writes its values maxed within the tile and its tile maximum;
//   3. cummax_carry: each tile takes the maximum of the tiles before it and
//      raises its values to it (left after one read when nothing crosses).
// K7a, K1 and K7b scan in one launch (take_tile .. finish_tile below): a block
// takes its tile from a ticket counter, publishes the tile's sum with a
// flag, waits for the flags of the tiles before it and adds their sums in
// pass 2's order, so the input is read once and the bits are the passes'
// bits.  K1 then publishes its tile maximum under a second flag and takes
// the maximum of the tiles before it (publish_and_carry): pass 3's carry,
// without a second read or write of the counts.  K7b takes only that carry
// (no sums).
// A row of at most one tile needs no pass 1 (no tile comes before it) and
// only ceil(n / 128) of the tile's warps (short tiles, below): K6 batched
// on such rows and K8 run blocks sized to the row with the same bits.
// Every float64 addition has a fixed association order (warp shuffles in a
// fixed tree, no atomics in the sums), which the plain PyTorch version
// (inference/resampling.py::_cumsum_ref) replays: kernel and plain version
// agree bit for bit.
//
// A scan may run over several independent rows at once (K6 batched: one row
// per chain): the grid is (tiles, rows), blockIdx.y is the row, and a Load
// functor's row(r) binds it to row r.  The device functions take the tile
// index and the row's pointers from their caller.
#pragma once
#include <climits>
#include <stdint.h>

namespace cssm {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ---- Short tiles ---------------------------------------------------------
//
// A row of n <= kTile elements fills only the first ceil(n / 128) warps of
// the tile; the threads past them hold items past n, which the sums take as
// +0.0 and the running max as INT_MIN.  So a block of `warps` >= ceil(n /
// 128) warps computes the tile's bits (K6 batched on short rows, K8): the
// block helpers below (but the int block_max, which only K1 and K7b use)
// take the number of warps in the block (kWarps by default, the whole
// tile) and their second tree reads the warps' values
// from shared memory below `warps` and an identity above it (0.0, INT_MIN;
// for the float maximum NaN, which fmaxf drops).  For the sum that is the
// 1024-thread tree on the very values the dropped warps would add, +0.0;
// the inclusive scans go by __shfl_up, which never carries a higher lane
// into a lower one.  With warps == 1 each warp stands alone, with no shared
// memory and no barrier: its sum is its warp's tree plus +0.0, which is
// exact because no sum of this header's is -0.0 (each starts from +0.0),
// and its exclusive scan is 0.0 + its lanes', likewise exact.  The warps
// may be the first of a larger block (K8): they meet at group_sync.

// The barrier of the block's first `warps` warps, the ones that run a
// block helper: __syncwarp for a warp on its own, __syncthreads for the
// whole tile, named barrier 1 for any other group (so the rest of the
// block may wait at barrier 0, __syncthreads, meanwhile).
__device__ __forceinline__ void group_sync(int warps) {
  if (warps == 1) {
    __syncwarp();
  } else if (warps == kWarps) {
    __syncthreads();
  } else {
    asm volatile("bar.sync 1, %0;" ::"r"(32 * warps) : "memory");
  }
}

__device__ __forceinline__ double block_sum(double v, double* smem,
                                            int warps = kWarps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (warps == 1) return __shfl_sync(kFull, v, 0);
  if (lane == 0) smem[warp] = v;
  group_sync(warps);
  if (warp == 0) {
    double t = lane < warps ? smem[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(kFull, t, o);
    if (lane == 0) smem[0] = t;
  }
  group_sync(warps);
  const double total = smem[0];
  group_sync(warps);
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

// The maximum over the block (fmaxf: a NaN loses to a number, so the result
// is the largest number passed, NaN only if every value is NaN, in any
// order of the tree).
__device__ __forceinline__ float block_max(float v, float* smem,
                                           int warps = kWarps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(kFull, v, o));
  if (warps == 1) return __shfl_sync(kFull, v, 0);
  if (lane == 0) smem[warp] = v;
  group_sync(warps);
  if (warp == 0) {
    float t = lane < warps ? smem[lane] : __int_as_float(0x7fffffff);
    for (int o = 16; o > 0; o >>= 1) {
      t = fmaxf(t, __shfl_down_sync(kFull, t, o));
    }
    if (lane == 0) smem[0] = t;
  }
  group_sync(warps);
  const float m = smem[0];
  group_sync(warps);
  return m;
}

__device__ __forceinline__ double block_exclusive_sum(double v, double* smem,
                                                      int warps = kWarps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  double ex = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) ex = 0.0;
  if (warps == 1) return ex;
  if (lane == 31) smem[warp] = incl;
  group_sync(warps);
  if (warp == 0) {
    double wi = lane < warps ? smem[lane] : 0.0;
    for (int o = 1; o < 32; o <<= 1) {
      const double t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    double we = __shfl_up_sync(kFull, wi, 1);
    smem[lane] = lane == 0 ? 0.0 : we;
  }
  group_sync(warps);
  const double res = smem[warp] + ex;
  group_sync(warps);
  return res;
}

__device__ __forceinline__ int block_exclusive_max(int v, int* smem,
                                                   int warps = kWarps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = max(incl, t);
  }
  int ex = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) ex = INT_MIN;
  if (warps == 1) return ex;
  if (lane == 31) smem[warp] = incl;
  group_sync(warps);
  if (warp == 0) {
    int wi = lane < warps ? smem[lane] : INT_MIN;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi = max(wi, t);
    }
    const int we = __shfl_up_sync(kFull, wi, 1);
    smem[lane] = lane == 0 ? INT_MIN : we;
  }
  group_sync(warps);
  const int res = max(smem[warp], ex);
  group_sync(warps);
  return res;
}

// clip(ceil(n*cdf - u), 0, n) of element i, n at i == n - 1: K1's count,
// with n*cdf and - u rounded separately as the plain version rounds them.
__device__ __forceinline__ int systematic_count(float cdf, float u, float nf,
                                                int64_t i, int64_t n) {
  float v = ceilf(__fsub_rn(__fmul_rn(nf, cdf), u));
  v = fminf(fmaxf(v, 0.f), nf);
  return i == n - 1 ? (int)n : (int)v;
}

// K1's counts of this thread's items base..base + kItems - 1 of a tile, on
// the block's first `warps` warps, from v (the normalised weights, 0.0 past
// n) and offset (the float64 sum of the row's tiles before this one, 0.0
// for the first): tile_prefix's order (the offset, the tile's exclusive
// scan, the items in turn), systematic_count, then tile_cummax_store's
// running max within the thread and across the warps.  K1, K6 batched and
// K8 all count here, so their counts agree bit for bit.  c[kItems - 1] is
// the running max at this thread's last item (at the tile's last thread,
// the tile's maximum).
__device__ __forceinline__ void tile_counts(const float (&v)[kItems],
                                            double offset, float u,
                                            int64_t base, int64_t n,
                                            double* dsm, int* ism,
                                            int (&c)[kItems],
                                            int warps = kWarps) {
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) s += (double)v[k];
  double p = offset + block_exclusive_sum(s, dsm, warps);
  const float nf = (float)n;
  int run = INT_MIN;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    p += (double)v[k];
    const int ck = base + k < n ? systematic_count(__double2float_rn(p), u,
                                                   nf, base + k, n)
                                : INT_MIN;
    run = max(run, ck);
    c[k] = run;
  }
  const int ex = block_exclusive_max(run, ism, warps);
#pragma unroll
  for (int k = 0; k < kItems; ++k) c[k] = max(c[k], ex);
}

// This thread's float64 sum of its kItems values of tile `tile`, in order.
template <class Load>
__device__ __forceinline__ double thread_sum(Load load, int64_t n,
                                             int64_t tile) {
  const int64_t base = tile * kTile + threadIdx.x * kItems;
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < n) acc += (double)load(i);
  }
  return acc;
}

// Pass 1: bsum[row][b] = float64 sum of tile b's values of the row.
template <class Load>
__global__ void __launch_bounds__(kThreads)
    tile_sums(Load rows, double* __restrict__ bsum, int64_t n) {
  __shared__ double smem[kWarps];
  const double s =
      block_sum(thread_sum(rows.row(blockIdx.y), n, blockIdx.x), smem);
  if (threadIdx.x == 0) {
    bsum[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// Pass 2: this thread's kItems inclusive prefixes of tile `b` of one row,
// accumulated in float64 (the sum of the earlier tiles' sums bsum[0..b), the
// tile's exclusive scan, then this thread's items in order) and each rounded
// to float32.
template <class Load>
__device__ __forceinline__ void tile_prefix(Load load,
                                            const double* __restrict__ bsum,
                                            int64_t n, int64_t b,
                                            float (&out)[kItems],
                                            double* smem) {
  double part = 0.0;
  for (int k = threadIdx.x; k < b; k += kThreads) part += bsum[k];
  const double offset = block_sum(part, smem);
  const int64_t base = (int64_t)b * kTile + threadIdx.x * kItems;
  float xv[kItems];
  double tsum = 0.0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    xv[k] = i < n ? load(i) : 0.f;
    tsum += (double)xv[k];
  }
  double p = offset + block_exclusive_sum(tsum, smem);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    p += (double)xv[k];
    out[k] = __double2float_rn(p);
  }
}

// Pass 2 of the running max: c[] (this thread's values of tile b of one
// row) maxed across the tile, stored to the row's out[], and the tile
// maximum to bmax[b].
__device__ __forceinline__ void tile_cummax_store(int (&c)[kItems],
                                                  int* __restrict__ out,
                                                  int* __restrict__ bmax,
                                                  int64_t n, int64_t b,
                                                  int* smem) {
  const int64_t base = b * kTile + threadIdx.x * kItems;
  int run = INT_MIN;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k >= n) c[k] = INT_MIN;
    run = max(run, c[k]);
    c[k] = run;
  }
  const int ex = block_exclusive_max(run, smem);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < n) out[i] = max(c[k], ex);
  }
  if (threadIdx.x == kThreads - 1) bmax[b] = max(run, ex);
}

// ---- The one-launch scan (K7a, K1, K7b) ---------------------------------
//
// The workspace (cached per device and stream by the wrapper, zeroed once
// when it is made, shared by K7a, K1 and K7b) holds a ticket counter, a
// count of finished blocks and, per tile, a 64-bit flag with a float64 sum
// (K7a, K1) and a second flag with the tile's int32 maximum (K1, K7b).
// Each call passes a fresh epoch (never 0): tile b's flag equals the epoch
// once its sum (or maximum) holds this call's, so flags left by earlier
// calls, of any of the three kernels, never satisfy a wait and no call
// clears them.
//   * Tiles are handed out in the order blocks start (take_tile), not by
//     blockIdx: a block only ever waits for tiles whose blocks already run,
//     so the scan cannot deadlock however many tiles there are.
//   * The last block to finish resets the two counters (finish_tile); the
//     next call on the same stream starts after it.  Two streams never
//     share a workspace, so their calls cannot interleave on it.
//   * A flag is written with st.release after the sum it guards and read
//     with ld.acquire before that sum is read through L2 (__ldcg).
//   * A ticket past the last tile, or a wait of seconds, can only mean a
//     corrupt workspace: the kernel traps (a launch error) instead of
//     hanging the card.
constexpr int kMaxSpins = 1 << 24;

struct ScanTile {
  unsigned long long flag;      // the epoch once sum holds this call's sum
  double sum;
};

struct ScanMax {
  unsigned long long flag;      // the epoch once max holds this call's max
  long long max;
};

struct ScanWorkspace {
  unsigned long long* ticket;   // tiles handed out in this call
  unsigned long long* done;     // blocks finished in this call
  ScanTile* tile;               // [capacity], flag and sum in one sector
  ScanMax* tile_max;            // [capacity], K1's and K7b's max carry
};

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The tile this block scans: the next ticket of this call.
__device__ __forceinline__ int64_t take_tile(const ScanWorkspace& ws,
                                             unsigned long long* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(ws.ticket, 1ull);
  __syncthreads();
  if (*slot >= gridDim.x) __trap();
  return (int64_t)*slot;
}

// Publish tile b's sum s (every thread passes it; thread 0 writes), then
// return the sum of the tiles before b in tile_prefix's order: thread k
// adds the sums of tiles k, k + kThreads, ... below b, each once its flag
// shows this call's epoch, and the block sums the threads' parts.
__device__ __forceinline__ double publish_and_offset(const ScanWorkspace& ws,
                                                     unsigned long long epoch,
                                                     int64_t b, double s,
                                                     double* smem) {
  if (threadIdx.x == 0) {
    ws.tile[b].sum = s;
    st_release(&ws.tile[b].flag, epoch);
  }
  double part = 0.0;
  for (int64_t k = threadIdx.x; k < b; k += kThreads) {
    for (int spins = 0; ld_acquire(&ws.tile[k].flag) != epoch; ++spins) {
      if (spins == kMaxSpins) __trap();
      __nanosleep(32);
    }
    part += __ldcg(&ws.tile[k].sum);
  }
  return block_sum(part, smem);
}

// Publish tile b's maximum m (thread kThreads - 1 holds it), then return
// the maximum of the tiles before b: thread k takes tiles k, k + kThreads,
// ... below b, each once its flag shows this call's epoch (an int max is
// exact in any order).  The tiles before b hold earlier tickets, so their
// blocks already run and publish without waiting for b.
__device__ __forceinline__ int publish_and_carry(const ScanWorkspace& ws,
                                                 unsigned long long epoch,
                                                 int64_t b, int m,
                                                 int* smem) {
  if (threadIdx.x == kThreads - 1) {
    ws.tile_max[b].max = m;
    st_release(&ws.tile_max[b].flag, epoch);
  }
  int part = INT_MIN;
  for (int64_t k = threadIdx.x; k < b; k += kThreads) {
    for (int spins = 0; ld_acquire(&ws.tile_max[k].flag) != epoch; ++spins) {
      if (spins == kMaxSpins) __trap();
      __nanosleep(32);
    }
    part = max(part, (int)__ldcg(&ws.tile_max[k].max));
  }
  return block_max(part, smem);
}

// Count this block finished; the last block of the call resets the
// counters for the next call on the stream.
__device__ __forceinline__ void finish_tile(const ScanWorkspace& ws,
                                            unsigned long long tiles) {
  if (threadIdx.x == 0) {
    if (atomicAdd(ws.done, 1ull) == tiles - 1) {
      *ws.ticket = 0ull;
      *ws.done = 0ull;
    }
  }
}

// Pass 3: tile b + 1 of row blockIdx.y raises its values to the maximum of
// the row's tiles 0..b (grid: tiles - 1 by rows).  Values within a tile are
// already nondecreasing, so one read of the tile's first value tells
// whether anything changes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cummax_carry(T* __restrict__ out, const T* __restrict__ bmax, int64_t n) {
  __shared__ int ism[kWarps];
  __shared__ int need;
  const int64_t row = blockIdx.y;
  out += row * n;
  bmax += row * (gridDim.x + 1);
  const int b = blockIdx.x + 1;
  T part = INT_MIN;
  for (int k = threadIdx.x; k < b; k += kThreads) part = max(part, bmax[k]);
  const T carry = block_max(part, ism);
  const int64_t start = (int64_t)b * kTile;
  if (threadIdx.x == 0) need = out[start] < carry;
  __syncthreads();
  if (!need) return;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = start + threadIdx.x * kItems + k;
    if (i < n) out[i] = max(out[i], carry);
  }
}

}  // namespace cssm
