// K7a: inclusive float32 prefix sum of [N]; K7b: exact int32 running max of
// [N].
//
// Replaces ops/scan_kernel.py::prefix_sum (:613; _prefix_core :406,
// _scan_kernel :49) and ops/scan_kernel.py::cummax_int32 (:480; _cummax_core
// :424, _cummax_kernel :102) of the JAX package, which resampling._cumsum
// and resampling._monotone_counts call on the device (resampling.py:40-43,
// :59-62): the stratified counts are built from them.
//
//   K7a: out[i] = float32(sum_{k <= i} x[k])   accumulated in float64
//   K7b: out[i] = max_{k <= i} c[k]            exact
//
// Both use the tile scan of scan.cuh, which K1 (counts.cu) uses too, so
// every prefix of the port adds in one order; the plain versions
// (inference/resampling.py::_cumsum_ref, torch.cummax) agree bit for bit.
// The TPU computes the prefix as blocked float32 matmuls on the MXU; here it
// is a float64 scan, which rounds once per entry.
//
// What bounds them on the H100: memory, 4 MiB in and 4 MiB out at N = 2^20
// (~2.5 us at 3.35 TB/s), and below ~10 us the launch and the host.  K7a
// is one launch (scan.cuh's take_tile .. finish_tile): each block loads its
// 4096 floats once, as one 16-byte load per thread where the address is
// 16-byte aligned (scalar loads otherwise, in the same kernel), publishes
// the tile's sum, adds the sums of the tiles before it in the three-pass
// order and writes its prefix once.  Its flags and tile sums live in a
// workspace that the wrapper keeps per device and stream (K1 shares it),
// so a call allocates only its output.  K7b is the same one launch with an
// int32 maximum: each tile publishes its maximum under the second flag and
// raises its values to the maximum of the tiles before it, as K1's carry
// does, in the same workspace.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace cssm {

// The one-launch prefix sum: see scan.cuh's one-launch scan for the
// workspace, tickets and flags.
__global__ void __launch_bounds__(kThreads)
    prefix_scan(const float* __restrict__ x, float* __restrict__ out,
                int64_t n, ScanWorkspace ws, unsigned long long epoch,
                unsigned long long tiles) {
  __shared__ double dsm[kWarps];
  __shared__ unsigned long long slot;
  const int64_t b = take_tile(ws, &slot);
  const int64_t base = b * kTile + threadIdx.x * kItems;
  const bool whole = base + kItems <= n;
  float v[kItems];
  if (whole && ((uintptr_t)x & 15) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(x + base));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = base + k < n ? __ldg(x + base + k) : 0.f;
    }
  }
  // thread_sum's order; the items past n add 0.0, which changes no sum
  double tsum = 0.0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) tsum += (double)v[k];
  const double offset =
      publish_and_offset(ws, epoch, b, block_sum(tsum, dsm), dsm);
  // tile_prefix's order: the offset, the tile's exclusive scan, the items
  double p = offset + block_exclusive_sum(tsum, dsm);
  float o[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    p += (double)v[k];
    o[k] = __double2float_rn(p);
  }
  if (whole && ((uintptr_t)out & 15) == 0) {
    *reinterpret_cast<float4*>(out + base) =
        make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k < n) out[base + k] = o[k];
    }
  }
  finish_tile(ws, tiles);
}

// The one-launch running max: the same scan with an int32 maximum in
// place of the float64 sum (see scan.cuh's one-launch scan).  Each tile
// maxes its values within the thread and across the tile (tile_cummax_store's
// arithmetic), publishes its maximum under the epoch-tagged flag of the
// workspace's second half and raises its values to the maximum of the tiles
// before it (publish_and_carry, K1's carry).  An int max is exact in any
// order, so the result equals torch.cummax bit for bit.
__global__ void __launch_bounds__(kThreads)
    cummax_one_launch(const int* __restrict__ x, int* __restrict__ out,
                      int64_t n, ScanWorkspace ws, unsigned long long epoch,
                      unsigned long long tiles) {
  __shared__ int ism[kWarps];
  __shared__ unsigned long long slot;
  const int64_t b = take_tile(ws, &slot);
  const int64_t base = b * kTile + threadIdx.x * kItems;
  const bool whole = base + kItems <= n;
  int c[kItems];
  if (whole && ((uintptr_t)x & 15) == 0) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(x + base));
    c[0] = q.x;
    c[1] = q.y;
    c[2] = q.z;
    c[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      c[k] = base + k < n ? __ldg(x + base + k) : INT_MIN;
    }
  }
  // the items past n are INT_MIN, which raise no maximum
  int run = INT_MIN;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run = max(run, c[k]);
    c[k] = run;
  }
  const int ex = block_exclusive_max(run, ism);
#pragma unroll
  for (int k = 0; k < kItems; ++k) c[k] = max(c[k], ex);
  // at thread kThreads - 1, c[kItems - 1] is the tile's maximum
  const int carry = publish_and_carry(ws, epoch, b, c[kItems - 1], ism);
#pragma unroll
  for (int k = 0; k < kItems; ++k) c[k] = max(c[k], carry);
  if (whole && ((uintptr_t)out & 15) == 0) {
    *reinterpret_cast<int4*>(out + base) = make_int4(c[0], c[1], c[2], c[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k < n) out[base + k] = c[k];
    }
  }
  finish_tile(ws, tiles);
}

}  // namespace cssm

// ws: the shared workspace (ticket, done, then a flag and a sum per tile;
// K7a reads the first 2 + 2 * tiles 64-bit words), zeroed when it was made;
// epoch: a value this workspace has not seen, never 0.  Sets the device
// only when it is not the current one.
extern "C" int cssm_prefix_sum(const void* x, void* out, void* ws, int64_t n,
                               unsigned long long epoch, int device,
                               void* stream) {
  using namespace cssm;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || epoch == 0) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + kTile - 1) / kTile;
  auto* words = (unsigned long long*)ws;
  const ScanWorkspace w{words, words + 1, (ScanTile*)(words + 2), nullptr};
  prefix_scan<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n, w, epoch,
      (unsigned long long)tiles);
  return (int)cudaGetLastError();
}

// ws: the shared workspace of `capacity` tiles (ticket, done, a flag and a
// sum per tile, then a flag and a maximum per tile; K7b uses the counters
// and the second half), zeroed when it was made; epoch: a value this
// workspace has not seen, never 0.  Sets the device only when it is not the
// current one.
extern "C" int cssm_cummax_int32(const void* x, void* out, void* ws,
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
  const ScanWorkspace w{words, words + 1, (ScanTile*)(words + 2),
                        (ScanMax*)(words + 2 + 2 * capacity)};
  cummax_one_launch<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, n, w, epoch, (unsigned long long)tiles);
  return (int)cudaGetLastError();
}
