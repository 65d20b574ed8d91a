// K4: the plain resampling gather on the [d, N] particle cloud.
//
// Replaces ops/resample_kernel.py::sorted_gather_resample_t of the JAX
// package (:616; kernel _make_merge_kernel :302 over _merge_kernel_body :66,
// host prepass _merge_prepass :456).  For every output column j:
//
//   anc_j   = first i with counts[i] > j
//   y[r, j] = x[r, anc_j]
//
// bit for bit x[:, _ancestors_from_counts(counts, N)]: a gather has no
// rounding.  It is K2 without the propagate, and finds its ancestors as K2
// does: each block of kMergeThreads threads owns kMergeTile merged
// positions of the counts and the output slots (ancestor.cuh's
// merge_path_ancestors: the block's split by a warp-wide search, its counts
// staged in shared memory by cp.async, its slots' ancestors expanded
// there), so no thread searches global memory for an ancestor.  The TPU's
// d -> multiple-of-8 padding, windowed duplication and prepass scalars are
// Mosaic workarounds and do not carry over.
//
// What bounds it on the H100: memory.  At d = 7, N = 2^20 it reads 28 MiB of
// cloud and 4 MiB of counts and writes 28 MiB: ~60 MiB, ~19 us at
// 3.35 TB/s.  After the merge each thread takes its up to eight output
// columns of the block at once (t, t + kMergeThreads, ...) and, row by row,
// loads the row's values of all of them before it stores any, so a thread
// keeps up to eight loads in flight even at d = 1.  (On the H100 this beat
// one, two or four columns with up to eight rows each, smaller and larger
// merge tiles, and the same loop over an int32 column count, which spills,
// at d = 1, 7 and 13.)  32 registers a thread, no spills: eight blocks of
// 256 on an SM, so the grid at N = 2^20 (1024 blocks) runs in one wave.
// Writes are coalesced (neighbouring threads, neighbouring columns) and
// reads follow nondecreasing ancestors, so neighbouring threads read
// neighbouring or equal addresses; a heavy ancestor's column is read by
// many threads at once (one transaction).  Heavy and spike counts give some
// blocks kMergeTile output columns and others none, which the grid does not
// balance.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ancestor.cuh"

namespace cssm {

// A block has at most kMergeTile output slots, so thread t takes slots
// t, t + kMergeThreads, ... (kGatherCols of them) and, row by row, loads
// the row's values of all of them before it stores any.
constexpr int kGatherCols = kMergeTile / kMergeThreads;

__global__ void __launch_bounds__(kMergeThreads, 8)
    gather_kernel(const float* __restrict__ x, const int* __restrict__ counts,
                  float* __restrict__ y, int d, int64_t n) {
  __shared__ __align__(16) int stage[kMergeTile + 4];
  __shared__ int anc[kMergeTile];
  __shared__ int64_t split[2];
  const MergeSlots slots = merge_path_ancestors(counts, n, stage, anc, split);
  const int k = threadIdx.x;
  if (k >= slots.nb) return;
  int64_t src[kGatherCols];
  bool live[kGatherCols];
#pragma unroll
  for (int c = 0; c < kGatherCols; ++c) {
    live[c] = k + c * kMergeThreads < slots.nb;
    src[c] = live[c] ? anc[k + c * kMergeThreads] : 0;
  }
  for (int r = 0; r < d; ++r) {
    const int64_t row = (int64_t)r * n;
    float v[kGatherCols];
#pragma unroll
    for (int c = 0; c < kGatherCols; ++c) {
      v[c] = live[c] ? __ldg(x + row + src[c]) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kGatherCols; ++c) {
      if (live[c]) y[row + slots.j0 + k + c * kMergeThreads] = v[c];
    }
  }
}

}  // namespace cssm

extern "C" int cssm_gather(const void* x, const void* counts, void* y, int d,
                           int64_t n, int device, void* stream) {
  using namespace cssm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // one block per kMergeTile positions of the 2n merged ones
  const unsigned blocks = (unsigned)((2 * n + kMergeTile - 1) / kMergeTile);
  gather_kernel<<<blocks, kMergeThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)counts, (float*)y, d, n);
  return (int)cudaGetLastError();
}
