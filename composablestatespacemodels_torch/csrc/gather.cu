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
// rounding.  It is K2 without the propagate: one thread per output column,
// the ancestor from ancestor.cuh's upper_bound over the L2-resident counts.
// The TPU's d -> multiple-of-8 padding, windowed duplication and prepass
// scalars are Mosaic workarounds and do not carry over.
//
// What bounds it on the H100: memory.  At d = 7, N = 2^20 it reads 28 MiB of
// cloud and 4 MiB of counts and writes 28 MiB: ~60 MiB, ~19 us at
// 3.35 TB/s.  Neighbouring threads write neighbouring addresses; their reads
// are neighbouring too except across a heavy ancestor, whose column many
// threads read at once (one transaction).  The ~20-probe search is the
// latency this simple version pays; K2's merge path (ancestor.cuh) is the
// routine that replaces it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ancestor.cuh"

namespace cssm {

__global__ void __launch_bounds__(256)
    gather_kernel(const float* __restrict__ x, const int* __restrict__ counts,
                  float* __restrict__ y, int d, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t anc = upper_bound(counts, n, j);
  for (int r = 0; r < d; ++r) y[r * n + j] = __ldg(x + r * n + anc);
}

}  // namespace cssm

extern "C" int cssm_gather(const void* x, const void* counts, void* y, int d,
                           int64_t n, int device, void* stream) {
  using namespace cssm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)counts, (float*)y, d, n);
  return (int)cudaGetLastError();
}
