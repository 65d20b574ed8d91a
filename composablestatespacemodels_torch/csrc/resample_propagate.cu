// K2 + K3: fused systematic resample + exact affine-Gaussian propagate +
// next-step log-weights, on the [d, N] particle cloud.
//
// Replaces ops/resample_kernel.py::sorted_gather_resample_propagate_t of the
// JAX package (:667; _merge_kernel_body :66, _merge_propagate_tail :381,
// _propagate_weights_block :410) with the observation hooks of
// models/observation.py (all seven pointwise families) as the device
// function K3 (obs_density.cuh), one instantiation per family.  For every
// output column j:
//
//   anc_j   = first i with counts[i] > j
//   y[r, j] = a_r * x[r, anc_j] + b_r + s_r * z_{r,j}        (z ~ N(0, 1))
//   logw[j] = fn(sum_r design_r * y[r, j], consts)
//
// with coef [d, 4] = (a, b, sqrt(q), design) per row, z from Philox4x32-10
// keyed by the step seed with the column as counter (philox.cuh).
//
// What bounds it on the H100: memory.  At d = 7, N = 2^20 a step reads
// 28 MiB of cloud plus the 4 MiB counts and writes 28 MiB of cloud plus
// 4 MiB of log-weights: ~64 MiB, ~20 us at 3.35 TB/s.  The design does each
// of those transfers once: resample, propagate and weighting happen in
// registers, and the separate log-weight output replaces the TPU's spare
// padding row (a sublane-alignment workaround).  The TPU streams a merge of
// the counts with the output slots; here each block of 256 threads takes
// a fixed range of 2048 merged positions (ancestor.cuh's
// merge_path_ancestors: split by a warp-wide search, counts staged in
// shared memory by cp.async, ancestors expanded there), so no thread runs a
// dependent search through global memory.  Then the block's threads take
// its output columns in order, one column a thread at a time (four on
// average), through propagate.cuh's preloaded column step: a column's
// cloud loads are issued before its Philox rounds, so their latency hides
// behind the noise.  The y and log-weight writes are coalesced, and the
// cloud reads follow nondecreasing ancestors.  At most 42 registers a
// thread (six blocks of 256 on an SM).  The TPU's windowed duplication and
// prepass scalars do not carry over.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ancestor.cuh"
#include "obs_density.cuh"
#include "propagate.cuh"

namespace cssm {

template <int FAMILY>
__global__ void __launch_bounds__(kMergeThreads, 6) resample_propagate_kernel(
    const float* __restrict__ x, const int* __restrict__ counts,
    const float* __restrict__ coef, const float* __restrict__ consts,
    const int* __restrict__ seed, float* __restrict__ y,
    float* __restrict__ logw, int d, int64_t n) {
  __shared__ __align__(16) int stage[kMergeTile + 4];
  __shared__ int anc[kMergeTile];
  __shared__ int64_t split[2];
  const MergeSlots slots = merge_path_ancestors(counts, n, stage, anc, split);
  for (int k = threadIdx.x; k < slots.nb; k += kMergeThreads) {
    const int64_t j = slots.j0 + k;
    const float gamma =
        propagate_column_preloaded<4>(x, anc[k], coef, seed, y, d, n, j);
    logw[j] = obs_log_density<FAMILY>(gamma, consts);
  }
}

}  // namespace cssm

extern "C" int cssm_resample_propagate(const void* x, const void* counts,
                                       const void* coef, const void* consts,
                                       const void* seed, void* y, void* logw,
                                       int d, int64_t n, int family,
                                       int device, void* stream) {
  using namespace cssm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // one block per kMergeTile positions of the 2n merged ones
  const unsigned blocks = (unsigned)((2 * n + kMergeTile - 1) / kMergeTile);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xp = (const float*)x;
  const auto* cp = (const int*)counts;
  const auto* kp = (const float*)coef;
  const auto* wp = (const float*)consts;
  const auto* sp = (const int*)seed;
  return dispatch_family(family, [&](auto fam) {
    resample_propagate_kernel<decltype(fam)::value>
        <<<blocks, kMergeThreads, 0, s>>>(xp, cp, kp, wp, sp, (float*)y,
                                          (float*)logw, d, n);
    return (int)cudaGetLastError();
  });
}
