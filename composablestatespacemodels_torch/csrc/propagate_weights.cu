// K5 (+ K3): the standalone exact affine-Gaussian propagate with optional
// log-weights, on the [d, N] particle cloud.
//
// Replaces ops/resample_kernel.py::propagate_weights_t of the JAX package
// (:756; body _propagate_weights_block :410) with the observation hooks of
// models/observation.py (all seven pointwise families) as K3
// (obs_density.cuh), one instantiation per family.  For every column j:
//
//   y[r, j] = a_r * x[r, j] + b_r + s_r * z_{r,j}        (z ~ N(0, 1))
//   logw[j] = fn(sum_r design_r * y[r, j], consts)       (with a family)
//
// coef is [d, 4] = (a, b, sqrt(q), design) with a family and [d, 3] without
// one; the log-weights are a separate [N] output (the TPU wrote them into a
// spare padding row of the cloud).  The filter runs it where the propagate
// cannot fold into the resample (per-step summaries need the unpropagated
// resampled cloud).  The column step and its Philox noise are K2's
// (propagate.cuh), so the plain version draws the same normals.
//
// What bounds it on the H100: memory.  At d = 7, N = 2^20 it reads 28 MiB and
// writes 28 MiB (+4 MiB of log-weights): ~60 MiB, ~18 us at 3.35 TB/s.  One
// thread per column, neighbouring threads on neighbouring addresses; the
// Philox rounds and Box-Muller (two normals per log/sqrt/cos/sin) ride along.
#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_density.cuh"
#include "propagate.cuh"

namespace cssm {

constexpr int kNoWeights = -1;

template <int FAMILY>
__global__ void __launch_bounds__(256) propagate_weights_kernel(
    const float* __restrict__ x, const float* __restrict__ coef,
    const float* __restrict__ consts, const int* __restrict__ seed,
    float* __restrict__ y, float* __restrict__ logw, int d, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  if constexpr (FAMILY == kNoWeights) {
    propagate_column<3>(x, j, coef, seed, y, d, n, j);
  } else {
    const float gamma = propagate_column<4>(x, j, coef, seed, y, d, n, j);
    logw[j] = obs_log_density<FAMILY>(gamma, consts);
  }
}

}  // namespace cssm

extern "C" int cssm_propagate_weights(const void* x, const void* coef,
                                      const void* consts, const void* seed,
                                      void* y, void* logw, int d, int64_t n,
                                      int family, int device, void* stream) {
  using namespace cssm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xp = (const float*)x;
  const auto* kp = (const float*)coef;
  const auto* wp = (const float*)consts;
  const auto* sp = (const int*)seed;
  if (family == kNoWeights) {
    propagate_weights_kernel<kNoWeights><<<blocks, kThreads, 0, s>>>(
        xp, kp, wp, sp, (float*)y, (float*)logw, d, n);
    return (int)cudaGetLastError();
  }
  return dispatch_family(family, [&](auto fam) {
    propagate_weights_kernel<decltype(fam)::value>
        <<<blocks, kThreads, 0, s>>>(xp, kp, wp, sp, (float*)y,
                                     (float*)logw, d, n);
    return (int)cudaGetLastError();
  });
}
