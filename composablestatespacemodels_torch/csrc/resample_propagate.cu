// K2 + K3: fused systematic resample + exact affine-Gaussian propagate +
// next-step log-weights, on the [d, N] particle cloud.
//
// Replaces ops/resample_kernel.py::sorted_gather_resample_propagate_t of the
// JAX package (:667; _merge_kernel_body :66, _merge_propagate_tail :381,
// _propagate_weights_block :410) with the observation hooks of
// models/observation.py (Gaussian :80, Poisson :110) as the device function
// K3 (obs_density.cuh).  For every output column j:
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
// padding row (a sublane-alignment workaround).  Ancestors come from one
// thread per output column running an upper_bound over counts, which stays
// in the 50 MB L2 (4 MiB); the dependent-load chain of that search (~20
// probes) is the latency this simple version pays.  The TPU's streaming
// merge, windowed duplication and prepass scalars do not carry over; a
// streaming merge with TMA is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_density.cuh"
#include "philox.cuh"

namespace cssm {

// first i in [0, n) with counts[i] > j (counts nondecreasing, last == n)
__device__ __forceinline__ int64_t upper_bound(const int* __restrict__ counts,
                                               int64_t n, int64_t j) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)__ldg(counts + mid) > j) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo < n ? lo : n - 1;
}

template <int FAMILY>
__global__ void __launch_bounds__(256) resample_propagate_kernel(
    const float* __restrict__ x, const int* __restrict__ counts,
    const float* __restrict__ coef, const float* __restrict__ consts,
    const int* __restrict__ seed, float* __restrict__ y,
    float* __restrict__ logw, int d, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t anc = upper_bound(counts, n, j);
  const uint2 key = make_uint2((uint32_t)__ldg(seed), 0u);
  float gamma = 0.f;
  for (int r0 = 0; r0 < d; r0 += 4) {
    const uint4 bits = philox4x32_10(
        make_uint4((uint32_t)j, (uint32_t)(r0 >> 2), 0u, 0u), key);
    float z[4];
    box_muller(bits.x, bits.y, z[0], z[1]);
    box_muller(bits.z, bits.w, z[2], z[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + k;
      if (r < d) {
        const float* cr = coef + 4 * r;
        const float v = __fadd_rn(
            __fadd_rn(__fmul_rn(__ldg(cr), __ldg(x + r * n + anc)),
                      __ldg(cr + 1)),
            __fmul_rn(__ldg(cr + 2), z[k]));
        y[r * n + j] = v;
        const float g = __fmul_rn(__ldg(cr + 3), v);
        gamma = r == 0 ? g : __fadd_rn(gamma, g);
      }
    }
  }
  logw[j] = obs_log_density<FAMILY>(gamma, consts);
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
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xp = (const float*)x;
  const auto* cp = (const int*)counts;
  const auto* kp = (const float*)coef;
  const auto* wp = (const float*)consts;
  const auto* sp = (const int*)seed;
  if (family == kGaussian) {
    resample_propagate_kernel<kGaussian><<<blocks, kThreads, 0, s>>>(
        xp, cp, kp, wp, sp, (float*)y, (float*)logw, d, n);
  } else if (family == kPoisson) {
    resample_propagate_kernel<kPoisson><<<blocks, kThreads, 0, s>>>(
        xp, cp, kp, wp, sp, (float*)y, (float*)logw, d, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
