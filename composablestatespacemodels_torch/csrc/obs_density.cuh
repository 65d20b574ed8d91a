// K3: observation log-densities evaluated inside the fused resample kernel.
//
// Replaces the Pallas weight hooks of the JAX package
// (models/observation.py::kernel_log_density, the `fn` half: Gaussian :80,
// Poisson :110).  The per-step constants come from the family's torch
// `make_consts` (outside the kernel: Poisson's lgamma(y + 1) is one scalar
// per step).  Family ids are those of models/observation.py (GAUSSIAN_ID,
// POISSON_ID); the plain twin is models/observation.py::kernel_fn, with the
// same operation order and explicit rounding.
#pragma once

namespace cssm {

constexpr int kGaussian = 0;
constexpr int kPoisson = 1;

template <int FAMILY>
__device__ __forceinline__ float obs_log_density(float gamma,
                                                 const float* __restrict__ c) {
  if constexpr (FAMILY == kGaussian) {
    // c = (y, 1/v, -0.5 log(2 pi) - log v):  c2 - 0.5 z^2, z = (y - gamma)/v
    const float z = __fmul_rn(__fsub_rn(__ldg(c), gamma), __ldg(c + 1));
    return __fsub_rn(__ldg(c + 2), __fmul_rn(__fmul_rn(0.5f, z), z));
  } else {
    // c = (y, lgamma(y + 1)):  y gamma - exp(gamma) - lgamma(y + 1)
    return __fsub_rn(__fsub_rn(__fmul_rn(__ldg(c), gamma), expf(gamma)),
                     __ldg(c + 1));
  }
}

}  // namespace cssm
