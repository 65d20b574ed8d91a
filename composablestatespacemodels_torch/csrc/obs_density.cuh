// K3: observation log-densities evaluated inside K2, K5 and K8.
//
// Replaces the Pallas weight hooks of the JAX package
// (models/observation.py::kernel_log_density, the `fn` half: Gaussian :80,
// Poisson :110, ZeroInflatedPoisson :149, NegativeBinomial :189, Bernoulli
// :227, StudentsT :266, Beta :327 with the Stirling lgamma :282).  The
// per-step constants come from the family's torch `make_consts`, outside
// the kernel: everything that depends on the observation alone (lgamma of
// y, log of the scale, ...) is one scalar per step.  Family ids are those of
// models/observation.py; the plain twins are models/observation.py::
// kernel_fn, with the same operation order and explicit float32 rounding
// (no contraction into fused multiply-adds), so kernel and twin agree bit
// for bit where the CUDA math functions (expf, logf, log1pf) are the ones
// torch's CUDA kernels call.
//
// What bounds it: nothing of its own.  It runs in registers on the gamma a
// thread already holds, reading at most 5 constants (L1-resident, the same
// for every thread); Beta's two lgamma_f32 are ~40 float operations and two
// logf, small beside the propagate's Philox rounds.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace cssm {

constexpr int kGaussian = 0;
constexpr int kPoisson = 1;
constexpr int kZeroInflatedPoisson = 2;
constexpr int kNegativeBinomial = 3;
constexpr int kBernoulli = 4;
constexpr int kStudentsT = 5;
constexpr int kBeta = 6;

// logaddexp(a, b) = max(a, b) + log1p(exp(-|a - b|))
__device__ __forceinline__ float log_add_exp(float a, float b) {
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(__fsub_rn(a, b)))));
}

// lgamma(x) for x > 0 (the JAX package's _lgamma_f32): Stirling's series at
// z >= 8 with three correction terms; smaller x shift up through
// lgamma(x) = lgamma(x + 8) - log(x (x+1) ... (x+7)), the product selected
// away (it overflows to inf) where x >= 8.
__device__ __forceinline__ float lgamma_f32(float x) {
  const bool big = x >= 8.f;
  const float z = big ? x : __fadd_rn(x, 8.f);
  float prod = x;
#pragma unroll
  for (int i = 1; i < 8; ++i) prod = __fmul_rn(prod, __fadd_rn(x, (float)i));
  const float corr = big ? 0.f : logf(prod);
  const float zi = __fdiv_rn(1.f, z);
  const float zi2 = __fmul_rn(zi, zi);
  const float series = __fmul_rn(
      zi, __fadd_rn((float)(1.0 / 12.0),
                    __fmul_rn(zi2, __fadd_rn((float)(-1.0 / 360.0),
                                             __fmul_rn(zi2, (float)(
                                                 1.0 / 1260.0))))));
  const float lead = __fsub_rn(__fmul_rn(__fsub_rn(z, 0.5f), logf(z)), z);
  return __fsub_rn(
      __fadd_rn(__fadd_rn(lead, (float)0.9189385332046727), series), corr);
}

template <int FAMILY>
__device__ __forceinline__ float obs_log_density(float gamma,
                                                 const float* __restrict__ c) {
  if constexpr (FAMILY == kGaussian) {
    // c = (y, 1/v, -0.5 log(2 pi) - log v):  c2 - 0.5 z^2, z = (y - gamma)/v
    const float z = __fmul_rn(__fsub_rn(__ldg(c), gamma), __ldg(c + 1));
    return __fsub_rn(__ldg(c + 2), __fmul_rn(__fmul_rn(0.5f, z), z));
  } else if constexpr (FAMILY == kPoisson) {
    // c = (y, lgamma(y + 1)):  y gamma - exp(gamma) - lgamma(y + 1)
    return __fsub_rn(__fsub_rn(__fmul_rn(__ldg(c), gamma), expf(gamma)),
                     __ldg(c + 1));
  } else if constexpr (FAMILY == kZeroInflatedPoisson) {
    // c = (y, log p, log(1 - p), lgamma(y + 1), y == 0)
    const float lam = expf(gamma);
    const float log_1mp = __ldg(c + 2);
    if (__ldg(c + 4) > 0.5f) {
      return log_add_exp(__ldg(c + 1), __fsub_rn(log_1mp, lam));
    }
    return __fsub_rn(
        __fsub_rn(__fadd_rn(log_1mp, __fmul_rn(__ldg(c), gamma)), lam),
        __ldg(c + 3));
  } else if constexpr (FAMILY == kNegativeBinomial) {
    // c = (lgamma(r + y) - lgamma(y + 1) - lgamma(r), y, r, log r), with
    // log(mu + r) = logaddexp(gamma, log r)
    const float log_r = __ldg(c + 3);
    const float lse = log_add_exp(gamma, log_r);
    return __fadd_rn(
        __fadd_rn(__ldg(c), __fmul_rn(__ldg(c + 2), __fsub_rn(log_r, lse))),
        __fmul_rn(__ldg(c + 1), __fsub_rn(gamma, lse)));
  } else if constexpr (FAMILY == kBernoulli) {
    // c = (y,):  p = logistic(gamma) clamped to 1 above 6 and 0 below -6;
    // the JAX package's log(max(p, 1e-300)) is log(max(p, 0)) in float32
    // (1e-300 rounds to 0), and p == 0 (1 - p == 0) takes the -1e30 floor
    const float e = expf(-fabsf(gamma));
    const float den = __fadd_rn(1.f, e);
    float p = gamma >= 0.f ? __fdiv_rn(1.f, den) : __fdiv_rn(e, den);
    p = gamma > 6.f ? 1.f : (gamma < -6.f ? 0.f : p);
    if (__ldg(c) == 1.f) return p == 0.f ? -1e30f : logf(fmaxf(p, 0.f));
    return p == 1.f ? -1e30f : logf(fmaxf(__fsub_rn(1.f, p), 0.f));
  } else if constexpr (FAMILY == kStudentsT) {
    // c = (y, 1/v, lognorm - log v, (nu + 1)/2, nu):
    // c2 - (nu + 1)/2 log1p(z^2 / nu), z = (y - gamma)/v
    const float z = __fmul_rn(__fsub_rn(__ldg(c), gamma), __ldg(c + 1));
    return __fsub_rn(
        __ldg(c + 2),
        __fmul_rn(__ldg(c + 3),
                  log1pf(__fdiv_rn(__fmul_rn(z, z), __ldg(c + 4)))));
  } else {
    static_assert(FAMILY == kBeta, "unknown observation family");
    // c = (log y, (b - 1) log1p(-y) - lgamma(b), b), a = exp(-gamma):
    // (a - 1) log y + c1 + lgamma(a + b) - lgamma(a)
    const float a = expf(-gamma);
    const float head =
        __fadd_rn(__fmul_rn(__fsub_rn(a, 1.f), __ldg(c)), __ldg(c + 1));
    return __fsub_rn(__fadd_rn(head, lgamma_f32(__fadd_rn(a, __ldg(c + 2)))),
                     lgamma_f32(a));
  }
}

// Calls launch(std::integral_constant<int, FAMILY>{}) for the runtime
// family id -- one template instantiation per family -- and returns its
// result; an unknown id gives cudaErrorInvalidValue without a launch.
template <typename Launch>
int dispatch_family(int family, Launch&& launch) {
  switch (family) {
    case kGaussian:
      return launch(std::integral_constant<int, kGaussian>{});
    case kPoisson:
      return launch(std::integral_constant<int, kPoisson>{});
    case kZeroInflatedPoisson:
      return launch(std::integral_constant<int, kZeroInflatedPoisson>{});
    case kNegativeBinomial:
      return launch(std::integral_constant<int, kNegativeBinomial>{});
    case kBernoulli:
      return launch(std::integral_constant<int, kBernoulli>{});
    case kStudentsT:
      return launch(std::integral_constant<int, kStudentsT>{});
    case kBeta:
      return launch(std::integral_constant<int, kBeta>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cssm
