// K8: B chains' whole T-step bootstrap particle filter in one launch (PMMH).
//
// Replaces ops/sweep_kernel.py::pf_sweep_chains of the JAX package (:358;
// bodies _make_sweep_kernel :109 for n <= 128 and _make_sweep_kernel_multi
// :206 for n <= 1024) with the observation hooks of models/observation.py
// (all seven pointwise families, one instantiation each) as K3
// (obs_density.cuh).  For each chain b and step t, on the cloud x [d, n]:
//
//   x[r, j]  = a * x[r, j] + b + s * z          (coef[t, b, r] = (a, b, s))
//   logw[j]  = observed[t] ? fn(sum_r design[t, r] * x[r, j], wconsts[t, b])
//                          : 0                  (a select, not a multiply)
//   m = max logw,  u[j] = exp(logw[j] - m),  total = sum u   (float64 sum)
//   ll[b]   += observed[t] ? m + log(total) - log(n) : 0
//   counts   = cummax(clip(ceil(n * prefix(u / total) - ud), 0, n)), last n
//   x[:, j]  = x[:, first i with counts[i] > j]
//
// coef[0] is the dt = 0 step: x0 is the cloud at the first observation time.
// A masked step still resamples (under uniform weights), as the TPU kernel
// does.  Outputs ll [B] and the final resampled clouds x_final [B, d, n].
//
// Design.  One block of kThreads = 1024 threads per chain; thread j owns
// particle j (n <= 1024).  The cloud lives in shared memory, in two [d, n]
// buffers that swap at the gather, with u and the counts beside them:
// (2d + 2) n * 4 bytes, 64 KiB at d = 7, n = 1024, so the launch raises the
// block's dynamic shared memory limit.  The step's reductions, prefix and
// running max are scan.cuh's (block_max, block_sum, tile_prefix and
// tile_cummax_store on a single tile), so the cdf bits are K1's on the same
// normalised weights, and ancestor.cuh's upper_bound reads the counts from
// shared memory.  Normals come from Philox4x32-10 (philox.cuh) under key
// (seed, 0) with counter (j, r / 4, t, b), and the resampling uniform ud of
// (t, b) from counter (0, 0, t, b) under key (seed, 1): no two (step, chain)
// pairs share a stream.  Every float step is explicitly rounded, so the
// plain version (ops/sweep_kernel.py) replays the kernel bit for bit.
//
// What bounds it on the H100: latency, not bytes.  At the PMMH shape (n =
// 100, d = 7, T = 400) a step is ~100 threads of arithmetic between a dozen
// block barriers; the only device-memory traffic is the step's coefficients
// and constants (~100 B per chain).  The TPU's lane-chunk layout, its
// per-launch chain cap (64 // chunks) with group seeds, and B % 8 do not
// carry over: one launch runs exactly the B chains asked for.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ancestor.cuh"
#include "obs_density.cuh"
#include "philox.cuh"
#include "propagate.cuh"
#include "scan.cuh"

namespace cssm {

// u[i] from shared memory.
struct SharedValues {
  const float* u;
  __device__ __forceinline__ float operator()(int64_t i) const { return u[i]; }
};

// u[i] / total, rounded as the plain version's float32 division.
struct SharedNormalised {
  const float* u;
  float total;
  __device__ __forceinline__ float operator()(int64_t i) const {
    return __fdiv_rn(u[i], total);
  }
};

// The resampling uniform of (step t, chain b), in (0, 1): the top 24 bits
// of Philox word 0, as Box-Muller's u1.
__device__ __forceinline__ float step_uniform(uint32_t seed, uint32_t t,
                                              uint32_t b) {
  const uint4 bits =
      philox4x32_10(make_uint4(0u, 0u, t, b), make_uint2(seed, 1u));
  return __fadd_rn(__fmul_rn((float)(bits.x >> 8), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

template <int FAMILY>
__global__ void __launch_bounds__(kThreads) sweep_kernel(
    const float* __restrict__ x0, const float* __restrict__ coef,
    const float* __restrict__ design, const float* __restrict__ wconsts,
    const int* __restrict__ mask, const int* __restrict__ seed_p,
    float* __restrict__ ll_out, float* __restrict__ x_final, int d, int n,
    int steps, int kc, float log_n) {
  extern __shared__ float smem[];
  __shared__ double dsm[kWarps];
  __shared__ float fsm[kWarps];
  __shared__ int ism[kWarps];
  __shared__ int tile_max;
  const int chain = blockIdx.x, chains = gridDim.x, j = threadIdx.x;
  const int64_t dn = (int64_t)d * n;
  float* x = smem;
  float* y = x + dn;
  float* u = y + dn;
  int* counts = (int*)(u + n);
  const uint32_t seed = (uint32_t)__ldg(seed_p);
  const float nf = (float)n;
  if (j < n) {
    for (int r = 0; r < d; ++r) {
      x[r * n + j] = __ldg(x0 + chain * dn + r * n + j);
    }
  }
  float ll = 0.f;
  for (int t = 0; t < steps; ++t) {
    const float* cf = coef + ((int64_t)t * chains + chain) * d * 3;
    const float* g = design + (int64_t)t * d;
    const bool observed = __ldg(mask + t) != 0;
    // 1-2. propagate this thread's particle, then its log-weight
    float lw = -INFINITY;
    if (j < n) {
      float gamma = 0.f;
      for (int r0 = 0; r0 < d; r0 += 4) {
        const uint4 bits = philox4x32_10(
            make_uint4((uint32_t)j, (uint32_t)(r0 >> 2), (uint32_t)t,
                       (uint32_t)chain),
            make_uint2(seed, 0u));
        float z[4];
        box_muller(bits.x, bits.y, z[0], z[1]);
        box_muller(bits.z, bits.w, z[2], z[3]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = r0 + k;
          if (r < d) {
            const float v = affine_step(__ldg(cf + 3 * r), x[r * n + j],
                                        __ldg(cf + 3 * r + 1),
                                        __ldg(cf + 3 * r + 2), z[k]);
            x[r * n + j] = v;
            const float gv = __fmul_rn(__ldg(g + r), v);
            gamma = r == 0 ? gv : __fadd_rn(gamma, gv);
          }
        }
      }
      if (observed) {
        lw = obs_log_density<FAMILY>(
            gamma, wconsts + ((int64_t)t * chains + chain) * kc);
      } else {
        lw = 0.f;
      }
    }
    // 3. max, the float64 sum of u in scan.cuh's order, the ll
    const float maxw = block_max(lw, fsm);
    if (j < n) u[j] = expf(__fsub_rn(lw, maxw));
    __syncthreads();
    const float total =
        __double2float_rn(block_sum(thread_sum(SharedValues{u}, n, 0), dsm));
    if (observed) {
      ll = __fadd_rn(ll, __fsub_rn(__fadd_rn(maxw, logf(total)), log_n));
    }
    // 4. systematic counts and their running max (K1's arithmetic)
    float cdf[kItems];
    tile_prefix(SharedNormalised{u, total}, nullptr, n, 0, cdf, dsm);
    const float ud = step_uniform(seed, (uint32_t)t, (uint32_t)chain);
    int c[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      float v = ceilf(__fsub_rn(__fmul_rn(nf, cdf[k]), ud));
      v = fminf(fmaxf(v, 0.f), nf);
      c[k] = (int)threadIdx.x * kItems + k == n - 1 ? n : (int)v;
    }
    tile_cummax_store(c, counts, &tile_max, n, 0, ism);
    __syncthreads();
    // 5-6. ancestors from the counts in shared memory; gather into y
    if (j < n) {
      const int64_t anc = upper_bound(counts, n, j);
      for (int r = 0; r < d; ++r) y[r * n + j] = x[r * n + anc];
    }
    __syncthreads();
    float* swap = x;
    x = y;
    y = swap;
  }
  if (j < n) {
    for (int r = 0; r < d; ++r) {
      x_final[chain * dn + r * n + j] = x[r * n + j];
    }
  }
  if (j == 0) ll_out[chain] = ll;
}

template <int FAMILY>
int launch_sweep(const float* x0, const float* coef, const float* design,
                 const float* wconsts, const int* mask, const int* seed,
                 float* ll, float* x_final, int chains, int d, int n,
                 int steps, int kc, float log_n, size_t smem,
                 cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<FAMILY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<FAMILY><<<chains, kThreads, smem, s>>>(
      x0, coef, design, wconsts, mask, seed, ll, x_final, d, n, steps, kc,
      log_n);
  return (int)cudaGetLastError();
}

}  // namespace cssm

// x0 [B, d, n], coef [T, B, d, 3], design [T, d] and wconsts [T, B, kc]
// float32, mask [T] int32, seed one int32; out ll [B], x_final [B, d, n].
extern "C" int cssm_pf_sweep_chains(const void* x0, const void* coef,
                                    const void* design, const void* wconsts,
                                    const void* mask, const void* seed,
                                    void* ll, void* x_final, int chains,
                                    int d, int n, int steps, int kc,
                                    float log_n, int family, int device,
                                    void* stream) {
  using namespace cssm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(2 * d + 2) * n * sizeof(float);
  const auto* xp = (const float*)x0;
  const auto* cp = (const float*)coef;
  const auto* gp = (const float*)design;
  const auto* wp = (const float*)wconsts;
  const auto* mp = (const int*)mask;
  const auto* sp = (const int*)seed;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_family(family, [&](auto fam) {
    return launch_sweep<decltype(fam)::value>(
        xp, cp, gp, wp, mp, sp, (float*)ll, (float*)x_final, chains, d, n,
        steps, kc, log_n, smem, s);
  });
}
