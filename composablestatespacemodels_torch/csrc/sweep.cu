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
// Design.  One block per chain, sized to its cloud: ceil(n / 32) warps,
// thread j owning particle j (n <= 1024), so 256 chains at n = 100 are 256
// blocks of 128 threads, resident at once on the H100's 132 SMs.  The
// cloud lives in shared memory, in two [d, n] buffers that swap at the
// gather, with the log-weights and the counts beside them: (2d + 2) n * 4
// bytes, 64 KiB at d = 7, n = 1024, so the launch raises the block's
// dynamic shared memory limit.  A step:
//   1. every thread propagates its particle, eight rows at a time (two
//      Philox blocks computed together, so their rounds interleave), and
//      writes its log-weight to shared memory; one barrier;
//   2. the first ceil(n / 128) warps, the ones a 4096-item tile of n items
//      fills, scan it (sweep_scan): thread i takes items 4i..4i+3, their
//      maximum, u = exp(lw - max), the float64 sum, the ll, the prefix of
//      u / total and the counts with their running max, in scan.cuh's
//      short-tile helpers, so the bits are the 1024-thread tile's, K1's on
//      the same normalised weights.  At n <= 128 that is one warp, with no
//      barrier; beyond, its warps meet at a named barrier while the rest of
//      the block waits at the next __syncthreads;
//   3. every thread finds its ancestor by ancestor.cuh's upper_bound on the
//      counts in shared memory and gathers its column; one barrier.
// Normals come from Philox4x32-10 (philox.cuh) under key (seed, 0) with
// counter (j, r / 4, t, b), and the resampling uniform ud of (t, b) from
// counter (0, 0, t, b) under key (seed, 1): no two (step, chain) pairs
// share a stream.  Every float step is explicitly rounded, so the plain
// version (ops/sweep_kernel.py) replays the kernel bit for bit.  Four
// particles a thread (the tile's own layout: one warp at n <= 128, no
// hand-over of the log-weights) ran 2.2x slower on an H100 than one a
// thread at n = 100 and 1.9x at n = 512: its particles' Philox and Box-Muller
// chains follow one another on one warp where one a thread spreads them
// over four.
//
// What bounds it on the H100: latency, not bytes.  At the PMMH shape a
// step is a chain of dependent arithmetic and shuffles on one to four
// warps a chain; the only device-memory traffic is the step's
// coefficients and constants (~100 B per chain).  The TPU's lane-chunk
// layout, its per-launch chain cap (64 // chunks) with group seeds, and
// B % 8 do not carry over: one launch runs exactly the B chains asked for.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ancestor.cuh"
#include "obs_density.cuh"
#include "philox.cuh"
#include "propagate.cuh"
#include "scan.cuh"

namespace cssm {

// The resampling uniform of (step t, chain b), in (0, 1): the top 24 bits
// of Philox word 0, as Box-Muller's u1.
__device__ __forceinline__ float step_uniform(uint32_t seed, uint32_t t,
                                              uint32_t b) {
  const uint4 bits =
      philox4x32_10(make_uint4(0u, 0u, t, b), make_uint2(seed, 1u));
  return __fadd_rn(__fmul_rn((float)(bits.x >> 8), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

// The barrier of the whole block (a warp on its own needs only __syncwarp).
__device__ __forceinline__ void block_sync(int warps) {
  if (warps == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Rows r0 .. r0 + R - 1 (those below d) of particle j: the affine step
// with the normals z, in place in x, and gamma, the design's sum over the
// rows so far.
template <int R>
__device__ __forceinline__ void step_rows(float* x, const float* cf,
                                          const float* g, const float (&z)[R],
                                          int r0, int d, int n, int j,
                                          float& gamma) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = r0 + k;
    if (r < d) {
      const float v = affine_step(__ldg(cf + 3 * r), x[r * n + j],
                                  __ldg(cf + 3 * r + 1), __ldg(cf + 3 * r + 2),
                                  z[k]);
      x[r * n + j] = v;
      const float gv = __fmul_rn(__ldg(g + r), v);
      gamma = r == 0 ? gv : __fadd_rn(gamma, gv);
    }
  }
}

// The scan warps' part of step t, on a short tile: thread i of the first
// ceil(n / 128) warps (`warps`; ONE when that is one) holds items
// 4i..4i+3.  From the log-weights lw in shared memory: their maximum, u =
// exp(lw - max) and its float64 sum, the ll increment, then the counts of
// u / total (tile_counts, K1's arithmetic, offset 0.0), stored to counts.
// The instance for one warp has the helpers' branches on the warp count
// folded away.  Built without it (scripts/torch_sweep_instance_probe.py:
// the runtime instance alone, 60 registers against 64), K8 ran 8-9% slower
// on an H100 at one chain, d = 7, n = 100 and n = 512.
template <bool ONE>
__device__ __forceinline__ void sweep_scan(const float* lw, int* counts,
                                           int n, int warps, float lw_floor,
                                           uint32_t seed, int t, int chain,
                                           bool observed, float log_n,
                                           float& ll, double* dsm, float* fsm,
                                           int* ism) {
  if (ONE) warps = 1;
  const float ud = step_uniform(seed, (uint32_t)t, (uint32_t)chain);
  const int64_t base = (int64_t)threadIdx.x * kItems;
  float v[kItems];
  // the maximum also takes -inf for the particle slots that a 1024-thread
  // block leaves empty below n = 1024 (lw_floor; NaN, which fmaxf drops,
  // for none), so it is the 1024-thread block's maximum
  float m = lw_floor;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = base + k < n ? lw[base + k] : 0.f;
    if (base + k < n) m = fmaxf(m, v[k]);
  }
  const float maxw = block_max(m, fsm, warps);
  double tsum = 0.0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = base + k < n ? expf(__fsub_rn(v[k], maxw)) : 0.f;
    tsum += (double)v[k];
  }
  const float total = __double2float_rn(block_sum(tsum, dsm, warps));
  if (observed) {
    ll = __fadd_rn(ll, __fsub_rn(__fadd_rn(maxw, logf(total)), log_n));
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = base + k < n ? __fdiv_rn(v[k], total) : 0.f;
  }
  int c[kItems];
  tile_counts(v, 0.0, ud, base, n, dsm, ism, c, warps);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n) counts[base + k] = c[k];
  }
}

// One chain per block of ceil(n / 32) warps; thread j owns particle j.
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
  const int chain = blockIdx.x, chains = gridDim.x, j = threadIdx.x;
  const int warps = blockDim.x >> 5;
  const int scan_warps = (n + 32 * kItems - 1) / (32 * kItems);
  const int64_t dn = (int64_t)d * n;
  float* x = smem;
  float* y = x + dn;
  float* lw_s = y + dn;
  int* counts = (int*)(lw_s + n);
  const uint32_t seed = (uint32_t)__ldg(seed_p);
  const float lw_floor = n < kThreads ? -INFINITY : __int_as_float(0x7fffffff);
  for (int64_t i = j; i < dn; i += blockDim.x) {
    x[i] = __ldg(x0 + chain * dn + i);
  }
  block_sync(warps);
  float ll = 0.f;
  for (int t = 0; t < steps; ++t) {
    const float* cf = coef + ((int64_t)t * chains + chain) * d * 3;
    const float* g = design + (int64_t)t * d;
    const float* wc = wconsts + ((int64_t)t * chains + chain) * kc;
    const bool observed = __ldg(mask + t) != 0;
    // 1-2. propagate this thread's particle, eight rows at a time (two
    // Philox blocks whose rounds interleave), then its log-weight, to
    // shared memory for the scan warps
    if (j < n) {
      float gamma = 0.f;
      for (int r0 = 0; r0 < d; r0 += 8) {
        const uint4 c0 = make_uint4((uint32_t)j, (uint32_t)(r0 >> 2),
                                    (uint32_t)t, (uint32_t)chain);
        const uint2 key = make_uint2(seed, 0u);
        if (r0 + 4 < d) {
          const uint4 b0 = philox4x32_10(c0, key);
          const uint4 b1 = philox4x32_10(
              make_uint4(c0.x, c0.y + 1u, c0.z, c0.w), key);
          float z[8];
          box_muller(b0.x, b0.y, z[0], z[1]);
          box_muller(b0.z, b0.w, z[2], z[3]);
          box_muller(b1.x, b1.y, z[4], z[5]);
          box_muller(b1.z, b1.w, z[6], z[7]);
          step_rows<8>(x, cf, g, z, r0, d, n, j, gamma);
        } else {
          const uint4 b0 = philox4x32_10(c0, key);
          float z[4];
          box_muller(b0.x, b0.y, z[0], z[1]);
          box_muller(b0.z, b0.w, z[2], z[3]);
          step_rows<4>(x, cf, g, z, r0, d, n, j, gamma);
        }
      }
      lw_s[j] = observed ? obs_log_density<FAMILY>(gamma, wc) : 0.f;
    }
    block_sync(warps);
    // 3-4. the scan warps: max, sum, ll, counts
    if (j < 32 * scan_warps) {
      if (scan_warps == 1) {
        sweep_scan<true>(lw_s, counts, n, 1, lw_floor, seed, t, chain,
                         observed, log_n, ll, dsm, fsm, ism);
      } else {
        sweep_scan<false>(lw_s, counts, n, scan_warps, lw_floor, seed, t,
                          chain, observed, log_n, ll, dsm, fsm, ism);
      }
    }
    block_sync(warps);
    // 5-6. ancestors from the counts in shared memory; gather into y
    if (j < n) {
      const int64_t anc = upper_bound(counts, n, j);
      for (int r = 0; r < d; ++r) y[r * n + j] = x[r * n + anc];
    }
    block_sync(warps);
    float* swap = x;
    x = y;
    y = swap;
  }
  for (int64_t i = j; i < dn; i += blockDim.x) {
    x_final[chain * dn + i] = x[i];
  }
  if (j == 0) ll_out[chain] = ll;  // thread 0 is a scan thread
}

// A chain's block: ceil(n / 32) warps, and the dynamic shared memory of
// its two clouds, log-weights and counts, which the kernel is allowed.
__host__ inline int sweep_threads(int n) { return 32 * ((n + 31) / 32); }

template <int FAMILY>
cudaError_t sweep_shared(int d, int n, size_t* smem) {
  *smem = (size_t)(2 * d + 2) * n * sizeof(float);
  return cudaFuncSetAttribute(sweep_kernel<FAMILY>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <int FAMILY>
int launch_sweep(const float* x0, const float* coef, const float* design,
                 const float* wconsts, const int* mask, const int* seed,
                 float* ll, float* x_final, int chains, int d, int n,
                 int steps, int kc, float log_n, cudaStream_t s) {
  size_t smem;
  cudaError_t err = sweep_shared<FAMILY>(d, n, &smem);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<FAMILY><<<chains, sweep_threads(n), smem, s>>>(
      x0, coef, design, wconsts, mask, seed, ll, x_final, d, n, steps, kc,
      log_n);
  return (int)cudaGetLastError();
}

// The loaded kernel's registers and local memory a thread, and the blocks
// of its launch at (d, n) that an SM holds at once, from the CUDA runtime.
template <int FAMILY>
int sweep_occupancy(int d, int n, int* out) {
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, sweep_kernel<FAMILY>);
  size_t smem;
  if (err == cudaSuccess) err = sweep_shared<FAMILY>(d, n, &smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, sweep_kernel<FAMILY>, sweep_threads(n), smem);
  }
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return (int)err;
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
  if (n <= 0 || n > kThreads) return (int)cudaErrorInvalidValue;
  const auto* xp = (const float*)x0;
  const auto* cp = (const float*)coef;
  const auto* gp = (const float*)design;
  const auto* wp = (const float*)wconsts;
  const auto* mp = (const int*)mask;
  const auto* sp = (const int*)seed;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_family(family, [&](auto fam) {
    return launch_sweep<decltype(fam)::value>(xp, cp, gp, wp, mp, sp,
                                              (float*)ll, (float*)x_final,
                                              chains, d, n, steps, kc, log_n,
                                              s);
  });
}

// K8 at (d, n) for `family`: out[0] registers a thread, out[1] local
// memory bytes a thread (spills), out[2] blocks resident per SM.
extern "C" int cssm_pf_sweep_occupancy(int d, int n, int family, int device,
                                       void* out) {
  using namespace cssm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || n > kThreads || d <= 0) return (int)cudaErrorInvalidValue;
  return dispatch_family(family, [&](auto fam) {
    return sweep_occupancy<decltype(fam)::value>(d, n, (int*)out);
  });
}
