// The exact affine-Gaussian step of one particle column: propagate_column
// for K5 (propagate_weights.cu), propagate_column_preloaded for K2
// (resample_propagate.cu); K8 (sweep.cu) uses their rounding, affine_step,
// on a cloud in shared memory:
//
//   y[r, j] = a_r * x[r, src] + b_r + s_r * z_{r,j}        (z ~ N(0, 1))
//   gamma_j = sum_r design_r * y[r, j]                     (weighted only)
//
// coef is [d, NCOL] row-major: (a, b, sqrt(q)) and, when NCOL == 4, the
// design.  z comes from Philox4x32-10 keyed by the step seed with counter
// (j, r / 4, 0, 0) (philox.cuh), so the plain version
// (ops/resample_kernel.py::philox_normals) draws the same normals.  Every
// float step is explicitly rounded: no FMA the plain version lacks.  The
// two column steps compute the same bits; the preloaded one issues the
// loads of the first kPreload rows before any Philox round, so their
// latency hides behind the noise (K2 runs several columns a thread, where
// that latency is not hidden by other blocks).
#pragma once
#include <stdint.h>

#include "philox.cuh"

namespace cssm {

// a * x + b + s * z with every operation rounded on its own (no FMA), in
// the plain version's order: (a * x + b) + s * z.
__device__ __forceinline__ float affine_step(float a, float x, float b,
                                             float s, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), b), __fmul_rn(s, z));
}

template <int NCOL>
__device__ __forceinline__ float propagate_column(
    const float* __restrict__ x, int64_t src, const float* __restrict__ coef,
    const int* __restrict__ seed, float* __restrict__ y, int d, int64_t n,
    int64_t j) {
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
        const float* cr = coef + NCOL * r;
        const float v = affine_step(__ldg(cr), __ldg(x + r * n + src),
                                    __ldg(cr + 1), __ldg(cr + 2), z[k]);
        y[r * n + j] = v;
        if constexpr (NCOL == 4) {
          const float g = __fmul_rn(__ldg(cr + 3), v);
          gamma = r == 0 ? g : __fadd_rn(gamma, g);
        }
      }
    }
  }
  return gamma;
}

// Rows r0 .. r0 + 3 (those below d) of column j, their cloud values xv
// already loaded: the noise of Philox group r0 / 4, the affine step, the
// store and the design dot product.
template <int NCOL>
__device__ __forceinline__ void column_group(const float (&xv)[4], int r0,
                                             const float* __restrict__ coef,
                                             uint2 key, float* __restrict__ y,
                                             int d, int64_t n, int64_t j,
                                             float& gamma) {
  const uint4 bits = philox4x32_10(
      make_uint4((uint32_t)j, (uint32_t)(r0 >> 2), 0u, 0u), key);
  float z[4];
  box_muller(bits.x, bits.y, z[0], z[1]);
  box_muller(bits.z, bits.w, z[2], z[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = r0 + k;
    if (r < d) {
      const float* cr = coef + NCOL * r;
      const float v = affine_step(__ldg(cr), xv[k], __ldg(cr + 1),
                                  __ldg(cr + 2), z[k]);
      y[r * n + j] = v;
      if constexpr (NCOL == 4) {
        const float g = __fmul_rn(__ldg(cr + 3), v);
        gamma = r == 0 ? g : __fadd_rn(gamma, g);
      }
    }
  }
}

constexpr int kPreload = 8;

// propagate_column's values, with rows 0 .. kPreload - 1 of x[:, src]
// loaded first; rows from kPreload on load per group of four.
template <int NCOL>
__device__ __forceinline__ float propagate_column_preloaded(
    const float* __restrict__ x, int64_t src, const float* __restrict__ coef,
    const int* __restrict__ seed, float* __restrict__ y, int d, int64_t n,
    int64_t j) {
  const uint2 key = make_uint2((uint32_t)__ldg(seed), 0u);
  float pre[kPreload / 4][4];
#pragma unroll
  for (int r = 0; r < kPreload; ++r) {
    pre[r / 4][r % 4] = r < d ? __ldg(x + r * n + src) : 0.f;
  }
  float gamma = 0.f;
#pragma unroll
  for (int g = 0; g < kPreload / 4; ++g) {
    if (4 * g < d) {
      column_group<NCOL>(pre[g], 4 * g, coef, key, y, d, n, j, gamma);
    }
  }
  for (int r0 = kPreload; r0 < d; r0 += 4) {
    float xv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xv[k] = r0 + k < d ? __ldg(x + (r0 + k) * n + src) : 0.f;
    }
    column_group<NCOL>(xv, r0, coef, key, y, d, n, j, gamma);
  }
  return gamma;
}

}  // namespace cssm
