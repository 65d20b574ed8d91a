// Philox4x32-10 counter-based generator and Box-Muller normals.
//
// Replaces the TPU's per-core hardware PRNG (pltpu.prng_seed /
// prng_random_bits in ops/resample_kernel.py::_propagate_weights_block of the
// JAX package).  Those bits cannot be reproduced on the card, so the kernel
// draws from Philox4x32-10 (Salmon et al., SC'11) keyed by the per-step seed,
// with the output column as the counter; the plain PyTorch version
// (ops/resample_kernel.py::philox4x32_10) computes the same bits with int64
// tensor ops, so the card compares kernel and plain version on identical
// noise.  Normals use 24-bit uniforms and Box-Muller with cos+sin pairing,
// as the JAX kernel does; every float step is explicitly rounded
// (__fmul_rn / __fadd_rn) so that nvcc cannot contract it into an FMA that
// the plain version does not perform.
#pragma once
#include <stdint.h>

namespace cssm {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round) {
      key.x += W0;
      key.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// One Box-Muller pair from two 32-bit words: u1 in (0, 1] from the top 24
// bits of a (never 0, log-safe), theta = 2*pi*u2 with u2 in [0, 1).
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& z0,
                                           float& z1) {
  const float scale = 5.9604644775390625e-08f;  // 2^-24
  const float half_ulp = 2.98023223876953125e-08f;  // 2^-25
  const float two_pi = (float)6.28318530717958;
  const float u1 = __fadd_rn(__fmul_rn((float)(a >> 8), scale), half_ulp);
  const float theta = __fmul_rn(two_pi, __fmul_rn((float)(b >> 8), scale));
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  z0 = __fmul_rn(r, cosf(theta));
  z1 = __fmul_rn(r, sinf(theta));
}

}  // namespace cssm
