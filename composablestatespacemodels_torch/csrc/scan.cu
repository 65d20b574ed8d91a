// K7a: inclusive float32 prefix sum of [N]; K7b: exact int32 running max of
// [N].
//
// Replaces ops/scan_kernel.py::prefix_sum (:613; _prefix_core :406,
// _scan_kernel :49) and ops/scan_kernel.py::cummax_int32 (:480; _cummax_core
// :424, _cummax_kernel :102) of the JAX package, which resampling._cumsum
// and resampling._monotone_counts call on the device (resampling.py:40-43,
// :59-62): the stratified counts are built from them.
//
//   K7a: out[i] = float32(sum_{k <= i} x[k])   accumulated in float64
//   K7b: out[i] = max_{k <= i} c[k]            exact
//
// Both are the tile scan of scan.cuh, which K1 (counts.cu) uses too, so
// every prefix of the port has one implementation; the plain versions
// (inference/resampling.py::_cumsum_ref, torch.cummax) agree bit for bit.
// The TPU computes the prefix as blocked float32 matmuls on the MXU; here it
// is a float64 scan, which rounds once per entry.
//
// What bounds them on the H100: memory, 4 MiB in and 4 MiB out at N = 2^20
// (~2.5 us at 3.35 TB/s); at that size the two or three launches cost more.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace cssm {

struct Identity {
  const float* x;
  int64_t n;
  __device__ __forceinline__ Identity row(int r) const {
    return {x + (int64_t)r * n, n};
  }
  __device__ __forceinline__ float operator()(int64_t i) const {
    return __ldg(x + i);
  }
};

__global__ void __launch_bounds__(kThreads)
    prefix_scan(Identity load, const double* __restrict__ bsum,
                float* __restrict__ out, int64_t n) {
  __shared__ double dsm[kWarps];
  float p[kItems];
  tile_prefix(load, bsum, n, blockIdx.x, p, dsm);
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x * kItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n) out[base + k] = p[k];
  }
}

__global__ void __launch_bounds__(kThreads)
    cummax_scan(const int* __restrict__ x, int* __restrict__ out,
                int* __restrict__ bmax, int64_t n) {
  __shared__ int ism[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x * kItems;
  int c[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    c[k] = base + k < n ? __ldg(x + base + k) : INT_MIN;
  }
  tile_cummax_store(c, out, bmax, n, blockIdx.x, ism);
}

}  // namespace cssm

extern "C" int cssm_prefix_sum(const void* x, void* out, void* bsum,
                               int64_t n, int device, void* stream) {
  using namespace cssm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + kTile - 1) / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  const Identity load{(const float*)x, n};
  tile_sums<<<blocks, kThreads, 0, s>>>(load, (double*)bsum, n);
  prefix_scan<<<blocks, kThreads, 0, s>>>(load, (const double*)bsum,
                                          (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int cssm_cummax_int32(const void* x, void* out, void* bmax,
                                 int64_t n, int device, void* stream) {
  using namespace cssm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + kTile - 1) / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  cummax_scan<<<blocks, kThreads, 0, s>>>((const int*)x, (int*)out,
                                          (int*)bmax, n);
  if (blocks > 1) {
    cummax_carry<int><<<blocks - 1, kThreads, 0, s>>>((int*)out,
                                                      (const int*)bmax, n);
  }
  return (int)cudaGetLastError();
}
