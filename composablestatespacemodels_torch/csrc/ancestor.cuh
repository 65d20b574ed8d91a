// The ancestor of an output column, shared by K2 (resample_propagate.cu), K4
// (gather.cu) and K8 (sweep.cu).
//
// Resampling works on nondecreasing counts (counts[-1] == n): particle i owns
// output slots [counts[i-1], counts[i]), so the ancestor of slot j is the
// first i with counts[i] > j (inference/resampling.py::_ancestors_from_counts
// of either package), or n - 1 when there is none.  Two ways to find it:
//
// * upper_bound: one thread per output column searches the counts; a
//   chain of ~log2(n) dependent probes.  Only K8 uses it, on its counts in
//   shared memory (N <= 1024).
//
// * merge_path_ancestors (K2, K4): the ancestors are the merge of two
//   nondecreasing sequences, the particles' boundaries counts[0..n) and the
//   slots 0..n), where particle i goes before slot j when counts[i] <= j.
//   Particle i then sits at merged position i + counts[i] and slot j's
//   ancestor is the number of particles before it.  Each block owns a fixed
//   range of kMergeTile merged positions (merge path): its particles plus
//   its slots number kMergeTile, however the counts are spread (one
//   particle owning every slot, or two spikes with zero-offspring particles
//   between them), so a block never stages more than kMergeTile counts.
//   One warp per end of the range finds the split (merge_split: 32 probes a
//   round, 4 rounds at N = 2^20, in place of ~20 dependent ones); the
//   block's counts go to shared memory by cp.async (16 bytes at a time where
//   counts is 16-byte aligned); each thread then finds its own split of
//   kMergeItems positions in shared memory and walks them, writing the
//   ancestors of its slots to shared memory.  No thread searches global
//   memory for an ancestor.  ops/resample_kernel.py::merge_path_ancestors_ref
//   replays this arithmetic on the CPU.
//
// Counts are clamped to [0, n] in the comparisons, which leaves the answer
// of nondecreasing counts unchanged and keeps i + counts[i] increasing.
#pragma once
#include <stdint.h>

namespace cssm {

// first i in [0, n) with counts[i] > j (counts nondecreasing, last == n)
__device__ __forceinline__ int64_t upper_bound(const int* __restrict__ counts,
                                               int64_t n, int64_t j) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int c = counts[mid];
    if ((int64_t)c > j) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo < n ? lo : n - 1;
}

constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;
constexpr int kMergeTile = kMergeThreads * kMergeItems;  // merged positions

__device__ __forceinline__ int64_t clamp_count(int c, int64_t n) {
  return c < 0 ? 0 : (c > n ? n : (int64_t)c);
}

// The split of merged position d, by one whole warp: the number of
// particles i with clamp(counts[i]) + i < d.  Each round the 32 lanes probe
// the last index of 32 equal chunks of the unknown range [lo, hi); the
// ballot's count of true probes keeps one chunk.
__device__ __forceinline__ int64_t merge_split(const int* __restrict__ counts,
                                               int64_t n, int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > n ? d - n : 0, hi = d < n ? d : n;
  while (hi > lo) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t p = lo + (lane + 1) * step - 1;
    const bool below = p < hi && clamp_count(__ldg(counts + p), n) + p < d;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    const int64_t keep = lo + c * step;
    hi = keep + step - 1 < hi ? keep + step - 1 : hi;
    lo = keep;
  }
  return lo;
}

// kBytes (4 or 16) from global src to shared dst, asynchronously.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
                 : "memory");
  }
}

// The block's output slots [j0, j0 + nb) and their ancestors, anc[0..nb),
// for the merged range [blockIdx.x * kMergeTile, ... + kMergeTile) of a
// kMergeThreads-thread block.  stage holds kMergeTile + 4 ints, 16-byte
// aligned; anc kMergeTile ints.
struct MergeSlots {
  int64_t j0;
  int nb;
};

__device__ __forceinline__ MergeSlots merge_path_ancestors(
    const int* __restrict__ counts, int64_t n, int* stage, int* anc,
    int64_t* split) {
  const int warp = threadIdx.x >> 5;
  const int64_t d0 = (int64_t)blockIdx.x * kMergeTile;
  const int64_t d1 = d0 + kMergeTile < 2 * n ? d0 + kMergeTile : 2 * n;
  if (warp < 2) {
    const int64_t d = warp == 0 ? d0 : d1;
    const int64_t i = merge_split(counts, n, d);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  __syncthreads();
  const int64_t i0 = split[0], i1 = split[1];
  const int64_t j0 = d0 - i0;
  const int na = (int)(i1 - i0), nb = (int)(d1 - i1 - j0);
  // stage counts[a0 .. i1) with counts[i0 + k] at stage[lead + k]
  const bool wide = ((uintptr_t)counts & 15) == 0;
  const int64_t a0 = wide ? i0 & ~(int64_t)3 : i0;
  const int lead = (int)(i0 - a0);
  for (int q = threadIdx.x; 4 * q < lead + na; q += kMergeThreads) {
    const int64_t g = a0 + 4 * q;
    if (wide && g + 4 <= n) {
      cp_async<16>(stage + 4 * q, counts + g);
    } else {
      for (int k = 0; k < 4 && g + k < i1; ++k) {
        cp_async<4>(stage + 4 * q + k, counts + g + k);
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const int* seg = stage + lead;
  // this thread's positions [dd, dd + kMergeItems) of the block's range:
  // its split (ia particles, dd - ia slots) by binary search in shared
  // memory, then the walk
  const int dd = threadIdx.x * kMergeItems;
  const int total = (int)(d1 - d0);
  if (dd < total) {
    int lo = dd > nb ? dd - nb : 0, hi = dd < na ? dd : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (clamp_count(seg[mid], n) + (i0 + mid) < d0 + dd) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int ia = lo, jb = dd - lo;
    const int end = dd + kMergeItems < total ? dd + kMergeItems : total;
    for (int t = dd; t < end; ++t) {
      if (ia < na && (jb >= nb || clamp_count(seg[ia], n) <= j0 + jb)) {
        ++ia;
      } else {
        anc[jb++] = (int)(i0 + ia < n ? i0 + ia : n - 1);
      }
    }
  }
  __syncthreads();
  return {j0, nb};
}

}  // namespace cssm
