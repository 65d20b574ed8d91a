// The ancestor of an output column, shared by K2 (resample_propagate.cu), K4
// (gather.cu) and K8 (sweep.cu).
//
// Resampling works on nondecreasing counts (counts[-1] == n): particle i owns
// output slots [counts[i-1], counts[i]), so the ancestor of slot j is the
// first i with counts[i] > j (inference/resampling.py::_ancestors_from_counts
// of either package).  One thread per output column runs this upper_bound
// over the counts, which stay in the 50 MB L2 (4 MiB at N = 2^20); the
// ~20-probe dependent-load chain is the latency these simple kernels pay in
// place of the TPU's streaming merge.  K8 keeps its counts in shared
// memory, which the read-only cache path (__ldg) does not reach: it takes
// kGlobal = false, a plain load.
#pragma once
#include <stdint.h>

namespace cssm {

// first i in [0, n) with counts[i] > j (counts nondecreasing, last == n)
template <bool kGlobal = true>
__device__ __forceinline__ int64_t upper_bound(const int* __restrict__ counts,
                                               int64_t n, int64_t j) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    int c;
    if constexpr (kGlobal) {
      c = __ldg(counts + mid);
    } else {
      c = counts[mid];
    }
    if ((int64_t)c > j) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo < n ? lo : n - 1;
}

}  // namespace cssm
