// A block-wide exclusive prefix sum of int64 values, one a thread: the
// exchange kernels' (exchange.cu) scans of tile counts and positions.
#pragma once
#include "common.cuh"

namespace otbt {
namespace {

constexpr int kScanThreads = 256;

// Block-wide exclusive scan of one value per thread; *total gets the
// block's sum.  sh holds kScanThreads values.
__device__ __forceinline__ long long block_exclusive(long long v,
                                                     long long* sh,
                                                     long long* total) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    long long x = t >= off ? sh[t - off] : 0;
    __syncthreads();
    sh[t] += x;
    __syncthreads();
  }
  long long incl = sh[t];
  *total = sh[kScanThreads - 1];
  __syncthreads();
  return incl - v;
}

}  // namespace
}  // namespace otbt
