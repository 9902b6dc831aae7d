// Exclusive prefix sum of int64 values, in three kernels: each block
// sums its tile, one block scans the tile sums, each block scans its
// tile again and adds its tile's offset back.
//
// Used by the join's pair expansion (join.cu, the per-probe-row pair
// counts) and the sort-based aggregate's group numbering (groupsort.cu,
// the boundary flags): the scan is the body of both kernels, so it is
// written here rather than taken from a library.  The value of row i
// comes from a loader functor, so a scan reads its inputs once, without
// a materialized copy.  Bound: bytes (one read per pass, two passes).
#pragma once
#include "common.cuh"

namespace otbt {
namespace {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;   // 1024 rows

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

template <class Load>
__global__ void scan_tile_sums(Load load, long long n,
                               long long* __restrict__ tile_sums) {
  __shared__ long long sh[kScanThreads];
  long long base = (long long)blockIdx.x * kScanTile +
                   (long long)threadIdx.x * kScanItems;
  long long s = 0;
  for (int q = 0; q < kScanItems; ++q)
    if (base + q < n) s += load(base + q);
  long long total;
  block_exclusive(s, sh, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: tile_sums becomes its own exclusive scan; *total the sum.
__global__ void scan_tile_offsets(long long* __restrict__ tile_sums,
                                  long long tiles,
                                  long long* __restrict__ total) {
  __shared__ long long sh[kScanThreads];
  long long carry = 0;
  for (long long b = 0; b < tiles; b += kScanThreads) {
    long long i = b + threadIdx.x;
    long long v = i < tiles ? tile_sums[i] : 0;
    long long chunk;
    long long ex = block_exclusive(v, sh, &chunk);
    if (i < tiles) tile_sums[i] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

template <class Load>
__global__ void scan_tiles(Load load, long long n,
                           const long long* __restrict__ tile_offsets,
                           long long* __restrict__ out) {
  __shared__ long long sh[kScanThreads];
  long long base = (long long)blockIdx.x * kScanTile +
                   (long long)threadIdx.x * kScanItems;
  long long v[kScanItems];
  long long s = 0;
  for (int q = 0; q < kScanItems; ++q) {
    v[q] = base + q < n ? load(base + q) : 0;
    s += v[q];
  }
  long long total;
  long long run = tile_offsets[blockIdx.x] + block_exclusive(s, sh, &total);
  for (int q = 0; q < kScanItems; ++q) {
    if (base + q < n) out[base + q] = run;
    run += v[q];
  }
}

// out[i] = load(0) + ... + load(i - 1); *total = the sum of all n.
// tile_sums: scratch of max(ceil(n / kScanTile), 1) int64 (the count
// join.cu's otbt_scan_tiles reports to the host).
template <class Load>
inline void exclusive_scan(Load load, long long n, long long* out,
                           long long* tile_sums, long long* total,
                           cudaStream_t s) {
  long long tiles = (n + kScanTile - 1) / kScanTile;
  if (tiles > 0)
    scan_tile_sums<<<(unsigned)tiles, kScanThreads, 0, s>>>(load, n,
                                                            tile_sums);
  scan_tile_offsets<<<1, kScanThreads, 0, s>>>(tile_sums, tiles, total);
  if (tiles > 0)
    scan_tiles<<<(unsigned)tiles, kScanThreads, 0, s>>>(load, n, tile_sums,
                                                        out);
}

}  // namespace
}  // namespace otbt
