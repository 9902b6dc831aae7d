// Row copies over a set of columns of mixed widths (1, 2, 4 or 8 bytes
// an entry), for the exchange (exchange.cu).  One launch moves up to
// kMaxSetCols columns: each thread takes a row and copies it in every
// column, so neighbouring threads read neighbouring entries of each
// column.
#pragma once
#include "common.cuh"

namespace otbt {
namespace {

constexpr int kMaxSetCols = 16;

struct ColSet {
  int k;
  int width[kMaxSetCols];
  const char* in[kMaxSetCols];
  char* out[kMaxSetCols];
};

__device__ __forceinline__ void copy_entry(const ColSet& c, int j,
                                           long long src, long long dst) {
  switch (c.width[j]) {
    case 1:
      ((uint8_t*)c.out[j])[dst] = ((const uint8_t*)c.in[j])[src];
      break;
    case 2:
      ((uint16_t*)c.out[j])[dst] = ((const uint16_t*)c.in[j])[src];
      break;
    case 4:
      ((uint32_t*)c.out[j])[dst] = ((const uint32_t*)c.in[j])[src];
      break;
    default:
      ((unsigned long long*)c.out[j])[dst] =
          ((const unsigned long long*)c.in[j])[src];
  }
}

// out[p] = 0 in a column of width c.width[j].
__device__ __forceinline__ void zero_entry(const ColSet& c, int j,
                                           long long dst) {
  switch (c.width[j]) {
    case 1:
      ((uint8_t*)c.out[j])[dst] = 0;
      break;
    case 2:
      ((uint16_t*)c.out[j])[dst] = 0;
      break;
    case 4:
      ((uint32_t*)c.out[j])[dst] = 0;
      break;
    default:
      ((unsigned long long*)c.out[j])[dst] = 0;
  }
}

// out[pos[i]] = in[i] for every row with pos[i] >= 0; a column whose
// `in` is null gets zero there (a source that never set a null mask:
// its rows are not null).
__global__ void scatter_rows(ColSet c, const long long* __restrict__ pos,
                             long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    long long p = pos[i];
    if (p < 0) continue;
    for (int j = 0; j < c.k; ++j) {
      if (c.in[j] != nullptr)
        copy_entry(c, j, i, p);
      else
        zero_entry(c, j, p);
    }
  }
}

// Build the column sets from HOST arrays of k device pointers and widths
// and launch `fn(set)` once per kMaxSetCols columns.
template <class Launch>
inline int for_column_sets(const long long* in_ptrs, const long long* out_ptrs,
                           const int* widths, int k, Launch fn) {
  for (int lo = 0; lo < k; lo += kMaxSetCols) {
    ColSet c;
    c.k = k - lo < kMaxSetCols ? k - lo : kMaxSetCols;
    for (int j = 0; j < kMaxSetCols; ++j) {
      bool on = j < c.k;
      int w = on ? widths[lo + j] : 8;
      if (w != 1 && w != 2 && w != 4 && w != 8)
        return (int)cudaErrorInvalidValue;
      c.width[j] = w;
      c.in[j] = on ? (const char*)in_ptrs[lo + j] : nullptr;
      c.out[j] = on ? (char*)out_ptrs[lo + j] : nullptr;
    }
    fn(c);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace
}  // namespace otbt
