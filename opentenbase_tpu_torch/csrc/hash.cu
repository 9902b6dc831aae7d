// splitmix64 row hash over one or more int64 columns.
//
// Replaces opentenbase_tpu/utils/hashing.py:36 splitmix64_jax and :70
// hash_columns_jax (uint64 jnp arithmetic), the executor's multi-column
// join key: h = splitmix64(col0), then h = splitmix64(h ^ col) for each
// further column.  The result is the uint64 hash's bit pattern, equal
// to hash_columns_np's.  One thread per row reads every key column in
// the one pass, in native 64-bit unsigned arithmetic (wrapping as the
// reference's uint64 does).  Bound: bytes (8 bytes a column read, 8
// bytes written, a row).
#include "common.cuh"

namespace {

constexpr int kMaxCols = 16;
typedef unsigned long long u64;

struct HashCols {
  int k;
  const long long* col[kMaxCols];
};

__device__ __forceinline__ u64 splitmix64(u64 z) {
  z += 0x9E3779B97F4A7C15ULL;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

__global__ void hash_kernel(HashCols cols, long long n,
                            long long* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    u64 h = splitmix64((u64)cols.col[0][i]);
    for (int c = 1; c < cols.k; ++c) h = splitmix64(h ^ (u64)cols.col[c][i]);
    out[i] = (long long)h;
  }
}

}  // namespace

// col_ptrs: a HOST array of k device pointers to int64 columns of n rows.
extern "C" int otbt_hash_columns(const long long* col_ptrs, int k,
                                 long long n, void* out, void* stream) {
  if (k < 1 || k > kMaxCols) return (int)cudaErrorInvalidValue;
  HashCols cols;
  cols.k = k;
  for (int c = 0; c < kMaxCols; ++c)
    cols.col[c] = c < k ? (const long long*)col_ptrs[c] : nullptr;
  if (n > 0)
    hash_kernel<<<otbt::grid_for(n), otbt::kThreads, 0,
                  (cudaStream_t)stream>>>(cols, n, (long long*)out);
  return (int)cudaGetLastError();
}
