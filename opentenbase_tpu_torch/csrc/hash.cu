// K11: splitmix64 row hash over one or more int64 columns, and the
// routing hash of the cluster tier's exchanges.
//
// hash_kernel replaces opentenbase_tpu/utils/hashing.py:36
// splitmix64_jax and :70 hash_columns_jax (uint64 jnp arithmetic), the
// executor's multi-column join key: h = splitmix64(col0), then
// h = splitmix64(h ^ col) for each further column.  The result is the
// uint64 hash's bit pattern, equal to hash_columns_np's.
//
// route_kernel replaces opentenbase_tpu/ops/kernels.py:509 bucket_ids
// and exec/mesh_exec.py:581 _route_hash with the shard-map lookup of
// :634-637: per row, a NULL key hashes as 0, a TEXT key maps its
// dictionary code (clipped into range) through a LUT of the values'
// hash_string, then the same splitmix64 chain, h % buckets in native
// uint64, and the destination shard_map[h % buckets] (or the bucket
// itself without a map); a row that is not valid gets `ndn`.  It is
// bit-equal to the host placement (hash_columns_np -> shard map) the
// locator stored the rows with, so a redistributed row lands where
// the sharded table it joins already lives.
//
// One thread per row reads every key column in the one pass, in native
// 64-bit unsigned arithmetic (wrapping as the reference's uint64 does).
// Bound: bytes (8 bytes a key column read, plus the masks, 8 or 4 bytes
// written, a row; the LUTs and the 16 KB shard map stay in cache).
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

struct RouteCols {
  int k;
  const long long* col[kMaxCols];
  const bool* null[kMaxCols];     // null mask or nullptr
  const long long* lut[kMaxCols];   // TEXT hash LUT or nullptr
  long long lut_len[kMaxCols];
};

__global__ void route_kernel(RouteCols c, long long n,
                             const bool* __restrict__ valid,
                             const int* __restrict__ shard_map,
                             unsigned long long buckets, int ndn,
                             int* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (valid != nullptr && !valid[i]) {
      out[i] = ndn;
      continue;
    }
    u64 h = 0;
    for (int j = 0; j < c.k; ++j) {
      u64 x;
      if (c.null[j] != nullptr && c.null[j][i]) {
        x = 0;
      } else if (c.lut[j] != nullptr) {
        long long code = c.col[j][i];
        code = code < 0 ? 0 : (code >= c.lut_len[j] ? c.lut_len[j] - 1 : code);
        x = (u64)c.lut[j][code];
      } else {
        x = (u64)c.col[j][i];
      }
      h = j == 0 ? splitmix64(x) : splitmix64(h ^ x);
    }
    u64 b = h % buckets;
    out[i] = shard_map != nullptr ? shard_map[b] : (int)b;
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

// Routing destinations.  col_ptrs / null_ptrs / lut_ptrs / lut_lens:
// HOST arrays of k entries (device pointers, 0 where a key has no null
// mask or no LUT).  valid and shard_map may be null (bucket_ids: every
// row, out = the bucket).
extern "C" int otbt_route_dest(const long long* col_ptrs,
                               const long long* null_ptrs,
                               const long long* lut_ptrs,
                               const long long* lut_lens, int k,
                               long long n, const void* valid,
                               const void* shard_map, long long buckets,
                               int ndn, void* out, void* stream) {
  if (k < 1 || k > kMaxCols || buckets < 1) return (int)cudaErrorInvalidValue;
  RouteCols c;
  c.k = k;
  for (int j = 0; j < kMaxCols; ++j) {
    bool on = j < k;
    c.col[j] = on ? (const long long*)col_ptrs[j] : nullptr;
    c.null[j] = on ? (const bool*)null_ptrs[j] : nullptr;
    c.lut[j] = on ? (const long long*)lut_ptrs[j] : nullptr;
    c.lut_len[j] = on ? lut_lens[j] : 0;
    if (on && c.lut[j] != nullptr && c.lut_len[j] < 1)
      return (int)cudaErrorInvalidValue;
  }
  if (n > 0)
    route_kernel<<<otbt::grid_for(n), otbt::kThreads, 0,
                   (cudaStream_t)stream>>>(
        c, n, (const bool*)valid, (const int*)shard_map,
        (unsigned long long)buckets, ndn, (int*)out);
  return (int)cudaGetLastError();
}
