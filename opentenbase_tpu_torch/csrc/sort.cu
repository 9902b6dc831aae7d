// Lexicographic multi-key sort, as a permutation: a bitonic network.
//
// Replaces opentenbase_tpu/ops/kernels.py:488 sort_rows (jax.lax.sort
// over [~valid, keys..., payload..., valid]).  The wrapper turns every
// key into one int64 order word (ops/kernels.py order_words), so this
// kernel only compares signed int64 words lexicographically, with the
// row index as the last tie-break: the order is total, hence the sort is
// deterministic and stable, like the reference's stable lax.sort.
//
// Bound: bytes.  The network is padded to the next power of two with
// positions that sort after every row, and runs log2(N)(log2(N)+1)/2
// compare-exchange passes, each one launch over N/2 pairs that gathers
// the words of both rows.  That is simple and right at any size; a
// shared-memory stage for the short strides is later work.
#include "common.cuh"

namespace {

// a < b in the lexicographic order of the words, then by row index;
// indices >= n are padding and sort after every row.
__device__ __forceinline__ bool row_less(const long long* __restrict__ words,
                                         int n_words, long long n,
                                         long long a, long long b) {
  bool pa = a >= n, pb = b >= n;
  if (pa || pb) return !pa ? true : (pb && a < b);
  for (int w = 0; w < n_words; ++w) {
    long long x = words[(long long)w * n + a];
    long long y = words[(long long)w * n + b];
    if (x != y) return x < y;
  }
  return a < b;
}

__global__ void iota_kernel(long long* perm, long long m) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < m; i += stride)
    perm[i] = i;
}

__global__ void bitonic_pass(const long long* __restrict__ words, int n_words,
                             long long n, long long* __restrict__ perm,
                             long long m, long long k, long long j) {
  long long stride = (long long)gridDim.x * blockDim.x;
  // one thread per pair: pair p owns the lower position i (bit j clear)
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < m / 2; p += stride) {
    long long i = ((p / j) * 2 * j) + (p % j);
    long long l = i + j;
    long long a = perm[i], b = perm[l];
    bool ascending = (i & k) == 0;
    bool swap = ascending ? row_less(words, n_words, n, b, a)
                          : row_less(words, n_words, n, a, b);
    if (swap) {
      perm[i] = b;
      perm[l] = a;
    }
  }
}

}  // namespace

// words: n_words x n int64 (row-major by word); perm: m int64 outputs,
// m = the next power of two >= n.  perm[:n] is the sorted order.
extern "C" int otbt_sort_perm(const void* words, int n_words, long long n,
                              void* perm, long long m, void* stream) {
  if (m < n || (m & (m - 1)) != 0 || n_words < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long* p = (long long*)perm;
  if (m > 0) iota_kernel<<<otbt::grid_for(m), otbt::kThreads, 0, s>>>(p, m);
  for (long long k = 2; k <= m; k <<= 1) {
    for (long long j = k >> 1; j > 0; j >>= 1) {
      bitonic_pass<<<otbt::grid_for(m / 2), otbt::kThreads, 0, s>>>(
          (const long long*)words, n_words, n, p, m, k, j);
    }
  }
  return (int)cudaGetLastError();
}
