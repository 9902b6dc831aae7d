// Sort-based GROUP BY: key statistics, sort words, group boundaries and
// group numbering.
//
// Replaces opentenbase_tpu/ops/kernels.py:178 grouped_agg_sort (a lax
// program: pack or lexicographic sort, boundary flags, cumsum,
// segment reductions).  The wrapper (ops/kernels.py) drives it:
//   1. key_stats: min and max of each int64 key image over the valid
//      rows (a warp reduction, then one atomic per warp);
//   2. the host reads those 2k numbers and applies the reference's
//      62-bit pack test (float32, as there);
//   3. group_words: one packed word per row (the fast branch:
//      acc = acc * range + (k - min), invalid rows = top), or the words
//      [invalid, packed (wrapping int64), keys...] (the exact branch);
//   4. K10's radix sort (sort.cu) orders them, row index last;
//   5. group_ids: boundary flags over the sorted rows, their exclusive
//      scan (scan.cuh), the group id of every row scattered back to row
//      order and each group's first row (`take`, for the key values);
//   6. K4's kernel (grouped_agg.cu) reduces the aggregates per group id.
// Both branches give the reference's group order: with no wrap the
// packed word orders the rows as the keys do.
//
// The traced form (a captured fragment program may not read the device
// from the host) replaces steps 2 and 3 with group_gate, one thread that
// applies the same pack test on the device and writes (fast, top), and
// group_words_dev, which reads them and always writes the exact branch's
// 1 + [k > 1] + k words: under the fast branch word 0 is the packed word
// and the others are 0, which sorts exactly as the one packed word does
// (the radix sort skips the zero words' passes on the device).  Bound:
// the sort's active passes over the words; the other kernels move a few
// bytes a row.
#include "common.cuh"
#include "scan.cuh"

namespace {

typedef unsigned long long u64;

__global__ void key_stats(const long long* __restrict__ ints, int k,
                          long long n, const bool* __restrict__ valid,
                          long long* __restrict__ mins,
                          long long* __restrict__ maxs) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (int c = 0; c < k; ++c) {
    const long long* key = ints + (long long)c * n;
    long long mn = 0x7fffffffffffffffLL, mx = (long long)(1ULL << 63);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
      if (!valid[i]) continue;
      long long v = key[i];
      mn = v < mn ? v : mn;
      mx = v > mx ? v : mx;
    }
    for (int off = 16; off > 0; off >>= 1) {
      long long a = __shfl_down_sync(0xffffffffu, mn, off);
      long long b = __shfl_down_sync(0xffffffffu, mx, off);
      mn = a < mn ? a : mn;
      mx = b > mx ? b : mx;
    }
    if ((threadIdx.x & 31) == 0) {
      atomicMin(mins + c, mn);
      atomicMax(maxs + c, mx);
    }
  }
}

__global__ void group_words(const long long* __restrict__ ints, int k,
                            long long n, const bool* __restrict__ valid,
                            const long long* __restrict__ mins,
                            const long long* __restrict__ maxs, int fast,
                            long long top, long long* __restrict__ words) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    bool v = valid[i];
    if (fast) {
      // under the pack test every range fits and the product does too
      long long acc = 0;
      for (int c = 0; c < k; ++c) {
        long long mn = mins[c], mx = maxs[c];
        long long rng = (long long)(mx >= mn ? (u64)mx - (u64)mn : 0ULL) + 1;
        long long d = (long long)((u64)ints[(long long)c * n + i] - (u64)mn);
        d = d < 0 ? 0 : (d > rng - 1 ? rng - 1 : d);
        acc = acc * rng + d;
      }
      words[i] = v ? acc : top;
      continue;
    }
    words[i] = v ? 0 : 1;
    int w = 1;
    if (k > 1) {
      // the reference's packed int64, wrapping as it does
      u64 packed = 0;
      for (int c = 0; c < k; ++c) {
        u64 mn = (u64)mins[c], mx = (u64)maxs[c];
        u64 d = v ? (u64)ints[(long long)c * n + i] - mn : 0ULL;
        packed = packed * (mx - mn + 1ULL) + d;
      }
      words[n + i] = (long long)packed;
      w = 2;
    }
    for (int c = 0; c < k; ++c)
      words[(long long)(w + c) * n + i] = ints[(long long)c * n + i];
  }
}

// The reference's single-word pack test (ops/kernels.py:217-226) on the
// device, in float32 as there: sum of log2(span + 2) over the keys plus
// log2(n + 2) under 62 bits.  gate[0] = fast, gate[1] = top (the product
// of the key ranges, the word of an invalid row).
__global__ void group_gate(const long long* __restrict__ mins,
                           const long long* __restrict__ maxs, int k,
                           long long n, long long* __restrict__ gate) {
  float bits = 0.0f;
  u64 top = 1;
  for (int c = 0; c < k; ++c) {
    long long mn = mins[c], mx = maxs[c];
    u64 span = mx >= mn ? (u64)mx - (u64)mn : 0ULL;
    top *= span + 1ULL;
    bits = __fadd_rn(bits, log2f(__fadd_rn(__ull2float_rn(span), 2.0f)));
  }
  bits = __fadd_rn(bits, log2f(__ll2float_rn(n + 2)));
  bool fast = bits < 62.0f;
  gate[0] = fast ? 1 : 0;
  gate[1] = fast ? (long long)top : 0;
}

__global__ void group_words_dev(const long long* __restrict__ ints, int k,
                                long long n, const bool* __restrict__ valid,
                                const long long* __restrict__ mins,
                                const long long* __restrict__ maxs,
                                const long long* __restrict__ gate,
                                long long* __restrict__ words) {
  const bool fast = gate[0] != 0;
  const long long top = gate[1];
  const int w_all = 1 + (k > 1 ? 1 : 0) + k;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    bool v = valid[i];
    if (fast) {
      long long acc = 0;
      for (int c = 0; c < k; ++c) {
        long long mn = mins[c], mx = maxs[c];
        long long rng = (long long)(mx >= mn ? (u64)mx - (u64)mn : 0ULL) + 1;
        long long d = (long long)((u64)ints[(long long)c * n + i] - (u64)mn);
        d = d < 0 ? 0 : (d > rng - 1 ? rng - 1 : d);
        acc = acc * rng + d;
      }
      words[i] = v ? acc : top;
      for (int w = 1; w < w_all; ++w) words[(long long)w * n + i] = 0;
      continue;
    }
    words[i] = v ? 0 : 1;
    int w = 1;
    if (k > 1) {
      u64 packed = 0;
      for (int c = 0; c < k; ++c) {
        u64 mn = (u64)mins[c], mx = (u64)maxs[c];
        u64 d = v ? (u64)ints[(long long)c * n + i] - mn : 0ULL;
        packed = packed * (mx - mn + 1ULL) + d;
      }
      words[n + i] = (long long)packed;
      w = 2;
    }
    for (int c = 0; c < k; ++c)
      words[(long long)(w + c) * n + i] = ints[(long long)c * n + i];
  }
}

// flags[i] = 1 where sorted row i starts a group: a valid row whose
// keys differ from the previous sorted row's (or the first row).
__global__ void group_flags(const long long* __restrict__ ints, int k,
                            long long n, const bool* __restrict__ valid,
                            const long long* __restrict__ perm,
                            unsigned char* __restrict__ flags) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    long long r = perm[i];
    bool b = valid[r];
    if (b && i > 0) {
      long long q = perm[i - 1];
      bool differs = false;
      for (int c = 0; c < k && !differs; ++c)
        differs = ints[(long long)c * n + r] != ints[(long long)c * n + q];
      b = differs;
    }
    flags[i] = b ? 1 : 0;
  }
}

struct FlagLoad {
  const unsigned char* flags;
  __device__ __forceinline__ long long operator()(long long i) const {
    return (long long)flags[i];
  }
};

__global__ void fill_take(const long long* __restrict__ perm,
                          long long max_groups, long long* __restrict__ take) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < max_groups; g += stride)
    take[g] = perm[0];
}

__global__ void group_scatter(const long long* __restrict__ perm,
                              const bool* __restrict__ valid, long long n,
                              const unsigned char* __restrict__ flags,
                              const long long* __restrict__ excl,
                              long long max_groups,
                              long long* __restrict__ gid_row,
                              long long* __restrict__ take) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    long long r = perm[i];
    long long g = excl[i] + flags[i] - 1;
    gid_row[r] = valid[r] ? g : -1;
    if (flags[i] && g < max_groups) take[g] = r;
  }
}

}  // namespace

// ints: k x n int64 key images; mins / maxs: k, preset to INT64_MAX /
// INT64_MIN.
extern "C" int otbt_group_key_stats(const void* ints, int k, long long n,
                                    const void* valid, void* mins,
                                    void* maxs, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (n > 0)
    key_stats<<<otbt::grid_for(n, 4), otbt::kThreads, 0,
                (cudaStream_t)stream>>>((const long long*)ints, k, n,
                                        (const bool*)valid,
                                        (long long*)mins, (long long*)maxs);
  return (int)cudaGetLastError();
}

// words: 1 x n (fast) or (1 + [k > 1] + k) x n (exact).
extern "C" int otbt_group_words(const void* ints, int k, long long n,
                                const void* valid, const void* mins,
                                const void* maxs, int fast, long long top,
                                void* words, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (n > 0)
    group_words<<<otbt::grid_for(n), otbt::kThreads, 0,
                  (cudaStream_t)stream>>>(
        (const long long*)ints, k, n, (const bool*)valid,
        (const long long*)mins, (const long long*)maxs, fast, top,
        (long long*)words);
  return (int)cudaGetLastError();
}

// The traced form of steps 2-3: gate (2 int64) and words
// ((1 + [k > 1] + k) x n) on the device; nothing is read by the host.
extern "C" int otbt_group_words_dev(const void* ints, int k, long long n,
                                    const void* valid, const void* mins,
                                    const void* maxs, void* gate,
                                    void* words, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  group_gate<<<1, 1, 0, s>>>((const long long*)mins, (const long long*)maxs,
                             k, n, (long long*)gate);
  if (n > 0)
    group_words_dev<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
        (const long long*)ints, k, n, (const bool*)valid,
        (const long long*)mins, (const long long*)maxs,
        (const long long*)gate, (long long*)words);
  return (int)cudaGetLastError();
}

// perm: the sorted order (n); flags: n bytes, excl: n, tile_sums:
// otbt_scan_tiles(n), n_groups: 1 (all scratch or outputs);
// gid_row: n (group id of each row, -1 for invalid rows); take:
// max_groups (first row of each group, perm[0] past the last group).
extern "C" int otbt_group_ids(const void* ints, int k, long long n,
                              const void* valid, const void* perm,
                              long long max_groups, void* flags, void* excl,
                              void* tile_sums, void* n_groups, void* gid_row,
                              void* take, void* stream) {
  if (k < 1 || n < 1 || max_groups < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* p = (const long long*)perm;
  unsigned char* f = (unsigned char*)flags;
  group_flags<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
      (const long long*)ints, k, n, (const bool*)valid, p, f);
  otbt::exclusive_scan(FlagLoad{f}, n, (long long*)excl,
                       (long long*)tile_sums, (long long*)n_groups, s);
  fill_take<<<otbt::grid_for(max_groups), otbt::kThreads, 0, s>>>(
      p, max_groups, (long long*)take);
  group_scatter<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
      p, (const bool*)valid, n, f, (const long long*)excl, max_groups,
      (long long*)gid_row, (long long*)take);
  return (int)cudaGetLastError();
}
