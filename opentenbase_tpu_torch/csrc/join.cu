// Hash join kernels: build, probe, pair expansion, index composition and
// the semi / anti masks.
//
// Replaces opentenbase_tpu/ops/kernels.py:306 join_build, :349
// join_probe_counts, :418 join_expand, :452 compose_index, :463
// semi_mask and :468 anti_mask (jnp/lax programs).  The reference "hash
// join" is a sort-merge join on one int64 key: sort the build side once,
// find each probe row's run of equal keys, expand the pairs.
//
// - Build (K6): invalid rows become key INT64_MAX, then K10's bitonic
//   sort (sort.cu, called through its C entry) orders the one-word keys
//   with the row index as the tie-break, which is the stable order of
//   both reference branches; a gather writes the sorted keys.  Bound:
//   the sort's passes over the keys (171 passes at 2^18 rows); a radix
//   sort is later work.
// - Probe (K7): a one-thread kernel reads the sorted keys' ends and
//   decides, on the device, between the reference's two strategies: a
//   direct-address table of T + 1 slots (T = max(2 nb, np)), filled
//   with atomicMin (first row) and atomicAdd (count) and read with one
//   gather per probe row, when the live keys span less than T (uint64
//   span); else two binary searches per probe row.  The table kernels
//   and the probe kernel read the flag, so no host read is needed.
//   Bound: bytes (the sorted and probe keys read, lo and count written).
// - Expansion (K8): the per-row pair count (count, or max(count, 1)
//   for valid probe rows of a left outer join) is scanned in scan.cuh
//   and one thread per probe row writes its pairs; pairs past the total
//   stay (0, 0).  Bound: bytes.  A probe row with many matches is
//   written by one thread: skew serialises, which TPC-H's key joins
//   (at most a few dozen matches a row) do not show.
// - Compose (K9) is an int64 gather; the masks are elementwise.
#include "common.cuh"
#include "scan.cuh"

extern "C" int otbt_sort_perm(const void* words, int n_words, long long n,
                              void* perm, long long m, void* stream);

namespace {

constexpr long long kI64Max = 0x7fffffffffffffffLL;
typedef unsigned long long u64;

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void mask_keys(const long long* __restrict__ keys,
                          const bool* __restrict__ valid, long long n,
                          long long* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = valid[i] ? keys[i] : kI64Max;
}

// out[i] = src[idx[i]], the index clamped into [0, n_src) (a JAX
// gather clamps an out-of-range index the same way).
__global__ void gather_i64(const long long* __restrict__ src,
                           long long n_src, const long long* __restrict__ idx,
                           long long n, long long* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = src[clampll(idx[i], 0, n_src - 1)];
}

// stats[0] = 1 when the direct table applies, stats[1] = the least key.
__global__ void probe_stats(const long long* __restrict__ sk, long long nb,
                            long long T, long long* __restrict__ stats) {
  // live keys (!= INT64_MAX) form a prefix of the sorted keys
  long long lo = 0, hi = nb;
  while (lo < hi) {
    long long mid = lo + (hi - lo) / 2;
    if (sk[mid] != kI64Max) lo = mid + 1; else hi = mid;
  }
  long long mn = sk[0];
  bool ok = lo > 0;
  if (ok) {
    long long mx = sk[lo - 1];
    ok = mx >= mn && (u64)mx - (u64)mn < (u64)T;
  }
  stats[0] = ok ? 1 : 0;
  stats[1] = mn;
}

__global__ void table_init(const long long* __restrict__ stats,
                           long long slots, long long nb,
                           long long* __restrict__ lo_tab,
                           long long* __restrict__ cnt_tab) {
  if (!stats[0]) return;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < slots; i += stride) {
    lo_tab[i] = nb;
    cnt_tab[i] = 0;
  }
}

__global__ void table_fill(const long long* __restrict__ stats,
                           const long long* __restrict__ sk, long long nb,
                           long long T, long long* __restrict__ lo_tab,
                           long long* __restrict__ cnt_tab) {
  if (!stats[0]) return;
  const long long mn = stats[1];
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nb; i += stride) {
    long long k = sk[i];
    // the reference files NULL / invalid keys (INT64_MAX) in slot T,
    // which no probe reads (a probe's slot is clamped below T): skip
    // them rather than serialise their atomics on one address
    if (k == kI64Max) continue;
    long long cell = clampll(k - mn, 0, T - 1);
    atomicMin(lo_tab + cell, i);
    atomicAdd((u64*)(cnt_tab + cell), 1ULL);
  }
}

__device__ __forceinline__ long long lower_bound(const long long* sk,
                                                 long long nb, long long v) {
  long long lo = 0, hi = nb;
  while (lo < hi) {
    long long mid = lo + (hi - lo) / 2;
    if (sk[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long upper_bound(const long long* sk,
                                                 long long nb, long long v) {
  long long lo = 0, hi = nb;
  while (lo < hi) {
    long long mid = lo + (hi - lo) / 2;
    if (sk[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void probe_kernel(const long long* __restrict__ stats,
                             const long long* __restrict__ sk, long long nb,
                             const long long* __restrict__ probe,
                             const bool* __restrict__ probe_valid,
                             long long np, long long T,
                             const long long* __restrict__ lo_tab,
                             const long long* __restrict__ cnt_tab,
                             long long* __restrict__ lo_out,
                             long long* __restrict__ cnt_out) {
  const bool direct = stats[0] != 0;
  const long long mn = stats[1];
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < np; i += stride) {
    bool pv = probe_valid[i];
    long long key = probe[i];
    long long pk = pv ? key : kI64Max - 1;
    bool usable = pv && key != kI64Max;
    long long lo, c = 0;
    if (direct) {
      // the reference's int64 difference, wrapping as it does
      long long off = (long long)((u64)pk - (u64)mn);
      long long loc = clampll(off, 0, T - 1);
      if (usable && off >= 0 && off < T) c = cnt_tab[loc];
      lo = c > 0 ? lo_tab[loc] : 0;
    } else {
      lo = lower_bound(sk, nb, pk);
      long long loc = lo < nb ? lo : nb - 1;
      if (usable && sk[loc] == pk) c = upper_bound(sk, nb, pk) - lo;
    }
    lo_out[i] = lo;
    cnt_out[i] = c;
  }
}

// The pair count of probe row i.
struct PairCount {
  const long long* counts;
  const bool* probe_valid;   // may be null
  int left_outer;
  __device__ __forceinline__ long long operator()(long long i) const {
    long long c = counts[i];
    if (!left_outer) return c;
    if (probe_valid && !probe_valid[i]) return 0;
    return c > 1 ? c : 1;
  }
};

__global__ void expand_pairs(PairCount eff, const long long* __restrict__ lo,
                             const long long* __restrict__ perm,
                             const long long* __restrict__ offsets,
                             long long np, long long out_size,
                             long long* __restrict__ probe_idx,
                             long long* __restrict__ build_idx) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < np; p += stride) {
    long long e = eff(p);
    if (e == 0) continue;
    long long base = offsets[p];
    bool miss = eff.left_outer && eff.counts[p] == 0;
    long long first = lo[p];
    for (long long r = 0; r < e; ++r) {
      long long j = base + r;
      if (j >= out_size) break;
      probe_idx[j] = p;
      build_idx[j] = miss ? -1 : perm[first + r];
    }
  }
}

__global__ void join_mask_kernel(const long long* __restrict__ counts,
                                 const bool* __restrict__ probe_valid,
                                 long long n, int anti,
                                 bool* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = anti ? (probe_valid[i] && counts[i] == 0) : counts[i] > 0;
}

}  // namespace

// keys, valid: n; masked: n scratch; perm: m = the next power of two
// >= n; sorted_keys: n.
extern "C" int otbt_join_build(const void* keys, const void* valid,
                               long long n, void* masked, void* perm,
                               long long m, void* sorted_keys,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0)
    mask_keys<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
        (const long long*)keys, (const bool*)valid, n, (long long*)masked);
  int rc = otbt_sort_perm(masked, 1, n, perm, m, stream);
  if (rc != 0) return rc;
  if (n > 0)
    gather_i64<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
        (const long long*)masked, n, (const long long*)perm, n,
        (long long*)sorted_keys);
  return (int)cudaGetLastError();
}

// sorted_keys: nb >= 1; probe, probe_valid, lo, cnt: np; T = max(2 nb,
// np); stats: 2 int64 scratch; lo_tab, cnt_tab: T + 1 int64 scratch
// (slot T, the reference's overflow slot, stays at its initial value).
extern "C" int otbt_join_probe_counts(const void* sorted_keys, long long nb,
                                      const void* probe,
                                      const void* probe_valid, long long np,
                                      long long T, void* stats, void* lo_tab,
                                      void* cnt_tab, void* lo, void* cnt,
                                      void* stream) {
  if (nb < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* sk = (const long long*)sorted_keys;
  long long* st = (long long*)stats;
  probe_stats<<<1, 1, 0, s>>>(sk, nb, T, st);
  table_init<<<otbt::grid_for(T + 1), otbt::kThreads, 0, s>>>(
      st, T + 1, nb, (long long*)lo_tab, (long long*)cnt_tab);
  table_fill<<<otbt::grid_for(nb), otbt::kThreads, 0, s>>>(
      st, sk, nb, T, (long long*)lo_tab, (long long*)cnt_tab);
  if (np > 0)
    probe_kernel<<<otbt::grid_for(np), otbt::kThreads, 0, s>>>(
        st, sk, nb, (const long long*)probe, (const bool*)probe_valid, np, T,
        (const long long*)lo_tab, (const long long*)cnt_tab, (long long*)lo,
        (long long*)cnt);
  return (int)cudaGetLastError();
}

// lo, counts, probe_valid (may be null), offsets: np; perm: nb;
// tile_sums: otbt_scan_tiles(np); total: 1; probe_idx, build_idx:
// out_size, zeroed by the caller.
extern "C" int otbt_join_expand(const void* lo, const void* counts,
                                const void* perm, const void* probe_valid,
                                long long np, long long nb, int left_outer,
                                void* offsets, void* tile_sums, void* total,
                                void* probe_idx, void* build_idx,
                                long long out_size, void* stream) {
  (void)nb;
  cudaStream_t s = (cudaStream_t)stream;
  PairCount eff{(const long long*)counts, (const bool*)probe_valid,
                left_outer};
  otbt::exclusive_scan(eff, np, (long long*)offsets, (long long*)tile_sums,
                       (long long*)total, s);
  if (np > 0)
    expand_pairs<<<otbt::grid_for(np), otbt::kThreads, 0, s>>>(
        eff, (const long long*)lo, (const long long*)perm,
        (const long long*)offsets, np, out_size, (long long*)probe_idx,
        (long long*)build_idx);
  return (int)cudaGetLastError();
}

extern "C" int otbt_compose_index(const void* prior, long long n_prior,
                                  const void* take, long long n, void* out,
                                  void* stream) {
  if (n_prior < 1) return (int)cudaErrorInvalidValue;
  if (n > 0)
    gather_i64<<<otbt::grid_for(n), otbt::kThreads, 0,
                 (cudaStream_t)stream>>>((const long long*)prior, n_prior,
                                         (const long long*)take, n,
                                         (long long*)out);
  return (int)cudaGetLastError();
}

// anti = 0: counts > 0 (semi); anti = 1: probe_valid & counts == 0.
extern "C" int otbt_join_mask(const void* counts, const void* probe_valid,
                              long long n, int anti, void* out,
                              void* stream) {
  if (anti && !probe_valid) return (int)cudaErrorInvalidValue;
  if (n > 0)
    join_mask_kernel<<<otbt::grid_for(n), otbt::kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const long long*)counts, (const bool*)probe_valid, n, anti,
        (bool*)out);
  return (int)cudaGetLastError();
}

// Scratch entries (int64) of a scan's tile_sums over n rows: what the
// caller allocates for otbt_join_expand and otbt_group_ids.
extern "C" long long otbt_scan_tiles(long long n) {
  long long tiles = (n + otbt::kScanTile - 1) / otbt::kScanTile;
  return tiles > 0 ? tiles : 1;
}
