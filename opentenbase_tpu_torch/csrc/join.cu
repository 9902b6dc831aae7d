// Hash join kernels: build, probe, pair expansion, index composition and
// the semi / anti masks.
//
// Replaces opentenbase_tpu/ops/kernels.py:306 join_build, :349
// join_probe_counts, :418 join_expand, :452 compose_index, :463
// semi_mask and :468 anti_mask (jnp/lax programs).  The reference "hash
// join" is a sort-merge join on one int64 key: sort the build side once,
// find each probe row's run of equal keys, expand the pairs.
//
// - Build (K6): the reference's two branches, chosen on the device with
//   no host read: one kernel takes the min and max of the valid keys,
//   the next applies the reference's 62-bit gate in float32 (as
//   groupsort.cu group_gate does for K5) and writes one word a row: the
//   fast branch's acc = clip(key - min, 0, rng - 1), rng for an invalid
//   row; else the key, INT64_MAX for an invalid row.  K10's radix sort
//   (sort.cu, called through its C entry) orders that word with the row
//   index as the tie-break and writes the sorted word itself; one
//   elementwise epilogue turns the fast branch's acc_s back into keys
//   (INT64_MAX where acc_s >= rng).  Bound: bytes; the sort's active
//   passes (three for TPC-H's dense keys) dominate.
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
// - Compose (K9): one launch gathers every prior index vector of a join
//   side and its output-space null masks at `take` (two rows a thread,
//   take read once); the prior reads are random, so they bound it, and
//   the launch, not the bytes, is most of a small call.  The masks are
//   one elementwise pass, 16 rows a thread with 16-byte loads and
//   stores.
#include "common.cuh"
#include "scan.cuh"

extern "C" int otbt_sort_perm(const void* words, int w, long long n,
                              void* scratch, long long scratch_bytes,
                              void* perm, void* first, void* stream);
extern "C" long long otbt_sort_scratch_bytes(int w, long long n);

namespace {

constexpr long long kI64Max = 0x7fffffffffffffffLL;
typedef unsigned long long u64;

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// stats: [0] min and [1] max of the valid keys, [2] 1 when a row is valid.
__global__ void build_stats_init(long long* __restrict__ stats) {
  stats[0] = kI64Max;
  stats[1] = (long long)(1ULL << 63);
  stats[2] = 0;
}

__global__ void build_stats(const long long* __restrict__ keys,
                            const bool* __restrict__ valid, long long n,
                            long long* __restrict__ stats) {
  long long mn = kI64Max, mx = (long long)(1ULL << 63);
  int any = 0;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (!valid[i]) continue;
    long long k = keys[i];
    mn = k < mn ? k : mn;
    mx = k > mx ? k : mx;
    any = 1;
  }
  for (int off = 16; off > 0; off >>= 1) {
    long long a = __shfl_down_sync(0xffffffffu, mn, off);
    long long b = __shfl_down_sync(0xffffffffu, mx, off);
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
  }
  any = __any_sync(0xffffffffu, any);
  if ((threadIdx.x & 31) == 0 && any) {
    atomicMin(stats, mn);
    atomicMax(stats + 1, mx);
    stats[2] = 1;
  }
}

// The reference's gate (ops/kernels.py:317-327), in float32 as there:
// log2(span + 2) + log2(n + 2) < 62 with a valid row, span as uint64.
struct BuildGate {
  bool fast;
  long long mn, rng;
};

__device__ __forceinline__ BuildGate build_gate(const long long* stats,
                                                long long n) {
  long long mn = stats[0], mx = stats[1];
  u64 span = mx >= mn ? (u64)mx - (u64)mn : 0ULL;
  float bits = __fadd_rn(log2f(__fadd_rn(__ull2float_rn(span), 2.0f)),
                         log2f(__ll2float_rn(n + 2)));
  BuildGate g;
  g.fast = bits < 62.0f && stats[2] != 0;
  g.mn = mn;
  g.rng = (long long)span + 1;   // used under the gate: span < 2^62
  return g;
}

__global__ void build_word(const long long* __restrict__ keys,
                           const bool* __restrict__ valid, long long n,
                           const long long* __restrict__ stats,
                           long long* __restrict__ word) {
  const BuildGate g = build_gate(stats, n);
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    bool v = valid[i];
    long long k = keys[i];
    word[i] = g.fast ? (v ? clampll((long long)((u64)k - (u64)g.mn), 0,
                                    g.rng - 1)
                          : g.rng)
                     : (v ? k : kI64Max);
  }
}

// The fast branch's sorted acc back to keys, in place.
__global__ void build_epilogue(long long n, const long long* __restrict__ stats,
                               long long* __restrict__ sorted_keys) {
  const BuildGate g = build_gate(stats, n);
  if (!g.fast) return;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    long long a = sorted_keys[i];
    sorted_keys[i] = a >= g.rng ? kI64Max : a + g.mn;
  }
}

// K9 compose: every prior index vector and every output-space null mask
// of one join side gathered at `take` in one launch.  A JAX gather's
// index: a negative one counts from the end (+ n), then it is clamped
// into [0, n).
constexpr int kMaxCompose = 48;   // priors (and masks) a launch
struct Compose {
  int k, m;   // priors, masks
  const long long* prior[kMaxCompose];
  long long n_prior[kMaxCompose];
  long long* out[kMaxCompose];
  const unsigned char* mask[kMaxCompose];
  long long n_mask[kMaxCompose];
  unsigned char* mask_out[kMaxCompose];
};

__device__ __forceinline__ long long jax_index(long long t, long long n) {
  return clampll(t < 0 ? t + n : t, 0, n - 1);
}

// Two rows a thread: take read once with one 16-byte load, each prior's
// two entries written with one 16-byte store, each mask's two bytes with
// one 2-byte store (the outputs are fresh allocations; an unaligned
// take or a lone last row takes the scalar path).  The prior reads are
// the random part and set the time.
__global__ void __launch_bounds__(256) compose_kernel(
    Compose c, const long long* __restrict__ take, long long n) {
  const long long i = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  if (i + 1 < n) {
    long long t0, t1;
    if ((((unsigned long long)(take + i)) & 15ULL) == 0) {
      const longlong2 t = __ldcs(reinterpret_cast<const longlong2*>(take + i));
      t0 = t.x;
      t1 = t.y;
    } else {
      t0 = take[i];
      t1 = take[i + 1];
    }
    for (int j = 0; j < c.k; ++j) {
      const long long np = c.n_prior[j];
      const longlong2 o = make_longlong2(c.prior[j][jax_index(t0, np)],
                                         c.prior[j][jax_index(t1, np)]);
      __stcs(reinterpret_cast<longlong2*>(c.out[j] + i), o);
    }
    for (int j = 0; j < c.m; ++j) {
      const long long nm = c.n_mask[j];
      const unsigned short o =
          (unsigned short)(c.mask[j][jax_index(t0, nm)] |
                           (c.mask[j][jax_index(t1, nm)] << 8));
      *reinterpret_cast<unsigned short*>(c.mask_out[j] + i) = o;
    }
  } else {
    const long long t0 = take[i];
    for (int j = 0; j < c.k; ++j)
      c.out[j][i] = c.prior[j][jax_index(t0, c.n_prior[j])];
    for (int j = 0; j < c.m; ++j)
      c.mask_out[j][i] = c.mask[j][jax_index(t0, c.n_mask[j])];
  }
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

// Semi / anti mask, 16 rows a thread in chunks of 512 rows a warp.  The
// counts come in as eight 16-byte loads a thread (two 8-byte loads each
// when the view is not 16-byte aligned), lane l taking rows 64 k + 2 l
// and + 1 of load k, so every load instruction of the warp reads 512
// contiguous bytes; the 16 mask bytes of a thread go through shared
// memory back to rows 16 l .. 16 l + 15, where one 16-byte load of
// probe_valid (anti) and one 16-byte store of the mask are contiguous
// too.  `out` is 16-byte aligned (the entry refuses another); the rows
// after the last whole chunk take one thread each.  Bound: bytes (9 a
// row, 10 for anti).
constexpr int kMaskThreads = 128;
constexpr int kMaskChunk = 512;   // rows a warp

__device__ __forceinline__ bool mask_of(long long c, unsigned char v,
                                        int anti) {
  return anti ? (v != 0 && c == 0) : c > 0;
}

__global__ void __launch_bounds__(kMaskThreads)
join_mask_kernel(const long long* __restrict__ counts,
                 const unsigned char* __restrict__ probe_valid, long long n,
                 int anti, long long chunks,
                 unsigned char* __restrict__ out) {
  __shared__ __align__(16) unsigned char sh[kMaskThreads / 32][kMaskChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long chunk = (long long)blockIdx.x * (kMaskThreads / 32) + warp;
  if (chunk < chunks) {
    const long long base = chunk * kMaskChunk;
    const long long* c = counts + base + 2 * lane;
    long long x[16];
    if ((((unsigned long long)(counts + base)) & 15ULL) == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const longlong2 v =
            __ldg(reinterpret_cast<const longlong2*>(c + 64 * k));
        x[2 * k] = v.x;
        x[2 * k + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        x[2 * k] = __ldg(c + 64 * k);
        x[2 * k + 1] = __ldg(c + 64 * k + 1);
      }
    }
    unsigned short* sw = reinterpret_cast<unsigned short*>(sh[warp]);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      sw[32 * k + lane] =
          (unsigned short)((anti ? x[2 * k] == 0 : x[2 * k] > 0) |
                           ((anti ? x[2 * k + 1] == 0 : x[2 * k + 1] > 0)
                            << 8));
    __syncwarp();
    uint4 m = reinterpret_cast<const uint4*>(sh[warp])[lane];
    if (anti) {
      const unsigned char* pv = probe_valid + base + 16 * lane;
      uint4 v;
      if ((((unsigned long long)pv) & 15ULL) == 0) {
        v = __ldg(reinterpret_cast<const uint4*>(pv));
      } else {
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int q = 0; q < 16; ++q)
          w[q >> 2] |= (unsigned)(pv[q] != 0) << ((q & 3) * 8);
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      m.x &= v.x; m.y &= v.y; m.z &= v.z; m.w &= v.w;
    }
    *reinterpret_cast<uint4*>(out + base + 16 * lane) = m;
  }
  // the rows after the last whole chunk, one a thread
  const long long r = chunks * kMaskChunk +
                      (long long)blockIdx.x * kMaskThreads + threadIdx.x;
  if (r < n) out[r] = mask_of(counts[r], anti ? probe_valid[r] : 0, anti);
}

}  // namespace

// Scratch bytes of otbt_join_build over n build rows: the word, the
// stats and the sort's scratch.
extern "C" long long otbt_join_scratch_bytes(long long n) {
  long long sort = otbt_sort_scratch_bytes(1, n);
  return sort < 0 ? -1 : ((8 * n + 255) & ~255LL) + 256 + sort;
}

// keys, valid: n; scratch: otbt_join_scratch_bytes(n) bytes; perm,
// sorted_keys: n.
extern "C" int otbt_join_build(const void* keys, const void* valid,
                               long long n, void* scratch,
                               long long scratch_bytes, void* perm,
                               void* sorted_keys, void* stream) {
  long long need = otbt_join_scratch_bytes(n);
  if (n < 0 || need < 0 || scratch_bytes < need)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* sb = (unsigned char*)scratch;
  long long* word = (long long*)sb;
  sb += (8 * n + 255) & ~255LL;
  long long* stats = (long long*)sb;
  sb += 256;
  const long long* k = (const long long*)keys;
  const bool* v = (const bool*)valid;
  long long* sk = (long long*)sorted_keys;
  const int g = otbt::grid_for(n);
  build_stats_init<<<1, 1, 0, s>>>(stats);
  build_stats<<<g, otbt::kThreads, 0, s>>>(k, v, n, stats);
  build_word<<<g, otbt::kThreads, 0, s>>>(k, v, n, stats, word);
  int rc = otbt_sort_perm(word, 1, n, sb, otbt_sort_scratch_bytes(1, n),
                          perm, sk, stream);
  if (rc != 0) return rc;
  build_epilogue<<<g, otbt::kThreads, 0, s>>>(n, stats, sk);
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

// K9.  priors / outs: HOST arrays of k int64 device pointers, n_priors
// their lengths; masks / mask_outs: m bool device pointers, n_masks
// their lengths; outputs 16-byte aligned (mask outputs 2-byte).  One
// launch.
extern "C" int otbt_compose_indices(const long long* priors,
                                    const long long* n_priors,
                                    const long long* outs, int k,
                                    const long long* masks,
                                    const long long* n_masks,
                                    const long long* mask_outs, int m,
                                    const void* take, long long n,
                                    void* stream) {
  if (k < 0 || k > kMaxCompose || m < 0 || m > kMaxCompose || n < 0)
    return (int)cudaErrorInvalidValue;
  Compose c;
  c.k = k;
  c.m = m;
  for (int j = 0; j < k; ++j) {
    if (n_priors[j] < 1 || (outs[j] & 15)) return (int)cudaErrorInvalidValue;
    c.prior[j] = (const long long*)priors[j];
    c.n_prior[j] = n_priors[j];
    c.out[j] = (long long*)outs[j];
  }
  for (int j = 0; j < m; ++j) {
    if (n_masks[j] < 1 || (mask_outs[j] & 1))
      return (int)cudaErrorInvalidValue;
    c.mask[j] = (const unsigned char*)masks[j];
    c.n_mask[j] = n_masks[j];
    c.mask_out[j] = (unsigned char*)mask_outs[j];
  }
  if (n > 0)
    compose_kernel<<<(unsigned)((n + 511) / 512), 256, 0,
                     (cudaStream_t)stream>>>(c, (const long long*)take, n);
  return (int)cudaGetLastError();
}

// anti = 0: counts > 0 (semi); anti = 1: probe_valid & counts == 0.
extern "C" int otbt_join_mask(const void* counts, const void* probe_valid,
                              long long n, int anti, void* out,
                              void* stream) {
  if (anti && !probe_valid) return (int)cudaErrorInvalidValue;
  if (((unsigned long long)out) & 15ULL) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const long long chunks = n / kMaskChunk;
    const long long rest = n - kMaskChunk * chunks;
    const long long warps_per_block = kMaskThreads / 32;
    long long blocks = (chunks + warps_per_block - 1) / warps_per_block;
    const long long rest_blocks = (rest + kMaskThreads - 1) / kMaskThreads;
    if (blocks < rest_blocks) blocks = rest_blocks;
    join_mask_kernel<<<(unsigned)blocks, kMaskThreads, 0,
                       (cudaStream_t)stream>>>(
        (const long long*)counts, (const unsigned char*)probe_valid, n, anti,
        chunks, (unsigned char*)out);
  }
  return (int)cudaGetLastError();
}

// Scratch entries (int64) of a scan's tile_sums over n rows: what the
// caller allocates for otbt_join_expand and otbt_group_ids.
extern "C" long long otbt_scan_tiles(long long n) {
  long long tiles = (n + otbt::kScanTile - 1) / otbt::kScanTile;
  return tiles > 0 ? tiles : 1;
}
